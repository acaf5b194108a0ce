"""The yardstick's bytes, operations and per-layer arithmetic against hand
counts."""
import json
import math
from types import SimpleNamespace

import pytest

from chipbench import harness, yardstick

IMDD40 = json.loads((harness.HERE / "configs" / "imdd40.json").read_text())
CNN = IMDD40["cnn"]


def test_bytes_and_operations_a_symbol():
    # 2 float32 samples in, 1 float32 soft symbol out
    assert yardstick.stream_bytes_per_symbol(CNN) == 12
    # layer 1: 1 -> 5 channels, K 9, once per 8 samples (4 a symbol
    # pair): 45 MACs / 4 = 11.25 a symbol; layer 2: 5 -> 5, K 9, once per 8
    # samples: 225 / 4 = 56.25; layer 3: 5 -> 8, K 9, once per 16 samples,
    # 8 symbols out: 360 / 8 = 45
    assert yardstick.macs_per_symbol(CNN) == pytest.approx(
        11.25 + 56.25 + 45.0)
    assert yardstick.ops_per_symbol(CNN) == pytest.approx(225.0)


def test_call_counts_by_hand():
    # one row of 64 final positions: spans 64 (layer 3), 135 (layer 2),
    # 143 (layer 1), 1145 samples
    assert yardstick.spans(64, [9, 9, 9], [8, 1, 2]) == [1145, 143, 135, 64]
    assert yardstick.call_macs(CNN, 2, 64 * 16) == 2 * (
        143 * 45 + 135 * 225 + 64 * 360)
    # rows that do not overlap: every byte of every row
    assert yardstick.call_bytes(4, 100, 100, 200) == (400 + 200) * 4
    # rows that overlap in memory count once: 3 rows of 100 at stride 60
    assert yardstick.call_bytes(3, 100, 60, 150) == (220 + 150) * 4


def paper_overlap(n_inst: int) -> int:
    """o_act = nextEven(ceil(o_sym / (V_p·N_i)))·V_p·N_i, o_sym = (K-1)(1 +
    V_p(L-1))/2 = 68 (paper §6.1)."""
    o_sym = (CNN["kernel"] - 1) * (1 + CNN["v_parallel"]
                                    * (CNN["layers"] - 1)) // 2
    q = math.ceil(o_sym / (CNN["v_parallel"] * n_inst))
    return (q + q % 2) * CNN["v_parallel"] * n_inst


def test_partition_work_ratio_at_4096_instances():
    assert paper_overlap(4096) == 65536 and paper_overlap(64) == 1024
    calls = [{"rows": 4096, "width": 2 * 138392, "row_stride": 2 * 7320,
              "out": 4096 * 138392}] * 3
    ctx = SimpleNamespace(calls=calls, traced={"batches": 3},
                          system=SimpleNamespace(kept_symbols=4096 * 7320))
    ratio = harness.reader("partition_work_ratio")(ctx)
    assert ratio == pytest.approx(138392 / 7320)
    assert harness.reader("partition_work_ratio")(
        SimpleNamespace(calls=[])) is None


def test_eq_mfu_and_roofline_by_hand():
    ctx = SimpleNamespace(config=IMDD40,
                          system=SimpleNamespace(kept_symbols=10 ** 7),
                          window={"batches": 4000, "seconds": 1.0,
                                  "submit_s": [1e-4, 3e-4]})
    assert harness.reader("eq_mfu")(ctx) == pytest.approx(
        100 * 40e9 * 225 / 1979e12)
    assert harness.reader("host_submit_ms")(ctx) == pytest.approx(0.2)
    # the n64 call: 64 rows of (468,480 + 2·1024) symbols at a stride of
    # 468,480 symbols, 0.3 ms of cnn_eq kernel
    width, stride, out = 2 * 470528, 2 * 468480, 64 * 470528
    n_bytes = (63 * stride + width) * 4 + out * 4
    ops = 2 * yardstick.call_macs(CNN, 64, width)
    assert n_bytes / 3.35e12 > ops / 1979e12          # bound by bytes
    ctx = SimpleNamespace(
        config=IMDD40,
        calls=[{"rows": 64, "width": width, "row_stride": stride,
                "out": out}],
        trace={"by_name": {"void cnn_eq_kernel_rb<2>": 3e-4,
                           "Memcpy DtoD": 1e-4}},
        traced={"batches": 1})
    assert harness.reader("cnn_eq_roofline")(ctx) == pytest.approx(
        100 * n_bytes / 3.35e12 / 3e-4)
    assert harness.reader("partition_copy_ms")(ctx) == pytest.approx(0.1)
    ctx.trace = {"by_name": {}}
    assert harness.reader("cnn_eq_roofline")(ctx) is None

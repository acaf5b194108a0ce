"""Port vs reference: design-space exploration (repro_torch.core.dse), on
the CPU.

Mirrors the DSE tests of tests/test_training.py (Pareto front and
operating-point selection, the MAC ceilings, the paper's 135-model CNN
grid). The analytic parts equal the reference's: the three grids field by
field, the ceilings, `pareto_front` and `select_operating_point` on the
same entries. `explore` trains through the port's `train_equalizer` (a
few steps here): worst-of-seeds BER, the MAC count and the feasibility
flag per entry, the same result from the same generator state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro_torch.core import dse
from repro_torch.core.equalizer import CNNEqConfig
from repro_torch.core.fir import FIRConfig
from repro_torch.core.train_eq import EqTrainConfig
from repro_torch.data.equalizer_data import channel_fn


def _entries(mod):
    return [
        mod.DSEEntry("cnn", None, mac_per_sym=10, ber=0.05, feasible=True),
        mod.DSEEntry("cnn", None, mac_per_sym=20, ber=0.01, feasible=True),
        mod.DSEEntry("cnn", None, mac_per_sym=30, ber=0.02, feasible=True),
        mod.DSEEntry("fir", None, mac_per_sym=40, ber=0.005,
                     feasible=False),
    ]


def test_dse_pareto_and_selection():
    entries = _entries(dse)
    front = dse.pareto_front(entries)
    assert [e.mac_per_sym for e in front] == [10, 20, 40]
    pick = dse.select_operating_point(entries)
    assert pick.mac_per_sym == 20      # best BER among feasible
    with pytest.raises(ValueError, match="no feasible model"):
        dse.select_operating_point([e for e in entries if not e.feasible])
    # the reference on the same entries, and on a random cloud
    assert [dataclasses.astuple(e) for e in front] == \
        [dataclasses.astuple(e) for e in jdse.pareto_front(_entries(jdse))]
    rng = np.random.default_rng(0)
    cloud = [(float(m), float(b), bool(f)) for m, b, f in zip(
        rng.integers(1, 60, 200), rng.random(200).round(3),
        rng.random(200) < 0.7)]
    mine = [dse.DSEEntry("cnn", i, m, b, f)
            for i, (m, b, f) in enumerate(cloud)]
    ref = [jdse.DSEEntry("cnn", i, m, b, f)
           for i, (m, b, f) in enumerate(cloud)]
    assert [e.cfg for e in dse.pareto_front(mine)] == \
        [e.cfg for e in jdse.pareto_front(ref)]
    assert dse.select_operating_point(mine).cfg == \
        jdse.select_operating_point(ref).cfg


def test_dse_mac_ceilings():
    # paper: DSP_avail/T_req·f_clk·1.2 for the XCVU13P @ 200 MHz, 40 GBd
    assert dse.mac_sym_max_fpga() == pytest.approx(
        12288 / 40e9 * 200e6 * 1.2)
    assert dse.mac_sym_max_fpga() == pytest.approx(73.728)
    # the paper's operating point (56.25 MAC/sym) is feasible, K=15 C=5
    # L=3 V_p=8 (≈ 93.75) is not:
    assert CNNEqConfig().mac_per_symbol() <= dse.mac_sym_max_fpga()
    assert CNNEqConfig(kernel=15).mac_per_symbol() > dse.mac_sym_max_fpga()
    # the accelerator analogue scales with chips
    assert dse.mac_sym_max_tpu(chips=2) == 2 * dse.mac_sym_max_tpu(chips=1)
    # both ceilings equal the reference's, defaults and arguments
    assert dse.mac_sym_max_fpga() == jdse.mac_sym_max_fpga()
    assert dse.mac_sym_max_fpga(4096, 10e9, 300e6, 1.0) == \
        jdse.mac_sym_max_fpga(4096, 10e9, 300e6, 1.0)
    assert dse.mac_sym_max_tpu() == jdse.mac_sym_max_tpu()
    assert dse.mac_sym_max_tpu(4, 1e15, 0.5, 80e9) == \
        jdse.mac_sym_max_tpu(4, 1e15, 0.5, 80e9)


def test_cnn_grid_is_paper_sized():
    assert len(list(dse.cnn_grid())) == 135      # 5·3·3·3 models (§3.5)
    for mine, ref in ((dse.cnn_grid(), jdse.cnn_grid()),
                      (dse.fir_grid(), jdse.fir_grid()),
                      (dse.volterra_grid(), jdse.volterra_grid())):
        mine, ref = list(mine), list(ref)
        assert [dataclasses.asdict(c) for c in mine] == \
            [dataclasses.asdict(c) for c in ref]
        assert [c.mac_per_symbol() for c in mine] == \
            [c.mac_per_symbol() for c in ref]


def test_explore_keeps_worst_seed_and_repeats():
    fn = channel_fn("proakis", device="cpu")
    cfg = EqTrainConfig(steps=4, batch=2, seq_syms=64, eval_syms=512)
    entries = [("cnn", CNNEqConfig(kernel=15)), ("fir", FIRConfig(taps=9))]
    ceiling = dse.mac_sym_max_fpga()
    out = dse.explore(torch.Generator().manual_seed(1), entries, fn, cfg,
                      ceiling, n_seeds=2, device="cpu")
    assert [e.kind for e in out] == ["cnn", "fir"]
    assert [e.mac_per_sym for e in out] == [c.mac_per_symbol()
                                            for _, c in entries]
    assert [e.feasible for e in out] == [False, True]
    assert all(0.0 <= e.ber <= 1.0 for e in out)
    again = dse.explore(torch.Generator().manual_seed(1), entries, fn, cfg,
                        ceiling, n_seeds=2, device="cpu")
    assert [e.ber for e in again] == [e.ber for e in out]
    # the worst of the seeds: one seed alone never beats it
    one = dse.explore(torch.Generator().manual_seed(1), entries, fn, cfg,
                      ceiling, n_seeds=1, device="cpu")
    assert all(a.ber <= b.ber for a, b in zip(one, out))
    assert dse.select_operating_point(out).kind == "fir"

"""Card-only tests of the port: the hand-written kernels on an NVIDIA card.

Every test here needs a CUDA card and skips without one (the decision is
made inside the `cuda_device` fixture, never at import). This file imports
no jax, so it also runs on the card's host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain version (`ref.py`) bitwise on the card at
any tile width, stacked or shared weights, and the serving path must run
through the kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import equalizer_ht as HT
from repro_torch.core import equalizer as teq
from repro_torch.core.engine import EqualizerEngine, stacked_engine_fn
from repro_torch.kernels.cnn_eq import cnn_eq as kern
from repro_torch.kernels.cnn_eq import ref
from repro_torch.serve import BatchPolicy, ServeRuntime, TenantSpec

FMTS = ((2, 5, 3, 4),) * 3
QAT = {"w_int": 2.0, "w_frac": 5.0, "a_int": 3.0, "a_frac": 4.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda", 0)


def _folded(seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    p = teq.init(gen, HT.CNN, device="cpu")
    w = teq.folded_weights(teq.fold_bn(
        p, teq.init_bn_state(HT.CNN, device="cpu"), HT.CNN))
    return tuple((wi.to(device), bi.to(device)) for wi, bi in w)


def _x(rows, n_syms, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((rows, n_syms * 2)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_kernels_equal_plain_versions_on_card(cuda_device, stacked):
    st = teq.layer_strides(HT.CNN)
    rows = 4
    per = [_folded(s, cuda_device) for s in range(rows)]
    if stacked:
        w = tuple((torch.stack([p[l][0] for p in per]),
                   torch.stack([p[l][1] for p in per])) for l in range(3))
        q = tuple((torch.stack([kern.quantize_weights_int8(p, FMTS)[l][0]
                                for p in per]), w[l][1]) for l in range(3))
    else:
        w, q = per[0], kern.quantize_weights_int8(per[0], FMTS)
    x_cpu = _x(rows, 1003, seed=1)
    x = x_cpu.to(cuda_device)
    wants = {"fp32": ref.cnn_eq(x, w, st), "bf16": ref.cnn_eq_bf16(x, w, st),
             "int8": ref.cnn_eq_int8(x, q, st, FMTS)}
    for tile_m in (16, 64, 256):
        before = dict(kern.LAUNCHES)
        got = {"fp32": kern.cnn_eq_fused(x, w, st, tile_m),
               "bf16": kern.cnn_eq_fused_bf16(x, w, st, tile_m),
               "int8": kern.cnn_eq_fused_int8(x, q, st, FMTS, tile_m)}
        torch.cuda.synchronize()
        for name in kern.LAUNCHES:
            assert kern.LAUNCHES[name] == before[name] + 1
        for dp in got:
            assert got[dp].is_cuda
            assert torch.equal(got[dp], wants[dp]), (dp, tile_m)
    # the card's kernels also equal the plain versions run on the host
    w_cpu = tuple((a.cpu(), b.cpu()) for a, b in w)
    assert torch.equal(got["fp32"].cpu(), ref.cnn_eq(x_cpu, w_cpu, st))


@pytest.mark.cuda
def test_engine_defaults_to_card_and_stacks(cuda_device):
    engines = [EqualizerEngine(cfg=HT.CNN, weights=_folded(s), tile_m=64)
               for s in (5, 6)]
    assert engines[0].device.type == "cuda"
    x = _x(2, 700, seed=2).to(cuda_device)
    y = stacked_engine_fn(engines)(x)
    for i, e in enumerate(engines):
        assert torch.equal(y[i:i + 1], e(x[i:i + 1]))


@pytest.mark.cuda
def test_serve_runtime_on_card_is_bitwise_offline(cuda_device):
    rng = np.random.default_rng(3)
    specs = []
    for i, qat in enumerate([QAT, QAT, None]):
        p = teq.init(torch.Generator().manual_seed(10 + i), HT.CNN,
                     device="cpu")
        if qat is not None:
            p["qat"] = {f"layer{l}": dict(qat) for l in range(3)}
        specs.append(TenantSpec(f"t{i}", HT.CNN, params=p, tile_m=32))
    waves = {s.tenant_id: rng.standard_normal(2 * 900).astype(np.float32)
             for s in specs}
    kern.reset_launch_counts()
    rt = ServeRuntime(BatchPolicy(max_batch=2))
    for s in specs:
        rt.open(s)
    for start in range(0, 1800, 333):
        for tid, w in waves.items():
            rt.submit(tid, w[start:start + 333])
    outs = {tid: rt.close(tid) for tid in waves}
    assert kern.LAUNCHES["cnn_eq_fused_int8"] > 0
    assert kern.LAUNCHES["cnn_eq_fused"] > 0
    for s in specs:
        want = s.build_engine()(waves[s.tenant_id]).cpu().numpy()
        np.testing.assert_array_equal(outs[s.tenant_id], want)


@pytest.mark.cuda
def test_tile_too_large_for_shared_memory_raises(cuda_device):
    st = teq.layer_strides(HT.CNN)
    w = _folded(0, cuda_device)
    x = _x(1, 64, seed=4).to(cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        kern.cnn_eq_fused(x, w, st, tile_m=8192)
    # a tile that fits still runs and equals the plain version
    assert torch.equal(kern.cnn_eq_fused(x, w, st, tile_m=1024),
                       ref.cnn_eq(x, w, st))

"""Port vs reference: EqualizerEngine, stacked launches and autotune.

The `auto` ladder must deploy the same backend as the JAX engine from the
same trained parameters (int8, bf16, fp32 formats, and the BN-fold veto
that sends an overflowing int8 grid to bf16). Engine outputs are held
against the reference oracles on the same folded weights (int8 exact,
fp32 rtol=1e-6/atol=5e-6, bf16 atol=1e-5); inside the port, a stacked
launch equals each engine run alone bitwise. The autotune cache lives in
its own file with a platform key.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equalizer_ht as HT
from repro.core import autotune as jautotune
from repro.core import equalizer as jeq
from repro.core.engine import EqualizerEngine as JEngine
from repro.kernels.cnn_eq import ref as jref
from repro_torch.core import autotune
from repro_torch.core import equalizer as teq
from repro_torch.core.engine import (BACKENDS, UNTIMED_TILE_M,
                                     EqualizerEngine, stacked_engine_fn)

RTOL, ATOL = 1e-6, 5e-6
BF16_ATOL = 1e-5
CFG = teq.CNNEqConfig()
FMT_INT8 = {"w_int": 2, "w_frac": 5, "a_int": 3, "a_frac": 4}
FMT_BF16 = {"w_int": 3, "w_frac": 8, "a_int": 3, "a_frac": 8}
FMT_FP32 = {"w_int": 10, "w_frac": 10, "a_int": 3, "a_frac": 4}


def _params(seed, fmt=None, bn_scale=1.0):
    """JAX-initialized params + BN state as numpy (optionally QAT widths)."""
    params = jax.tree.map(np.asarray, jeq.init(jax.random.PRNGKey(seed),
                                               HT.CNN))
    rng = np.random.default_rng(seed)
    for bn in params["bn"]:
        bn["scale"] = (bn_scale * (1 + 0.1 * rng.standard_normal(
            bn["scale"].shape))).astype(np.float32)
    state = {"bn": [{"mean": (0.1 * rng.standard_normal(5)).astype(
                        np.float32),
                     "var": (1 + 0.5 * rng.random(5)).astype(np.float32)}
                    for _ in range(HT.CNN.layers - 1)]}
    if fmt is not None:
        params["qat"] = {f"layer{i}": {k: np.float32(v)
                                       for k, v in fmt.items()}
                         for i in range(HT.CNN.layers)}
    return params, state


def _x(n_syms, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, n_syms * 2)).astype(np.float32)


@pytest.mark.parametrize("fmt,bn_scale,expect", [
    (FMT_INT8, 1.0, "fused_int8"),
    (FMT_INT8, 40.0, "fused_bf16"),      # BN fold overflows Q2.5: veto
    (FMT_BF16, 1.0, "fused_bf16"),
    (FMT_FP32, 1.0, "fused_fp32"),
    (None, 1.0, "fused_fp32"),           # no QAT at all
])
@pytest.mark.parametrize("per_channel", [False, True])
def test_auto_ladder_matches_reference(fmt, bn_scale, expect, per_channel):
    params, state = _params(0, fmt, bn_scale)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax.tree.map(jnp.asarray, state)
    je = JEngine.from_params(jparams, jstate, HT.CNN, interpret=True,
                             per_channel=per_channel)
    te = EqualizerEngine.from_params(params, state, CFG, device="cpu",
                                     per_channel=per_channel)
    assert te.backend == je.backend
    if not per_channel:
        assert te.backend == expect
    assert te.formats == je.formats
    assert te.halo_samples == je.halo_samples
    assert te.total_stride == je.total_stride


def test_explicit_int8_refuses_overflowing_grid_like_reference():
    params, state = _params(1, FMT_INT8, bn_scale=40.0)
    with pytest.raises(ValueError, match="overflow"):
        JEngine.from_params(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state), HT.CNN,
                            backend="fused_int8", interpret=True)
    with pytest.raises(ValueError, match="overflow"):
        EqualizerEngine.from_params(params, state, CFG,
                                    backend="fused_int8", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        EqualizerEngine.from_params(params, state, CFG, backend="fused_int4",
                                    device="cpu")
    assert BACKENDS == ("ref", "fused_fp32", "fused_bf16", "fused_int8")


@pytest.mark.parametrize("fmt", [FMT_INT8, FMT_BF16, None])
def test_engine_output_matches_reference_oracles(fmt):
    params, state = _params(2, fmt)
    te = EqualizerEngine.from_params(params, state, CFG, tile_m=32,
                                     device="cpu")
    jw = tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
               for w, b in te.weights)
    st = teq.layer_strides(CFG)
    x = _x(300, seed=2)
    got = te(x).numpy()
    if te.backend == "fused_int8":
        want = jref.cnn_eq_quant(jnp.asarray(x), jw, st, te.formats)
        np.testing.assert_array_equal(got, np.asarray(want))
    elif te.backend == "fused_bf16":
        want = jref.cnn_eq_bf16(jnp.asarray(x), jw, st)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=BF16_ATOL)
    else:
        want = jref.cnn_eq(jnp.asarray(x), jw, st)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    one = te(x[0])                               # 1-D input squeezes
    assert one.dim() == 1 and torch.equal(one, te(x[:1])[0])
    ref_engine = EqualizerEngine(cfg=CFG, weights=te.weights, backend="ref",
                                 device="cpu")
    if te.backend == "fused_fp32":
        assert torch.equal(ref_engine(x), te(x))


@pytest.mark.parametrize("fmt", [FMT_INT8, FMT_BF16, None])
def test_stacked_engine_fn_bitwise_equals_solo(fmt):
    engines = [EqualizerEngine.from_params(*_params(s, fmt), CFG, tile_m=16,
                                           device="cpu")
               for s in (3, 4, 5)]
    assert len({e.group_key() for e in engines}) == 1
    x = torch.from_numpy(_x(250, rows=3, seed=3))
    y = stacked_engine_fn(engines)(x)
    for i, e in enumerate(engines):
        assert torch.equal(y[i:i + 1], e(x[i:i + 1]))
    refs = [EqualizerEngine(cfg=CFG, weights=e.weights, backend="ref",
                            device="cpu") for e in engines]
    y_ref = stacked_engine_fn(refs)(x)
    for i, e in enumerate(refs):
        assert torch.equal(y_ref[i:i + 1], e(x[i:i + 1]))


def test_group_and_tune_keys():
    a = EqualizerEngine.from_params(*_params(6, FMT_INT8), CFG, tile_m=16,
                                    device="cpu")
    b = EqualizerEngine.from_params(*_params(7, FMT_INT8), CFG, tile_m=16,
                                    device="cpu")
    c = EqualizerEngine.from_params(*_params(7, FMT_INT8), CFG, tile_m=32,
                                    device="cpu")
    d = EqualizerEngine.from_params(*_params(7, FMT_BF16), CFG, tile_m=16,
                                    device="cpu")
    assert a.group_key() == b.group_key()
    assert a.tune_key() == c.tune_key() and a.group_key() != c.group_key()
    assert a.tune_key() != d.tune_key()
    assert "cpu" in a.tune_key()
    with pytest.raises(ValueError, match="not batch-compatible"):
        stacked_engine_fn([a, d])
    assert a.describe()["backend"] == "fused_int8"
    assert a.describe()["device"] == "cpu"


def test_autotune_cache_round_trips_on_its_own_file(tmp_path, monkeypatch):
    path = tmp_path / "autotune_tile_m_torch.json"
    monkeypatch.setattr(autotune, "CACHE_PATH", path)
    autotune.clear_cache()
    assert autotune.CACHE_PATH.name != jautotune.CACHE_PATH.name
    assert autotune.platform_key("cpu") == "cpu"
    engine = EqualizerEngine.from_params(*_params(8, FMT_INT8), CFG,
                                         device="cpu")
    best = autotune.best_tile_m(CFG, "fused_int8", engine._make_fn,
                                candidates=(16, 32), probe_syms=256,
                                device="cpu")
    assert best in (16, 32)
    data = json.loads(path.read_text())
    assert data == {"L3_K9_C5_Vp8_Nos2__fused_int8__cpu": best}
    autotune.clear_cache()                  # memory gone, disk remains

    def boom(tile_m):
        raise AssertionError("cache miss: the sweep ran again")
    assert autotune.best_tile_m(CFG, "fused_int8", boom, device="cpu") == best
    batched = autotune.best_tile_m(CFG, "fused_int8", engine._make_fn,
                                   candidates=(16,), probe_syms=128,
                                   probe_batch=3, device="cpu")
    assert batched == 16
    assert "L3_K9_C5_Vp8_Nos2__fused_int8__cpu__B3_S128" in json.loads(
        path.read_text())
    autotune.clear_cache(disk=True)
    assert not path.exists()


def test_auto_tile_resolves_through_autotune(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH", tmp_path / "cache.json")
    monkeypatch.setattr(autotune, "DEFAULT_TILES", (16, 64))
    autotune.clear_cache()
    # K = 7: its kernel tiles by tile_m (every datapath at the paper's
    # widths runs a kernel that does not, test_untiled_kernels_skip_the_
    # autotune)
    cfg = teq.CNNEqConfig(kernel=7)
    weights = teq.folded_weights(teq.fold_bn(
        teq.init(torch.Generator().manual_seed(9), cfg, device="cpu"),
        teq.init_bn_state(cfg, device="cpu"), cfg))
    engine = EqualizerEngine(cfg=cfg, weights=weights, backend="fused_fp32",
                             device="cpu")
    assert engine.tile_m == "auto" and engine.tile_is_timed()
    assert engine.resolved_tile_m() in (16, 64)
    assert isinstance(engine.tile_m, int)
    autotune.clear_cache()


@pytest.mark.parametrize("backend,kernel,timed", [
    ("fused_int8", 9, False),       # paper widths: cnn_eq_kernel_rb
    ("fused_bf16", 9, False),
    ("ref", 9, False),
    ("fused_fp32", 9, False),
    ("fused_fp32", 7, True),        # the generic kernel tiles by tile_m
    ("fused_bf16", 7, True),
])
def test_untiled_kernels_skip_the_autotune(monkeypatch, backend, kernel,
                                           timed):
    cfg = teq.CNNEqConfig(kernel=kernel)
    gen = torch.Generator().manual_seed(kernel)
    weights = teq.folded_weights(teq.fold_bn(
        teq.init(gen, cfg, device="cpu"),
        teq.init_bn_state(cfg, device="cpu"), cfg))
    swept = []

    def best_tile_m(cfg, backend, make_fn, **kw):
        swept.append(backend)
        return 32
    monkeypatch.setattr(autotune, "best_tile_m", best_tile_m)
    engine = EqualizerEngine(cfg=cfg, weights=weights, backend=backend,
                             formats=((2, 5, 3, 4),) * 3, device="cpu")
    assert engine.tile_is_timed() == timed
    assert engine.resolved_tile_m() == (32 if timed else UNTIMED_TILE_M)
    assert swept == ([backend] if timed else [])

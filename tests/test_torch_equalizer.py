"""Port vs reference: the equalizer core and QAT (repro_torch.core).

Inputs come from numpy seeds; JAX parameters are drawn once with `eq.init`
and carried across as numpy through `repro_torch.interop`.

Tolerances (port vs JAX, on the CPU):
  * BN folding, fixed-point fake quantization, frozen formats, deployment
    plans and `requant_int8`: identical (same elementwise float ops, round
    half to even in both frameworks);
  * forward passes (`apply`, `apply_folded`): rtol=1e-6, atol=5e-6 — the
    two frameworks' convolutions sum in different orders, and the output
    reaches |y| ≈ 16, where 5e-6 alone is under 3 ULP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equalizer_ht as HT
from repro.core import equalizer as jeq
from repro.core import qat as jqat
from repro.kernels.cnn_eq import cnn_eq as jkern
from repro_torch import interop
from repro_torch.core import equalizer as teq
from repro_torch.core import qat as tqat
from repro_torch.kernels.cnn_eq import cnn_eq as tkern

RTOL, ATOL = 1e-6, 5e-6
CFGS = [HT.CNN, jeq.CNNEqConfig(layers=4, kernel=7, channels=4,
                                v_parallel=4)]


def _tcfg(cfg):
    return teq.CNNEqConfig(**{f: getattr(cfg, f) for f in
                              ("layers", "kernel", "channels", "v_parallel",
                               "n_os", "levels", "bn_momentum")})


def _jax_params(cfg, seed=0):
    key = jax.random.PRNGKey(seed)
    params = jeq.init(key, cfg)
    rng = np.random.default_rng(seed)
    for bn in params["bn"]:
        bn["scale"] = jnp.asarray(
            1 + 0.2 * rng.standard_normal(bn["scale"].shape), jnp.float32)
        bn["bias"] = jnp.asarray(
            0.1 * rng.standard_normal(bn["bias"].shape), jnp.float32)
    for layer in params["conv"]:
        layer["b"] = jnp.asarray(
            0.1 * rng.standard_normal(layer["b"].shape), jnp.float32)
    state = {"bn": [{"mean": jnp.asarray(0.1 * rng.standard_normal(s.shape),
                                         jnp.float32),
                     "var": jnp.asarray(1 + 0.5 * rng.random(s.shape),
                                        jnp.float32)}
                    for s in (b["mean"] for b in
                              jeq.init_bn_state(cfg)["bn"])]}
    return params, state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wave(rng, n, rows=2):
    return rng.standard_normal((rows, n)).astype(np.float32)


@pytest.mark.parametrize("cfg", CFGS)
def test_fold_bn_bitwise(cfg):
    params, state = _jax_params(cfg)
    want = jeq.folded_weights(jeq.fold_bn(params, state, cfg))
    tp = interop.to_torch(_np(params), device="cpu")
    ts = interop.to_torch(_np(state), device="cpu")
    got = teq.folded_weights(teq.fold_bn(tp, ts, _tcfg(cfg)))
    for (wj, bj), (wt, bt) in zip(want, got):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("cfg", CFGS)
def test_apply_and_apply_folded_match_reference(cfg):
    params, state = _jax_params(cfg, seed=1)
    x = _wave(np.random.default_rng(1), 64 * cfg.v_parallel * cfg.n_os)
    tp = interop.to_torch(_np(params), device="cpu")
    ts = interop.to_torch(_np(state), device="cpu")
    tc = _tcfg(cfg)
    yj, _ = jeq.apply(params, jnp.asarray(x), cfg, bn_state=state)
    yt, _ = teq.apply(tp, torch.from_numpy(x), tc, bn_state=ts)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=ATOL)
    fj = jeq.apply_folded(jeq.fold_bn(params, state, cfg), jnp.asarray(x),
                          cfg)
    ft = teq.apply_folded(teq.fold_bn(tp, ts, tc), torch.from_numpy(x), tc)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL,
                               atol=ATOL)
    # 1-D input squeezes, like the reference
    f1 = teq.apply_folded(teq.fold_bn(tp, ts, tc), torch.from_numpy(x[0]),
                          tc)
    assert f1.shape == ft.shape[1:]


def test_apply_train_mode_updates_bn_state_like_reference():
    cfg = HT.CNN
    params, state = _jax_params(cfg, seed=2)
    x = _wave(np.random.default_rng(2), 512, rows=4)
    yj, nj = jeq.apply(params, jnp.asarray(x), cfg, train=True,
                       bn_state=state)
    yt, nt = teq.apply(interop.to_torch(_np(params), device="cpu"),
                       torch.from_numpy(x), _tcfg(cfg), train=True,
                       bn_state=interop.to_torch(_np(state), device="cpu"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    for sj, st in zip(nj["bn"], nt["bn"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       rtol=1e-5, atol=1e-6)


def test_apply_with_qat_matches_reference():
    cfg = HT.CNN
    params, state = _jax_params(cfg, seed=3)
    params["qat"] = {f"layer{i}": {"w_int": jnp.float32(2.3),
                                   "w_frac": jnp.float32(5.6),
                                   "a_int": jnp.float32(3.0),
                                   "a_frac": jnp.float32(4.0)}
                     for i in range(cfg.layers)}
    x = _wave(np.random.default_rng(3), 512)
    yj, _ = jeq.apply(params, jnp.asarray(x), cfg, bn_state=state,
                      qat_enabled=True)
    yt, _ = teq.apply(interop.to_torch(_np(params), device="cpu"),
                      torch.from_numpy(x), _tcfg(cfg),
                      bn_state=interop.to_torch(_np(state), device="cpu"),
                      qat_enabled=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=ATOL)


def test_init_layout_and_he_scale():
    cfg = teq.CNNEqConfig()
    gen = torch.Generator().manual_seed(0)
    p = teq.init(gen, cfg, qat=tqat.QATConfig(), device="cpu")
    shapes = [tuple(l["w"].shape) for l in p["conv"]]
    assert shapes == [(5, 1, 9), (5, 5, 9), (8, 5, 9)]
    assert len(p["bn"]) == cfg.layers - 1
    assert set(p["qat"]) == {"layer0", "layer1", "layer2"}
    big = teq.init(torch.Generator().manual_seed(1),
                   teq.CNNEqConfig(channels=64), device="cpu")
    std = float(big["conv"][1]["w"].std())
    assert abs(std - (2.0 / (64 * 9)) ** 0.5) < 0.01
    again = teq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["conv"][2]["w"], p["conv"][2]["w"])
    assert teq.layer_strides(cfg) == jeq.layer_strides(HT.CNN)
    assert cfg.receptive_field_syms == HT.CNN.receptive_field_syms
    assert cfg.mac_per_symbol() == HT.CNN.mac_per_symbol()


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

def _grid_values(rng, frac):
    """Random values plus exact half-way points of the 2^-frac grid."""
    base = rng.standard_normal(512).astype(np.float32) * 6
    half = (np.arange(-40, 40) + 0.5).astype(np.float32) / np.float32(
        2.0 ** frac)
    return np.concatenate([base, half, np.float32([1e6, -1e6, 0.0])])


@pytest.mark.parametrize("ib,fb", [(2, 5), (3, 4), (0, 7), (5, 10)])
def test_quantize_fixed_bitwise(ib, fb):
    x = _grid_values(np.random.default_rng(ib * 10 + fb), fb)
    want = np.asarray(jqat.quantize_fixed(jnp.asarray(x), jnp.float32(ib),
                                          jnp.float32(fb)))
    got = tqat.quantize_fixed(torch.from_numpy(x), ib, fb).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_interp_and_ste_gradient():
    x = _grid_values(np.random.default_rng(0), 4)
    want = np.asarray(jqat.quantize_interp(jnp.asarray(x), jnp.float32(2.3),
                                           jnp.float32(4.6)))
    got = tqat.quantize_interp(torch.from_numpy(x), 2.3, 4.6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xt = torch.tensor([0.3, 100.0], requires_grad=True)
    tqat.quantize_fixed(xt, 2, 3).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), [1.0, 0.0])


@pytest.mark.parametrize("fmt", [
    {"w_int": 2, "w_frac": 5, "a_int": 3, "a_frac": 4},       # int8
    {"w_int": 3, "w_frac": 8, "a_int": 3, "a_frac": 8},       # bf16
    {"w_int": 2.2, "w_frac": 4.7, "a_int": 3.0, "a_frac": 3.1},
    {"w_int": 10, "w_frac": 10, "a_int": 3, "a_frac": 4},     # fp32
])
def test_deployment_plan_and_formats_identical(fmt):
    qj = {f"layer{i}": {k: jnp.float32(v) for k, v in fmt.items()}
          for i in (2, 0, 1)}
    qt = interop.to_torch(_np(qj), device="cpu")
    assert tqat.deployment_plan(qt) == jqat.deployment_plan(qj)
    assert tqat.layer_formats(qt) == jqat.layer_formats(qj)
    assert tqat.plan_backend(tqat.deployment_plan(qt)) == \
        jqat.plan_backend(jqat.deployment_plan(qj))
    assert tqat.deployment_dtype(qt["layer0"]) == \
        jqat.deployment_dtype(qj["layer0"])
    assert tqat.frozen_format({k: float(v) for k, v in fmt.items()}) == \
        jqat.frozen_format(qj["layer0"])
    bj = jqat.average_bits(qj)
    bt = tqat.average_bits(qt)
    assert [float(v) for v in bt] == [float(v) for v in bj]
    assert float(tqat.quant_loss_term(qt, tqat.QATConfig())) == \
        float(jqat.quant_loss_term(qj, jqat.QATConfig()))
    fz = tqat.freeze_qparams(qt)
    cl = tqat.clip_qparams(qt, tqat.QATConfig())
    for n in qj:
        for k in fmt:
            assert float(fz[n][k]) == float(jqat.freeze_qparams(qj)[n][k])
            assert float(cl[n][k]) == float(
                jqat.clip_qparams(qj, jqat.QATConfig())[n][k])


@pytest.mark.parametrize("cfg", CFGS)
def test_per_channel_formats_identical(cfg):
    params, state = _jax_params(cfg, seed=4)
    wj = jeq.folded_weights(jeq.fold_bn(params, state, cfg))
    wt = interop.to_torch(_np(wj), device="cpu")
    for base in [(2, 5, 3, 4), (4, 3, 3, 4), (1, 6, 2, 5)]:
        formats = (base,) * cfg.layers
        got = tqat.per_channel_formats(wt, formats)
        assert got == jqat.per_channel_formats(wj, formats)
        assert [tqat.format_max_bits(f[0], f[1]) for f in got] == \
            [jqat.format_max_bits(f[0], f[1]) for f in got]


@pytest.mark.parametrize("ai,af", [(3, 4), (0, 7), (2, 2), (5, 2)])
def test_requant_int8_bitwise_including_half_way(ai, af):
    x = _grid_values(np.random.default_rng(ai + 7 * af), af)
    want = np.asarray(jkern.requant_int8(jnp.asarray(x), ai, af))
    got = tkern.requant_int8(torch.from_numpy(x), ai, af)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tkern.dequant_int8(got, af).numpy(),
        np.asarray(jkern.dequant_int8(jnp.asarray(want), af)))

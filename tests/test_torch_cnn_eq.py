"""Port vs reference: the fused cnn_eq datapaths (repro_torch.kernels.cnn_eq).

The port's plain versions (`ref.py`, what its wrappers run on a CPU tensor)
are held against the JAX package's oracles (`repro.kernels.cnn_eq.ref`)
and its Pallas kernels run in interpret mode, on the same numpy inputs and
the same BN-folded weights:

  * int8: identical (integer dots, power-of-two rescales) — scalar and
    per-output-channel formats;
  * fp32: rtol=1e-6, atol=5e-6 (the port sums one product at a time,
    tap-major then C_in; the reference sums each tap over C_in first);
  * bf16: atol=1e-5 (same reason, on bf16-rounded operands).

Inside the port everything is bitwise: any tile_m, stacked == solo, wrapper
== untiled plain version. On the card each kernel must equal its plain
version bitwise (tests/test_torch_cuda.py; chip_smoke.py at full size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equalizer_ht as HT
from repro.core import equalizer as jeq
from repro.kernels.cnn_eq import cnn_eq as jkern
from repro.kernels.cnn_eq import ops as jops
from repro.kernels.cnn_eq import ref as jref
from repro_torch import interop
from repro_torch.core import equalizer as teq
from repro_torch.kernels.cnn_eq import cnn_eq as tkern
from repro_torch.kernels.cnn_eq import ops as tops
from repro_torch.kernels.cnn_eq import ref as tref

RTOL, ATOL = 1e-6, 5e-6
BF16_ATOL = 1e-5
INT8_FMT = (2, 5, 3, 4)
CFG4 = jeq.CNNEqConfig(layers=4, kernel=7, channels=4, v_parallel=4)


def _folded_np(cfg, seed):
    """BN-folded weights from JAX eq.init + a random BN state, as numpy."""
    params = jeq.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    state = {"bn": [{"mean": jnp.asarray(0.1 * rng.standard_normal(
                        s["mean"].shape), jnp.float32),
                     "var": jnp.asarray(1 + 0.5 * rng.random(
                        s["var"].shape), jnp.float32)}
                    for s in jeq.init_bn_state(cfg)["bn"]]}
    for layer in params["conv"]:
        layer["b"] = jnp.asarray(0.05 * rng.standard_normal(
            layer["b"].shape), jnp.float32)
    return jax.tree.map(np.asarray, jeq.folded_weights(
        jeq.fold_bn(params, state, cfg)))


def _x(cfg, n_syms, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, n_syms * cfg.n_os)).astype(np.float32)


def _jw(w_np):
    return tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in w_np)


def _tw(w_np):
    return interop.to_torch(w_np, device="cpu")


def _stack_np(ws):
    return tuple((np.stack([w[l][0] for w in ws]),
                  np.stack([w[l][1] for w in ws])) for l in range(len(ws[0])))


def _strides(cfg):
    return jeq.layer_strides(cfg)


# ---------------------------------------------------------------------------
# plain versions vs the reference oracles and interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

# the Pallas kernels (interpret mode, seconds per compile) are run at the
# paper's topology; the second topology is held against the JAX oracles
@pytest.mark.parametrize("cfg,n_syms,pallas", [(HT.CNN, 333, True),
                                               (CFG4, 201, False)])
def test_fp32_matches_reference_and_pallas(cfg, n_syms, pallas):
    w = _folded_np(cfg, 0)
    x = _x(cfg, n_syms)
    st = _strides(cfg)
    got = tref.cnn_eq(torch.from_numpy(x), _tw(w), st).numpy()
    want_ref = np.asarray(jref.cnn_eq(jnp.asarray(x), _jw(w), st))
    assert got.shape == want_ref.shape
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    if pallas:
        want_pallas = np.asarray(jkern.cnn_eq_fused(
            jnp.asarray(x), _jw(w), st, tile_m=64, interpret=True))
        np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)
    wrapped = tkern.cnn_eq_fused(torch.from_numpy(x), _tw(w), st, tile_m=16)
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_fp32_stacked_matches_pallas_stacked():
    cfg = HT.CNN
    ws = [_folded_np(cfg, s) for s in range(3)]
    x = _x(cfg, 250, rows=3, seed=1)
    st = _strides(cfg)
    want = np.asarray(jkern.cnn_eq_fused(jnp.asarray(x), _jw(_stack_np(ws)),
                                         st, tile_m=32, interpret=True))
    got = tkern.cnn_eq_fused(torch.from_numpy(x), _tw(_stack_np(ws)), st,
                             tile_m=32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg,n_syms,pallas", [(HT.CNN, 333, True),
                                               (CFG4, 201, False)])
def test_bf16_matches_reference_and_pallas(cfg, n_syms, pallas):
    w = _folded_np(cfg, 1)
    x = _x(cfg, n_syms, seed=2)
    st = _strides(cfg)
    bw_j = jkern.cast_weights_bf16(_jw(w))
    bw_t = tkern.cast_weights_bf16(_tw(w))
    for (wj, bj), (wt, bt) in zip(bw_j, bw_t):
        assert wt.dtype == torch.bfloat16 and bt.dtype == torch.float32
        np.testing.assert_array_equal(wt.float().numpy(),
                                      np.asarray(wj, np.float32))
    got = tref.cnn_eq_bf16(torch.from_numpy(x), bw_t, st).numpy()
    want_ref = np.asarray(jref.cnn_eq_bf16(jnp.asarray(x), bw_j, st))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=BF16_ATOL)
    if pallas:
        want_pallas = np.asarray(jkern.cnn_eq_fused_bf16(
            jnp.asarray(x), bw_j, st, tile_m=64, interpret=True))
        np.testing.assert_allclose(got, want_pallas, rtol=0,
                                   atol=BF16_ATOL)
    wrapped = tkern.cnn_eq_fused_bf16(torch.from_numpy(x), _tw(w), st,
                                      tile_m=16)
    np.testing.assert_array_equal(wrapped.numpy(), got)


def _per_channel(cfg, w):
    from repro.core import qat as jqat
    return jqat.per_channel_formats(w, (INT8_FMT,) * cfg.layers)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("cfg", [HT.CNN, CFG4])
def test_int8_exact_against_pallas_and_fake_quant(cfg, per_channel):
    w = _folded_np(cfg, 2)
    formats = (_per_channel(cfg, w) if per_channel
               else (INT8_FMT,) * cfg.layers)
    if per_channel:
        assert any(isinstance(f[0], tuple) for f in formats)
    x = _x(cfg, 277, seed=3)
    st = _strides(cfg)
    qj = jkern.quantize_weights_int8(_jw(w), formats)
    qt = tkern.quantize_weights_int8(_tw(w), formats)
    for (wj, bj), (wt, bt) in zip(qj, qt):
        assert wt.dtype == torch.int8
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    want_pallas = np.asarray(jkern.cnn_eq_fused_int8(
        jnp.asarray(x), qj, st, formats, tile_m=64, interpret=True))
    want_quant = np.asarray(jref.cnn_eq_quant(jnp.asarray(x), _jw(w), st,
                                              formats))
    xt = torch.from_numpy(x)
    plain = tref.cnn_eq_int8(xt, qt, st, formats).numpy()
    wrapped = tkern.cnn_eq_fused_int8(xt, qt, st, formats,
                                      tile_m=16).numpy()
    fake = tref.cnn_eq_quant(xt, _tw(w), st, formats).numpy()
    for got in (plain, wrapped, fake):
        np.testing.assert_array_equal(got, want_pallas)
        np.testing.assert_array_equal(got, want_quant)


# ---------------------------------------------------------------------------
# invariances inside the port (bitwise)
# ---------------------------------------------------------------------------

def _datapaths(cfg, w_np):
    st = _strides(cfg)
    fmts = (INT8_FMT,) * cfg.layers
    w = _tw(w_np)
    q = tkern.quantize_weights_int8(w, fmts)
    return {
        "fp32": (lambda x, t: tkern.cnn_eq_fused(x, w, st, t),
                 lambda x: tref.cnn_eq(x, w, st)),
        "bf16": (lambda x, t: tkern.cnn_eq_fused_bf16(x, w, st, t),
                 lambda x: tref.cnn_eq_bf16(x, w, st)),
        "int8": (lambda x, t: tkern.cnn_eq_fused_int8(x, q, st, fmts, t),
                 lambda x: tref.cnn_eq_int8(x, q, st, fmts)),
    }


@pytest.mark.parametrize("n_syms", [8, 17 * 8 + 3, 700])
def test_any_tile_m_equals_untiled_plain_version(n_syms):
    cfg = HT.CNN
    x = torch.from_numpy(_x(cfg, n_syms, rows=2, seed=4))
    for name, (wrapped, plain) in _datapaths(cfg, _folded_np(cfg, 3)).items():
        want = plain(x)
        assert want.shape == (2, (n_syms * 2 // 16) * 8)
        for tile_m in (1, 16, 64, 256):
            got = wrapped(x, tile_m)
            assert torch.equal(got, want), (name, tile_m)


def test_stacked_equals_solo_bitwise():
    cfg = HT.CNN
    st = _strides(cfg)
    fmts = (INT8_FMT,) * cfg.layers
    ws = [_tw(_folded_np(cfg, s)) for s in (5, 6, 7)]
    x = torch.from_numpy(_x(cfg, 300, rows=3, seed=5))

    def stack(per):
        return tuple((torch.stack([p[l][0] for p in per]),
                      torch.stack([p[l][1] for p in per]))
                     for l in range(cfg.layers))
    bws = [tkern.cast_weights_bf16(w) for w in ws]
    qws = [tkern.quantize_weights_int8(w, fmts) for w in ws]
    runs = [(lambda xx, w: tkern.cnn_eq_fused(xx, w, st, 32), ws),
            (lambda xx, w: tkern.cnn_eq_fused_bf16(xx, w, st, 32), bws),
            (lambda xx, w: tkern.cnn_eq_fused_int8(xx, w, st, fmts, 32), qws)]
    for fn, per in runs:
        batched = fn(x, stack(per))
        for i in range(3):
            assert torch.equal(batched[i:i + 1], fn(x[i:i + 1], per[i]))


def test_int8_rejects_formats_wider_than_8_bits():
    cfg = HT.CNN
    st = _strides(cfg)
    w = _tw(_folded_np(cfg, 0))
    x = torch.zeros((1, 64))
    q = tkern.quantize_weights_int8(w, (INT8_FMT,) * 3)
    for bad in [(3, 5, 3, 4), (2, 5, 3, 5), ((2, 2, 2, 2, 2),
                                             (5, 5, 6, 5, 5), 3, 4)]:
        with pytest.raises(ValueError, match="does not fit int8"):
            tkern.cnn_eq_fused_int8(x, q, st, (bad,) + (INT8_FMT,) * 2)
    with pytest.raises(ValueError, match="bits > int8"):
        tkern.quantize_weights_int8(w, ((3, 5, 3, 4),) * 3)
    with pytest.raises(ValueError, match="2 formats for 3 layers"):
        tkern.cnn_eq_fused_int8(x, q, st, (INT8_FMT,) * 2)


def test_wrappers_check_their_inputs():
    cfg = HT.CNN
    st = _strides(cfg)
    w = _tw(_folded_np(cfg, 0))
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="float32"):
        tkern.cnn_eq_fused(x.double(), w, st)
    with pytest.raises(ValueError, match="float32 biases|weights"):
        tkern.cnn_eq_fused(x, tkern.cast_weights_bf16(w), st)
    stacked = tuple((wi[None].repeat(3, 1, 1, 1), bi[None].repeat(3, 1))
                    for wi, bi in w)
    with pytest.raises(ValueError, match="stacked weights carry 3 rows"):
        tkern.cnn_eq_fused(x, stacked, st)
    noncontig = ((w[0][0].transpose(0, 2).contiguous().transpose(0, 2),
                  w[0][1]),) + w[1:]
    with pytest.raises(ValueError, match="contiguous"):
        tkern.cnn_eq_fused(x, noncontig, st)
    with pytest.raises(ValueError, match="one stride per layer"):
        tkern.cnn_eq_fused(x, w, st[:2])
    with pytest.raises(ValueError, match="at most 65535 rows"):
        tkern.cnn_eq_fused(torch.zeros((65536, 16)), w, st)
    assert tkern.cnn_eq_fused(torch.zeros((2, 15)), w, st).shape == (2, 0)


def test_host_helpers_match_reference():
    cfg = CFG4
    kernels = [cfg.kernel] * cfg.layers
    st = _strides(cfg)
    for tile_m in (1, 16, 100):
        assert tkern._layer_spans(tile_m, kernels, st) == \
            jkern._layer_spans(tile_m, kernels, st)
    assert tref.receptive_halo(kernels, st) == jref.receptive_halo(kernels,
                                                                   st)
    x = _x(cfg, 50)
    xp_j, n_j = jref._halo_pad(jnp.asarray(x), kernels, st)
    xp_t, n_t = tref._halo_pad(torch.from_numpy(x), kernels, st)
    assert n_j == n_t
    np.testing.assert_array_equal(xp_t.numpy(), np.asarray(xp_j))


def test_equalize_matches_reference():
    cfg = HT.CNN
    params = jeq.init(jax.random.PRNGKey(9), cfg)
    state = jeq.init_bn_state(cfg)
    x = _x(cfg, 200, seed=9)
    want = np.asarray(jops.equalize(params, state, jnp.asarray(x), cfg,
                                    use_pallas=False))
    tp = interop.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    ts = interop.to_torch(jax.tree.map(np.asarray, state), device="cpu")
    for use_kernel in (True, False):
        got = tops.equalize(tp, ts, torch.from_numpy(x), teq.CNNEqConfig(),
                            use_kernel=use_kernel, tile_m=32, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the plan: which kernel a call runs on the card (cnn_eq._plan, mirrored by
# csrc/cnn_eq.cu's cnn_eq_plan, which the card tests hold it to)
# ---------------------------------------------------------------------------

def _plan_dims(cfg):
    return tuple((cfg.kernel, c_in, c_out, s)
                 for c_in, c_out, s in cfg.layer_specs())


@pytest.mark.parametrize("mode", [tkern.MODE_FP32, tkern.MODE_BF16,
                                  tkern.MODE_INT8])
@pytest.mark.parametrize("cfg_name", ["equalizer_ht", "equalizer_lp"])
def test_plan_takes_register_blocked_kernel_at_paper_widths(mode, cfg_name):
    from repro_torch.configs import equalizer_ht, equalizer_lp
    cfg = {"equalizer_ht": equalizer_ht,
           "equalizer_lp": equalizer_lp}[cfg_name].CNN
    assert tkern._plan(mode, _plan_dims(cfg)) == "rb"
    w = _tw(_folded_np(cfg, 0))
    assert not tkern.takes_tile_m(mode, w, _strides(cfg))


@pytest.mark.parametrize("mode,cfg", [
    (tkern.MODE_FP32, jeq.CNNEqConfig(kernel=7)),            # other K
    (tkern.MODE_BF16, jeq.CNNEqConfig(kernel=7)),            # other K
    (tkern.MODE_INT8, jeq.CNNEqConfig(channels=4)),          # other C
    (tkern.MODE_BF16, jeq.CNNEqConfig(v_parallel=4)),        # other V_p
    (tkern.MODE_INT8, jeq.CNNEqConfig(n_os=4)),              # other N_os
    (tkern.MODE_BF16, jeq.CNNEqConfig(layers=2)),            # L = 2
    (tkern.MODE_INT8, jeq.CNNEqConfig(layers=4)),            # L = 4
    (tkern.MODE_BF16, CFG4),
])
def test_plan_takes_generic_kernel_elsewhere(mode, cfg):
    assert tkern._plan(mode, _plan_dims(cfg)) == "generic"
    w = _tw(_folded_np(cfg, 0))
    assert tkern.takes_tile_m(mode, w, _strides(cfg))


def test_forced_launch_refuses_a_host_tensor():
    cfg = HT.CNN
    w = _tw(_folded_np(cfg, 0))
    x = torch.zeros((1, 256))
    for instance in ("rb", "generic"):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            tkern._forced(instance, tkern.MODE_BF16, x, w, _strides(cfg))

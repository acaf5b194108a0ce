"""Port vs reference: channels, data and optimizer (repro_torch.channels,
repro_torch.data, repro_torch.optim).

The two frameworks draw different random numbers, so each channel's draws
are made once, with JAX's own keys as `simulate` splits them, and handed to
the port's deterministic `_propagate`. It must reproduce `simulate` within
atol=1e-4: the slack covers FFT rounding (complex64 through two pocketfft
builds) after the normalization to unit variance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels import common as jcommon
from repro.channels import imdd as jimdd
from repro.channels import proakis as jproakis
from repro.optim import AdamW as JAdamW
from repro.optim import schedule as jschedule
from repro_torch import interop
from repro_torch.channels import common as tcommon
from repro_torch.channels import imdd as timdd
from repro_torch.channels import proakis as tproakis
from repro_torch.data import equalizer_data as tdata
from repro_torch.optim import AdamState, AdamW
from repro_torch.optim import schedule as tschedule

CH_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _imdd_draws(key, cfg, n_syms):
    """The arrays `repro.channels.imdd.simulate` draws, split as it splits."""
    kbits, knoise = jax.random.split(key)
    syms = jax.random.randint(kbits, (n_syms,), 0, cfg.levels)
    knoise, kase = jax.random.split(knoise)
    shape = (n_syms * cfg.sim_os,)
    ase_re = jax.random.normal(kase, shape)
    ase_im = jax.random.normal(jax.random.fold_in(kase, 1), shape)
    noise = jax.random.normal(knoise, shape, jnp.float32)
    return syms, ase_re, ase_im, noise


@pytest.mark.parametrize("cfg", [
    jimdd.IMDDConfig(),
    jimdd.IMDDConfig(fiber_km=10.0, snr_db=25.0, osnr_db=20.0, rrc_taps=65),
], ids=["default", "short_fiber"])
def test_imdd_propagate_reproduces_simulate(cfg):
    n_syms = 300
    key = jax.random.PRNGKey(3)
    want_rx, want_syms = jimdd.simulate(key, cfg, n_syms)
    syms, ase_re, ase_im, noise = _imdd_draws(key, cfg, n_syms)
    np.testing.assert_array_equal(np.asarray(syms), np.asarray(want_syms))
    tcfg = timdd.IMDDConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})
    got = timdd._propagate(_t(syms), _t(ase_re), _t(ase_im), _t(noise), tcfg)
    assert got.shape == (n_syms * cfg.n_os,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_rx), rtol=0,
                               atol=CH_ATOL)
    # batched: each row is its own frame (own normalization and SNRs); a
    # batched FFT and conv round differently from single-row ones
    both = timdd._propagate(*(torch.stack([_t(a), torch.flip(_t(a), (0,))])
                              for a in (syms, ase_re, ase_im, noise)), tcfg)
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), rtol=0,
                               atol=1e-5)


def test_proakis_propagate_reproduces_simulate():
    cfg = jproakis.ProakisConfig()
    n_syms = 400
    key = jax.random.PRNGKey(5)
    want_rx, want_syms = jproakis.simulate(key, cfg, n_syms)
    kbits, knoise = jax.random.split(key)
    syms = jax.random.randint(kbits, (n_syms,), 0, cfg.levels)
    noise = jax.random.normal(knoise, (n_syms * cfg.n_os,), jnp.float32)
    np.testing.assert_array_equal(np.asarray(syms), np.asarray(want_syms))
    got = tproakis._propagate(_t(syms), _t(noise), tproakis.ProakisConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want_rx), rtol=0,
                               atol=CH_ATOL)


def test_fir_same_is_a_true_convolution():
    """Asymmetric taps: a missing flip (F.conv1d is a cross-correlation)
    would show here, where the repo's symmetric taps would hide it."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(97).astype(np.float32)
    for n_taps in (4, 5):
        taps = rng.standard_normal(n_taps).astype(np.float32)
        want = np.asarray(jcommon.fir_same(jnp.asarray(x), jnp.asarray(taps)))
        got = tcommon.fir_same(_t(x), _t(taps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        pad = n_taps // 2
        ref = np.convolve(np.pad(x, (pad, n_taps - 1 - pad)), taps, "valid")
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_symbol_mapping_taps_and_ber_match_reference():
    rng = np.random.default_rng(1)
    for levels in (2, 4):
        np.testing.assert_array_equal(
            tcommon.pam_constellation(levels, "cpu").numpy(),
            np.asarray(jcommon.pam_constellation(levels)))
        bits = rng.integers(0, levels, 50)
        np.testing.assert_array_equal(
            tcommon.bits_to_pam(_t(bits), levels).numpy(),
            np.asarray(jcommon.bits_to_pam(jnp.asarray(bits), levels)))
        y = rng.standard_normal((3, 40)).astype(np.float32) * 1.5
        np.testing.assert_array_equal(
            tcommon.pam_decision(_t(y), levels).numpy(),
            np.asarray(jcommon.pam_decision(jnp.asarray(y), levels)))
        true = rng.integers(0, levels, (3, 40))
        assert float(tcommon.ber_from_soft(_t(y), _t(true), levels)) == \
            pytest.approx(float(jcommon.ber_from_soft(jnp.asarray(y),
                                                      jnp.asarray(true),
                                                      levels)))
    np.testing.assert_array_equal(tcommon.rrc_taps(129, 0.2, 4),
                                  jcommon.rrc_taps(129, 0.2, 4))
    np.testing.assert_array_equal(tcommon.rc_taps(65, 0.3, 2),
                                  jcommon.rc_taps(65, 0.3, 2))
    up = tcommon.upsample(_t(np.arange(1, 4, dtype=np.float32)), 3)
    np.testing.assert_array_equal(
        up.numpy(), np.asarray(jcommon.upsample(jnp.arange(1.0, 4.0), 3)))


@pytest.mark.parametrize("kind", ["imdd", "proakis"])
def test_frames_draw_a_batch_in_one_call(kind):
    fn = tdata.channel_fn(kind, device="cpu")
    rx, syms = tdata.frames(torch.Generator().manual_seed(0), fn, 4, 128)
    assert rx.shape == (4, 256) and syms.shape == (4, 128)
    assert rx.dtype == torch.float32 and syms.dtype == torch.int64
    assert bool(torch.isfinite(rx).all())
    # each row is normalized on its own and carries its own symbols
    np.testing.assert_allclose(rx.mean(-1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(rx.std(-1, correction=0).numpy(), 1.0,
                               atol=1e-4)
    assert not torch.equal(syms[0], syms[1])
    # the same seed draws the same frames; the stream keeps drawing
    again, _ = tdata.frames(torch.Generator().manual_seed(0), fn, 4, 128)
    assert torch.equal(rx, again)
    it = tdata.stream(torch.Generator().manual_seed(0), kind, 2, 64,
                      device="cpu")
    a, b = next(it), next(it)
    assert a[0].shape == (2, 128) and not torch.equal(a[0], b[0])


# ---------------------------------------------------------------------------
# AdamW and schedules
# ---------------------------------------------------------------------------

def _np_tree(rng):
    return {"conv": [{"w": rng.standard_normal((3, 2, 5)).astype(np.float32),
                      "b": rng.standard_normal(3).astype(np.float32)}],
            "w0": np.float32(0.3)}


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(2)
    params, g1, g2 = _np_tree(rng), _np_tree(rng), _np_tree(rng)
    jopt = JAdamW(lr=1e-2, weight_decay=0.01, grad_clip_norm=clip)
    topt = AdamW(lr=1e-2, weight_decay=0.01, grad_clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = interop.to_torch(params, device="cpu")
    ts = topt.init(tp)
    for g in (g1, g2):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(interop.to_torch(g, device="cpu"), ts, tp)
    assert isinstance(ts, AdamState) and int(ts.step) == 2
    for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        jax.tree.map(lambda w, t: np.testing.assert_allclose(
            t, np.asarray(w), rtol=1e-6, atol=1e-7),
            jax.tree.map(np.asarray, want), interop.to_numpy(got))


def test_adam_state_crosses_interop_both_ways():
    rng = np.random.default_rng(3)
    params = jax.tree.map(jnp.asarray, _np_tree(rng))
    jopt = JAdamW(lr=1e-3)
    _, js = jopt.update(jax.tree.map(jnp.ones_like, params),
                        jopt.init(params), params)
    carried = interop.to_torch(jax.tree.map(np.asarray, js), device="cpu")
    assert type(carried) is type(js)              # NamedTuple kept
    ts = AdamState(*carried)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    back = interop.to_numpy(ts)
    assert type(back) is AdamState
    js_again = type(js)(*back)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 js, js_again)


def test_schedules_match_reference():
    for step in (0, 1, 5, 10, 40, 100, 130):
        s_j, s_t = jnp.asarray(step, jnp.int32), torch.tensor(step)
        for jf, tf in (
                (jschedule.constant(3e-3), tschedule.constant(3e-3)),
                (jschedule.warmup_cosine(1e-2, 10, 100),
                 tschedule.warmup_cosine(1e-2, 10, 100)),
                (jschedule.linear_decay(1e-2, 100, 0.1),
                 tschedule.linear_decay(1e-2, 100, 0.1))):
            np.testing.assert_allclose(float(tf(s_t)), float(jf(s_j)),
                                       rtol=1e-6)

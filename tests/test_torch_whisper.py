"""Port vs reference: the encoder-decoder family (repro_torch.models.whisper,
common.sinusoidal_positions, attention.cross_attention, the registry's
encdec branch, data.lm_batches' frames, launch.steps and launch.serve) on
the CPU.

Inputs are drawn once with numpy and handed to both packages; the model's
weights are JAX's `init(PRNGKey(0), REDUCED)`, carried across through
`interop`. Held, in f32:

  * `sinusoidal_positions` at (1500, 1280), (448, 1280) and (30, 64)
    within 1e-6 of the reference's table (the port takes the reference's
    f32 denominators exactly; measured within 1 f32 ulp, 6e-8);
  * `cross_attention` with and without precomputed K/V, and `encode`, at
    rtol 1e-5 with atol 1e-5 · max|want|;
  * whisper-reduced at the LM bound (rtol 1e-4, atol 1e-4 · max|want|):
    prefill's last logits and all four state leaves (k, v, xk, xv), and
    teacher-forced decode steps past the cache width (the position table's
    clamp), each step's logits and the final state; the loss (rtol 1e-5)
    and every leaf's gradient within 1e-3 · max|leaf| of jax.grad of the
    reference's loss_fn; remat == no remat bitwise; fused decoder
    attention (the flash kernels' plain versions here) against the plain
    path within 1e-3 · max|leaf|; three steps of
    `launch.steps.build_train_step` against the reference's jitted step;
  * `lm_batches`: the reference's tokens bitwise, zero frames of shape
    (accum, mb, enc_len, d_model) in the param dtype;
  * the serving CLI and `launch.train.run` on the host.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro.models import whisper as jw
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import PipelineConfig, lm_batches
from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import registry as treg
from repro_torch.models import whisper as tw

KEY = jax.random.PRNGKey(0)
ARCH = "whisper-large-v3"
B, S, STEPS = 2, 10, 4
MAX_LEN = S + 2        # decode steps 2 and 3 run past the cache width


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel, what=""):
    """rtol rel, atol rel · max|want|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _tree_close(got, want, rel, what=""):
    g, w = _leaves(got), _leaves(_np(want))
    assert g.keys() == w.keys(), (what, g.keys() ^ w.keys())
    for path in w:
        assert tuple(g[path].shape) == np.shape(w[path]), path
        _close(g[path], w[path], rel, f"{what}{path}")


@functools.lru_cache(maxsize=None)
def _jax_params():
    return _np(jreg.build(jconfigs.get_config(ARCH, True)).init(KEY))


def _inputs():
    """Tokens (B, S + STEPS) and frames (B, enc_len, d) ~ 0.1·N, as the
    reference's tests/test_models.py draws them."""
    cfg = jconfigs.get_config(ARCH, True)
    toks = np.asarray(jax.random.randint(KEY, (B, S + STEPS), 0, cfg.vocab),
                      np.int64)
    frames = (0.1 * np.random.default_rng(1).standard_normal(
        (B, cfg.enc_len, cfg.d_model))).astype(np.float32)
    return toks, frames


# ---------------------------------------------------------------------------
# op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(1500, 1280), (448, 1280), (30, 64)])
def test_sinusoidal_positions_match_reference_table(n, d):
    got = tcommon.sinusoidal_positions(n, d, "cpu")
    want = np.asarray(jcommon.sinusoidal_positions(n, d))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_reference(cached):
    """Decoder layer 1's cross-attention over encoder states: K/V from the
    encoder output, or handed in precomputed (then enc_out is unused)."""
    jcfg, tcfg = (jconfigs.get_config(ARCH, True),
                  tconfigs.get_config(ARCH, True))
    jp = jax.tree.map(lambda a: a[1], _jax_params()["dec_layers"]["xattn"])
    tp = interop.to_torch(jp, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 7, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, tcfg.enc_len, tcfg.d_model)).astype(
        np.float32)
    jo, (jk, jv) = jattn.cross_attention(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(enc),
        jcfg)
    kv = (jk, jv) if cached else None
    to, (tk, tv) = tattn.cross_attention(
        tp, _t(x), None if cached else _t(enc), tcfg,
        cached_kv=None if kv is None else (_t(jk), _t(jv)))
    _close(to, jo, 1e-5, "out")
    _close(tk, jk, 1e-5, "k")
    _close(tv, jv, 1e-5, "v")


def test_encode_matches_reference():
    _, frames = _inputs()
    want = jax.jit(jw.encode, static_argnums=2)(
        jax.tree.map(jnp.asarray, _jax_params()), jnp.asarray(frames),
        jconfigs.get_config(ARCH, True))
    got = tw.encode(interop.to_torch(_jax_params(), "cpu"), _t(frames),
                    tconfigs.get_config(ARCH, True))
    _close(got, want, 1e-5, "encoder output")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_past_the_cache_width_match_reference(fused):
    """Prefill of S tokens over the frames, then STEPS teacher-forced
    decode steps at positions S .. S + 3 in a cache of S + 2 (the last two
    wrap the ring and clamp the position table): each step's logits, and
    all four state leaves after the prefill and after the last step."""
    jm = jreg.build(jconfigs.get_config(ARCH, True, fused_attention=fused))
    tm = treg.build(tconfigs.get_config(ARCH, True, fused_attention=fused))
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tp = interop.to_torch(_jax_params(), "cpu")
    toks, frames = _inputs()
    jl, jst = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32),
             "enc_embed": jnp.asarray(frames)},
        jm.init_serve_state(B, MAX_LEN))
    tl, tst = tm.prefill(tp, {"tokens": _t(toks[:, :S]),
                              "enc_embed": _t(frames)},
                         tm.init_serve_state(B, MAX_LEN, "cpu"))
    _close(tl, jl, 1e-4, "prefill logits")
    _tree_close(tst, jst, 1e-4, "prefill state")
    jdecode = jax.jit(jm.decode)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int64)[:, None]
        jl, jst = jdecode(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(S + i, jnp.int32), jst)
        tl, tst = tm.decode(tp, _t(tok), S + i, tst)
        _close(tl, jl, 1e-4, f"decode step {i} (position {S + i})")
    _tree_close(tst, jst, 1e-4, "decode state")


def test_decode_matches_prefill_within_the_port():
    """The reference's consistency check in the port alone, flash path:
    prefill(s) + one decode step == prefill(s + 1) at 2e-3."""
    m = treg.build(tconfigs.get_config(ARCH, True, fused_attention=True))
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    toks, frames = map(_t, _inputs())
    _, st = m.prefill(p, {"tokens": toks[:, :S], "enc_embed": frames},
                      m.init_serve_state(B, 48, "cpu"))
    lg_dec, _ = m.decode(p, toks[:, S:S + 1], S, st)
    lg_full, _ = m.prefill(p, {"tokens": toks[:, :S + 1],
                               "enc_embed": frames},
                           m.init_serve_state(B, 48, "cpu"))
    assert float((lg_dec - lg_full).abs().max()) < 2e-3


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """jax.value_and_grad of the reference's reduced whisper loss,
    computed once a module."""
    jm = jreg.build(jconfigs.get_config(ARCH, True))
    toks, frames = _inputs()
    t = jnp.asarray(toks, jnp.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss_fn,
                                                  has_aux=True))(
        jax.tree.map(jnp.asarray, _jax_params()),
        {"tokens": t, "labels": t, "enc_embed": jnp.asarray(frames)})
    return float(loss), _np(grads)


def _port_loss_and_grads(**overrides):
    tm = treg.build(tconfigs.get_config(ARCH, True, **overrides))
    params = interop.to_torch(_jax_params(), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks, frames = map(_t, _inputs())
    loss, _ = tm.loss_fn(tree_unflatten(params, leaves),
                         {"tokens": toks, "labels": toks,
                          "enc_embed": frames})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def test_loss_and_every_gradient_match_jax_grad(jax_loss_and_grads):
    """The loss (rtol 1e-5) and every leaf's gradient, the encoder's and
    the cross-attention's too, within 1e-3 · max|leaf| of jax.grad."""
    jloss, jgrads = jax_loss_and_grads
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _tree_close(grads, jgrads, 1e-3, "grad ")
    g = _leaves(grads)
    for key in ("/enc_layers/attn/wq", "/dec_layers/xattn/wk",
                "/dec_layers/attn/wv", "/enc_norm"):
        assert float(g[key].abs().max()) > 0, key


def test_remat_leaves_loss_and_gradients_unchanged():
    a_loss, a = _port_loss_and_grads()
    b_loss, b = _port_loss_and_grads(remat=False)
    assert torch.equal(a_loss, b_loss)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_fused_attention_gradients_match_the_plain_path():
    a_loss, a = _port_loss_and_grads(fused_attention=True)
    b_loss, b = _port_loss_and_grads()
    np.testing.assert_allclose(float(a_loss), float(b_loss), rtol=1e-6)
    for (path, x), y in zip(_leaves(a).items(), tree_leaves(b)):
        _close(x, y.numpy(), 1e-3, path)


def test_three_train_steps_match_reference_jitted_step():
    """Three steps of `launch.steps.build_train_step` (accum 2, AdamW with
    grad_clip_norm 1.0, frames in the batch) from carried-over params and
    optimizer state after one reference step: loss at rtol 1e-5, params
    and both moments at the LM bound."""
    from repro.launch import steps as jsteps
    from repro.optim import AdamW as JAdamW
    from repro_torch.launch import steps as tsteps
    from repro_torch.optim import AdamW
    steps, lr = 3, 3e-4
    jm = jreg.build(jconfigs.get_config(ARCH, True))
    jopt = JAdamW(lr=lr, grad_clip_norm=1.0)
    jstep = jax.jit(jsteps.build_train_step(jm, jopt))
    jp = jax.tree.map(jnp.asarray, _jax_params())
    jo = jopt.init(jp)
    data = np.asarray(jax.random.randint(jax.random.PRNGKey(3),
                                         (steps + 1, 2, 2, 12), 0,
                                         jm.cfg.vocab), np.int32)
    frames = (0.1 * np.random.default_rng(4).standard_normal(
        (steps + 1, 2, 2, jm.cfg.enc_len, jm.cfg.d_model))).astype(
            np.float32)

    def jb(i):
        return {"tokens": jnp.asarray(data[i]), "labels": jnp.asarray(
            data[i]), "enc_embed": jnp.asarray(frames[i])}
    jp, jo, _ = jstep(jp, jo, jb(0))
    params = interop.to_torch(_np(jp), "cpu")
    opt_state = interop.adam_state_to_torch(_np(jo), "cpu")
    tstep = tsteps.build_train_step(
        treg.build(tconfigs.get_config(ARCH, True)),
        AdamW(lr=lr, grad_clip_norm=1.0))
    for i in range(1, steps + 1):
        jp, jo, jmet = jstep(jp, jo, jb(i))
        tb = _t(data[i]).long()
        params, opt_state, met = tstep(params, opt_state, {
            "tokens": tb, "labels": tb, "enc_embed": _t(frames[i])})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    for what, got, want in (("params", params, jp),
                            ("mu", opt_state.mu, jo.mu),
                            ("nu", opt_state.nu, jo.nu)):
        _tree_close(got, want, 1e-4, f"{what} ")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_batches_carry_the_reference_tokens_and_zero_frames(dtype):
    from jax.sharding import PartitionSpec as P
    from repro.data.pipeline import PipelineConfig as JPipelineConfig
    from repro.data.pipeline import lm_batches as jlm_batches
    from repro.launch.mesh import make_mesh
    tcfg = tconfigs.get_config(ARCH, True, dtype=dtype)
    pipe = PipelineConfig(seq_len=16, global_batch=6, accum=2, seed=4)
    mesh = make_mesh((1, 1), ("data", "model"))
    spec = {"tokens": P(None, ("data",), None),
            "enc_embed": P(None, ("data",), None, None)}
    jit_ = jlm_batches(JPipelineConfig(**dataclasses.asdict(pipe)),
                       jconfigs.get_config(ARCH, True, dtype=dtype), mesh,
                       spec, start_step=1)
    it = lm_batches(pipe, tcfg, "cpu", start_step=1)
    for _ in range(2):
        want, got = next(jit_), next(it)
        assert set(got) == set(want) == {"tokens", "labels", "enc_embed"}
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        e = got["enc_embed"]
        assert e.shape == (2, 3, tcfg.enc_len, tcfg.d_model) == \
            want["enc_embed"].shape
        assert e.dtype == tcfg.param_dtype() and not bool(e.any())


# ---------------------------------------------------------------------------
# the entry points on the host
# ---------------------------------------------------------------------------

def test_serve_main_on_the_cpu_returns_zero():
    assert tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len",
                        "12", "--gen", "3", "--device", "cpu"]) == 0


def test_train_run_trains_the_encdec_family(tmp_path):
    """`launch.train.run` on whisper-reduced (lm_batches' frames in every
    batch): finite losses, the optimizer stepped."""
    out = ttrain.run(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--accum", "2",
                      "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert int(out["final"][1].step) == 2

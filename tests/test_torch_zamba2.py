"""Port vs reference: the hybrid family (repro_torch.models.mamba2, zamba2,
the registry's hybrid branch, launch.steps and launch.serve) on the CPU.

Inputs are drawn once with numpy and handed to both packages; the model's
weights are JAX's `init(PRNGKey(0), REDUCED)`, carried across through
`interop`. Held, in f32:

  * mamba2 op by op — `ssd_chunked`'s y and final state for S ∈ {1, 16,
    37, 64} at chunk 16 (one step, one chunk, a padded tail, several
    chunks), with and without a carried state; `_causal_conv` with and
    without its state; `apply` in its three modes (training, prefill from
    a state, one decode step) with the states it returns — at rtol 1e-5
    with atol 1e-5 · max|want|: the same f32 operations summed in each
    backend's order;
  * a backward through `ssd_chunked` over full chunks: finite (the
    mask-before-exp guard), and within 1e-3 · max|leaf| of jax.grad;
  * zamba2-reduced: the training forward's logits and the prefill and
    teacher-forced decode logits at the LM bound (rtol 1e-4, atol
    1e-4 · max|want|), prefill's and decode's states leaf for leaf; the
    loss (rtol 1e-5) and the gradient of every leaf, the shared block's
    too, within 1e-3 · max|leaf| of jax.grad of the reference's loss_fn;
    remat == no remat bitwise; fused attention (the flash kernels' plain
    versions here) against the plain path within 1e-3 · max|leaf|;
    `attn_points` of both configs; three steps of
    `launch.steps.build_train_step` against the reference's jitted step;
  * the serving CLI and `launch.train.run` on the host.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba2 as jm2
from repro.models import registry as jreg
from repro.models import zamba2 as jz
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba2 as tm2
from repro_torch.models import registry as treg
from repro_torch.models import zamba2 as tz

KEY = jax.random.PRNGKey(0)
ARCH = "zamba2-1.2b"
B, S, STEPS, MAX_LEN = 2, 24, 4, 40


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
    """{path: leaf} over dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _leaves(x, f"{prefix}/{i}").items()}
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


def _tokens(vocab: int, shape=(B, S + STEPS)) -> np.ndarray:
    return np.asarray(jax.random.randint(KEY, shape, 0, vocab), np.int64)


# ---------------------------------------------------------------------------
# mamba2, op by op
# ---------------------------------------------------------------------------

def _ssd_inputs(s, seed, b=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bb, cc, st


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "carried_state"])
@pytest.mark.parametrize("s", [1, 16, 37, 64])
def test_ssd_chunked_matches_reference(s, with_state):
    x, dt, a, b, c, st = _ssd_inputs(s, s)
    init = st if with_state else None
    jy, jst = jm2.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), 16,
                              None if init is None else jnp.asarray(init))
    ty, tst = tm2.ssd_chunked(*map(_t, (x, dt, a, b, c)), 16,
                              None if init is None else _t(init))
    assert ty.shape == (2, s, 3, 4) and tst.shape == (2, 3, 4, 5)
    _close(ty, jy, 1e-5, "y")
    _close(tst, jst, 1e-5, "final state")


def test_ssd_backward_over_full_chunks_is_finite_and_matches_jax_grad():
    """Two full chunks: the j > i region of every chunk's decay matrix has
    li > 0 and overflows exp; masking before exp keeps the gradient
    finite. Gradients of x, dt, A, B, C and the initial state within
    1e-3 · max|leaf| of jax.grad."""
    x, dt, a, b, c, st = _ssd_inputs(32, 7)
    rng = np.random.default_rng(8)
    wy = rng.standard_normal((2, 32, 3, 4)).astype(np.float32)
    ws = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)

    def jloss(*args):
        y, fin = jm2.ssd_chunked(*args[:5], 16, args[5])
        return jnp.sum(y * wy) + jnp.sum(fin * ws)
    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (x, dt, a, b, c, st)))
    leaves = [_t(v).requires_grad_(True) for v in (x, dt, a, b, c, st)]
    y, fin = tm2.ssd_chunked(*leaves[:5], 16, leaves[5])
    tg = torch.autograd.grad((y * _t(wy)).sum() + (fin * _t(ws)).sum(),
                             leaves)
    for name, got, want in zip(("x", "dt", "A", "B", "C", "state"), tg, jg):
        assert bool(torch.isfinite(got).all()), name
        _close(got, want, 1e-3, name)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    st = rng.standard_normal((2, 3, 10)).astype(np.float32)
    jo, jst = jm2._causal_conv(*map(jnp.asarray, (x, w, bias)),
                               jnp.asarray(st) if with_state else None)
    to, tst = tm2._causal_conv(*map(_t, (x, w, bias)),
                               _t(st) if with_state else None)
    _close(to, jo, 1e-5, "out")
    _close(tst, jst, 1e-5, "state")


def _mamba_state(seed):
    cfg = tconfigs.get_config(ARCH, True)
    _, nh, p, conv_dim = tm2.dims(cfg)
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((B, cfg.d_conv - 1, conv_dim))
            .astype(np.float32),
            "ssm": rng.standard_normal((B, nh, p, cfg.ssm_state))
            .astype(np.float32)}


@pytest.mark.parametrize("mode,s", [("train", 21), ("prefill", 21),
                                    ("decode", 1)])
def test_mamba_apply_matches_reference(mode, s):
    """Layer 1's mamba block: training (no state), prefill of 21 tokens
    from a random state (the chunked scan), one decode step from a random
    state (the single-step recurrence); output and new state."""
    jcfg, tcfg = (jconfigs.get_config(ARCH, True),
                  tconfigs.get_config(ARCH, True))
    jp = jax.tree.map(lambda a: a[1], _jax_params()["layers"]["mamba"])
    tp = interop.to_torch(jp, "cpu")
    u = np.random.default_rng(4).standard_normal(
        (B, s, tcfg.d_model)).astype(np.float32)
    st = None if mode == "train" else _mamba_state(5)
    jo, jst = jax.jit(jm2.apply, static_argnums=2)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(u), jcfg,
        None if st is None else jax.tree.map(jnp.asarray, st))
    to, tst = tm2.apply(tp, _t(u), tcfg,
                        None if st is None else interop.to_torch(st, "cpu"))
    _close(to, jo, 1e-5, "out")
    if st is None:
        assert tst is None and jst is None
    else:
        _tree_close(tst, jst, 1e-5, "state")


def test_mamba_init_and_state_match_reference_leaves():
    """The init tree (keys, shapes, types, the deterministic leaves) and
    `init_state`'s types: conv in the param dtype, ssm in f32."""
    cfg = tconfigs.get_config(ARCH, True, dtype="bfloat16")
    own = tm2.init(torch.Generator().manual_seed(0), cfg, "cpu")
    ref = _np(jm2.init(KEY, jconfigs.get_config(ARCH, True,
                                                dtype="bfloat16")))
    assert own.keys() == ref.keys()
    for k in ref:
        assert tuple(own[k].shape) == ref[k].shape, k
        assert str(own[k].dtype).replace("torch.", "") == str(ref[k].dtype)
    for k in ("A_log", "dt_bias", "D", "conv_b", "ssm_norm"):
        _close(own[k], ref[k].astype(np.float32), 1e-6, k)
    st = tm2.init_state(cfg, 3, "cpu")
    assert (st["conv"].dtype, st["ssm"].dtype) == (torch.bfloat16,
                                                   torch.float32)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_attn_points_equal_reference(reduced):
    t = tconfigs.get_config(ARCH, reduced)
    assert tz.attn_points(t) == jz.attn_points(
        jconfigs.get_config(ARCH, reduced))
    assert tz.attn_points(tconfigs.get_config(ARCH)) == [5, 11, 17, 23, 29,
                                                         35]


def test_forward_logits_match_reference():
    toks = _tokens(512)[:, :S]
    jl = jax.jit(jz.forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, _jax_params()),
                    jnp.asarray(toks, jnp.int32),
                    jconfigs.get_config(ARCH, True))
    tl = tz.forward(interop.to_torch(_jax_params(), "cpu"), _t(toks),
                    tconfigs.get_config(ARCH, True))
    _close(tl, jl, 1e-4, "logits")


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_match_reference_with_states(fused):
    """Prefill of S tokens, then STEPS teacher-forced decode steps (JAX's
    greedy tokens fed to both): logits at the LM bound, and after the
    prefill and after the last step every state leaf (the mamba layers'
    conv and ssm, the shared block's ring caches)."""
    jm = jreg.build(jconfigs.get_config(ARCH, True, fused_attention=fused))
    tm = treg.build(tconfigs.get_config(ARCH, True, fused_attention=fused))
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tp = interop.to_torch(_jax_params(), "cpu")
    toks = _tokens(512)[:, :S]
    jdecode = jax.jit(jm.decode)
    jl, jst = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jm.init_serve_state(B, MAX_LEN))
    tl, tst = tm.prefill(tp, {"tokens": _t(toks)},
                         tm.init_serve_state(B, MAX_LEN, "cpu"))
    _close(tl, jl, 1e-4, "prefill logits")
    _tree_close(tst, jst, 1e-4, "prefill state")
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int64)[:, None]
        jl, jst = jdecode(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(S + i, jnp.int32), jst)
        tl, tst = tm.decode(tp, _t(tok), S + i, tst)
        _close(tl, jl, 1e-4, f"decode step {i}")
    _tree_close(tst, jst, 1e-4, "decode state")


def test_decode_matches_prefill_within_the_port():
    """The reference's consistency check, in the port alone, with the
    flash path: prefill(s) + one decode step == prefill(s + 1) at 2e-3."""
    m = treg.build(tconfigs.get_config(ARCH, True, fused_attention=True))
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(512)[:, :S + 1])
    _, st = m.prefill(p, {"tokens": toks[:, :S]},
                      m.init_serve_state(B, MAX_LEN, "cpu"))
    lg_dec, _ = m.decode(p, toks[:, S:S + 1], S, st)
    lg_full, _ = m.prefill(p, {"tokens": toks},
                           m.init_serve_state(B, MAX_LEN, "cpu"))
    assert float((lg_dec - lg_full).abs().max()) < 2e-3


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """jax.value_and_grad of the reference's reduced zamba2 loss, computed
    once a module."""
    jm = jreg.build(jconfigs.get_config(ARCH, True))
    toks = jnp.asarray(_tokens(512)[:, :S], jnp.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, _jax_params()),
        {"tokens": toks, "labels": toks})
    return float(loss), _np(grads)


def _port_loss_and_grads(**overrides):
    tm = treg.build(tconfigs.get_config(ARCH, True, **overrides))
    params = interop.to_torch(_jax_params(), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = _t(_tokens(512)[:, :S])
    loss, _ = tm.loss_fn(tree_unflatten(params, leaves),
                         {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def test_loss_and_every_gradient_match_jax_grad(jax_loss_and_grads):
    """The loss (rtol 1e-5) and every leaf's gradient within
    1e-3 · max|leaf| of jax.grad, through remat, the SSD chunk loop and
    the shared block at both of its application points; the shared
    block's and the mamba layers' gradients nonzero."""
    jloss, jgrads = jax_loss_and_grads
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _tree_close(grads, jgrads, 1e-3, "grad ")
    g = _leaves(grads)
    for key in ("/shared/attn/wq", "/shared/attn/wo", "/shared/mlp/w_up",
                "/layers/mamba/in_proj", "/layers/mamba/A_log"):
        assert float(g[key].abs().max()) > 0, key


def test_remat_leaves_loss_and_gradients_unchanged():
    a_loss, a = _port_loss_and_grads()
    b_loss, b = _port_loss_and_grads(remat=False)
    assert torch.equal(a_loss, b_loss)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_fused_attention_gradients_match_the_plain_path():
    """The shared block's attention through `_FusedCausal` (the flash
    kernels' plain versions on the host) against the chunked plain path:
    loss within 1e-6, every gradient within 1e-3 · max|leaf|."""
    a_loss, a = _port_loss_and_grads(fused_attention=True)
    b_loss, b = _port_loss_and_grads()
    np.testing.assert_allclose(float(a_loss), float(b_loss), rtol=1e-6)
    for (path, x), y in zip(_leaves(a).items(), tree_leaves(b)):
        _close(x, y.numpy(), 1e-3, path)


def test_three_train_steps_match_reference_jitted_step():
    """Three steps of `launch.steps.build_train_step` (accum 2, AdamW with
    grad_clip_norm 1.0) from carried-over params and optimizer state after
    one reference step: loss at rtol 1e-5, params and both moments at the
    LM bound."""
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
                                         (steps + 1, 2, 2, 20), 0,
                                         jm.cfg.vocab), np.int32)
    jp, jo, _ = jstep(jp, jo, {"tokens": jnp.asarray(data[0]),
                               "labels": jnp.asarray(data[0])})
    params = interop.to_torch(_np(jp), "cpu")
    opt_state = interop.adam_state_to_torch(_np(jo), "cpu")
    tstep = tsteps.build_train_step(
        treg.build(tconfigs.get_config(ARCH, True)),
        AdamW(lr=lr, grad_clip_norm=1.0))
    for i in range(1, steps + 1):
        jp, jo, jmet = jstep(jp, jo, {"tokens": jnp.asarray(data[i]),
                                      "labels": jnp.asarray(data[i])})
        tb = _t(data[i]).long()
        params, opt_state, met = tstep(params, opt_state,
                                       {"tokens": tb, "labels": tb})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    assert int(opt_state.step) == int(jo.step) == steps + 1
    for what, got, want in (("params", params, jp),
                            ("mu", opt_state.mu, jo.mu),
                            ("nu", opt_state.nu, jo.nu)):
        _tree_close(got, want, 1e-4, f"{what} ")


# ---------------------------------------------------------------------------
# the entry points on the host
# ---------------------------------------------------------------------------

def test_serve_main_on_the_cpu_returns_zero():
    assert tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len",
                        "12", "--gen", "3", "--device", "cpu"]) == 0


def test_train_run_trains_the_hybrid_family(tmp_path):
    """`launch.train.run` on zamba2-reduced: finite losses, the optimizer
    stepped, a checkpoint written."""
    out = ttrain.run(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--accum", "2",
                      "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert int(out["final"][1].step) == 2

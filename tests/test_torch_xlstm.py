"""Port vs reference: the xlstm serving path (repro_torch.models.xlstm, the
ssm family of the registry, launch.serve) on the CPU.

Inputs are drawn once with numpy and handed to both packages; the model's
weights are JAX's `xlstm.init(PRNGKey(0), REDUCED)`, carried across
through `interop` (bf16 through ml_dtypes where the tree is bf16). Held:

  * the cells and blocks op by op in f32 — `mlstm_chunked` with and
    without a carried state, at S a multiple of the chunk, not one, and
    below it; `mlstm_step`; `_conv_causal` with and without its state;
    both blocks' `apply` with and without a state — at rtol 1e-5 with
    atol 1e-5 · max|want|: the same f32 operations, einsums and matmuls
    summed in each backend's order (measured ≤ 7e-7 · max|want|);
  * the whole reduced model: prefill last-token logits and every returned
    state, 4 teacher-forced decode steps and `loss_fn`'s value, at the LM
    bound of tests/test_torch_lm.py (`_close`: rtol 1e-4, atol
    1e-4 · max|want|; measured ≤ 7e-7 · max|want|);
  * the init tree leaf for leaf (keys, shapes, types and the deterministic
    leaves);
  * the serving CLI on the host;
  * training: the reduced loss and every gradient against jax.grad of the
    reference's loss_fn within 1e-3 · max|leaf| (the dense family's
    gradient bound), slstm_r and slstm_w nonzero; remat == no remat
    bitwise; three train steps against the reference's jitted step (loss
    rtol 1e-5, params and moments at the LM bound); `launch.train`
    building and stepping the family (f32, bf16) and a CLI run that
    survives an injected failure bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.models import xlstm as jx
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as treg
from repro_torch.models import xlstm as tx

KEY = jax.random.PRNGKey(0)
ARCH = "xlstm-125m"
B, S, STEPS = 2, 24, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _op_close(got, want, what=""):
    """rtol 1e-5, atol 1e-5 · max|want| (the module docstring's bound)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


def _close(got, want, what=""):
    """rtol 1e-4, atol 1e-4 · max|want| (tests/test_torch_lm.py's bound)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=what)


def _leaves(tree, prefix=""):
    """{path: leaf} over dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _tree_close(got, want, close, what=""):
    g, w = _leaves(got), _leaves(_np(want))
    assert g.keys() == w.keys(), (what, g.keys() ^ w.keys())
    for path in w:
        close(g[path], w[path], f"{what}{path}")


# ---------------------------------------------------------------------------
# the cells and blocks, op by op
# ---------------------------------------------------------------------------

def _mlstm_inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 3.0).astype(np.float32)
    log_f = np.asarray(-jax.nn.softplus(-jnp.asarray(f_pre)))
    return q, k, v, log_i, log_f


def _mlstm_state(b, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d, d)).astype(np.float32),
            rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(48, 16), (37, 16), (10, 16)],
                         ids=["multiple", "padded", "below_chunk"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(s, chunk, with_state):
    q, k, v, li, lf = _mlstm_inputs(2, s, 4, 8, s)
    st = _mlstm_state(2, 4, 8, 1) if with_state else None
    want_h, want_st = jx.mlstm_chunked(
        *map(jnp.asarray, (q, k, v, li, lf)), chunk,
        None if st is None else tuple(map(jnp.asarray, st)))
    got_h, got_st = tx.mlstm_chunked(
        *map(_t, (q, k, v, li, lf)), chunk,
        None if st is None else tuple(map(_t, st)))
    assert got_h.shape == (2, s, 4, 8)
    _op_close(got_h, want_h, "h")
    for name, a, w in zip(("C", "n", "m"), got_st, want_st):
        _op_close(a, w, name)


def test_mlstm_step_matches_reference():
    q, k, v, li, lf = (a[:, 0] for a in _mlstm_inputs(2, 1, 4, 8, 2))
    st = _mlstm_state(2, 4, 8, 3)
    want_h, want_st = jx.mlstm_step(*map(jnp.asarray, (q, k, v, li, lf)),
                                    tuple(map(jnp.asarray, st)))
    got_h, got_st = tx.mlstm_step(*map(_t, (q, k, v, li, lf)),
                                  tuple(map(_t, st)))
    _op_close(got_h, want_h, "h")
    for name, a, w in zip(("C", "n", "m"), got_st, want_st):
        _op_close(a, w, name)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_causal_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = (rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state
          else None)
    want, want_st = jx._conv_causal(*map(jnp.asarray, (x, w, b)),
                                    None if st is None else jnp.asarray(st))
    got, got_st = tx._conv_causal(*map(_t, (x, w, b)),
                                  None if st is None else _t(st))
    _op_close(got, want, "y")
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype: str = "float32"):
    cfg = jconfigs.get_config(ARCH, reduced=True, dtype=dtype)
    return _np(jreg.build(cfg).init(KEY))


def _cfgs():
    return (jconfigs.get_config(ARCH, reduced=True),
            tconfigs.get_config(ARCH, reduced=True))


@pytest.mark.parametrize("kind,index", [("mlstm", 0), ("slstm", 1)])
@pytest.mark.parametrize("with_state", [False, True])
def test_block_apply_matches_reference(kind, index, with_state):
    """Block `index` of the carried-over reduced weights on a random
    stream, from no state and from a random nonzero state."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(jnp.asarray, _jax_params()["blocks"][index][kind])
    tp = interop.to_torch(_jax_params()["blocks"][index][kind], "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, 64)).astype(np.float32)
    jst = tst = None
    if with_state:
        init = (jx.mlstm_block_state if kind == "mlstm"
                else jx.slstm_block_state)(jcfg, 2)
        st = jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape))
                          .astype(np.float32), _np(init))
        if kind == "slstm":                      # n > 0, as a run leaves it
            c, n, h, m = st["cell"]
            st["cell"] = (c, np.abs(n) + 0.5, h, m)
        jst = jax.tree.map(jnp.asarray, st)
        tst = interop.to_torch(st, "cpu")
    apply_j = jx.mlstm_block_apply if kind == "mlstm" else \
        jx.slstm_block_apply
    apply_t = tx.mlstm_block_apply if kind == "mlstm" else \
        tx.slstm_block_apply
    want, want_st = apply_j(jp, jnp.asarray(x), jcfg, jst)
    got, got_st = apply_t(tp, _t(x), tcfg, tst)
    _op_close(got, want, "out")
    if with_state:
        _tree_close(got_st, want_st, _op_close, "state")
    else:
        assert got_st is None and want_st is None


# ---------------------------------------------------------------------------
# the whole model: weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_init_tree_carries_across_leaf_for_leaf(dtype):
    carried = _leaves(interop.to_torch(_jax_params(dtype), "cpu"))
    cfg = tconfigs.get_config(ARCH, reduced=True, dtype=dtype)
    own = _leaves(tx.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    assert carried.keys() == own.keys()
    for path, t in own.items():
        assert (carried[path].shape, carried[path].dtype) == (
            t.shape, t.dtype), path
    d, nh = cfg.d_model, cfg.n_heads
    for path, t in own.items():
        name = path.rsplit("/", 1)[-1]
        if name in ("norm", "skip", "gn", "ffn_norm", "mlstm_norm",
                    "final_norm"):
            want = torch.ones(t.shape, dtype=t.dtype)
        elif name == "conv_b":
            want = torch.zeros(t.shape, dtype=t.dtype)
        elif name == "if_bias":
            want = torch.tensor([0.0] * nh + [3.0, 4.0, 5.0, 6.0])
        elif name == "slstm_b":
            want = torch.tensor([0.0] * 2 * d + [1.0] * d + [0.0] * d)
        else:
            continue
        assert t.dtype == want.dtype and torch.equal(t, want), path
        assert torch.equal(carried[path], want), path
    assert own["/blocks/1/slstm/slstm_r"].shape == (4, nh, d // nh, d // nh)
    assert [k.split("/")[3] for k in own if k.endswith("/norm")] == [
        "mlstm", "slstm", "mlstm"]


def test_init_draws_with_the_reference_scales():
    """Each weight's spread is the reference's `dense_init` scale:
    1/sqrt(fan_in) with fan_in = shape[-2], 0.3 for slstm_r, 1 for embed."""
    cfg = tconfigs.get_config(ARCH, reduced=True)
    p = tx.init(torch.Generator().manual_seed(0), cfg, "cpu")
    sl, ml = p["blocks"][1]["slstm"], p["blocks"][0]["mlstm"]
    for t, scale in ((sl["slstm_r"], 0.3), (p["embed"], 1.0),
                     (sl["slstm_w"], 64 ** -0.5), (ml["conv_w"], 0.5),
                     (ml["mlstm_q"], 32 ** -0.5)):
        assert abs(float(t.std()) / scale - 1.0) < 0.15, (t.shape, scale)


def _tokens(vocab: int) -> np.ndarray:
    return np.asarray(jax.random.randint(KEY, (B, S + STEPS), 0, vocab),
                      np.int64)


def _both():
    jm = jreg.build(jconfigs.get_config(ARCH, True))
    tm = treg.build(tconfigs.get_config(ARCH, True))
    return (jm, jax.tree.map(jnp.asarray, _jax_params()), tm,
            interop.to_torch(_jax_params(), "cpu"))


def test_prefill_logits_and_states_match_reference():
    jm, jp, tm, tp = _both()
    toks = _tokens(jm.cfg.vocab)[:, :S]
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jm.init_serve_state(B, 48))
    tl, tst = tm.prefill(tp, {"tokens": _t(toks)},
                         tm.init_serve_state(B, 48, "cpu"))
    assert tl.shape == (B, jm.cfg.vocab_padded)
    _close(tl, jl, "logits")
    _tree_close(tst, jst, _close, "state")


def test_decode_teacher_forced_matches_reference():
    """STEPS greedy decode steps after the prefill, both packages fed JAX's
    greedy tokens, each step's logits and the final states compared."""
    jm, jp, tm, tp = _both()
    toks = _tokens(jm.cfg.vocab)[:, :S]
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jm.init_serve_state(B, 48))
    _, tst = tm.prefill(tp, {"tokens": _t(toks)},
                        tm.init_serve_state(B, 48, "cpu"))
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int64)[:, None]
        jl, jst = jm.decode(jp, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(S + i, jnp.int32), jst)
        tl, tst = tm.decode(tp, _t(tok), S + i, tst)
        _close(tl, jl, f"decode step {i}")
    _tree_close(tst, jst, _close, "state")


def test_loss_matches_reference():
    jm, jp, tm, tp = _both()
    toks = _tokens(jm.cfg.vocab)
    jloss, jaux = jm.loss_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                  "labels": jnp.asarray(toks, jnp.int32)})
    tloss, taux = tm.loss_fn(tp, {"tokens": _t(toks), "labels": _t(toks)})
    _close(tloss, jloss, "loss")
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    assert float(taux["ce"]) == float(tloss)


def test_decode_matches_prefill_within_the_port():
    """The reference's own consistency check (tests/test_models.py), in the
    port alone: prefill(s) + one decode step == prefill(s + 1) at 2e-3."""
    cfg = tconfigs.get_config(ARCH, True)
    m = treg.build(cfg)
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(cfg.vocab)[:, :S + 1])
    _, st = m.prefill(p, {"tokens": toks[:, :S]},
                      m.init_serve_state(B, 48, "cpu"))
    lg_dec, _ = m.decode(p, toks[:, S:S + 1], S, st)
    lg_full, _ = m.prefill(p, {"tokens": toks},
                           m.init_serve_state(B, 48, "cpu"))
    assert float((lg_dec - lg_full).abs().max()) < 2e-3


def test_bf16_reduced_model_serves_finite_logits():
    """The full config's dtype at reduced size: bf16 params and streams,
    f32 cell states."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH, True),
                              dtype="bfloat16")
    m = treg.build(cfg)
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    st = m.init_serve_state(B, 48, "cpu")
    assert st[0]["conv"].dtype == torch.bfloat16
    assert st[1]["cell"][0].dtype == torch.float32
    lg, st = m.prefill(p, {"tokens": _t(_tokens(cfg.vocab)[:, :S])}, st)
    lg, st = m.decode(p, lg.argmax(-1)[:, None], S, st)
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_main_on_the_cpu_returns_zero():
    assert tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len",
                        "12", "--gen", "3", "--device", "cpu"]) == 0


def test_serve_session_builds_seeded_xlstm_weights_and_states():
    cfg = tconfigs.get_config(ARCH, True, tp=1, fused_attention=True)
    a = tserve.serve_session(cfg, 2, 8, 12, device="cpu", seed=3)
    b = tserve.serve_session(cfg, 2, 8, 12, device="cpu", seed=3)
    assert torch.equal(a[1]["blocks"][1]["slstm"]["slstm_r"],
                       b[1]["blocks"][1]["slstm"]["slstm_r"])
    assert [next(iter(bl)) for bl in a[1]["blocks"]] == [
        "mlstm", "slstm", "mlstm"]
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    logits, st = a[3](a[1], {"tokens": toks}, a[2])
    nxt, logits, st = a[4](a[1], logits.argmax(-1)[:, None], 8, st)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_build_trains_the_ssm_family(dtype):
    """`launch.train.build` takes xlstm: one step of the reduced model on
    the CPU (f32, and bf16 as the full config trains) gives a finite loss,
    moves every parameter leaf, and its gradient reaches slstm_r and
    slstm_w."""
    cfg = tconfigs.get_config(ARCH, reduced=True, tp=1, dtype=dtype)
    init_state, train_step = ttrain.build(cfg, 3e-4, 1, device="cpu")
    params, opt = init_state()
    toks = _t(_tokens(cfg.vocab)[None])
    new, new_opt, met = train_step(params, opt, {"tokens": toks,
                                                 "labels": toks})
    assert bool(torch.isfinite(met["loss"])) and int(new_opt.step) == 1
    moved = {p: bool((a.float() != b.float()).any()) for p, a, b in zip(
        _leaves(params), tree_leaves(params), tree_leaves(new))}
    assert moved["/blocks/1/slstm/slstm_r"]
    assert moved["/blocks/1/slstm/slstm_w"]
    grads = tree_leaves(new_opt.mu)
    names = list(_leaves(params))
    for key in ("/blocks/1/slstm/slstm_r", "/blocks/1/slstm/slstm_w"):
        assert float(grads[names.index(key)].abs().max()) > 0, key


@pytest.fixture
def cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py trains "
                    "there")


def test_train_build_on_the_card_does_not_fall_back(cuda_absent):
    """Without a card, `build(..., device="cuda")` raises (the entry point
    runs on the card or not at all); with one, tests/test_torch_cuda.py
    trains there."""
    with pytest.raises(RuntimeError):
        ttrain.build(tconfigs.get_config(ARCH, reduced=True), 3e-4, 1,
                     device="cuda")


# ---------------------------------------------------------------------------
# training: loss and gradients against jax.grad, the train step, restarts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """jax.value_and_grad of the reference's reduced xlstm loss (~17 s on
    the host: computed once a module)."""
    jm = jreg.build(jconfigs.get_config(ARCH, True))
    toks = jnp.asarray(_tokens(jm.cfg.vocab), jnp.int32)
    (loss, aux), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, _jax_params()),
        {"tokens": toks, "labels": toks})
    return float(loss), _np(grads)


def _port_loss_and_grads(**overrides):
    tm = treg.build(tconfigs.get_config(ARCH, True, **overrides))
    params = interop.to_torch(_jax_params(), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = _t(_tokens(tm.cfg.vocab))
    loss, _ = tm.loss_fn(tree_unflatten(params, leaves),
                         {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def test_loss_and_every_gradient_match_jax_grad(jax_loss_and_grads):
    """The reduced model's loss (rtol 1e-5) and the gradient of every leaf
    within 1e-3 · max|leaf| of jax.grad of the reference's loss_fn (the
    dense family's gradient bound), through the sLSTM block's backward
    (the plain reverse loop here) and remat; slstm_r's and slstm_w's
    gradients nonzero."""
    jloss, jgrads = jax_loss_and_grads
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    g, w = _leaves(grads), _leaves(jgrads)
    assert g.keys() == w.keys()
    for path in w:
        want = np.asarray(w[path], np.float32)
        assert g[path].shape == want.shape, path
        np.testing.assert_allclose(g[path].numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()),
                                   err_msg=path)
    for key in ("slstm_r", "slstm_w"):
        assert float(g[f"/blocks/1/slstm/{key}"].abs().max()) > 0, key


def test_remat_leaves_loss_and_gradients_unchanged():
    """Rematerializing each block recomputes the same values: loss and
    gradients equal the run without remat bitwise (on the CPU)."""
    a_loss, a = _port_loss_and_grads()
    b_loss, b = _port_loss_and_grads(remat=False)
    assert torch.equal(a_loss, b_loss)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_three_train_steps_match_reference_jitted_step():
    """Three steps of `launch.steps.build_train_step` (accum 2, AdamW with
    grad_clip_norm 1.0) from carried-over params and a carried-over
    optimizer state after one reference step, against the reference's
    jitted step: the loss at rtol 1e-5, every leaf of the params and of
    both moments at the LM bound (`_close`)."""
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
                                         (steps + 1, 2, 2, 24), 0,
                                         jm.cfg.vocab), np.int32)
    jp, jo, _ = jstep(jp, jo, {"tokens": jnp.asarray(data[0]),
                               "labels": jnp.asarray(data[0])})
    params = interop.to_torch(_np(jp), "cpu")
    opt_state = interop.adam_state_to_torch(_np(jo), "cpu")
    tm = treg.build(tconfigs.get_config(ARCH, True))
    tstep = tsteps.build_train_step(tm, AdamW(lr=lr, grad_clip_norm=1.0))
    for i in range(1, steps + 1):
        batch = {"tokens": jnp.asarray(data[i]),
                 "labels": jnp.asarray(data[i])}
        jp, jo, jmet = jstep(jp, jo, batch)
        tb = {"tokens": _t(data[i]).long(), "labels": _t(data[i]).long()}
        params, opt_state, met = tstep(params, opt_state, tb)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    assert int(opt_state.step) == int(jo.step) == steps + 1
    for what, got, want in (("params", params, jp),
                            ("mu", opt_state.mu, jo.mu),
                            ("nu", opt_state.nu, jo.nu)):
        _tree_close(got, want, _close, f"{what} ")


def test_train_run_survives_a_failure_bitwise(tmp_path):
    """`launch.train.run` on xlstm-reduced with a failure injected before
    step 2 and a checkpoint every step ends bitwise where an uninterrupted
    run ends, with the same losses."""
    def run(name, fail):
        return ttrain.run(["--arch", ARCH, "--device", "cpu", "--steps",
                           "3", "--batch", "2", "--seq", "16", "--accum",
                           "2", "--ckpt-every", "1", "--ckpt-dir",
                           str(tmp_path / name), *fail])
    clean = run("clean", [])
    failed = run("failed", ["--fail-at", "2"])
    assert (clean["restarts"], failed["restarts"]) == (0, 1)
    assert clean["losses"] == failed["losses"]
    assert all(np.isfinite(clean["losses"]))
    for a, b in zip(tree_leaves(clean["final"]),
                    tree_leaves(failed["final"])):
        assert torch.equal(a, b)

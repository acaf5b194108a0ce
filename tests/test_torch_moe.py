"""Port vs reference: the MoE family (repro_torch.models.mlp's `moe_init`,
`capacity`, `moe_apply`; the transformer's MoE layer; the mixtral and
moonshot configs).

JAX draws the weights (`moe_init`, or the whole reduced model's `init`)
and `interop` carries them across; inputs are drawn with numpy. Held in
f32 (the reduced configs' dtype):

  * `_one_hot` against `jax.nn.one_hot` where the index is −1 or ≥ n (a
    zero row), `_top_k` against `jax.lax.top_k` on tied values (the lower
    index first), `capacity` against the reference's;
  * `moe_apply`'s y and aux for moonshot-reduced (8 experts, top-2) and
    mixtral-reduced (4 experts, top-2): two groups of 64, the one-group
    fallback (S = 96 does not divide into groups of 64), tied
    probabilities (a zero router: every token picks experts 0 and 1 and
    most are dropped outright) and dropped first choices (a router that
    sends more first choices to expert 0 than its capacity): y at rtol
    1e-5 with atol 1e-5 · max|y| (f32 einsums summed in each backend's
    order), aux at rtol 1e-6, the dropped rows exactly 0 in both;
  * the reduced models' loss (ce + 1e-2·aux) and every gradient against
    jax.grad within 1e-3 · max|leaf| (the dense family's bound);
  * prefill and 4 teacher-forced decode steps at the LM bound of
    tests/test_torch_lm.py (rtol 1e-4, atol 1e-4 · max|logits|);
  * the init tree leaf for leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr

KEY = jax.random.PRNGKey(0)
ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x22b")
B, S, STEPS = 2, 24, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# the hazards, one by one
# ---------------------------------------------------------------------------

def test_one_hot_of_an_out_of_range_index_is_a_zero_row():
    idx = np.array([[-1, 0, 3, 4, 7, -5]], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.int32))
    got = tmlp._one_hot(_t(idx), 4, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, [0, 3, 4, 5]].sum() == 0


@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_top_k_puts_the_lower_index_first_on_ties(k):
    rng = np.random.default_rng(0)
    probs = rng.choice(np.float32([0.05, 0.1, 0.2]), (3, 5, 8))
    probs[0, 0] = 0.125                              # all eight tied
    wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
    gv, gi = tmlp._top_k(_t(probs), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi[0, 0].tolist() == list(range(k))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch):
    for reduced in (True, False):
        jc = jconfigs.get_config(arch, reduced)
        tc = tconfigs.get_config(arch, reduced)
        for g in (1, 7, 40, 64, 96, 2048):
            assert tmlp.capacity(tc, g) == jmlp.capacity(jc, g), (g,)


# ---------------------------------------------------------------------------
# moe_apply against the reference's
# ---------------------------------------------------------------------------

# (name, S, router change): two groups of 64; the one-group fallback;
# tied probabilities; dropped tokens
MOE_CASES = [("groups", 128, None), ("one_group", 96, None),
             ("tied", 128, "zero"), ("dropped", 128, "favour0")]


@functools.lru_cache(maxsize=None)
def _moe_params(arch: str):
    return _np(jmlp.moe_init(KEY, jconfigs.get_config(arch, True)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,s,router", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_reference(arch, name, s, router):
    jcfg = jconfigs.get_config(arch, True)
    tcfg = tconfigs.get_config(arch, True)
    p = dict(_moe_params(arch))
    p["router"] = np.array(p["router"])
    if router == "zero":
        p["router"][:] = 0.0
    x = np.random.default_rng(7).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    if router == "favour0":      # logit 0 up by ~6.4: probabilities stay
        p["router"][:, 0] += 0.05    # normal f32 numbers (XLA's CPU
        x += 1.0                     # flushes subnormals, torch does not)
    wy, waux = jmlp.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg)
    gy, gaux = tmlp.moe_apply(interop.to_torch(p, "cpu"), _t(x), tcfg)
    assert gy.shape == x.shape and gy.dtype == torch.float32
    _close(gy, wy, 1e-5, "y")
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
    zero_rows = np.all(np.asarray(wy) == 0, axis=-1)
    np.testing.assert_array_equal(np.all(gy.numpy() == 0, axis=-1),
                                  zero_rows)
    group = min(jcfg.moe_group, s) if s % jcfg.moe_group == 0 else s
    first = np.argmax(x @ p["router"], axis=-1)
    if router == "zero":               # tied: every token dropped outright
        assert zero_rows.sum() > 0     # past both experts' capacity
    elif router == "favour0":          # expert 0's first choices pass
        per_group = (first.reshape(-1, group) == 0).sum(axis=1)
        assert per_group.min() > jmlp.capacity(jcfg, group)
        assert not zero_rows.all()     # the second choices still land
    else:
        assert not zero_rows.all()


# ---------------------------------------------------------------------------
# the whole reduced models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return _np(jreg.build(jconfigs.get_config(arch, True)).init(KEY))


def _tokens(vocab: int) -> np.ndarray:
    return np.asarray(jax.random.randint(KEY, (B, S + STEPS), 0, vocab),
                      np.int64)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_init_tree_carries_across_leaf_for_leaf(arch):
    carried = _leaves(interop.to_torch(_jax_params(arch), "cpu"))
    cfg = tconfigs.get_config(arch, reduced=True)
    own = _leaves(ttr.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    assert carried.keys() == own.keys()
    for path, t in own.items():
        assert (carried[path].shape, carried[path].dtype) == (
            t.shape, t.dtype), path
    assert own["/layers/mlp/moe_gate"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert own["/layers/mlp/router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax_grad(arch):
    jm = jreg.build(jconfigs.get_config(arch, True))
    toks = _tokens(jm.cfg.vocab)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, _jax_params(arch)),
        {"tokens": jnp.asarray(toks, jnp.int32),
         "labels": jnp.asarray(toks, jnp.int32)})
    tm = treg.build(tconfigs.get_config(arch, True))
    params = interop.to_torch(_jax_params(arch), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = tm.loss_fn(tree_unflatten(params, leaves),
                           {"tokens": _t(toks), "labels": _t(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"].detach()), float(jaux["aux"]),
                               rtol=1e-5)
    assert float(aux["aux"].detach()) > 0
    g = _leaves(tree_unflatten(params, list(grads)))
    w = _leaves(_np(jgrads))
    assert g.keys() == w.keys()
    for path in w:
        _close(g[path], w[path], 1e-3, path)
    assert float(g["/layers/mlp/router"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    jm = jreg.build(jconfigs.get_config(arch, True))
    tm = treg.build(tconfigs.get_config(arch, True))
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    tp = interop.to_torch(_jax_params(arch), "cpu")
    toks = _tokens(jm.cfg.vocab)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                         jm.init_serve_state(B, 48))
    tl, tst = tm.prefill(tp, {"tokens": _t(toks[:, :S])},
                         tm.init_serve_state(B, 48, "cpu"))
    _close(tl, jl, 1e-4, "prefill logits")
    _close(tst["k"], jst["k"], 1e-4, "cache k")
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int64)[:, None]
        jl, jst = jm.decode(jp, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(S + i, jnp.int32), jst)
        tl, tst = tm.decode(tp, _t(tok), S + i, tst)
        _close(tl, jl, 1e-4, f"decode step {i}")

"""Port vs reference: the dense LM serving path (repro_torch.models,
configs, parallel.sharding, launch).

JAX's `transformer.init` draws the weights (the two packages cannot share
random streams); they cross to the port through `interop` as numpy (bf16
through ml_dtypes), and the same tokens go to both. Held at f32
(the reduced configs' dtype):

  * prefill last-token logits and the filled KV caches, fused (the flash
    kernel's plain version on the CPU against the Pallas kernel in
    interpret mode) and unfused (the chunked plain path against XLA's);
  * 4 greedy decode steps teacher-forced with JAX's tokens, each step's
    logits;

at rtol 1e-4 with atol 1e-4 · max|reference| (`_close`). That is looser
than the rtol 1e-6 / atol 5e-6 of the equalizer's cross-package tests for
a measured reason: a transformer's attention amplifies f32 rounding from
layer to layer. qwen3-reduced (qk-norm) agrees to 2.4e-6 in its logits
(max |logit| 3.9), 5e-3 of the bound. smollm-reduced has no qk-norm and
`dense_init` takes fan_in = 1 KV head for wk, so |k| reaches ~40 and its
softmax is near one-hot: a 3-ulp difference in layer 0's k (1.3e-5 at
|k| 36) grows ~20× a layer, to 2.5e-3 in layer 2's cached k — the same
2.6e-3 by which the reference's own fused and unfused paths disagree there
(measured on a 40-token prompt). Its logits then differ by up to 0.37 of
the bound on these inputs (the reference test's own batch recipe, 2 × 24
tokens from PRNGKey(0), tests/test_models.py), and decode steps on other
40-token prompts reached 1.2× the bound at the fourth step.
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
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro.models import transformer as jtr
from repro.parallel import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.parallel import sharding as tsharding

KEY = jax.random.PRNGKey(0)
PORTED = ("qwen3-0.6b", "smollm-135m", "internlm2-1.8b", "deepseek-7b",
          "xlstm-125m")
F32_ATOL = 5e-6        # single ops at |y| ≲ 10: a few f32 ulps
B, S, MAX_LEN, STEPS = 2, 24, 48, 4


def _close(got, want, what=""):
    """rtol 1e-4, atol 1e-4 · max|want| (the module docstring's bound)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# sharding helpers and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_resolve_heads_and_kv_head_map_equal_reference(arch):
    cfg = jconfigs.get_config(arch)
    for tp in (1, 2, 4, 16):
        got = tsharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, tp)
        want = jsharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, tp)
        assert got == want, (arch, tp)
        hq, kv_eff = want
        np.testing.assert_array_equal(
            tsharding.kv_head_map(cfg.n_heads, cfg.n_kv_heads, hq, kv_eff),
            jsharding.kv_head_map(cfg.n_heads, cfg.n_kv_heads, hq, kv_eff))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_reference_field_by_field(arch, reduced):
    t = tconfigs.get_config(arch, reduced=reduced)
    j = jconfigs.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.vocab_padded) == (j.head_dim, j.vocab_padded)
    assert t.param_dtype() == getattr(torch, str(j.param_dtype()))
    o = tconfigs.get_config(arch, reduced, tp=1, fused_attention=True)
    assert (o.tp, o.fused_attention) == (1, True)


def test_model_config_defaults_equal_reference():
    assert (dataclasses.asdict(tcommon.ModelConfig())
            == dataclasses.asdict(jcommon.ModelConfig()))
    assert [f.name for f in dataclasses.fields(tcommon.ModelConfig)] == [
        f.name for f in dataclasses.fields(jcommon.ModelConfig)]


def test_archs_list_only_what_the_port_builds():
    assert set(tconfigs.ARCHS) == set(PORTED) < set(jconfigs.ARCHS)
    assert tconfigs.SHAPES == {k: tconfigs.ShapeSpec(**dataclasses.asdict(v))
                               for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("mixtral-8x22b")
    for arch in tconfigs.ARCHS:
        assert treg.build(tconfigs.get_config(arch, True)).cfg.family == (
            "ssm" if arch == "xlstm-125m" else "dense")


@pytest.mark.parametrize("family", ["moe", "vlm", "hybrid", "encdec"])
def test_unported_families_raise_naming_their_roadmap_item(family):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        treg.build(tcommon.ModelConfig(family=family))


def test_ssm_family_builds_and_its_prefill_runs():
    cfg = tconfigs.get_config("xlstm-125m", reduced=True)
    model = treg.build(cfg)
    assert model.cfg.family == "ssm"
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    logits, state = model.prefill(params, {"tokens": toks},
                                  model.init_serve_state(2, 16, "cpu"))
    assert logits.shape == (2, cfg.vocab_padded)
    assert len(state) == cfg.n_layers
    assert bool(torch.isfinite(logits).all())


def test_moe_layers_raise():
    cfg = tcommon.ModelConfig(n_experts=4, top_k=2, dtype="float32")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        ttr.init_layer(torch.Generator(), cfg, device="cpu")


# ---------------------------------------------------------------------------
# numerics, op by op
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=F32_ATOL)
    # jitted, as the model runs it: XLA's eager exp rounds 3 of the 24
    # frequencies 1 ulp differently, which positions up to 481 turn into
    # 1e-5 in the output
    jrope = jax.jit(jcommon.rope, static_argnums=2)
    for pos in (np.arange(7), np.arange(14).reshape(2, 7) * 37):
        np.testing.assert_allclose(
            tcommon.rope(_t(x), _t(pos), 1e4).numpy(),
            np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
            rtol=1e-6, atol=F32_ATOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_dense_mlp_matches_reference(act):
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-0.6b", True),
                              mlp_act=act)
    jp = jmlp.init(KEY, dataclasses.replace(
        jconfigs.get_config("qwen3-0.6b", True), mlp_act=act))
    x = np.random.default_rng(1).standard_normal((2, 5, 128)).astype(
        np.float32)
    want = jmlp.apply(jp, jnp.asarray(x),
                      jconfigs.get_config("qwen3-0.6b", True,
                                          mlp_act=act))
    got = tmlp.apply(interop.to_torch(_tree_np(jp), "cpu"), _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sq,sk,q_chunk,window,q_offset", [
    (64, 64, 16, 0, 0),          # chunked, full causal
    (64, 64, 16, 20, 0),         # chunked, window band per chunk
    (48, 96, 16, 24, 48),        # chunked at an offset, band clipped
    (40, 40, 1024, 0, 0),        # one chunk
    (40, 40, 1024, 9, 0),        # one chunk, window
])
def test_chunked_plain_attention_matches_reference(sq, sk, q_chunk, window,
                                                   q_offset):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, sq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 32)).astype(np.float32)
    want = jattn._attend_causal_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_offset, window,
                                    q_chunk)
    got = tattn._attend_causal_xla(_t(q), _t(k), _t(v), q_offset, window,
                                   q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if sq > q_chunk:
        with pytest.raises(ValueError, match="must divide"):
            tattn._attend_causal_xla(_t(q[:, :-1]), _t(k), _t(v), q_offset,
                                     window, q_chunk)


def test_attend_full_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 13, 1, 16)).astype(np.float32)
    want = jattn.attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    got = tattn.attend_full(_t(q), _t(k), _t(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_self_attention_cache_modes_match_reference(fused):
    """No cache, prefill into a cache, then one decode step at cache_pos
    (the port writes the caller's cache in place)."""
    jcfg = jconfigs.get_config("qwen3-0.6b", True, fused_attention=fused)
    tcfg = tconfigs.get_config("qwen3-0.6b", True, fused_attention=fused)
    jp = jattn.init(KEY, jcfg)
    tp = interop.to_torch(_tree_np(jp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 10, 128)).astype(
        np.float32)
    pos = np.arange(10)
    jo, _ = jattn.self_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    to, _ = tattn.self_attention(tp, _t(x), tcfg, _t(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    jc = jattn.init_cache(jcfg, 2, 16)
    tc = tattn.init_cache(tcfg, 2, 16, device="cpu")
    jo, jc = jattn.self_attention(jp, jnp.asarray(x[:, :9]), jcfg,
                                  jnp.asarray(pos[:9]), jc, 0)
    to, tc2 = tattn.self_attention(tp, _t(x[:, :9]), tcfg, _t(pos[:9]), tc,
                                   0)
    assert tc2 is tc
    for name, got, want in (("prefill", to, jo), ("k", tc["k"], jc["k"]),
                            ("v", tc["v"], jc["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    jo, jc = jattn.self_attention(jp, jnp.asarray(x[:, 9:]), jcfg,
                                  jnp.asarray(pos[9:]), jc, 9)
    to, tc = tattn.self_attention(tp, _t(x[:, 9:]), tcfg, _t(pos[9:]), tc, 9)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_layer_apply_matches_reference(fused):
    """One transformer block without a cache (the training-time body),
    layer 1 of the carried-over qwen3-reduced weights."""
    jcfg = jconfigs.get_config("qwen3-0.6b", True, fused_attention=fused)
    tcfg = tconfigs.get_config("qwen3-0.6b", True, fused_attention=fused)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[1]),
                       _jax_params("qwen3-0.6b")["layers"])
    tlp = ttr._layer(interop.to_torch(_jax_params("qwen3-0.6b"), "cpu")[
        "layers"], 1)
    h = np.random.default_rng(6).standard_normal((2, 12, 128)).astype(
        np.float32)
    pos = np.arange(12)
    jh, _, jaux = jtr.layer_apply(jlp, jnp.asarray(h), jcfg,
                                  jnp.asarray(pos))
    th, cache, taux = ttr.layer_apply(tlp, _t(h), tcfg, _t(pos))
    assert cache is None and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("w,s,pos", [(8, 1, 13), (8, 5, 0), (8, 8, 0),
                                     (8, 11, 0), (8, 11, 4), (8, 5, 6)])
def test_ring_write_matches_reference(w, s, pos):
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((2, w, 3, 4)).astype(np.float32)
    vals = rng.standard_normal((2, s, 3, 4)).astype(np.float32)
    want = jtr._ring_write(jnp.asarray(buf), jnp.asarray(vals), pos)
    tbuf = _t(buf)
    got = ttr._ring_write(tbuf, _t(vals), pos)
    assert got is tbuf                       # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the whole model: weights carried across, prefill + decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str = "float32"):
    cfg = jconfigs.get_config(arch, reduced=True, dtype=dtype)
    return _tree_np(jreg.build(cfg).init(KEY))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch,dtype", [("qwen3-0.6b", "float32"),
                                        ("smollm-135m", "float32"),
                                        ("qwen3-0.6b", "bfloat16")])
def test_jax_init_tree_carries_across_leaf_for_leaf(arch, dtype):
    carried = _paths(interop.to_torch(_jax_params(arch, dtype), "cpu"))
    cfg = tconfigs.get_config(arch, reduced=True, dtype=dtype)
    own = _paths(ttr.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    assert carried.keys() == own.keys()
    for path, t in own.items():
        assert (carried[path].shape, carried[path].dtype) == (
            t.shape, t.dtype), path
    assert own["/embed"].dtype == cfg.param_dtype()
    assert own["/layers/attn/wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)


def _tokens(vocab: int) -> np.ndarray:
    """The reference test's batch recipe (tests/test_models.py): tokens
    from randint(PRNGKey(0)), here for the prompt and the decode steps."""
    return np.asarray(jax.random.randint(KEY, (B, S + STEPS), 0, vocab),
                      np.int64)


def _both(arch: str, fused: bool):
    jm = jreg.build(jconfigs.get_config(arch, True, fused_attention=fused))
    tm = treg.build(tconfigs.get_config(arch, True, fused_attention=fused))
    return (jm, jax.tree.map(jnp.asarray, _jax_params(arch)), tm,
            interop.to_torch(_jax_params(arch), "cpu"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-135m"])
@pytest.mark.parametrize("fused", [False, True])
def test_prefill_logits_and_caches_match_reference(arch, fused):
    jm, jp, tm, tp = _both(arch, fused)
    toks = _tokens(jm.cfg.vocab)[:, :S]
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jm.init_serve_state(B, MAX_LEN))
    tl, tst = tm.prefill(tp, {"tokens": _t(toks)},
                         tm.init_serve_state(B, MAX_LEN, "cpu"))
    assert tl.shape == (B, jm.cfg.vocab_padded)
    _close(tl, jl, "logits")
    _close(tst["k"], jst["k"], "cache k")
    _close(tst["v"], jst["v"], "cache v")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-135m"])
@pytest.mark.parametrize("fused", [False, True])
def test_decode_teacher_forced_matches_reference(arch, fused):
    """STEPS greedy decode steps after the prefill; both packages are fed
    JAX's greedy tokens, so each step's logits compare like for like."""
    jm, jp, tm, tp = _both(arch, fused)
    toks = _tokens(jm.cfg.vocab)[:, :S]
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jm.init_serve_state(B, MAX_LEN))
    _, tst = tm.prefill(tp, {"tokens": _t(toks)},
                        tm.init_serve_state(B, MAX_LEN, "cpu"))
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int64)[:, None]
        jl, jst = jm.decode(jp, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(S + i, jnp.int32), jst)
        tl, tst = tm.decode(tp, _t(tok), S + i, tst)
        _close(tl, jl, f"decode step {i}")


def test_decode_matches_prefill_within_the_port():
    """The reference's own consistency check, in the port alone:
    prefill(s) + one decode step == prefill(s + 1) at 2e-3."""
    cfg = tconfigs.get_config("qwen3-0.6b", True, fused_attention=True)
    m = treg.build(cfg)
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(cfg.vocab)[:, :S + 1])
    _, st = m.prefill(p, {"tokens": toks[:, :S]},
                      m.init_serve_state(B, MAX_LEN, "cpu"))
    lg_dec, _ = m.decode(p, toks[:, S:S + 1], S, st)
    lg_full, _ = m.prefill(p, {"tokens": toks},
                           m.init_serve_state(B, MAX_LEN, "cpu"))
    assert float((lg_dec - lg_full).abs().max()) < 2e-3


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-135m"])
def test_serve_main_on_the_cpu_returns_zero(arch):
    assert tserve.main(["--arch", arch, "--batch", "2", "--prompt-len",
                        "12", "--gen", "3", "--device", "cpu"]) == 0


def test_serve_session_builds_seeded_weights_and_caches():
    cfg = tconfigs.get_config("qwen3-0.6b", True, tp=1,
                              fused_attention=True)
    a = tserve.serve_session(cfg, 2, 8, 12, device="cpu", seed=3)
    b = tserve.serve_session(cfg, 2, 8, 12, device="cpu", seed=3)
    assert torch.equal(a[1]["layers"]["attn"]["wq"],
                       b[1]["layers"]["attn"]["wq"])
    assert a[2]["k"].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads,
                               cfg.head_dim)
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    logits, st = a[3](a[1], {"tokens": toks}, a[2])
    nxt, logits, st = a[4](a[1], logits.argmax(-1)[:, None], 8, st)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert bool(torch.isfinite(logits).all())

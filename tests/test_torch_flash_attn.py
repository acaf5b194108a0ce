"""Port vs reference: the flash-attention forward kernel
(repro_torch.kernels.flash_attn).

On the CPU the wrapper runs the kernel's plain version
(`ref.flash_attention`: GQA by index, f32 softmax and products, 0 for a row
with no valid key); these tests hold it, and the port's `mha` oracle,
against the JAX package's Pallas kernel run in interpret mode and its
`mha_ref`, on the same numpy inputs. The grid is the reference's own
(tests/test_flash_attn.py): GQA, sliding window, non-aligned lengths, a
decode query at an offset, bidirectional, MQA; each in f32 and bf16 at the
reference's tolerances (f32 atol 2e-5, bf16 atol 2e-2: one bf16 rounding
of the output at |o| ≤ 2).

The training functions: the plain forward with lse against the Pallas
`flash_attention_fwd` over the same grid (o f32 atol 2e-5, lse 1e-5), the
plain backward against the Pallas `flash_attention_bwd` fed the same
o, lse and cotangent (f32 atol 2e-5; bf16 atol 2^-6 · max|want|: the port
rounds each f32 gradient once, while the reference rounds dk and dv to
bf16 per query head and rounds again when it sums the GQA group, which at
a group of 2 is up to two bf16 ulps of the largest entry — measured 1.6e-2
at max|dk| 2.9, one ulp), and the autograd `Function` of the fused path on
the CPU against autograd through `mha`.

On the card the CUDA kernels must agree with these plain versions
(tests/test_torch_cuda.py; chip_smoke.py at the serving and training
shapes).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jflash
from repro.kernels.flash_attn import mha_ref as jmha
from repro.kernels.flash_attn.flash_attn import \
    attention_costs as jattention_costs
from repro.kernels.flash_attn.flash_attn import \
    flash_attention_bwd as jflash_bwd
from repro.kernels.flash_attn.flash_attn import \
    flash_attention_fwd as jflash_fwd
from repro_torch.kernels import flash_attn as tfa_pkg
from repro_torch.kernels.flash_attn import flash_attn as tfa
from repro_torch.kernels.flash_attn import ops as tfa_ops
from repro_torch.kernels.flash_attn import ref as tfa_ref
from repro_torch.models import attention as tattn

GRID = [  # b, sq, sk, h, hkv, d, causal, window, q_offset
    (2, 128, 128, 4, 4, 64, True, 0, 0),
    (1, 256, 256, 4, 2, 64, True, 64, 0),       # GQA + sliding window
    (2, 100, 100, 2, 2, 32, True, 0, 0),        # non-block-aligned
    (1, 1, 320, 4, 4, 64, True, 0, 319),        # decode: 1 query at offset
    (2, 64, 192, 2, 2, 64, False, 0, 0),        # bidirectional
    (1, 96, 96, 8, 1, 16, True, 0, 0),          # MQA
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, sq, sk, h, hkv, d, dtype, seed=0):
    """The same inputs for both packages: numpy normals, rounded once to
    bf16 (round to nearest even in both) when dtype is bf16."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
        return ([jnp.asarray(a) for a in arrs],
                [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                 for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("case", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_kernel(case, dtype):
    b, sq, sk, h, hkv, d, causal, win, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, sq, sk, h, hkv, d, dtype)
    want = jflash(jq, jk, jv, causal=causal, window=win, q_offset=qoff,
                  block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=win,
                              q_offset=qoff)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("case", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_reference_oracle(case, dtype):
    b, sq, sk, h, hkv, d, causal, win, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, sq, sk, h, hkv, d, dtype)
    rep = h // hkv
    want = jmha(jq, jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, axis=2),
                causal=causal, window=win, q_offset=qoff)
    got = tfa_ref.mha(tq, tk.repeat_interleave(rep, dim=2),
                      tv.repeat_interleave(rep, dim=2), causal=causal,
                      window=win, q_offset=qoff)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    # every row of the grid sees a key, so the kernel's function is mha's
    flash = tfa_ref.flash_attention(tq, tk, tv, causal, win, qoff)
    np.testing.assert_allclose(_np(flash), _np(got), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_no_valid_key_are_zero_as_in_the_kernel(dtype):
    """q_offset = -5: query rows 0..4 sit before every key, so causality
    masks all their keys. The Pallas kernel (its l = 0 guard) and the port's
    plain flash give 0 there; mha gives the mean of v."""
    b, sq, sk, h, hkv, d = 1, 40, 40, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, sq, sk, h, hkv, d, dtype, seed=3)
    want = _np(jflash(jq, jk, jv, causal=True, q_offset=-5, block_q=16,
                      block_k=16, interpret=True))
    got = _np(tfa.flash_attention(tq, tk, tv, causal=True, q_offset=-5))
    assert np.all(want[:, :5] == 0) and np.all(got[:, :5] == 0)
    assert np.all(np.abs(got[:, 5:]).max(axis=-1) > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    rep = h // hkv
    oracle = _np(tfa_ref.mha(tq, tk.repeat_interleave(rep, dim=2),
                             tv.repeat_interleave(rep, dim=2),
                             q_offset=-5))
    mean_v = _np(tv.float().repeat_interleave(rep, dim=2).mean(dim=1))
    np.testing.assert_allclose(oracle[:, :5],
                               np.broadcast_to(mean_v[:, None], (b, 5, h, d)),
                               atol=TOL[dtype])


@pytest.mark.parametrize("kw", [
    dict(b=1, sq=1024, sk=1024, h=8, d=64, causal=True),
    dict(b=1, sq=1024, sk=1024, h=8, d=64, causal=True, window=128),
    dict(b=4, sq=2048, sk=2048, h=16, d=128, causal=True),
    dict(b=2, sq=1, sk=320, h=4, d=64, causal=True),
    dict(b=2, sq=64, sk=192, h=2, d=64, causal=False, dtype_bytes=4),
])
def test_attention_costs_equal_reference(kw):
    assert tfa.attention_costs(**kw) == jattention_costs(**kw)


def test_attention_costs_at_serving_shape():
    """qwen3-0.6b prefill, 4 × 2048 tokens, 16 heads of 128, bf16: the
    flops and bytes chip_smoke.py divides by the card's peaks."""
    c = tfa.attention_costs(4, 2048, 2048, 16, 128)
    assert c["flops"] == 4.0 * 4 * 16 * (2048 * 2048 / 2) * 128
    assert c["hbm_bytes"] == 2 * 4 * 16 * 128 * (4 * 2048)


@pytest.mark.parametrize("make", [
    lambda q, k, v: (q[..., :24], k[..., :24], v[..., :24]),   # D 24
    lambda q, k, v: (torch.randn(1, 8, 4, 144), torch.randn(1, 8, 2, 144),
                     torch.randn(1, 8, 2, 144)),                # D 144
    lambda q, k, v: (q[:, :, :3], k, v),                        # 2 ∤ 3
    lambda q, k, v: (q, k.double(), v.double()),
    lambda q, k, v: (q.half(), k.half(), v.half()),
    lambda q, k, v: (q, k, v[:, :5]),
    lambda q, k, v: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
    lambda q, k, v: (q[0], k[0], v[0]),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(make):
    q = torch.randn(1, 8, 4, 32)
    k = torch.randn(1, 8, 2, 32)
    v = torch.randn(1, 8, 2, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention(*make(q, k, v))


def test_wrapper_refuses_traced_offsets_and_negative_windows():
    q, k = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k, k, q_offset=torch.tensor(3))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, k, window=-1)


def test_every_head_dim_the_kernel_takes_runs_its_plain_version():
    assert tfa.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for d in tfa.HEAD_DIMS:
        q = torch.randn(1, 3, 2, d)
        out = tfa.flash_attention(q, q, q)
        assert out.shape == q.shape and bool(torch.isfinite(out).all())


def test_package_exports_and_submodule_names():
    """The package exports the entry points, and `flash_attn` still names
    the kernel module (no function re-exported under a submodule's name)."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.flash_attn.flash_attn")
    assert tfa is mod and tfa_pkg.flash_attn is mod
    assert tfa_pkg.flash_attention is tfa.flash_attention
    assert tfa_ops.flash_attention is tfa.flash_attention
    assert tfa_ops.mha_ref is tfa_ref.mha
    assert tfa_ops.attention_costs is tfa.attention_costs
    before = tfa.LAUNCHES["flash_attention"]
    tfa.flash_attention(torch.randn(1, 4, 2, 16), torch.randn(1, 4, 2, 16),
                        torch.randn(1, 4, 2, 16))
    assert tfa.LAUNCHES["flash_attention"] == before   # CPU: no launch


# ---------------------------------------------------------------------------
# the training functions: forward with lse, backward, the autograd Function
# ---------------------------------------------------------------------------

BWD_GRID = [  # b, s, h, hkv, d, window, q_offset (the reference's grid,
    (2, 128, 4, 4, 64, 0, 0),                  # tests/test_flash_attn.py,
    (1, 192, 4, 2, 32, 64, 0),                 # plus rows with no valid
    (2, 100, 2, 2, 64, 0, 0),                  # key)
    (1, 130, 4, 2, 32, 48, 0),
    (1, 40, 4, 2, 32, 0, -5),
]


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
        return ([jnp.asarray(a) for a in arrs],
                [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                 for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("case", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fwd_with_lse_matches_pallas_kernel(case, dtype):
    b, sq, sk, h, hkv, d, causal, win, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, sq, sk, h, hkv, d, dtype)
    jo, jl = jflash_fwd(jq, jk, jv, causal=causal, window=win,
                        q_offset=qoff, block_q=64, block_k=64,
                        interpret=True)
    to, tl = tfa.flash_attention_fwd(tq, tk, tv, causal=causal, window=win,
                                     q_offset=qoff)
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    assert tl.shape == (b, sq, h)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=1e-5)
    assert torch.equal(to, tfa.flash_attention(tq, tk, tv, causal, win,
                                               qoff))


def test_lse_of_rows_with_no_valid_key_is_neg_inf():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 40, 40, 4, 2, 32, "float32",
                                      seed=3)
    _, jl = jflash_fwd(jq, jk, jv, q_offset=-5, block_q=16, block_k=16,
                       interpret=True)
    o, tl = tfa.flash_attention_fwd(tq, tk, tv, q_offset=-5)
    assert np.all(_np(jl)[:, :5] == tfa_ref.NEG_INF)
    assert bool((tl[:, :5] == tfa_ref.NEG_INF).all())
    assert bool((o[:, :5] == 0).all()) and bool(torch.isfinite(tl).all())


@pytest.mark.parametrize("case", BWD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_kernel(case, dtype):
    """dq, dk, dv (dk and dv at Hkv heads) from the same q, k, v, the
    Pallas forward's o and lse, and one cotangent."""
    b, s, h, hkv, d, win, qoff = case
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(
        [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)],
        dtype, seed=1)
    jo, jl = jflash_fwd(jq, jk, jv, window=win, q_offset=qoff, block_q=64,
                        block_k=64, interpret=True)
    want = jflash_bwd(jq, jk, jv, jo, jl, jg, window=win, q_offset=qoff,
                      block_q=64, block_k=64, interpret=True)
    to = torch.from_numpy(np.array(_np(jo))).to(tq.dtype)
    tl = torch.from_numpy(np.array(jl))
    got = tfa.flash_attention_bwd(tq, tk, tv, to, tl, tg, True, win, qoff)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype and tuple(g.shape) == w.shape, name
        w = _np(w)
        atol = 2e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(w).max()
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", BWD_GRID)
def test_fused_function_matches_autograd_through_mha(case):
    """`attend_causal(fused=True)` under autograd is the training Function
    (forward with lse, the two backward kernels' plain versions on the
    CPU); its output and gradients equal autograd through the oracle."""
    b, s, h, hkv, d, win, qoff = case
    _, (q, k, v, g) = _inputs(
        [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)],
        "float32", seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tattn.attend_causal(*leaves, q_offset=qoff, window=win, fused=True)
    assert type(out.grad_fn).__name__ == "_FusedCausalBackward"
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    rep = h // hkv
    want_out = tfa_ref.mha(ref_leaves[0],
                           ref_leaves[1].repeat_interleave(rep, dim=2),
                           ref_leaves[2].repeat_interleave(rep, dim=2),
                           window=win, q_offset=qoff)
    keep = slice(max(-qoff, 0), None)     # mha gives masked rows mean(v)
    g_ref = g.clone()
    g_ref[:, :keep.start] = 0
    want = torch.autograd.grad(want_out, ref_leaves, g_ref)
    np.testing.assert_allclose(_np(out[:, keep].detach()),
                               _np(want_out[:, keep].detach()),
                               rtol=0, atol=2e-5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(w), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_fused_path_without_gradients_is_the_serving_forward():
    q, k = torch.randn(1, 12, 4, 16), torch.randn(1, 12, 2, 16)
    out = tattn.attend_causal(q, k, k, fused=True)
    assert out.grad_fn is None
    assert torch.equal(out, tfa.flash_attention(q, k, k))
    leaf = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tattn.attend_causal(leaf, k, k, fused=True).grad_fn is None
    assert tattn.attend_causal(leaf, k, k, fused=True).grad_fn is not None


@pytest.mark.parametrize("make", [
    lambda q, do, lse: dict(do=do[:, :-1]),
    lambda q, do, lse: dict(do=do.double()),
    lambda q, do, lse: dict(do=do.transpose(2, 3).contiguous()
                            .transpose(2, 3)),
    lambda q, do, lse: dict(lse=lse[:, :-1]),
    lambda q, do, lse: dict(lse=lse.double()),
    lambda q, do, lse: dict(delta=lse.transpose(1, 2).contiguous()
                            .transpose(1, 2)),
])
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(make):
    q, k = torch.randn(1, 8, 4, 32), torch.randn(1, 8, 2, 32)
    do, lse = torch.randn(1, 8, 4, 32), torch.randn(1, 8, 4)
    args = dict(do=do, lse=lse, delta=lse.clone())
    args.update(make(q, do, lse))
    for fn in (tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq):
        with pytest.raises(ValueError):
            fn(q, k, k, args["do"], args["lse"], args["delta"])


def test_training_entry_points_are_exported_and_count_nothing_on_cpu():
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                 "build_bwd"):
        assert getattr(tfa_pkg, name) is getattr(tfa, name)
    assert tfa_ops.flash_attention_fwd is tfa.flash_attention_fwd
    assert tfa_ops.flash_attention_bwd is tfa.flash_attention_bwd
    assert tfa.CSRC_BWD.is_file() and tfa.CSRC_BWD.suffix == ".cu"
    assert set(tfa.LAUNCHES) == {"flash_attention", "flash_attention_fwd",
                                 "flash_attention_bwd_dkv",
                                 "flash_attention_bwd_dq"}
    tfa.reset_launch_counts()
    q = torch.randn(1, 6, 2, 16)
    o, lse = tfa.flash_attention_fwd(q, q, q)
    tfa.flash_attention_bwd(q, q, q, o, lse, torch.randn_like(q))
    assert sum(tfa.LAUNCHES.values()) == 0            # CPU: no launch

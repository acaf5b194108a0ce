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

On the card the CUDA kernel must agree with this plain version
(tests/test_torch_cuda.py; chip_smoke.py at the serving shape).
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
from repro_torch.kernels import flash_attn as tfa_pkg
from repro_torch.kernels.flash_attn import flash_attn as tfa
from repro_torch.kernels.flash_attn import ops as tfa_ops
from repro_torch.kernels.flash_attn import ref as tfa_ref

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

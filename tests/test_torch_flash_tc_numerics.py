"""The numerical design of the bf16 tensor-core flash forward, on the CPU.

The bf16 instances of csrc/flash_attn.cu (`flash_attn_kernel_tc`) compute
S = Q·Kᵀ from bf16 operands with f32 sums (each bf16 × bf16 product is
exact in f32), an online softmax over 64-key tiles with its statistics in
f32 and in log2 units (the scale times log2 e, then exp2), the row sum l
from the f32 p, and O += P·V with P as the tensor cores' bf16 A operand:
a hi part (p rounded to nearest even) and a lo part (what hi missed,
rounded), two products. `tc_datapath` below is a plain-torch emulation of
that datapath; these tests hold it against the JAX package's Pallas
`flash_attention` / `flash_attention_fwd` in interpret mode, on the same
numpy inputs, at the bounds the card holds the kernel to: o within bf16
atol 2e-2 (`FLASH_TOL`), lse within 1e-5.

Why P is split: a single bf16 rounding of P (2^-9 relative) moves o by up
to 2^-9 · Σ p|v| / l. On the served qwen3 layer 0 (|v| up to 60, peaked
scores) that broke the layer-0 bound on the card (2e-2 + 1e-2·|want|,
max |diff| 0.125); a reduced stress of the same kind breaks it here too,
and the hi/lo pair holds it, at f32 accuracy against the plain version.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); this file pins what it should compute before it gets
there. The bf16 wrappers' 16-byte row check is also tested here, on host
tensors.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jflash
from repro.kernels.flash_attn.flash_attn import \
    flash_attention_fwd as jflash_fwd
from repro_torch.kernels.flash_attn import flash_attn as tfa
from repro_torch.kernels.flash_attn import ref as tfa_ref

BLOCK_K = 64                 # keys per staged tile, as in the kernel
FLASH_TOL_BF16 = 2e-2        # o, bf16 (chip_smoke.py FLASH_TOL)
LSE_TOL = 1e-5
NEG_INF = -1e30
LOG2E, LN2 = 1.44269504088896341, 0.693147180559945309

CASES = [  # b, sq, sk, h, hkv, d, causal, window, q_offset
    (1, 128, 128, 4, 2, 64, True, 0, 0),        # GQA 4/2
    (1, 200, 200, 4, 2, 64, True, 48, 0),       # window inside a tile
    (1, 40, 40, 4, 2, 48, True, 0, -5),         # negative q_offset
    (1, 1, 320, 4, 4, 64, True, 0, 319),        # Sq = 1 at an offset
    (2, 100, 100, 2, 2, 48, True, 0, 0),        # D = 48, not aligned
    (1, 65, 130, 4, 1, 80, False, 0, 0),        # MQA, bidirectional
]


def tc_datapath(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, q_offset: int, p_operand="split"):
    """(o in q's type, lse f32) as the tensor-core kernel computes them:
    64-key tiles, f32 statistics in log2 units, l from the f32 p, and P·V
    from P's bf16 hi + lo pair (``p_operand="split"``, the kernel), one
    bf16 rounding of P (``"bf16"``) or the f32 p itself (``"f32"``)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale_log2 = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, D)
    kf = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    qpos = q_offset + torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, BLOCK_K):
        kt, vt = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        kpos = k0 + torch.arange(kt.shape[2])[None, :]
        valid = kpos < sk
        if causal:
            valid = valid & (kpos <= qpos)
        if window > 0:
            valid = valid & (kpos > qpos - window)
        s = torch.where(valid, (qf @ kt.transpose(-1, -2)) * scale_log2,
                        -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(valid, torch.exp2(s - safe), 0.0)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp2(m - safe))
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = {"split": lambda: hi + (p - hi).to(torch.bfloat16).float(),
              "bf16": lambda: hi, "f32": lambda: p}[p_operand]()
        acc = acc * alpha + pv @ vt
        m = m_new
    o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m * LN2 + torch.log(torch.where(l > 0, l, 1.0)),
                      NEG_INF)
    return (o.permute(0, 2, 1, 3).to(q.dtype),
            lse[..., 0].permute(0, 2, 1).contiguous())


def _qkv(case, seed):
    """The same bf16 inputs for both packages (numpy normals rounded once
    to bf16, to nearest even in both)."""
    b, sq, sk, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32).astype(
        ml_dtypes.bfloat16) for s in ((b, sq, h, d), (b, sk, hkv, d),
                                      (b, sk, hkv, d))]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
             for a in arrs])


@pytest.mark.parametrize("case", CASES)
def test_tc_datapath_matches_pallas_kernel(case):
    causal, win, qoff = case[6:]
    (jq, jk, jv), (q, k, v) = _qkv(case, 1)
    want = np.asarray(jflash(jq, jk, jv, causal=causal, window=win,
                             q_offset=qoff, block_q=64, block_k=64,
                             interpret=True), np.float32)
    got, _ = tc_datapath(q, k, v, causal, win, qoff)
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= FLASH_TOL_BF16, err


@pytest.mark.parametrize("case", CASES)
def test_tc_datapath_lse_matches_pallas_fwd(case):
    causal, win, qoff = case[6:]
    (jq, jk, jv), (q, k, v) = _qkv(case, 2)
    jo, jl = jflash_fwd(jq, jk, jv, causal=causal, window=win,
                        q_offset=qoff, block_q=64, block_k=64,
                        interpret=True)
    o, lse = tc_datapath(q, k, v, causal, win, qoff)
    assert float(np.abs(lse.numpy() - np.asarray(jl)).max()) <= LSE_TOL
    assert float(np.abs(o.float().numpy() - np.asarray(jo, np.float32))
                 .max()) <= FLASH_TOL_BF16
    if qoff < 0:   # rows with no valid key: o = 0, lse = NEG_INF
        assert bool((o[:, :-qoff] == 0).all())
        assert bool((lse[:, :-qoff] == NEG_INF).all())


@pytest.mark.parametrize("case", CASES)
def test_split_p_is_f32_accurate_against_the_plain_version(case):
    causal, win, qoff = case[6:]
    _, (q, k, v) = _qkv(case, 3)
    q32, k32, v32 = q.float(), k.float(), v.float()
    wo, wl = tfa_ref.flash_attention_fwd(q32, k32, v32, causal, win, qoff)
    for operand in ("f32", "split"):
        o, lse = tc_datapath(q32, k32, v32, causal, win, qoff, operand)
        assert float((o - wo).abs().max()) <= 2e-5, operand
        assert float((lse - wl).abs().max()) <= 2e-6, operand
    # one bf16 rounding of P moves o by at most 2^-9 · Σ p|v| / l
    o_bf, _ = tc_datapath(q32, k32, v32, causal, win, qoff, "bf16")
    assert float((o_bf - wo).abs().max()) <= 2.0 ** -9 * float(
        v32.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_p_holds_the_layer0_bound_where_one_rounding_does_not(seed):
    # the served layer 0's kind of input, reduced: peaked scores (q, k
    # at 2.5 sigma) and |v| up to ~70; the bound chip_smoke.py holds the
    # kernel to on layer 0: |diff| <= 2e-2 + 1e-2·|want|
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(1, 256, 8, 128, generator=g) * 2.5).bfloat16()
    k = (torch.randn(1, 256, 4, 128, generator=g) * 2.5).bfloat16()
    v = (torch.randn(1, 256, 4, 128, generator=g) * 14).bfloat16()
    want = tfa_ref.flash_attention(q, k, v).float()

    def excess(operand):
        got, _ = tc_datapath(q, k, v, True, 0, 0, operand)
        return float(((got.float() - want).abs() - 2e-2
                      - 1e-2 * want.abs()).max())
    assert excess("split") <= 0.0
    assert excess("bf16") > 0.0


def test_bf16_row_alignment_check():
    base = torch.zeros(2 * 64 * 2 * 64 + 8, dtype=torch.bfloat16)
    q = base[:2 * 64 * 2 * 64].view(2, 64, 2, 64)
    assert q.data_ptr() % 16 == 0
    tfa._check_rows_aligned("flash_attention", q, q, q)
    shifted = base[1:1 + q.numel()].view(q.shape)          # 2 bytes off
    with pytest.raises(ValueError, match="bf16 k rows"):
        tfa._check_rows_aligned("flash_attention", q, shifted, q)
    wide = torch.zeros(2, 64, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="flash_attention_fwd: bf16 v"):
        tfa._check_rows_aligned("flash_attention_fwd", q, q, wide)
    # kv[:, :, 0] views of a (B, S, 2, Hkv, D) cache pass; a size-1 dim's
    # stride is never stepped along, so it is not checked
    kv = torch.zeros(2, 64, 2, 2, 64, dtype=torch.bfloat16)
    tfa._check_rows_aligned("flash_attention", q, kv[:, :, 0], kv[:, :, 1])
    one = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 2, 64), (3, 5, 64, 1))
    tfa._check_rows_aligned("flash_attention", one, one, one)
    # f32 instances stage with scalar loads: no row check
    f32 = torch.zeros(2, 64, 2, 68)[..., :64]
    tfa._check_rows_aligned("flash_attention", f32, f32, f32)

"""The numerical design of the bf16 tensor-core flash backward, on the CPU.

The bf16 instances of csrc/flash_attn_bwd.cu (`flash_bwd_dkv_kernel_tc`,
`flash_bwd_dq_kernel_tc`) recompute S = Q·Kᵀ and dP = dO·Vᵀ from bf16
operands with f32 sums (each bf16 × bf16 product is exact in f32) over
64 × 64 tiles, take p = exp2(s·scale·log2 e − lse·log2 e) under the mask
(scores in log2 units), ds = p·(dp − delta)·scale in f32, and feed P and
dS to the tensor cores' bf16 A operand as a hi part (rounded to nearest
even) and a lo part (what hi missed, rounded), two products each:
dV += Pᵀ·dO and dK += dSᵀ·Q summed over the q tiles and the GQA group in
f32, dQ += dS·K summed over the key tiles, each rounded once to bf16.
`tc_bwd_datapath` below is a plain-torch emulation of that datapath; these
tests hold it against the JAX package's Pallas `flash_attention_bwd` in
interpret mode, on the same numpy inputs, at 2^-6·max|want| (the bound the
port's plain backward is held to against it), and against the port's
plain version at the card's bf16 bound, 1e-2·|want| + 1e-3·max|want|
elementwise.

Why P and dS are split: a single bf16 rounding (2^-9 relative) of dS
moves dK and dQ by up to 2^-9·Σ|ds||q| (or |k|); on peaked scores with
large |v| and |do| that breaks the elementwise bound, which the hi/lo
pair holds at f32 accuracy. One rounding of P moves only dV, and on the
same inputs stays inside the bound (`test_split_*`).

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). The wrappers' 16-byte row check of do, the training
Function's copy of an unaligned cotangent and the build key's hash of the
shared header are tested here too.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.flash_attn import \
    flash_attention_bwd as jflash_bwd
from repro.kernels.flash_attn.flash_attn import \
    flash_attention_fwd as jflash_fwd
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import flash_attn as tfa
from repro_torch.kernels.flash_attn import ref as tfa_ref
from repro_torch.models import attention as tattn

TILE = 64                    # q rows and keys per tile, as in the kernels
PALLAS_REL = 2.0 ** -6       # tests/test_torch_flash_attn.py, bf16 backward
CARD_RTOL, CARD_ATOL_REL = 1e-2, 1e-3     # chip_smoke.py BWD_BF16_*
LOG2E = 1.44269504088896341

CASES = [  # b, sq, sk, h, hkv, d, causal, window, q_offset
    (1, 128, 128, 4, 2, 64, True, 0, 0),        # GQA 4/2
    (1, 200, 200, 4, 2, 64, True, 48, 0),       # window inside a tile
    (1, 40, 40, 4, 2, 48, True, 0, -5),         # negative q_offset
    (1, 1, 320, 4, 4, 64, True, 0, 319),        # Sq = 1 at an offset
    (2, 100, 100, 2, 2, 48, True, 0, 0),        # D = 48, not aligned
    (1, 65, 130, 4, 1, 80, False, 0, 0),        # MQA, bidirectional
]


def _operand(x: torch.Tensor, how: str) -> torch.Tensor:
    """x as the tensor cores see it: a bf16 hi + lo pair ("split"), one
    bf16 rounding ("bf16") or the f32 value itself ("f32")."""
    hi = x.to(torch.bfloat16).float()
    return {"split": lambda: hi + (x - hi).to(torch.bfloat16).float(),
            "bf16": lambda: hi, "f32": lambda: x}[how]()


def tc_bwd_datapath(q, k, v, do, lse, delta, causal, window, q_offset,
                    p_operand="split", ds_operand="split"):
    """(dq, dk, dv) in q's type, dk and dv at Hkv heads, as the tensor-core
    kernels compute them: 64 × 64 tiles, f32 sums, scores and lse in log2
    units, P and dS as ``p_operand`` / ``ds_operand`` (`_operand`)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=f32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=f32)
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, D)
    dof = do.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    lse2 = (lse.float() * torch.tensor(LOG2E, dtype=f32)).permute(
        0, 2, 1)[..., None]                                  # (B, H, Sq, 1)
    dlt = delta.float().permute(0, 2, 1)[..., None]
    qpos = q_offset + torch.arange(sq)[:, None]
    dq = torch.zeros(b, h, sq, d)
    dk = torch.zeros(b, h, sk, d)
    dv = torch.zeros(b, h, sk, d)
    for k0 in range(0, sk, TILE):
        ks, vs = slice(k0, k0 + TILE), slice(k0, k0 + TILE)
        kpos = k0 + torch.arange(kf[:, :, ks].shape[2])[None, :]
        for q0 in range(0, sq, TILE):
            rs = slice(q0, q0 + TILE)
            valid = kpos < sk
            if causal:
                valid = valid & (kpos <= qpos[rs])
            if window > 0:
                valid = valid & (kpos > qpos[rs] - window)
            s = qf[:, :, rs] @ kf[:, :, ks].transpose(-1, -2)
            x = torch.where(valid, s * scale_log2, -math.inf)
            p = torch.exp2(x - lse2[:, :, rs])
            dp = dof[:, :, rs] @ vf[:, :, vs].transpose(-1, -2)
            ds = p * (dp - dlt[:, :, rs]) * scale
            pa, dsa = _operand(p, p_operand), _operand(ds, ds_operand)
            dv[:, :, vs] += pa.transpose(-1, -2) @ dof[:, :, rs]
            dk[:, :, ks] += dsa.transpose(-1, -2) @ qf[:, :, rs]
            dq[:, :, rs] += dsa @ kf[:, :, ks]
    group = lambda t: t.reshape(b, hkv, rep, sk, d).sum(2).permute(0, 2, 1, 3)
    return (dq.permute(0, 2, 1, 3).to(q.dtype), group(dk).to(q.dtype),
            group(dv).to(q.dtype))


def _inputs(case, seed, scales=(1.0, 1.0, 1.0, 1.0)):
    """The same bf16 q, k, v, do for both packages (numpy normals, scaled,
    rounded once to bf16, to nearest even in both)."""
    b, sq, sk, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * sc).astype(np.float32).astype(
        ml_dtypes.bfloat16) for s, sc in zip(
        ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)),
        scales)]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
             for a in arrs])


def _card_excess(got, want) -> float:
    """max of |got − want| − (1e-2·|want| + 1e-3·max|want|): ≤ 0 within
    the card's bf16 backward bound."""
    w = want.float()
    return float(((got.float() - w).abs() - CARD_RTOL * w.abs()
                  - CARD_ATOL_REL * float(w.abs().max())).max())


@pytest.mark.parametrize("case", CASES)
def test_tc_bwd_datapath_matches_pallas_kernel(case):
    causal, win, qoff = case[6:]
    (jq, jk, jv, jg), (q, k, v, do) = _inputs(case, 1)
    jo, jl = jflash_fwd(jq, jk, jv, causal=causal, window=win,
                        q_offset=qoff, block_q=64, block_k=64,
                        interpret=True)
    want = jflash_bwd(jq, jk, jv, jo, jl, jg, causal=causal, window=win,
                      q_offset=qoff, block_q=64, block_k=64, interpret=True)
    o = torch.from_numpy(np.asarray(jo, np.float32)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(jl))
    got = tc_bwd_datapath(q, k, v, do, lse, tfa_ref.attention_delta(o, do),
                          causal, win, qoff)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= PALLAS_REL * float(np.abs(w).max()), (name, err)
    if qoff < 0:   # rows with no valid key get dq = 0
        assert bool((got[0][:, :-qoff] == 0).all())


@pytest.mark.parametrize("case", CASES)
def test_tc_bwd_datapath_within_card_bound_of_plain_version(case):
    causal, win, qoff = case[6:]
    _, (q, k, v, do) = _inputs(case, 2)
    o, lse = tfa_ref.flash_attention_fwd(q, k, v, causal, win, qoff)
    delta = tfa_ref.attention_delta(o, do)
    got = tc_bwd_datapath(q, k, v, do, lse, delta, causal, win, qoff)
    wdk, wdv = tfa_ref.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal, win, qoff)
    wdq = tfa_ref.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                         win, qoff)
    for name, g, w in zip(("dq", "dk", "dv"), got, (wdq, wdk, wdv)):
        assert _card_excess(g, w) <= 0.0, name


@pytest.mark.parametrize("case", CASES)
def test_split_operands_are_f32_accurate_against_the_plain_version(case):
    causal, win, qoff = case[6:]
    _, (q, k, v, do) = _inputs(case, 3)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o, lse = tfa_ref.flash_attention_fwd(q32, k32, v32, causal, win, qoff)
    delta = tfa_ref.attention_delta(o, do32)
    wdk, wdv = tfa_ref.flash_attention_bwd_dkv(q32, k32, v32, do32, lse,
                                               delta, causal, win, qoff)
    wdq = tfa_ref.flash_attention_bwd_dq(q32, k32, v32, do32, lse, delta,
                                         causal, win, qoff)
    for how in ("f32", "split"):
        got = tc_bwd_datapath(q32, k32, v32, do32, lse, delta, causal, win,
                              qoff, how, how)
        for name, g, w in zip(("dq", "dk", "dv"), got, (wdq, wdk, wdv)):
            # the reference's f32 bound on its own backward
            assert float((g - w).abs().max()) <= 5e-4, (how, name)


# peaked scores (q, k at 2.5 sigma) and large |v| and |do|, the kind of
# input of the served and trained qwen3 layer 0 (|v| up to ~60), reduced
STRESS = (1, 256, 256, 8, 4, 128, True, 0, 0)
STRESS_SCALES = (2.5, 2.5, 14.0, 14.0)


def _stress_excess(seed, p_operand, ds_operand):
    _, (q, k, v, do) = _inputs(STRESS, seed, STRESS_SCALES)
    o, lse = tfa_ref.flash_attention_fwd(q, k, v)
    delta = tfa_ref.attention_delta(o, do)
    got = tc_bwd_datapath(q, k, v, do, lse, delta, True, 0, 0, p_operand,
                          ds_operand)
    wdk, wdv = tfa_ref.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    wdq = tfa_ref.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    return {name: _card_excess(g, w)
            for name, g, w in zip(("dq", "dk", "dv"), got, (wdq, wdk, wdv))}


@pytest.mark.parametrize("seed", [0, 1])
def test_split_holds_the_card_bound_where_one_rounding_does_not(seed):
    split = _stress_excess(seed, "split", "split")
    assert max(split.values()) <= 0.0, split
    # one rounding of dS (2^-9 of each term of dK and dQ) breaks the bound
    one_ds = _stress_excess(seed, "split", "bf16")
    assert max(one_ds["dq"], one_ds["dk"]) > 0.0, one_ds
    # one rounding of P moves only dV = Pᵀ·dO, and here stays inside it:
    # unlike the forward's o, dV's bound has no fixed atol that |v| ~ 60
    # can outgrow, only 1e-3·max|dV|
    one_p = _stress_excess(seed, "bf16", "split")
    assert max(one_p.values()) <= 0.0, one_p


def test_bf16_do_row_alignment_check():
    q = torch.zeros(2, 64, 2, 64, dtype=torch.bfloat16)
    assert tfa.rows_aligned(q)
    tfa._check_rows_aligned("flash_attention_bwd_dq", q, q, q, q)
    base = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + q.numel()].view(q.shape)          # 2 bytes off
    assert not tfa.rows_aligned(shifted)
    with pytest.raises(ValueError, match="flash_attention_bwd_dkv: bf16 do"):
        tfa._check_rows_aligned("flash_attention_bwd_dkv", q, q, q, shifted)
    wide = torch.zeros(2, 64, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="flash_attention_bwd_dq: bf16 do"):
        tfa._check_rows_aligned("flash_attention_bwd_dq", q, q, q, wide)
    # f32 rows are taken as they lie
    assert tfa.rows_aligned(torch.zeros(2, 64, 2, 68)[..., :64])


def test_fused_backward_copies_an_unaligned_cotangent(monkeypatch):
    """`_FusedCausal.backward` hands the kernels rows they accept: an
    unaligned bf16 cotangent is copied before the backward runs, and the
    gradients equal those of the aligned one."""
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(s, generator=g).to(torch.bfloat16)
                   for s in ((1, 70, 4, 64), (1, 70, 2, 64), (1, 70, 2, 64),
                             (1, 70, 4, 64)))
    base = torch.zeros(do.numel() + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + do.numel()].view(do.shape)
    shifted.copy_(do)
    seen = []
    real = tattn.flash_attention_bwd

    def spy(q_, k_, v_, o_, lse_, g_, **kw):
        seen.append(tfa.rows_aligned(g_))
        return real(q_, k_, v_, o_, lse_, g_, **kw)
    monkeypatch.setattr(tattn, "flash_attention_bwd", spy)

    def grads(cot):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tattn.attend_causal(*leaves, fused=True)
        return torch.autograd.grad(out, leaves, cot)
    for a, b in zip(grads(shifted), grads(do)):
        assert torch.equal(a, b)
    assert seen == [True, True]


def test_build_key_hashes_the_included_header(tmp_path):
    src = tmp_path / "k.cu"
    hdr = tmp_path / "tiles.cuh"
    hdr.write_text("// helpers v1\n")
    src.write_text('#include <math.h>\n#include "tiles.cuh"\n'
                   "extern \"C\" int f() { return 0; }\n")
    tag = _build.source_tag(src)
    assert tag == _build.source_tag(src)
    hdr.write_text("// helpers v2\n")
    assert _build.source_tag(src) != tag
    # the flash sources share mma_tiles.cuh, which their keys cover
    for csrc in (tfa.CSRC, tfa.CSRC_BWD):
        assert '#include "mma_tiles.cuh"' in csrc.read_text()
        assert csrc.with_name("mma_tiles.cuh").is_file()

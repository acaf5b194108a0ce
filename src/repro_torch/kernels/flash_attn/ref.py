"""Plain PyTorch versions of the flash-attention kernels.

Port of `repro.kernels.flash_attn.ref`, plus the kernels' own semantics:

  * `mha` is the reference's oracle: k/v already at the query head count,
    masked scores set to -1e30 before a softmax, so a row whose keys are
    all masked gets the mean of v.
  * `flash_attention` has the kernel's signature and its semantics: GQA by
    index (query head h reads kv head h // (H / Hkv)), tail keys masked by
    ``kpos < Sk``, and a row with no valid key is 0 — the TPU kernel's
    ``l = 0`` guard (`repro.kernels.flash_attn.flash_attn._flash_kernel`)
    and the CUDA kernel's (csrc/flash_attn.cu). The wrapper runs it for a
    CPU tensor, and the card tests hold the kernel against it.
  * `flash_attention_fwd` is the training forward: the same output plus
    the row logsumexp ``lse`` (B, Sq, H) f32, NEG_INF (−1e30) for a row
    with no valid key (`repro.kernels.flash_attn.flash_attn.
    _flash_fwd_lse_kernel`).
  * `flash_attention_bwd_dkv`, `flash_attention_bwd_dq` and
    `flash_attention_bwd` are the backward as explicit formulas
    (`_flash_dkv_kernel`, `_flash_dq_kernel`), not autograd:
    p = exp(s − lse) taken under the mask only, dv = pᵀ·do,
    dp = do·vᵀ, ds = p·(dp − delta)·scale, dk = dsᵀ·q, dq = ds·k, with
    delta = rowsum(do ⊙ o) in f32. dk and dv come back at the Hkv kv heads
    with the GQA group summed in f32 before the one cast to q's type.

All compute the softmax and every product in float32 and cast the outputs
to q's type.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _valid(sq: int, sk: int, causal: bool, window: int, q_offset: int,
           device: torch.device) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query row i (position
    q_offset + i)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, window: int = 0,
        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) → (B, Sq, H, D).

    Softmax in f32; positions: q[i] is absolute q_offset + i, k[j] is j.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _valid(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) → (B, Sq, H, D) in q.dtype.

    The kernel's function: GQA by index, f32 softmax and products, 0 for a
    row with no valid key (`flash_attention_fwd`'s output).
    """
    return flash_attention_fwd(q, k, v, causal, window, q_offset)[0]


def _gqa(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, Hkv, D) → f32 (B, S, H, D): query head h reads kv head
    h // (H / Hkv)."""
    kv_of = torch.arange(h, device=t.device) // (h // t.shape[2])
    return t.float().index_select(2, kv_of)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """(o (B, Sq, H, D) in q.dtype, lse (B, Sq, H) f32).

    o is `flash_attention`'s; lse = m + log(l) over the valid keys of the
    scaled scores, NEG_INF for a row with no valid key.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _gqa(k, q.shape[2])) * scale
    mask = _valid(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)                    # (B, H, Sq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _gqa(v, q.shape[2]))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, NEG_INF))
    l = l.permute(0, 2, 1, 3)                          # (B, Sq, H, 1)
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    return o.to(q.dtype), lse[..., 0].permute(0, 2, 1).contiguous()


def _probs(q, k, lse, causal, window, q_offset):
    """(p (B, H, Sq, Sk) f32, mask): p = exp(s − lse) where the key is
    valid, 0 elsewhere. The exponent is taken under the mask only: a masked
    entry of a row whose lse is NEG_INF would overflow to inf."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _gqa(k, q.shape[2])) * scale
    mask = _valid(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    lse_ = lse.float().permute(0, 2, 1)[..., None]     # (B, H, Sq, 1)
    x = torch.where(mask, s - lse_, torch.zeros_like(s))
    return torch.where(mask, torch.exp(x), torch.zeros_like(s)), scale


def _dscores(p, do, v, delta, scale):
    """ds = p·(dp − delta)·scale with dp = do·vᵀ."""
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _gqa(v, do.shape[2]))
    delta_ = delta.float().permute(0, 2, 1)[..., None]
    return p * (dp - delta_) * scale


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0):
    """(dk, dv), each (B, Sk, Hkv, D) in q.dtype: the GQA group of each kv
    head summed in f32, then cast once."""
    b, sk, hkv, d = k.shape
    h = q.shape[2]
    p, scale = _probs(q, k, lse, causal, window, q_offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    ds = _dscores(p, do, v, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, sk, hkv, h // hkv, d).sum(dim=3)
    dv = dv.reshape(b, sk, hkv, h // hkv, d).sum(dim=3)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool = True, window: int = 0,
                           q_offset: int = 0) -> torch.Tensor:
    """dq (B, Sq, H, D) in q.dtype."""
    p, scale = _probs(q, k, lse, causal, window, q_offset)
    ds = _dscores(p, do, v, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _gqa(k, q.shape[2]))
    return dq.to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do ⊙ o) in f32, (B, Sq, H): the backward's one
    O(S·D) term outside the kernels, as the reference computes it outside
    Pallas."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """(dq, dk, dv): dq at H heads, dk and dv at Hkv heads."""
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     window, q_offset)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, window,
                                q_offset)
    return dq, dk, dv

"""Plain PyTorch versions of the flash-attention forward kernel.

Port of `repro.kernels.flash_attn.ref`, plus the kernel's own semantics:

  * `mha` is the reference's oracle: k/v already at the query head count,
    masked scores set to -1e30 before a softmax, so a row whose keys are
    all masked gets the mean of v.
  * `flash_attention` has the kernel's signature and its semantics: GQA by
    index (query head h reads kv head h // (H / Hkv)), tail keys masked by
    ``kpos < Sk``, and a row with no valid key is 0 — the TPU kernel's
    ``l = 0`` guard (`repro.kernels.flash_attn.flash_attn._flash_kernel`)
    and the CUDA kernel's (csrc/flash_attn.cu). The wrapper runs it for a
    CPU tensor, and the card tests hold the kernel against it.

Both compute the softmax and both products in float32 and cast the output
to q's type.
"""
from __future__ import annotations

import math

import torch


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
    row with no valid key.
    """
    h, hkv = q.shape[2], k.shape[2]
    kv_of = torch.arange(h, device=q.device) // (h // hkv)
    kf = k.float().index_select(2, kv_of)
    vf = v.float().index_select(2, kv_of)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = _valid(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)                    # (B, H, Sq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    l = l.permute(0, 2, 1, 3)                          # (B, Sq, H, 1)
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    return o.to(q.dtype)

"""Shared model machinery: config, norms, RoPE, sinusoidal positions,
rematerialization, init helpers.

Port of `repro.models.common`. `rms_norm` carries the reference's custom
VJP as a `torch.autograd.Function`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..interop import tree_map
from ..parallel.sharding import whole_last_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 1024
    d_head: int = 0              # 0 → d_model // n_heads
    qk_norm: bool = False
    window: int = 0              # sliding-window attention (0 = full)
    rope_theta: float = 1e4
    mlp_act: str = "silu"        # silu (gated) | gelu (2-matrix)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid / xlstm
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head: int = 64           # mamba2 head dim P
    attn_every: int = 0          # zamba2: shared attention block period
    slstm_at: Tuple[int, ...] = ()
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_len: int = 0
    # vlm (llava)
    img_tokens: int = 0
    # numerics / parallelism
    dtype: str = "bfloat16"
    tp: int = 1                  # tensor-parallel degree for head padding
    remat: bool = True
    scan_layers: bool = True
    moe_group: int = 2048        # tokens per MoE dispatch group
    train_accum: int = 1         # gradient-accumulation microbatches
    serve_fsdp: bool = False     # serve with 2-D-sharded params
    fused_attention: bool = False  # prefill attention in the flash kernel
    serve_int8_weights: bool = False  # int8 weight gathers at serve
    q_chunk: int = 1024          # query chunking for causal attention
    ssd_chunk: int = 64          # chunk length for SSD / chunkwise mLSTM
    max_full_attn_seq: int = 65536
    decode_window: int = 0       # 0 = full cache

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to the 128-lane boundary."""
        return ((self.vocab + 127) // 128) * 128

    def param_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"{self.dtype!r} is not a torch float type")
        return dt

    def n_params_dense(self) -> int:
        """Rough parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if self.n_experts:
            mlp_dense = 0
            moe = self.n_experts * (3 * d * f) + d * self.n_experts
        else:
            mlp_dense = 3 * d * f if self.mlp_act == "silu" else 2 * d * f
            moe = 0
        return l * (attn + mlp_dense + moe) + 2 * v * d

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.n_params_dense()
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        act = self.top_k * (3 * d * f) + d * self.n_experts
        return l * (attn + act) + 2 * v * d


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in f32 where the reference computes in f32 (bf16, f16 and f32
    inputs), but a float64 tensor stays float64, so a float64 run of the
    same function (the chip checks' reference) keeps its precision."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _rms_norm_impl(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = upcast(x)
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * upcast(scale)).to(dt)


class _RMSNorm(torch.autograd.Function):
    """The reference's `custom_vjp` (`repro.models.common._rms_bwd`): the
    backward in f32, dx in x's type, dscale summed over every leading axis
    in scale's type."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_impl(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = upcast(x)
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * r
        del xf
        gf = upcast(g)
        dscale = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
        gs = gf * upcast(scale)
        del gf
        # r · (gs − xhat · mean(gs · xhat)), each operand dropped once
        # used: at most three f32 tensors of x's size are live at once
        t = xhat * (gs * xhat).mean(dim=-1, keepdim=True)
        del xhat
        t = gs - t
        del gs
        return (r * t).to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 internal math, cast back to x's type; its gradient
    is the reference's (f32 math, cotangents in the stream's type). A
    DTensor split along the normalized dim is gathered along it first (a
    sum over a split dim left DTensor choosing to scatter the rows over
    the sequence instead)."""
    return _RMSNorm.apply(whole_last_dim(x), scale, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S) or (S,).

    The reference's formula, freqs = exp(−arange(half)·log(θ)/half), all in
    f32 (log θ and its quotient too, rounded on the host), so the two
    packages agree to f32 rounding. Everything is made on x's device: no
    host-to-device copy per call."""
    half = x.shape[-1] // 2
    rate = float(np.float32(np.log(np.float32(theta))) / np.float32(half))
    ft = torch.promote_types(x.dtype, torch.float32)
    freqs = torch.exp(-torch.arange(0, half, dtype=ft, device=x.device)
                      * rate)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(ft) * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = upcast(x[..., :half]), upcast(x[..., half:])
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int,
                         device: DeviceLike = "cuda") -> torch.Tensor:
    """(n, d) f32 table [sin(pos / 10000^(2i/d)), cos(...)], i < d // 2.

    The reference computes 10000^(2i/d) in f32 with `jnp.power`; a one-ulp
    difference there moves the angle at position 1499 by ~1e-4 rad (and
    `torch.pow` differs from it in 11 of whisper's 640 entries). So the
    exponent 2i/d is formed in f32 as the reference forms it, the power is
    taken in float64 on the host and rounded once to f32, which gives the
    reference's denominators exactly, and the angle pos / denominator is
    divided in f32 as the reference divides it. Its sin and cos are taken
    in float64 and rounded to f32: torch's f32 sin and cos on the host
    give results 1.5e-4 apart at angles near 1500 depending on how the
    tensor is split over threads (vectorized and scalar paths), float64's
    do not. The table is within 1 f32 ulp of the reference's, on
    ``device``. It is built once per (n, d, device) and shared by every
    caller after that (no host work or host-to-device copy per call), so
    callers read it and never write to it. Under a `FakeTensorMode` (the
    dry run) it is built anew and not kept: a fake table must not outlive
    its mode."""
    from torch._guards import detect_fake_mode
    dev = resolve_device(device)
    if detect_fake_mode() is not None:
        return _sinusoid_table.__wrapped__(n, d, dev)
    return _sinusoid_table(n, d, dev)


@functools.lru_cache(maxsize=16)
def _sinusoid_table(n: int, d: int, dev: torch.device) -> torch.Tensor:
    dim = np.arange(d // 2, dtype=np.float32)
    expo = (np.float32(2) * dim) / np.float32(d)
    denom = np.power(10000.0, expo.astype(np.float64)).astype(np.float32)
    pos = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    ang = (pos / torch.from_numpy(denom).to(dev)[None, :]).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]: (..., d) rows of the (V, d) embedding. On DTensors a
    vocab-parallel lookup: each rank gathers its rows of its own vocab
    slice (the FSDP dim gathered first), zeros where a token lies in
    another rank's slice, and the ranks of ``model`` sum (exactly one row
    is nonzero) into rows laid out over the batch: no op that DTensor has
    no rule for (an index of a sharded table, its accumulating backward)
    ever runs."""
    from ..parallel import sharding
    b, v = sharding.batch_head_entries(tokens.shape[0], table.shape[0])
    pl = sharding.spec_placements
    mesh = sharding.get_mesh()
    rows = pl(b, *(None,) * (tokens.dim() - 1))
    ts = pl(v, None)
    b_dims = sharding.batch_axes(mesh) if b else ()

    def local(tab, tok):
        if not v:                        # the whole vocab on this rank
            return tab[tok]
        n = tab.shape[0]
        idx = tok.long() - mesh.get_local_rank("model") * n
        hit = (idx >= 0) & (idx < n)
        out = tab[idx.clamp(0, n - 1)]
        return torch.where(hit[..., None], out, torch.zeros_like(out))
    out = sharding.local_call(
        local, (table, tokens), (ts, rows),
        sharding.grad_partial(pl(b, *(None,) * tokens.dim()),
                              ("model",) if v else ()),
        (sharding.grad_partial(ts, b_dims), rows))
    return sharding.logical(out, ("batch",) + (None,) * tokens.dim())


def lm_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (B, S, d) · lm_head (d, V) → logits (B, S, V). On DTensors each
    rank multiplies its rows by its vocab columns of the whole-d head (the
    FSDP dim gathered first): logits laid out over batch and vocab, as the
    reference's `sharding.logical` sets them."""
    from ..parallel import sharding
    b, v = sharding.batch_head_entries(h.shape[0], w.shape[1])
    pl = sharding.spec_placements
    hs, ws = pl(b, None, None), pl(None, v)
    b_dims = sharding.batch_axes(sharding.get_mesh()) if b else ()
    return sharding.local_call(
        lambda h_, w_: torch.einsum("bsd,dv->bsv", h_, w_), (h, w),
        (hs, ws), pl(b, None, v),
        (sharding.grad_partial(hs, ("model",) if v else ()),
         sharding.grad_partial(ws, b_dims)))


def dequant_int8(q: torch.Tensor, s: torch.Tensor, placements,
                 dtype: torch.dtype) -> torch.Tensor:
    """(q · s) in f32, then ``dtype``: an int8 weight and its f32 scale
    dequantized, as the reference's `dequantize_weights` takes each
    element. A DTensor q is first redistributed to ``placements`` (its
    serve-mode layout: the FSDP gather moves int8)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        q = q.redistribute(q.device_mesh, placements)
    return q.to(torch.float32).mul_(s).to(dtype)


def _layer_placements(placements) -> list:
    """The placements of one layer of a stacked (L, ...) DTensor laid out
    by ``placements``: a split of dim d is a split of the layer's dim
    d − 1 (the layer dim itself is never split)."""
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim == 0 for p in placements):
        raise ValueError(f"the layer dim of a stacked weight is split: "
                         f"{placements}")
    return [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in placements]


class Int8Weight:
    """An int8 weight ({"q": int8, "s": f32 scale}) that stays int8 until a
    layer reads it: ``w[i]`` is layer i of a stacked (L, ...) weight and
    `whole()` the whole weight, each gathered to its serve-mode layout
    (``placements``, whose leading layer dim is never split) and
    dequantized by `dequant_int8` when called. Nothing is kept: the
    caller drops a layer's weights when it is done with them."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, placements,
                 dtype: torch.dtype):
        self.q, self.s, self.placements, self.dtype = q, s, placements, dtype

    def __getitem__(self, i: int) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        q, pl = self.q, self.placements
        if isinstance(q, DTensor):            # layer i of each rank's shard
            q = DTensor.from_local(q.to_local()[i], q.device_mesh,
                                   _layer_placements(q.placements),
                                   run_check=False)
            pl = _layer_placements(pl)
        else:
            q = q[i]
        return dequant_int8(q, self.s, pl, self.dtype)

    def whole(self) -> torch.Tensor:
        return dequant_int8(self.q, self.s, self.placements, self.dtype)


def dequant_block(tree):
    """``tree`` with each `Int8Weight` dequantized whole (a block that is
    not stacked over layers); any other leaf as it is."""
    return tree_map(lambda t: t.whole() if isinstance(t, Int8Weight) else t,
                    tree)


def remat_run(on: bool) -> Callable[..., Any]:
    """run(fn, *args) → fn(*args), under `torch.utils.checkpoint`
    (non-reentrant) when ``on`` and grad is enabled, where the reference
    wraps a body in `jax.checkpoint`: the body's activations are dropped
    after the forward and recomputed in the backward. The bodies draw no
    random numbers, so no RNG state is kept."""
    if not (on and torch.is_grad_enabled()):
        return lambda fn, *args: fn(*args)
    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                        preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype, scale: Optional[float] = None,
               device: DeviceLike = "cuda") -> torch.Tensor:
    """N(0, 1)·scale drawn in f32 on the generator's device, then cast and
    placed on ``device``. The default scale is the reference's
    1/sqrt(fan_in) with fan_in = shape[-2] (so for wq (d, H, dh) it is H)."""
    dev = resolve_device(device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * s
    return w.to(dev, dtype)


def stack_layers(layer_params: list) -> Any:
    """[{...}, {...}] → {...} with a leading layer dim."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *layer_params)

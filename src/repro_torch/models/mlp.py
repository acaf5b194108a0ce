"""Dense MLPs (SwiGLU / GELU) and the GShard-style MoE layer.

Port of `repro.models.mlp`. The MoE layer dispatches tokens in groups of
at most ``cfg.moe_group`` (one group of S where that does not divide S),
with a capacity of C = cf·g·k/E tokens per expert and group; overflow
tokens are dropped, and the router's auxiliary loss, mean(density ·
density_proxy)·E², keeps the experts' use balanced. Plain PyTorch: the
one-hot dispatch and combine einsums and the expert products, as the
reference leaves them to XLA. Where the two frameworks differ, the port
follows the reference:
  * `jax.nn.one_hot` of an index < 0 or >= n is a zero row (a dispatch
    position is −1 for an expert not chosen and >= C for a dropped
    token); `_one_hot` compares with `arange(n)`, so the same holds;
    `F.one_hot` would raise, and clamping would dispatch into a slot;
  * `jax.lax.top_k` puts the lower index first among equal values;
    `torch.topk` promises no order, so `_top_k` takes a stable descending
    sort;
  * the dispatch positions are an int32 cumsum of one-hots
    (`torch.cumsum` of int32 would give int64 without its ``dtype``).
On a mesh both layers run on each rank's own rows through
`sharding.local_call`, with the reference's layouts as the local ones:
the dense MLP's hidden units over ``model`` (its `sharding.logical`
``("batch", None, "mlp")``; `sharding.weight_products`), the MoE
layer's experts over ``model`` where their count divides it, else d_ff
(`moe_apply`); without a mesh both are the plain products.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..parallel import sharding
from .common import ModelConfig, dense_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype()
    if cfg.mlp_act == "silu":
        return {"w_gate": dense_init(generator, (d, f), dt, device=dev),
                "w_up": dense_init(generator, (d, f), dt, device=dev),
                "w_down": dense_init(generator, (f, d), dt, device=dev)}
    return {"w_in": dense_init(generator, (d, f), dt, device=dev),
            "w_out": dense_init(generator, (f, d), dt, device=dev)}


def apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) → (B, S, d). On DTensors the products run on each
    rank's own rows with the hidden units over ``model`` (the
    reference's ``("batch", None, "mlp")``), then the closing layout sums
    the partial result over ``model``."""
    if cfg.mlp_act == "silu":
        y = swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    else:
        y = sharding.weight_products(
            _gelu_mlp, x, (params["w_in"], params["w_out"]), ("cols", "rows"))
    return sharding.logical(y, ("batch", None, None))


def swiglu(x, w_gate, w_up, w_down):
    """silu(x @ w_gate) · (x @ w_up) @ w_down; on DTensors on each rank's
    own rows, d_ff over ``model``, the result a partial sum over it
    (`sharding.weight_products`)."""
    return sharding.weight_products(_swiglu, x, (w_gate, w_up, w_down),
                                    ("cols", "cols", "rows"))


def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _gelu_mlp(x, w_in, w_out):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity dispatch)
# ---------------------------------------------------------------------------

def moe_init(generator: torch.Generator, cfg: ModelConfig,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The reference's MoE leaves: router (d, E) f32, moe_gate / moe_up
    (E, d, f) and moe_down (E, f, d) in the model's type."""
    dev = resolve_device(device)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype()
    return {
        "router": dense_init(generator, (d, e), torch.float32, device=dev),
        "moe_gate": dense_init(generator, (e, d, f), dt, device=dev),
        "moe_up": dense_init(generator, (e, d, f), dt, device=dev),
        "moe_down": dense_init(generator, (e, f, d), dt, device=dev),
    }


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * tokens_per_group * cfg.top_k
            / cfg.n_experts)
    return max(4, (c + 3) // 4 * 4)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: (..., n), a zero row where idx is outside
    [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` along the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) → (y (B, S, d), aux_loss scalar in the router's type).

    Tokens are dispatched in groups of ≤ cfg.moe_group: the dispatch and
    combine tensors are (B·G, g, E, C) with C = cf·g·k/E, so their
    footprint is linear in S for a fixed group size.

    Where x is a DTensor the layer runs on each rank's local rows, with
    the reference's layouts (experts over ``model`` where E divides it,
    as moonshot's 64; else experts whole and d_ff over ``model``, as
    mixtral's 8) as the local weights. Every rank of a model group holds
    the same tokens and routes them over all E experts, then runs its own
    experts (or its slice of d_ff): y is a partial sum over ``model``.
    aux is the mean of the batch shards' means, each equal across
    ``model``: a partial sum of each rank's share (DTensor would give a
    Partial("avg") output every rank's whole gradient). The router's and
    the experts' gradients are partial sums over the batch dims the rows
    lie over (each rank sees its rows' share)."""
    from torch.distributed.tensor import Partial
    mesh = sharding.get_mesh()
    axes = sharding.mesh_axes(mesh)
    e = cfg.n_experts
    ep = sharding.experts_shardable(e)
    b, _ = sharding.batch_head_entries(x.shape[0])
    m = "model" if "model" in axes else None
    pl = sharding.spec_placements
    rows = pl(b, None, None)
    w_in = pl(m, None, None) if ep else pl(None, None, m)
    w_out = pl(m, None, None) if ep else pl(None, m, None)
    b_dims = b or ()

    y_out = tuple(Partial() if a == m else r for a, r in zip(axes, rows))
    shares = [n for a, n in axes.items() if a in b_dims or a == m]
    router_grad = tuple(Partial() if a in b_dims or a == m else r
                        for a, r in zip(axes, pl()))

    def call(x_, router, gate, up, down):
        e0 = mesh.get_local_rank(m) * gate.shape[0] if ep and m else 0
        y_, aux_ = _moe_local(x_, router, gate, up, down, cfg, e0)
        return y_, aux_ / math.prod(shares)
    y, aux = sharding.local_call(
        call, (x, params["router"], params["moe_gate"], params["moe_up"],
               params["moe_down"]),
        (rows, pl(None, None), w_in, w_in, w_out), (y_out, router_grad),
        (y_out, router_grad)
        + tuple(sharding.grad_partial(w, b_dims) for w in (w_in, w_in,
                                                            w_out)))
    return sharding.logical(y, ("batch", None, None)), aux


def _moe_local(x: torch.Tensor, router, gate, up, down, cfg: ModelConfig,
               e0: int):
    """The layer over experts [e0, e0 + gate.shape[0]) of the
    cfg.n_experts the tokens are routed over (all of them off a mesh)."""
    bb, ss, d = x.shape
    g = min(cfg.moe_group, ss)
    n_groups = ss // g if ss % g == 0 else 1
    if ss % g != 0:
        g = ss
    x = x.reshape(bb * n_groups, g, d)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    # routing in the router's type: f32, as the reference (float64 in a
    # run that measures f32's own rounding)
    ft = router.dtype

    logits = x.to(ft) @ router                        # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)                               # (B,S,k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch/GShard)
    density = _one_hot(idx[..., 0], e, ft).mean(dim=1)         # (B,E)
    density_proxy = probs.mean(dim=1)
    aux = (density * density_proxy).mean() * e * e

    dispatch = torch.zeros((b, s, e, c), dtype=x.dtype, device=x.device)
    combine = torch.zeros((b, s, e, c), dtype=ft, device=x.device)
    counts = torch.zeros((b, 1, e), dtype=torch.int32, device=x.device)
    for r in range(k):                       # unrolled over choice rank
        mask_r = _one_hot(idx[..., r], e, torch.int32)           # (B,S,E)
        pos_r = torch.cumsum(mask_r, dim=1, dtype=torch.int32) - 1 + counts
        keep = (pos_r < c) & (mask_r > 0)
        pos_oh = _one_hot(pos_r, c, x.dtype) \
            * keep[..., None].to(x.dtype)                        # (B,S,E,C)
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh.to(ft) * gates[..., r][..., None, None]
        counts = counts + mask_r.sum(dim=1, keepdim=True, dtype=torch.int32)

    e_local = gate.shape[0]
    if e_local != e:
        dispatch = dispatch[:, :, e0:e0 + e_local]
        combine = combine[:, :, e0:e0 + e_local]
    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xin, gate)) \
        * torch.einsum("ebcd,edf->ebcf", xin, up)
    yout = torch.einsum("ebcf,efd->ebcd", h, down)
    y = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), yout)
    return y.reshape(bb, ss, d), aux

"""Step builders: the train, prefill and decode steps per (architecture ×
shape), their inputs' shapes, and how each input is laid out on a mesh.

Port of `repro.launch.steps`. The reference jits each step with
`in_shardings` and lowers it; the port runs a step eagerly, and where a
mesh is given its inputs are DTensors (`torch.distributed.tensor`): the
parameters and the optimizer state placed by `parallel.sharding.
param_shardings`, the batch by `batch_specs` (its rows over
`parallel.sharding.row_axes`), the serve state by `serve_state_specs`.
The model's own `sharding.logical` sites lay out the activations, and the
kernels take each rank's local shards through `local_map`
(`models.attention`, `models.xlstm`). Under
`torch._subclasses.fake_tensor.FakeTensorMode` over a fake process group
the same `make_lowerable` builds a cell of any size without memory: the
counterpart of the reference's `ShapeDtypeStruct`s, which
`launch.dryrun` runs through `launch.roofline`'s counter.

The train step reduces each gradient to its parameter's placements (a
weight replicated over ``data`` gets a `Partial` sum there) before the
clipping and the update, where the reference's GSPMD reduces implicitly:
a stacked layer leaf's one layer at a time inside the layer loop's
backward (`models.transformer._LayerGrad`), any other leaf's once
`torch.autograd.grad` returns it; its f32 sums live on the parameters'
shards. It lays the new parameters and moments out as their inputs
were. Plain tensors that the model makes (positions, masks) count as
replicated (`implicit_replication`). Left out by choice: the reference's
donation and out_shardings of the serve state (the port writes its
caches in place).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import configs
from ..configs.shapes import ShapeSpec
from ..interop import tree_leaves, tree_map, tree_named_leaves, tree_unflatten
from ..models import registry
from ..models.common import Int8Weight, ModelConfig, dequant_int8
from ..optim.adam import AdamW
from ..parallel import sharding
from ..parallel.sharding import P


# ---------------------------------------------------------------------------
# config resolution per (arch, shape)
# ---------------------------------------------------------------------------

def resolve_config(arch: str, shape: ShapeSpec, reduced: bool = False
                   ) -> ModelConfig:
    cfg = configs.get_config(arch, reduced=reduced)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        # zamba2 long-context decode: shared attn falls back to a sliding
        # window ring cache; Mamba2 state carries long range.
        cfg = dataclasses.replace(cfg, decode_window=4096)
    return cfg


def cell_supported(arch: str, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the long_500k policy (the
    reference's reason, word for word)."""
    if shape.name == "long_500k" and not configs.long_500k_runnable(arch):
        return False, ("full attention is quadratic in seq; 500k-token "
                       "decode requires a sub-quadratic family "
                       "(DESIGN.md §5 long_500k policy)")
    return True, ""


# ---------------------------------------------------------------------------
# input specs (shapes and types, never allocated)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and type without its data (the reference's
    `jax.ShapeDtypeStruct`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def zeros(self, device: torch.device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract inputs for the step kind. Training batches carry a leading
    grad-accumulation axis (the pipeline emits them pre-split)."""
    sds = ShapeDtype
    edt = cfg.param_dtype()
    i32 = torch.int32
    if shape.kind == "train":
        acc = max(1, cfg.train_accum)
        if shape.global_batch % acc:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split into {acc} micro-batches")
        mb = shape.global_batch // acc
        s = shape.seq_len
        batch: Dict[str, Any] = {}
        if cfg.family == "vlm":
            s_txt = s - cfg.img_tokens
            batch["embed_prefix"] = sds((acc, mb, cfg.img_tokens,
                                         cfg.d_model), edt)
            batch["tokens"] = sds((acc, mb, s_txt), i32)
            batch["labels"] = sds((acc, mb, s_txt), i32)
        elif cfg.family == "encdec":
            batch["enc_embed"] = sds((acc, mb, cfg.enc_len, cfg.d_model), edt)
            batch["tokens"] = sds((acc, mb, s), i32)
            batch["labels"] = sds((acc, mb, s), i32)
        else:
            batch["tokens"] = sds((acc, mb, s), i32)
            batch["labels"] = sds((acc, mb, s), i32)
        return batch
    if shape.kind == "prefill":
        b, s = shape.global_batch, shape.seq_len
        batch = {}
        if cfg.family == "vlm":
            batch["embed_prefix"] = sds((b, cfg.img_tokens, cfg.d_model), edt)
            batch["tokens"] = sds((b, s - cfg.img_tokens), i32)
        elif cfg.family == "encdec":
            batch["enc_embed"] = sds((b, cfg.enc_len, cfg.d_model), edt)
            batch["tokens"] = sds((b, s), i32)
        else:
            batch["tokens"] = sds((b, s), i32)
        return batch
    # decode: one new token against a state of capacity seq_len
    return {"token": sds((shape.global_batch, 1), i32),
            "pos": sds((), i32)}


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rows: bool = False) -> Dict[str, Any]:
    """`PartitionSpec` tree matching `input_specs`: the batch over every
    batch dim of ``mesh`` where the batch divides them, else whole (the
    reference's). With ``rows``, as the port's steps take their inputs:
    a batch that does not divide them all lies over the largest set of
    them that it divides (`sharding.row_axes`), as the models lay out
    their activations."""
    n = shape_batch(cfg, shape)
    if rows:
        b = sharding.row_axes(n, mesh) or None
    else:
        b_axes = sharding.batch_axes(mesh)
        b = b_axes if _divides(n, b_axes, mesh) else None
    if shape.kind == "train":
        out = {"tokens": P(None, b, None), "labels": P(None, b, None)}
        if cfg.family == "vlm":
            out["embed_prefix"] = P(None, b, None, None)
        if cfg.family == "encdec":
            out["enc_embed"] = P(None, b, None, None)
        return out
    if shape.kind == "prefill":
        out = {"tokens": P(b, None)}
        if cfg.family == "vlm":
            out["embed_prefix"] = P(b, None, None)
        if cfg.family == "encdec":
            out["enc_embed"] = P(b, None, None)
        return out
    return {"token": P(b, None), "pos": P()}


def shape_batch(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if shape.kind == "train":
        return shape.global_batch // max(1, cfg.train_accum)
    return shape.global_batch


def _divides(n: int, axes, mesh) -> bool:
    sizes = sharding.mesh_axes(mesh)
    size = 1
    for a in (axes or ()):
        size *= sizes[a]
    return n % size == 0 if size else False


# ---------------------------------------------------------------------------
# serve-state sharding specs (per family)
# ---------------------------------------------------------------------------

def _auto_spec(leaf, hints, mesh) -> P:
    """A spec from logical hints with divisibility fallback (a "batch" dim
    over the largest set of batch dims it divides, `sharding.row_axes`)."""
    sizes = sharding.mesh_axes(mesh)
    out = []
    for dim, ax in zip(leaf.shape, hints):
        if ax == "batch":
            cand = sharding.row_axes(dim, mesh)
        elif ax == "model":
            cand = ("model",) if "model" in sizes else ()
        else:
            cand = ()
        size = 1
        for a in cand:
            size *= sizes[a]
        ok = cand and size and dim % size == 0
        out.append((cand if len(cand) > 1 else cand[0]) if ok else None)
    return P(*out)


def _state_spec(path: str, leaf, mesh) -> P:
    nd = len(leaf.shape)
    base = path.split("/")[-1]
    if base in ("k", "v", "xk", "xv"):
        hints = {5: (None, "batch", None, "model", None),
                 4: ("batch", None, "model", None)}.get(nd, (None,) * nd)
        return _auto_spec(leaf, hints, mesh)
    if "conv" in path:
        hints = (None,) * (nd - 1) + ("model",)
        hints = ("batch",) + hints[1:] if nd >= 2 else hints
        if nd >= 3:
            hints = ((None, "batch") if nd == 4 else ("batch",)) \
                + (None,) * (nd - 2) + ("model",)
        return _auto_spec(leaf, hints, mesh)
    if "ssm" in path and nd >= 4:
        hints = (None,) * (nd - 4) + ("batch", "model", None, None)
        return _auto_spec(leaf, hints, mesh)
    if nd >= 2:
        return _auto_spec(leaf, ("batch",) + (None,) * (nd - 2) + ("model",),
                          mesh)
    return P()


def serve_state_specs(cfg: ModelConfig, state_shapes, mesh):
    """Spec tree for a serve state (leaves with a ``shape``), matched on
    the leaves' paths as the reference matches them.

    Heuristics per family (explicit, not guessed): rank-5 stacked KV caches
    shard (layer=None, batch, seq=None, heads→model, hd=None); Mamba conv
    states shard the channel dim; SSD states shard the head dim; xLSTM cell
    matrices shard the last (head-dim) axis.
    """
    return tree_unflatten(state_shapes, [
        _state_spec(path, leaf, mesh)
        for path, leaf in tree_named_leaves(state_shapes)])


# ---------------------------------------------------------------------------
# int8 weight-gathered serving
# ---------------------------------------------------------------------------
# serve_fsdp models (mixtral: 280 GB bf16) pay a per-layer weight all-gather
# over `data`; storing the big weights as int8 + per-tensor scale halves
# those collective bytes. The gather runs BEFORE dequantization (the
# int8 DTensor is redistributed to its serve-mode placements), so the
# collective moves int8, not bf16. The steps gather and dequantize a
# stacked layer weight one layer at a time, as the layer loop reaches it
# (`layerwise_int8`), where the reference's per-layer gather sits inside
# its layer scan.

_INT8_MIN_SIZE = 1 << 16
# the param-tree keys whose weights are per layer: stacked (L, ...) under
# "layers", "enc_layers", "dec_layers"; one dict a block under "blocks"
# (xlstm)
_LAYER_KEYS = ("layers", "enc_layers", "dec_layers", "blocks")


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"q", "s"}


def quantize_weights_int8(params):
    """Every leaf of rank ≥ 2 and at least 2^16 elements as {"q": int8,
    "s": f32 scale}: s = max|w| / 127 + 1e-12, q = clip(round(w / s), ±127)
    with round half to even, all in f32 (the reference's arithmetic)."""
    def one(leaf):
        if leaf.dim() >= 2 and leaf.numel() >= _INT8_MIN_SIZE:
            lf = leaf.to(torch.float32)
            s = torch.max(torch.abs(lf)) / 127.0 + 1e-12
            q = torch.clamp(torch.round(lf / s), -127, 127).to(torch.int8)
            return {"q": q, "s": s.to(torch.float32)}
        return leaf
    return tree_map(one, params)


def _map_qleaves(fn: Callable, tree, *rest):
    """``fn`` on each {"q", "s"} node (with the matching nodes of
    ``rest``), every other leaf as it is."""
    if _is_qleaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_qleaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_qleaves(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


def _gather_placements(spec, mesh):
    return None if mesh is None else sharding.placements(spec["q"], mesh)


def dequantize_weights(qparams, gather_specs, mesh, dtype: torch.dtype):
    """Gather each int8 weight to its ``gather_specs`` layout (the
    serve-mode spec, without the FSDP dim) and dequantize locally:
    (q · s) in f32, then ``dtype``. A plain q is dequantized as it is."""
    return _map_qleaves(lambda node, spec: dequant_int8(
        node["q"], node["s"], _gather_placements(spec, mesh), dtype),
        qparams, gather_specs)


def layerwise_int8(qparams, gather_specs, mesh, dtype: torch.dtype):
    """The int8 tree as the serving steps read it: each {"q", "s"} node
    under a per-layer key (`_LAYER_KEYS`) an `Int8Weight`, which the
    model's layer loop gathers and dequantizes one layer (or block) at a
    time; every other node (embed, lm_head, a shared block) gathered and
    dequantized now, as `dequantize_weights` does. Each element is the
    same (q · s) either way, so the steps' outputs are bitwise those on
    `dequantize_weights`' tree."""
    def per_layer(node, spec):
        return Int8Weight(node["q"], node["s"],
                          _gather_placements(spec, mesh), dtype)
    whole = {k: v for k, v in qparams.items() if k not in _LAYER_KEYS}
    out = dequantize_weights(whole, {k: gather_specs[k] for k in whole},
                             mesh, dtype)
    for k in qparams:
        if k in _LAYER_KEYS:
            out[k] = _map_qleaves(per_layer, qparams[k], gather_specs[k])
    return {k: out[k] for k in qparams}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _replication(tree):
    """`implicit_replication` where ``tree`` holds a DTensor (plain tensors
    the model makes count as replicated), else nothing."""
    if any(_is_dtensor(t) for t in tree_leaves(tree)):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _like(new, old):
    """``new`` laid out as ``old`` where old is a DTensor (a Partial
    reduced, a shard gathered or split), else ``new`` itself."""
    if _is_dtensor(old) and tuple(new.placements) != tuple(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def loss_and_grads(model: registry.Model, params, batch):
    """One microbatch's (loss, the gradient of every parameter leaf in
    `tree_leaves` order, None where unused), by `torch.autograd.grad`. On
    DTensor params (under `_replication`) the loss is replicated, and a
    stacked layer leaf's gradient comes back in its parameter's placements
    (the layer loop reduces each layer's as its backward produces it,
    `models.transformer._LayerGrad`); another leaf's may come back in any
    layout (a Partial sum)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss_fn(tree_unflatten(params, leaves), batch)
    if _is_dtensor(loss):
        loss = _replicated(loss)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


def build_train_step(model: registry.Model, opt: AdamW):
    """Gradient-accumulating train step: every batch leaf has a leading
    accum axis. For each microbatch, `loss_and_grads`; each gradient is
    laid out as its parameter (`_like`: a Partial reduced, a whole leaf
    split; a no-op on a stacked layer leaf's), then cast to f32 and added
    into the f32 sums, which are held on the parameters' shards. The sums
    are divided by accum and `opt.update` applies them (with its gradient
    clipping). Returns (new_params, new_opt_state, {"loss": mean
    microbatch loss}). The sums are updated in place; params and the
    optimizer state are not. The new params and state keep their inputs'
    layouts."""

    def train_step(params, opt_state, batch):
        with _replication(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        accum = tree_leaves(batch)[0].shape[0]
        plist = tree_leaves(params)
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in plist]
        losses = []
        for a in range(accum):
            loss, grads = loss_and_grads(model, params,
                                         tree_map(lambda t: t[a], batch))
            for acc, g, p in zip(gsum, grads, plist):
                if g is not None:
                    acc.add_(_like(g, p).float())
            losses.append(loss)
            del grads
        grads = tree_unflatten(params, [g / accum for g in gsum])
        new_params, new_opt = opt.update(grads, opt_state, params)
        new_params = tree_map(_like, new_params, params)
        new_opt = tree_map(_like, new_opt, opt_state)
        return new_params, new_opt, {"loss": torch.stack(losses).mean()}

    return train_step


def _replicated(t):
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def build_prefill_step(model: registry.Model):
    def prefill_step(params, batch, state):
        with _replication(params):
            logits, new_state = model.prefill(params, batch, state)
        return logits, new_state
    return prefill_step


def build_decode_step(model: registry.Model):
    def decode_step(params, token, pos, state):
        with _replication(params):
            logits, new_state = model.decode(params, token, pos, state)
            # greedy next token — serving loops feed it back (a
            # vocab-sharded DTensor gathers its vocab first)
            next_tok = torch.argmax(sharding.whole_last_dim(logits),
                                    dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_state
    return decode_step


# ---------------------------------------------------------------------------
# full assembly per cell
# ---------------------------------------------------------------------------

def place(tree, specs, mesh):
    """Each tensor leaf of ``tree`` (whole, the same on every rank) as a
    DTensor on ``mesh`` laid out by its `PartitionSpec` in ``specs`` (a
    tree of the same shape, or one spec for a single tensor); a leaf that
    already is a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        pl = sharding.placements(spec, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl)
    if isinstance(specs, P):
        return one(tree, specs)
    return tree_unflatten(tree, [one(t, s) for t, s in zip(
        tree_leaves(tree), sharding.spec_leaves(specs))])


@dataclasses.dataclass
class Lowerable:
    """Everything needed to run one (arch × shape × mesh) cell: the step
    ``fn`` and its arguments ``args`` (DTensors on ``mesh``: real, or fake
    under `FakeTensorMode`), with ``specs`` the `PartitionSpec` tree of
    each argument (None for a python int) so that `place` can lay out
    other data the same way."""
    cfg: ModelConfig
    fn: Any
    args: tuple
    kind: str
    mesh: Any = None
    specs: tuple = ()

    def place(self, i: int, tree):
        """``tree`` (whole tensors) laid out as argument ``i``."""
        return place(tree, self.specs[i], self.mesh)


def make_lowerable(arch: str, shape: ShapeSpec, mesh, reduced: bool = False,
                   lr: float = 1e-3, cfg_overrides: Optional[dict] = None,
                   params=None, seed: int = 0) -> Lowerable:
    """The (arch × shape) cell on ``mesh`` (a `DeviceMesh` over an
    initialized world, fake or real): its config (`resolve_config`, then
    ``cfg_overrides``), the model's weights (``params``, whole tensors the
    same on every rank, or the model's seeded init on the mesh's device),
    the step and its DTensor inputs. Parameters (and, for a train cell,
    the AdamW(lr, grad_clip_norm=1.0) state) are placed by
    `sharding.param_shardings` in mode "train", or "serve_fsdp" /
    "serve"; the batch by `batch_specs(…, rows=True)` (zeros of
    `input_specs`); the serve state by `serve_state_specs`. With
    ``cfg.serve_int8_weights`` the weights are stored as
    `quantize_weights_int8`; each step gathers and dequantizes the
    non-layer weights first and every layer's weights when its layer loop
    reaches them (`layerwise_int8`). Sets the current
    mesh (`sharding.set_mesh`) for the step to run in."""
    cfg = resolve_config(arch, shape, reduced=reduced)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    model = registry.build(cfg)
    if shape.kind == "train":
        mode = "train"
    else:
        mode = "serve_fsdp" if cfg.serve_fsdp else "serve"
    sharding.set_mesh(mesh, mode)
    dev = torch.device(mesh.device_type)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
    pspecs = sharding.param_specs(params, mesh, mode)

    def batch_zeros():
        return tree_map(lambda s: s.zeros(dev), input_specs(cfg, shape))

    if shape.kind == "train":
        opt = AdamW(lr=lr, grad_clip_norm=1.0)
        opt_state = opt.init(params)
        ospecs = sharding.param_specs(opt_state, mesh, mode)
        bspecs = batch_specs(cfg, shape, mesh, rows=True)
        args = (place(params, pspecs, mesh), place(opt_state, ospecs, mesh),
                place(batch_zeros(), bspecs, mesh))
        return Lowerable(cfg, build_train_step(model, opt), args, "train",
                         mesh, (pspecs, ospecs, bspecs))

    # serving cells
    b = shape.global_batch
    state = model.init_serve_state(b, shape.seq_len, dev)
    sspecs = serve_state_specs(cfg, state, mesh)
    state = place(state, sspecs, mesh)

    deq = None
    if cfg.serve_int8_weights:
        params = quantize_weights_int8(params)
        pspecs = sharding.param_specs(params, mesh, mode)
        gspecs = sharding.param_specs(params, mesh, "serve")
        dt = cfg.param_dtype()

        def deq(qp):
            return layerwise_int8(qp, gspecs, mesh, dt)
    dparams = place(params, pspecs, mesh)
    bspecs = batch_specs(cfg, shape, mesh, rows=True)

    if shape.kind == "prefill":
        inner = build_prefill_step(model)
        step = (inner if deq is None else
                (lambda p, batch, st: inner(deq(p), batch, st)))
        return Lowerable(cfg, step,
                         (dparams, place(batch_zeros(), bspecs, mesh), state),
                         "prefill", mesh, (pspecs, bspecs, sspecs))

    inner = build_decode_step(model)
    step = (inner if deq is None else
            (lambda p, tok, pos, st: inner(deq(p), tok, pos, st)))
    token = place(input_specs(cfg, shape)["token"].zeros(dev),
                  bspecs["token"], mesh)
    return Lowerable(cfg, step, (dparams, token, 0, state), "decode", mesh,
                     (pspecs, bspecs["token"], None, sspecs))

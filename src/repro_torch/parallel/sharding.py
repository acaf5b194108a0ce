"""Logical-axis sharding rules for the production mesh, and TP divisibility
resolution (head padding / KV replication).

Port of `repro.parallel.sharding`. Mesh dims: ("data", "model")
single-pod, ("pod", "data", "model") multi-pod. "pod" composes with "data"
for batch/FSDP sharding, so the same rules work on both meshes (missing
dims are dropped).

Parameter sharding is PATH-BASED: every weight name maps to a
`PartitionSpec` through `_PARAM_RULES` (Megatron 2-D layout: TP over
`model`, FSDP over `data`). The port's `PartitionSpec` is a tuple whose
entries are None, a mesh dim name or a tuple of names, equal entry by
entry to the reference's `jax.sharding.PartitionSpec` (a one-name tuple is
the name). `placements` turns a spec into DTensor placements, one per mesh
dim: `Shard(d)` where tensor dim d names that mesh dim, else `Replicate()`
(a tensor dim over ("pod", "data") is `Shard(d)` on both).

The rules read a mesh only through `mesh_axes`, which takes a torch
`DeviceMesh` or anything with `axis_names` and a `shape` mapping
(`launch.mesh.AbstractMesh`, or the reference tests' fake mesh), so the
specs of a 256-chip mesh are computed without its ranks.

`logical` is a no-op without a mesh, as in the reference; with one it
redistributes only a `DTensor`. The port's models call it where the
reference's do (`models.attention`, `mlp`, `transformer`, `mamba2`,
`zamba2`, `xlstm`, `whisper`), so a single-card run is unchanged and a
step built on a mesh (`launch.steps.make_lowerable`) lays its
activations out as the reference's GSPMD constraints do. `local_pair`
gives the in-place cache writes of a DTensor serve state their local
shards, `local_call` hands a kernel the local shards of DTensor
inputs, and `weight_products` runs the models' weight products on each
rank's own rows (`row_axes`) with the reference's Megatron layout.

TP divisibility policy: head counts are padded and KV heads replicated at
config-resolution time so every sharded dim divides the mesh axis.
"""
from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..interop import tree_named_leaves, tree_unflatten


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh dim name, or a tuple of
    names (major to minor). A one-name tuple is stored as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

_CURRENT: dict = {"mesh": None, "mode": "train"}


def set_mesh(mesh, mode: str = "train") -> None:
    _CURRENT["mesh"] = mesh
    _CURRENT["mode"] = mode


def get_mesh():
    return _CURRENT["mesh"]


def mesh_axes(mesh) -> Dict[str, int]:
    """{dim name: size} in mesh order, of a `DeviceMesh` (`mesh_dim_names`,
    `shape`) or of any object with `axis_names` and a `shape` mapping;
    none without a mesh."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> tuple:
    """Mesh dims that carry the batch: ("pod","data") when present."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def fsdp_axis(mesh):
    """FSDP shards parameters over the data dim (not pod: keep parameter
    all-gathers intra-pod; the pod dim only reduces gradients)."""
    return "data" if "data" in mesh_axes(mesh) else None


def _entry_axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else (entry or ())


def _fit(shape: Sequence[int], spec: PartitionSpec, mesh) -> PartitionSpec:
    """Divisibility safety: a dim that does not divide its mesh dims is
    replicated instead (an unpadded odd vocab, a batch of 1)."""
    axes = mesh_axes(mesh)
    fixed = []
    for dim, entry in zip(shape, spec):
        size = 1
        for a in _entry_axes(entry):
            size *= axes[a]
        fixed.append(entry if size and dim % size == 0 else None)
    return P(*fixed)


# ---------------------------------------------------------------------------
# Logical activation axes
# ---------------------------------------------------------------------------

def _logical_to_spec(axes: Sequence[Optional[str]], mesh,
                     mode: str) -> PartitionSpec:
    names = mesh_axes(mesh)
    out = []
    for ax in axes:
        if ax in ("batch", "seq_shard"):   # seq_shard: long-context SP
            out.append(batch_axes(mesh) or None)
        elif ax in ("heads", "kv_heads", "mlp", "vocab", "experts",
                    "ssm_inner", "model"):
            out.append("model" if "model" in names else None)
        elif ax == "fsdp":
            # train / serve_fsdp: params 2-D sharded (FSDP over data).
            # serve: params shard over `model` only (weight all-gathers per
            # decode step would dominate the token latency).
            out.append(None if mode == "serve" else fsdp_axis(mesh))
        else:                            # None / "embed" / "seq" / "head_dim"
            out.append(None)
    return P(*out)


def logical(x, axes: Sequence[Optional[str]]):
    """Apply a logical-axis layout (no-op without a mesh, or when ``x`` is
    not a `DTensor`): a DTensor is redistributed onto the current mesh with
    the placements of the logical axes, a "batch" dim over `row_axes`
    (the reference's batch dims where the rows divide them all, else the
    largest set of them the rows divide), other dims that do not divide
    their mesh dims replicated."""
    mesh = _CURRENT["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _logical_to_spec(axes, mesh, _CURRENT["mode"])
    spec = P(*((row_axes(n) or None) if ax == "batch" else e
               for n, ax, e in zip(x.shape, axes, spec)))
    return x.redistribute(mesh, placements(_fit(x.shape, spec, mesh), mesh))


def local_pair(dst, src):
    """(dst, src) ready for an in-place write of src into dst: where dst is
    a `DTensor`, its local shard and src's local shard laid out as dst (a
    plain src counts as replicated; src has dst's rank and dims); plain
    tensors as they are."""
    if not isinstance(dst, DTensor):
        return dst, src
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, dst.placements)
    return dst.to_local(), src.to_local()


def batch_head_entries(batch: int, *heads: int):
    """(batch entry, heads entry) of a spec on the current mesh for a
    tensor of ``batch`` rows and ``heads`` heads (each count given must
    divide): the batch dims the rows lie over (`row_axes`: all of them
    where the rows divide them, the reference's shard_map specs, else the
    largest set they divide), ``model`` where every head count divides
    it; None where not. The batch entry is also the set of mesh dims over
    which a weight's gradient is a partial sum: ranks that share rows
    (the ``pod`` ranks of a batch the rows lie whole over) see the same
    gradient."""
    if _CURRENT["mesh"] is None:
        return None, None
    m = mesh_axes(_CURRENT["mesh"]).get("model")
    return (row_axes(batch) or None,
            "model" if m and all(h % m == 0 for h in heads) else None)


def row_axes(batch: int, mesh=None) -> tuple:
    """The batch dims of ``mesh`` (default: the current mesh) that
    ``batch`` rows lie over: all of them where the rows divide them (the
    reference's rule), else the largest set of them that the rows divide,
    ``data`` rather than ``pod`` where two are as large (a pod's ranks
    gather the parameters and reduce the gradients among themselves), so
    that ranks share the work of a batch the reference's rule leaves
    whole (llava's and mixtral's 16-row microbatch on the 2 × 16 × 16
    mesh: over ``data``, whole over ``pod``); () where none divides or
    without a mesh."""
    mesh = _CURRENT["mesh"] if mesh is None else mesh
    axes = mesh_axes(mesh)
    dims = batch_axes(mesh)

    def size(sub):
        return int(np.prod([axes[a] for a in sub]))
    subs = [sub for k in range(len(dims) + 1)
            for sub in itertools.combinations(dims, k)
            if batch % size(sub) == 0]
    return max(subs, key=lambda sub: (size(sub), "data" in sub, len(sub)))


def axis_group(axis: str):
    """(group, this rank's coordinate) of the current mesh's ``axis``, the
    group as functional collectives take it; (None, 0) without a mesh or
    where the axis has one rank (nothing to reduce)."""
    mesh = _CURRENT["mesh"]
    axes = mesh_axes(mesh)
    if axes.get(axis, 1) == 1:
        return None, 0
    return (mesh, list(axes).index(axis)), mesh.get_local_rank(axis)


def spec_placements(*entries) -> tuple:
    """`placements` of ``P(*entries)`` on the current mesh (none without
    one)."""
    if _CURRENT["mesh"] is None:
        return ()
    return placements(P(*entries), _CURRENT["mesh"])


def whole_last_dim(x, unless: int = 0):
    """A DTensor split along its last dim, gathered along it (its other
    placements kept; with ``unless`` > 0 only over the mesh dims whose
    size does not divide ``unless``); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim in (last, -1)
          and (not unless or unless % x.device_mesh.size(i)) else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def split_last(x, n: int, d: int):
    """x (..., n·d) viewed as (..., n, d). A DTensor split along its last
    dim over a mesh dim whose size does not divide n is gathered along it
    first (a view cannot split such a shard; GSPMD gathers implicitly)."""
    x = whole_last_dim(x, unless=n)
    return x.reshape(*x.shape[:-1], n, d)


def split_cols(x, sizes):
    """`torch.split(x, sizes, dim=-1)`; a DTensor split along its last dim
    is gathered along it first (DTensor would otherwise move the shard to
    another dim to cut the pieces)."""
    return torch.split(whole_last_dim(x), sizes, dim=-1)


def merge_last(x):
    """x (..., n, d) viewed as (..., n·d). On a DTensor the view runs on
    each rank's local shard (the last dim gathered first if split), so
    the gradient comes back laid out as the merged output and its own
    split never meets a dim split over a mesh dim that does not divide
    the heads."""
    x = whole_last_dim(x)
    pl = tuple(getattr(x, "placements", ()))
    return local_call(
        lambda t: t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1]), (x,),
        (pl,), pl)


def grad_partial(specs: tuple, axes) -> tuple:
    """``specs`` with a Partial sum on each mesh dim named in ``axes``: the
    layout of the gradient of an input that the ranks on those dims each
    see part of."""
    names = mesh_axes(_CURRENT["mesh"])
    return tuple(Partial() if a in axes else p for a, p in zip(names, specs))


def local_call(fn, args, in_specs, out_specs, grad_specs=None):
    """``fn`` on each rank's local shards of ``args`` (`local_map` on the
    current mesh, the reference's shard_map): each arg redistributed to its
    ``in_specs`` placements first (a plain tensor counts as replicated),
    the outputs DTensors of ``out_specs``; an arg's gradient is laid out
    by its ``grad_specs`` entry (default: its ``in_specs``; a Partial
    where ranks holding copies of an input each see part of its
    gradient). Without a DTensor among ``args``, ``fn(*args)`` as it is
    (the specs are then empty: every spec helper here reads no dims
    without a mesh). The models hand the kernels their inputs through
    here."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor.placement_types import Placement
    mesh = _CURRENT["mesh"]
    args = tuple(a if isinstance(a, DTensor) or not torch.is_tensor(a)
                 else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False) for a in args)
    if out_specs and isinstance(out_specs[0], Placement):
        out_specs = list(out_specs)          # one output
    return local_map(fn, out_placements=out_specs, in_placements=in_specs,
                     in_grad_placements=grad_specs or in_specs,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def weight_products(fn, x, weights: tuple, kinds: tuple):
    """``fn(x, *weights)``, a chain of products of an activation x (B,
    ..., k) by weights, on each rank's own rows (the reference's Megatron
    layout) where x or a weight is a DTensor; ``fn(x, *weights)`` as it is
    otherwise. ``kinds[i]`` says how weight i is split over ``model``:
    "cols" along its last dim (column-parallel: its product split along
    that dim), "rows" along its first (row-parallel: its product a
    partial sum over ``model``), as `_PARAM_RULES` lays out its `mlp` /
    `ssm_inner` dim; every such dim must divide ``model``, else all are
    whole over it. x's rows lie over `row_axes` (the batch dims where
    they divide them: no rank multiplies more rows than its batch shard),
    x's last dim split over ``model`` if the first weight is "rows", else
    whole; every weight is gathered on its FSDP dim.
    The result has x's rows and is split over ``model`` along its last
    dim if the last weight is "cols", else a partial sum over it. x's
    gradient is a partial sum over ``model`` where the first weight is
    "cols" (each rank sees its columns' share), the weights' over the
    batch dims (each rank sees its rows' share)."""
    if not isinstance(x, DTensor) and not any(isinstance(w, DTensor)
                                              for w in weights):
        return fn(x, *weights)
    split = [w.shape[-1] if k == "cols" else w.shape[0]
             for w, k in zip(weights, kinds)]
    b, m = batch_head_entries(x.shape[0], *split)
    b_dims = b or ()
    pl = spec_placements
    lead = (b,) + (None,) * (x.dim() - 2)
    tp = ("model",) if m else ()
    ws = tuple(pl(*(None,) * (w.dim() - 1), m) if k == "cols"
               else pl(m, *(None,) * (w.dim() - 1))
               for w, k in zip(weights, kinds))
    if kinds[0] == "cols":
        xs = pl(*lead, None)
        xg = grad_partial(xs, tp)
    else:
        xs = xg = pl(*lead, m)
    out = (pl(*lead, m) if kinds[-1] == "cols"
           else grad_partial(pl(*lead, None), tp))
    return local_call(fn, (x, *weights), (xs, *ws), out,
                      (xg, *(grad_partial(s, b_dims) for s in ws)))


# ---------------------------------------------------------------------------
# Parameter sharding (path-based)
# ---------------------------------------------------------------------------
# rule: regex on the param path → logical axes of the (unstacked) weight.
# Stacked (scan-over-layers) weights get a leading None automatically — the
# walker inserts it when the array rank exceeds the rule length.

_PARAM_RULES = [
    # embeddings / heads
    (r"embed",            ("vocab", "fsdp")),
    (r"lm_head",          ("fsdp", "vocab")),
    (r"pos_embed",        (None, "fsdp")),
    # attention (column-parallel qkv, row-parallel o)
    (r"\bwq\b|\bwk\b|\bwv\b", ("fsdp", "heads", None)),
    (r"\bwo\b",           ("heads", None, "fsdp")),
    (r"q_norm|k_norm",    (None,)),
    # dense MLP (column-parallel in, row-parallel out)
    (r"w_gate|w_up|w_in", ("fsdp", "mlp")),
    (r"w_down|w_out",     ("mlp", "fsdp")),
    # MoE: experts-parallel over `model`
    (r"router",           ("fsdp", None)),
    (r"moe_gate|moe_up",  ("experts", "fsdp", None)),
    (r"moe_down",         ("experts", None, "fsdp")),
    # Mamba2 / xLSTM inner projections
    (r"in_proj|ssm_in",   ("fsdp", "ssm_inner")),
    (r"out_proj|ssm_out", ("ssm_inner", "fsdp")),
    (r"conv_w",           (None, "ssm_inner")),
    (r"conv_b|dt_bias|A_log|\bD\b", ("ssm_inner",)),
    (r"mlstm_|slstm_",    ("fsdp", "ssm_inner")),
    # norms, biases, scalars
    (r"norm|scale|bias",  (None,)),
]


def experts_shardable(n_experts: int, mesh=None) -> bool:
    """True when the expert count divides the model dim (moonshot 64e →
    EP16); otherwise experts replicate over `model` and d_ff is TP-sharded
    instead (mixtral 8e)."""
    if mesh is None:
        mesh = _CURRENT["mesh"]
    if mesh is None:
        return False
    axes = mesh_axes(mesh)
    return "model" in axes and n_experts % axes["model"] == 0


def _spec_for_path(path: str, shape: tuple, mesh, mode: str) -> PartitionSpec:
    ndim = len(shape)
    rules = list(_PARAM_RULES)
    # MoE fallback: experts that don't divide the model dim shard d_ff.
    if re.search(r"moe_gate|moe_up|moe_down", path) and ndim >= 3:
        if not experts_shardable(shape[-3], mesh):
            rules = [(r"moe_gate|moe_up", (None, "fsdp", "mlp")),
                     (r"moe_down", (None, "mlp", "fsdp"))] + rules
    for pat, axes in rules:
        if re.search(pat, path):
            axes = tuple(axes)
            if len(axes) < ndim:           # stacked layers / extra leading dims
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[-ndim:] if ndim > 0 else ()
            return _fit(shape, _logical_to_spec(axes, mesh, mode), mesh)
    return P()                              # replicate by default


def _path_str(path: Sequence[Any]) -> str:
    """A tree path (dict keys, field names, sequence indices) as the
    reference names it: the keys joined with "/", indices as digits."""
    return "/".join(str(k) for k in path)


def param_specs(params: Any, mesh, mode: str = "train") -> Any:
    """`PartitionSpec` tree for a parameter tree (leaves with a ``shape``),
    named as the reference names its paths (`interop.tree_named_leaves`)."""
    return tree_unflatten(params, [
        _spec_for_path(name, tuple(leaf.shape), mesh, mode)
        for name, leaf in tree_named_leaves(params)])


def spec_leaves(specs: Any) -> List[PartitionSpec]:
    """The specs of a `param_specs` tree in leaf order (a spec is a tuple,
    so `interop.tree_leaves` would walk into it)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in spec_leaves(v)]
    return []


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim in mesh
    order: `Shard(d)` where tensor dim d names the mesh dim, else
    `Replicate()`."""
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(params: Any, mesh, mode: str = "train") -> Any:
    """Each leaf's DTensor placements on ``mesh`` (the reference returns
    `NamedSharding`s)."""
    specs = param_specs(params, mesh, mode)
    return tree_unflatten(params, [placements(s, mesh)
                                   for s in spec_leaves(specs)])


# ---------------------------------------------------------------------------
# TP divisibility resolution (head padding / KV replication)
# ---------------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resolve_heads(n_heads: int, n_kv: int, tp: int):
    """(padded_q_heads, effective_kv_heads) for TP degree `tp`.

    Two schemes are compared and the cheaper one (fewest Q heads, then
    fewest KV replicas) is chosen:

    * **Group padding (A)**: pad each GQA group to a common size q' so that
      hq = n_kv·q' is a multiple of tp; KV heads are replicated by the
      smallest factor r | q' such that n_kv·r divides by tp.
    * **Full expansion (B)**: hq = round_up(n_heads, tp), one kv replica per
      q head.
    """
    if tp <= 1:
        return n_heads, n_kv
    q_per = -(-n_heads // n_kv)
    qa = q_per
    while (n_kv * qa) % tp:
        qa += 1
    hq_a = n_kv * qa
    r_a = next(r for r in range(1, qa + 1)
               if qa % r == 0 and (n_kv * r) % tp == 0)
    kv_a = n_kv * r_a
    hq_b = _round_up(n_heads, tp)
    kv_b = hq_b
    if (hq_a, kv_a) <= (hq_b, kv_b):
        return hq_a, kv_a
    return hq_b, kv_b


def kv_head_map(n_heads: int, n_kv: int, hq: int, kv_eff: int) -> np.ndarray:
    """Original kv-head index serving each *expanded* kv slot.

    Scheme A (hq % n_kv == 0, kv_eff % n_kv == 0): slot j → j // r.
    Scheme B (kv_eff == hq): slot j (== q slot) → original GQA assignment.
    """
    if hq % n_kv == 0 and kv_eff % n_kv == 0 and kv_eff < hq:
        r = kv_eff // n_kv
        return np.asarray([j // r for j in range(kv_eff)], dtype=np.int32)
    base = [(i * n_kv) // n_heads for i in range(n_heads)]
    base += [base[-1]] * (kv_eff - n_heads)      # padded heads reuse the last
    return np.asarray(base, dtype=np.int32)

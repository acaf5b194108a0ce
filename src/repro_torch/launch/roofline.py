"""Roofline of one step from what the step runs: no hardware needed.

Port of `repro.launch.roofline`. The reference reads the compiled HLO
(`analyze_hlo`: dot flops, fusion-level bytes and collectives with their
loop trip counts). The port has no compiler and no HLO: it runs the step
(on fake tensors, in the dry run) under `StepCounter`, a
`TorchDispatchMode` that sees every op each rank runs on its local
shards, in the order it runs them, so loops need no trip counts:

  * flops: `torch.utils.flop_counter`'s formulas on local shapes (per
    rank), the hand-written kernels' own (`kernels.flash_attn`,
    `kernels.slstm`: causal where causal, each an opaque op);
  * HBM bytes: Σ (operand + result bytes) of every op that moves data (not
    the views, allocations and metadata queries): the eager, no-fusion
    model, which is how the port runs;
  * temporaries: a made tensor's bytes from its op until no tensor on
    its storage is left (a view, or the buffer a collective's wait
    returns, holds it);
  * not counted: the runs DTensor makes of an op on fake tensors of the
    global shape to derive its output's shape (the first time it meets
    the op's schema): no rank runs them;
  * matrix products: each local `mm` / `bmm` / `addmm` / `baddbmm` by
    its operands' shapes (`products`), so a step's largest product, and
    whether a rank multiplies more rows than its own, can be read;
  * collectives: each functional collective (`_c10d_functional.*`) with
    its group size, into the reference's ring model (per-rank bytes
    moved: all-gather (n−1)·operand, all-reduce 2(n−1)/n·operand,
    reduce-scatter and all-to-all (n−1)/n·operand, a permute its
    operand). On a "cpu" mesh DTensor makes a shard-to-shard move of an
    all-gather and a chunk (gloo has no all-to-all); the counter counts
    such a move as the all-to-all the card's NCCL would run.

The HLO parser (`analyze_hlo`, `parse_collectives`, `from_compiled`) has
no counterpart: there is no HLO to parse.

Terms (seconds, per step, per rank), for an NVIDIA H100 SXM5 80GB
(NVIDIA's H100 Tensor Core GPU datasheet):
  compute    = flops / PEAK_FLOPS     (dense bf16 tensor cores, 989 TFLOP/s)
  memory     = hbm_bytes / HBM_BW     (HBM3, 3.35 TB/s)
  collective = ring_bytes / ICI_BW    (NVLink 4: 900 GB/s a GPU, both
                                       directions; 450 GB/s each way)
"""
from __future__ import annotations

import dataclasses
import heapq
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 datasheet: HBM3 bandwidth and
# the dense (no sparsity) tensor-core peaks by operand type; fp32 is the
# non-tensor FP32 rate
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_PER_CHIP = 80e9              # bytes of HBM3 a card
PEAK_FLOPS = PEAK_OPS_S["bf16"]  # FLOP/s a card
HBM_BW = HBM_BYTES_S             # bytes/s a card
ICI_BW = 450e9                   # NVLink bytes/s a card, each direction
PEAK_LIVE = 6                    # tensors `StepCounter` names at its peak
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")   # the local matrix products


@dataclasses.dataclass
class CollectiveStats:
    op_bytes: Dict[str, int]          # op kind → Σ operand bytes (per chip)
    ring_bytes: Dict[str, float]      # op kind → ring-model bytes moved/chip
    count: Dict[str, int]

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.op_bytes.values())

    @property
    def total_ring_bytes(self) -> float:
        return sum(self.ring_bytes.values())


def ring_bytes(kind: str, operand_bytes: float, n: int) -> float:
    """Bytes one rank moves for one collective of ``kind`` over ``n``
    ranks on an operand of ``operand_bytes`` (the reference's ring
    model)."""
    if kind == "all-gather":
        return operand_bytes * (n - 1)
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (n - 1) / n
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * (n - 1) / n
    return float(operand_bytes)               # collective-permute


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-chip flops
    hbm_bytes: float             # per-chip bytes accessed
    coll: CollectiveStats
    n_chips: int
    model_flops: float = 0.0     # 6·N·D (global, useful work)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll.total_ring_bytes / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-chip flops × chips) — remat/pad waste."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        total = self.n_chips * PEAK_FLOPS * self.t_step
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_operand_bytes": self.coll.total_operand_bytes,
            "collective_ring_bytes": self.coll.total_ring_bytes,
            "collective_ops": self.coll.count,
            "collective_ring_bytes_by_op": self.coll.ring_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_step_s": self.t_step,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
        }


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_active_params * tokens


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_COLLECTIVES = (("all_gather", "all-gather"), ("reduce_scatter",
                                               "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("broadcast", "collective-permute"),
                ("send", "collective-permute"),
                ("recv", "collective-permute"))
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "wait_tensor",
               "_local_scalar_dense", "is_same_size", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset", "dim"}


def _tensors(*trees) -> list:
    """The tensors among ``trees`` (lists, tuples, dicts of them)."""
    out: list = []
    for t in trees:
        _add_tensors(t, out)
    return out


def _add_tensors(x, out: list) -> None:
    # a module-level walk: a recursive closure would make a reference
    # cycle that keeps the tensors (and the peak estimate) alive
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _add_tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _add_tensors(y, out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The group size of a functional collective: its ``group_size``
    argument, else its group's size."""
    names = [a.name for a in func._schema.arguments]
    if "group_size" in names:
        return int(args[names.index("group_size")])
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = args[names.index("group_name")]
    if isinstance(group, str):
        group = _resolve_process_group(group)
    return group.size()


class StepCounter(TorchDispatchMode):
    """Counts, per rank, the flops (`flops`, and by op in `flops_by_op`,
    keyed "namespace.op"), HBM bytes and collectives of the ops
    run under it (see the module docstring), and the peak bytes of the
    tensors those ops make that are alive at once (`peak_bytes`: the
    step's temporaries, its inputs not included), with the op that made
    the peak (`peak_op`) and the largest tensors live there (`peak_live`:
    (bytes, making op, shape, dtype), at most `PEAK_LIVE`), and how often
    each local matrix product ran (`products`: (op, operand shapes) →
    count). Ops on DTensors pass to DTensor, whose local ops come back
    here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.op_bytes: Dict[str, int] = {}
        self.ring: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_op = ""
        self.peak_live: list = []
        self.products: Dict[tuple, int] = {}
        self._live: Dict[int, tuple] = {}
        self._refs: Dict[int, int] = {}
        self._key_of: Dict[int, int] = {}
        self._stores: Dict[int, list] = {}
        self._made = 0
        self.n_ops = 0
        self._muted = 0
        self._patched = None

    # -- collectives ---------------------------------------------------
    def _collective(self, kind: str, operand_bytes: int, n: int) -> None:
        self.op_bytes[kind] = self.op_bytes.get(kind, 0) + operand_bytes
        self.count[kind] = self.count.get(kind, 0) + 1
        self.ring[kind] = self.ring.get(kind, 0.0) + ring_bytes(
            kind, operand_bytes, n)

    def _alltoall(self, orig):
        """DTensor's shard-to-shard move, counted as one all-to-all of its
        input over the mesh dim (its ops inside are not counted again)."""
        def move(input, gather_dim, shard_dim, mesh, mesh_dim):
            n = mesh.size(mesh_dim)
            nbytes = _nbytes(input)
            self._collective("all-to-all", nbytes, n)
            self.hbm_bytes += 2 * nbytes
            self._muted += 1
            try:
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._muted -= 1
        return move

    def _silent(self, orig):
        """``orig`` with this counter muted while it runs."""
        def run(*args, **kwargs):
            self._muted += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._muted -= 1
        return run

    def __enter__(self):
        from torch.distributed.tensor import placement_types as pt
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._patched = []
        orig = getattr(pt, "shard_dim_alltoall", None)
        if orig is not None:
            self._patched.append((pt, "shard_dim_alltoall", orig))
            pt.shard_dim_alltoall = self._alltoall(orig)
        # DTensor derives an op's output shape by running it once on fake
        # tensors of the global shape (the first time it sees the op's
        # schema): no rank runs that op
        name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(ShardingPropagator, n)), None)
        if name is not None:
            orig = getattr(ShardingPropagator, name)
            self._patched.append((ShardingPropagator, name, orig))
            setattr(ShardingPropagator, name, self._silent(orig))
        return super().__enter__()

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._patched or ()):
            setattr(owner, name, orig)
        self._patched = None
        return super().__exit__(*exc)

    # -- memory ----------------------------------------------------------
    # A tensor's bytes stay live while any tensor on its storage lives: a
    # view, or the result of a collective's `wait_tensor` (the same buffer
    # on the card; a new one under FakeTensorMode), holds its base. A key's
    # storages are held until the key is freed: a storage that died while
    # its key lived (a collective's own result once its wait returned) would
    # leave its address to the next storage made there, which would then
    # pass for a view of the key, its bytes uncounted.
    def _track(self, t: torch.Tensor, op: str) -> None:
        key = self._key_of.get(t.untyped_storage()._cdata)
        if key is None:
            key = self._made = self._made + 1
            n = _nbytes(t)
            self._stores[key] = []
            self._refs[key] = 0
            self._live[key] = (n, op, tuple(t.shape), str(t.dtype)[6:])
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                self.peak_op = op
                self.peak_live = heapq.nlargest(PEAK_LIVE, self._live.values())
        self._hold(t, key)

    def _hold(self, t: torch.Tensor, key: int) -> None:
        st = t.untyped_storage()
        if st._cdata not in self._key_of:
            self._key_of[st._cdata] = key
            self._stores[key].append(st)
        self._refs[key] += 1
        weakref.finalize(t, self._free, key)

    def _free(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            for st in self._stores.pop(key):
                del self._key_of[st._cdata]
            self.live_bytes -= self._live.pop(key)[0]

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs its local ops here
        out = func(*args, **kwargs)
        if self._muted:
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        ins, outs = _tensors(args, kwargs), _tensors(out)
        if packet in self._flop_registry:
            f = self._flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            key = f"{func.namespace}.{name}"
            self.flops_by_op[key] = self.flops_by_op.get(key, 0.0) + f
        if name in PRODUCTS:
            key = (name, tuple(tuple(t.shape) for t in ins))
            self.products[key] = self.products.get(key, 0) + 1
        if func.namespace == "_c10d_functional":
            for key, kind in _COLLECTIVES:
                if key in name:
                    self._collective(kind, sum(_nbytes(t) for t in ins),
                                     _group_size(func, args))
                    break
        returns = func._schema.returns
        aliased = bool(returns) and all(r.alias_info is not None
                                        for r in returns)
        if name in _NO_TRAFFIC or (aliased and not func._schema.is_mutable):
            for t in outs:                 # an alias keeps its base alive
                key = self._key_of.get(t.untyped_storage()._cdata)
                if key is None and name == "wait_tensor":
                    key = self._key_of.get(ins[0].untyped_storage()._cdata)
                if key is not None:
                    self._hold(t, key)
            return out                     # a view, allocation or query
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        if not aliased:
            for t in outs:
                self._track(t, f"{func.namespace}.{name}")
        return out

    def products_by_size(self) -> list:
        """Every product counted: (op, operand shapes, count), the largest
        operand first."""
        def size(item):
            return max(int(torch.Size(s).numel()) for s in item[0][1])
        return [(op, shapes, c) for (op, shapes), c in
                sorted(self.products.items(), key=size, reverse=True)]

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.op_bytes), dict(self.ring),
                               dict(self.count))

    def roofline(self, n_chips: int, model_fl: float = 0.0) -> Roofline:
        return Roofline(flops=self.flops, hbm_bytes=self.hbm_bytes,
                        coll=self.collectives(), n_chips=n_chips,
                        model_flops=model_fl)


def count_step(fn, *args, n_chips: int = 1, model_fl: float = 0.0,
               counter: Optional[StepCounter] = None):
    """Run ``fn(*args)`` under a `StepCounter`; returns (its result, the
    counter's `Roofline`, the counter)."""
    counter = counter or StepCounter()
    with counter:
        out = fn(*args)
    return out, counter.roofline(n_chips, model_fl), counter

"""Checkpointing: atomic, keep-k, one directory layout with the reference.

Port of `repro.checkpoint.manager.CheckpointManager`. A checkpoint is
``step_XXXXXXXX/`` holding one ``.npy`` per leaf and ``manifest.json``
({"step", "arrays": {name: {"file", "shape", "dtype"}}, "extra"}); leaf
names are the reference's `_path_str` of the saved tree
(`interop.tree_named_leaves`: for the trainer's ``(params, opt_state)``,
``0/layers/attn/wq``, ``1/step``, ``1/mu/embed``), and a file is the name
with ``/`` → ``__``. Writes go to
``step_XXXXXXXX.tmp/`` and are published by one rename; keep_k old steps
are removed after the new one is durable.

bfloat16: numpy has no bf16 type without ``ml_dtypes``, which the card's
host lacks, so a bf16 leaf is stored as its uint16 bit pattern, with
``"dtype": "bfloat16"`` in the manifest; restore reads those bits back
(also from a ``.npy`` that holds them as 2-byte void records). Every other
leaf is stored as numpy stores its type, so a float32 checkpoint written by
the reference restores here leaf for leaf, and the reverse.

Mesh-agnostic, as the reference: a leaf is saved as its LOGICAL (whole)
tensor, so a `DTensor` leaf is gathered first, in a collective every rank
of the world joins. How it gathers depends on the backend and the leaf's
device (`launch.mesh.stages_through_host`), never on a caught error:
- NCCL, or a CPU mesh on any backend: `full_tensor()`, DTensor's own
  all-gather on the leaf's device;
- a CUDA mesh on any other backend (gloo, which cannot all-gather CUDA
  tensors: torch 2.11's crashed every rank) through the host
  (`gather_through_host`): each rank's `to_local()` shard is copied to
  the host, the CPU shards and their global offsets are gathered with
  `all_gather_object`, and the writer pastes each shard at its offset
  (for each mesh dimension, `Shard(d)` cuts as `torch.chunk` does, so
  the last shards may be short or empty; `Replicate` takes any one
  copy). The bytes are those `full_tensor()` gives.
A `Partial` placement raises ValueError naming the leaf: parameters and
optimizer state are never partial sums. In an initialized
`torch.distributed` world every rank calls `save` and rank 0 alone
writes; the others wait for the publish at a barrier.
``restore(..., mesh=, specs=)`` hands every leaf to `distribute_tensor`
with the placements of its spec on the NEW mesh, each rank cutting its
shard from the file it read (no collective): an elastic restart (4 ranks
→ 2, or one pod → two) is a restore, not a migration tool.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..interop import tree_named_leaves, tree_unflatten
from ..launch.mesh import stages_through_host
from ..parallel.sharding import placements, spec_leaves


def _shard_box(shape, mesh, places, coord
               ) -> Tuple[List[int], List[int]]:
    """(global offset, local shape) of the shard at mesh coordinate
    ``coord``: for each mesh dimension in order, `Shard(d)` cuts what is
    left of dim d as `torch.chunk` does (chunks of ceil(n / k); the last
    ones short or empty), `Replicate` leaves it whole."""
    offset, size = [0] * len(shape), list(shape)
    for i, place in enumerate(places):
        if place.is_shard():
            d = place.dim % len(shape)
            k = mesh.size(i)
            chunk = -(-size[d] // k)
            start = min(coord[i] * chunk, size[d])
            offset[d] += start
            size[d] = min(start + chunk, size[d]) - start
    return offset, size


def _check_placements(t, name: str) -> None:
    for place in t.placements:
        if place.is_partial():
            raise ValueError(
                f"{name}: a DTensor with a Partial placement "
                f"({tuple(t.placements)}) holds partial sums, not a "
                f"checkpointable tensor; reduce it first")


def gather_through_host(t, name: str = "leaf") -> torch.Tensor:
    """The logical tensor of DTensor ``t`` as a CPU tensor, gathered
    through host memory: every rank of the world calls this (each sends
    its CPU shard and global offset with `all_gather_object`, a rank
    outside ``t``'s mesh sends nothing) and every rank gets the whole
    tensor, equal bitwise to ``t.full_tensor()``."""
    _check_placements(t, name)
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    piece = None
    if coord is not None:
        local = t.to_local().detach().cpu()
        offset, size = _shard_box(tuple(t.shape), mesh, t.placements, coord)
        if list(local.shape) != size:
            raise ValueError(f"{name}: local shard {tuple(local.shape)} at "
                             f"{coord} is not the {tuple(size)} that "
                             f"{tuple(t.placements)} cut from "
                             f"{tuple(t.shape)}")
        piece = (offset, local)
    pieces = [None] * dist.get_world_size()
    dist.all_gather_object(pieces, piece)
    out = torch.empty(tuple(t.shape), dtype=t.dtype)
    for got in pieces:
        if got is not None:
            offset, local = got
            out[tuple(slice(o, o + n) for o, n
                      in zip(offset, local.shape))] = local
    return out


def _gathers_through_host(t) -> bool:
    """Whether DTensor ``t`` is gathered through the host: a CUDA leaf
    in a world whose backend is not NCCL
    (`launch.mesh.stages_through_host`)."""
    return stages_through_host(None, t.device)


def _to_numpy(leaf: Any, name: str = "leaf") -> Tuple[np.ndarray, str]:
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            if _gathers_through_host(t):
                t = gather_through_host(t, name)
            else:
                _check_placements(t, name)
                t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _writer() -> bool:
    """Whether this process writes: the only one, or rank 0 of a world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the host."""
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_k: int = 3

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None
             ) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        write = _writer()
        if write:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)

        manifest: Dict[str, Any] = {"step": step, "arrays": {},
                                    "extra": extra or {}}
        for name, leaf in tree_named_leaves(tree):
            arr, dtype_name = _to_numpy(leaf, name)  # every rank joins
            fname = name.replace("/", "__") + ".npy"
            if write:
                np.save(tmp / fname, arr)
            manifest["arrays"][name] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
        if write:
            (tmp / "manifest.json").write_text(json.dumps(manifest,
                                                          indent=2))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                  # atomic publish
            self._gc()
        if dist.is_initialized():
            dist.barrier()                     # published before any reads
        return final

    # -- restore ------------------------------------------------------------

    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device: Optional[DeviceLike] = None, mesh=None,
                specs: Any = None) -> Any:
        """Restore into the structure of ``tree_like``: each leaf takes its
        template's type, and lands on ``device`` (default: the template
        leaf's device).

        With ``mesh`` (a `DeviceMesh`; every rank of the world calls this)
        each leaf becomes a `DTensor` on the mesh's device type, placed by
        its spec in ``specs`` (a `parallel.sharding.param_specs` tree;
        without it, replicated): the elastic reshard-on-restore path.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        src = self.dir / f"step_{step:08d}"
        manifest = json.loads((src / "manifest.json").read_text())
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor
            dev = _mesh_device(mesh)
            spec_flat = spec_leaves(specs) if specs is not None else None
        else:
            dev = resolve_device(device) if device is not None else None
        out = []
        for i, (name, leaf) in enumerate(tree_named_leaves(tree_like)):
            meta = manifest["arrays"][name]
            t = _to_tensor(np.load(src / meta["file"]), meta["dtype"])
            if tuple(t.shape) != tuple(meta["shape"]):
                raise ValueError(f"{name}: file holds {tuple(t.shape)}, "
                                 f"manifest says {tuple(meta['shape'])}")
            if isinstance(leaf, torch.Tensor):
                t = t.to(dev or leaf.device, leaf.dtype)
            elif dev is not None:
                t = t.to(dev)
            if mesh is not None:
                place = (placements(spec_flat[i], mesh) if spec_flat
                         else None)
                t = distribute_tensor(t, mesh, place, src_data_rank=None)
            out.append(t)
        return tree_unflatten(tree_like, out)

    def extra(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        src = self.dir / f"step_{step:08d}"
        return json.loads((src / "manifest.json").read_text())["extra"]

    # -- gc -----------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_k]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

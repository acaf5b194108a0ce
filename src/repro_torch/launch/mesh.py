"""Device meshes, and the ranks that hold them.

Port of `repro.launch.mesh`. The reference is a single controller: one
process builds a `jax.sharding.Mesh` over every device it sees. The port is
SPMD, the PyTorch idiom: each rank is a process, and the mesh is torch's own
`torch.distributed.device_mesh.DeviceMesh` over an initialized
`torch.distributed` world, with the dim names ("data", "model") single-pod
or ("pod", "data", "model") multi-pod ("pod" composes with "data" for batch
and FSDP sharding, `parallel.sharding`).

The sharding rules read a mesh only through `parallel.sharding.mesh_axes`,
so an `AbstractMesh` (names and sizes, no ranks) stands in for a
production mesh: the specs of a 16×16 or 2×16×16 mesh are computed without
a world of 256 processes.

`init_fake_world` stands a world of 256 or 512 ranks up in one process (torch's
fake process group: collectives return at once and move nothing), so that
`make_production_mesh(fake=True)` is a real `DeviceMesh` of the production
shape whose DTensors, under `FakeTensorMode`, hold no memory: what
`launch.dryrun` runs a cell on.

`run_ranks` starts a world of processes on this host (``spawn``, a
`FileStore` rendezvous in a temporary directory, so concurrent worlds never
share a port) and returns each rank's result. Its ranks run oneMKL in its
reproducible mode (`RANK_ENV`): without it, a rank of two or more intra-op
threads now and then computes its OpenMP worker's part of an MKL vector
function (ATen's ``exp`` of more than 2048 elements, through oneMKL's VM
``vmsExp``) to ~1e-4 relative accuracy instead of to its last bit, so the
same inputs gave results ~1e-5 apart from run to run.

Which path a tensor takes between ranks is decided once, here
(`stages_through_host`): NCCL moves CUDA tensors device to device; any
other backend (gloo, as on a host with one card, where NCCL refuses two
ranks on one GPU) gets CUDA tensors copied to the host and back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import pathlib
import tempfile
import time
import traceback
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

# the environment of `run_ranks`' processes (unless the caller's sets
# these): oneMKL's conditional numerical reproducibility on its portable
# code path; "AUTO" and MKL_DYNAMIC=FALSE do not stop the worker threads'
# inexact vector math
RANK_ENV = {"MKL_CBWR": "COMPATIBLE"}
# (shape, dim names) of the reference's production meshes
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim names and sizes without ranks: what the sharding rules
    read (`axis_names`, and `shape` as a name → size mapping, the duck type
    of `jax.sharding.Mesh` that the reference's rules read)."""
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]

    @classmethod
    def of(cls, shape: Sequence[int], axes: Sequence[str]) -> "AbstractMesh":
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and dim names "
                             f"{tuple(axes)} differ in length")
        return cls(tuple(axes), dict(zip(axes, (int(s) for s in shape))))


def _device_type(device_type: Optional[str]) -> str:
    """"cuda" unless the caller asks for "cpu" (raises without a card)."""
    return resolve_device(device_type or "cuda").type


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A `DeviceMesh` of ``shape`` named ``axes`` over the initialized world
    (`init_device_mesh`: the world's size must be the shape's product). The
    device type is "cuda" unless the caller asks for "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def init_fake_world(world: int) -> None:
    """Initialize the default process group as torch's fake group of
    ``world`` ranks, this process being rank 0: no peers, no transport,
    collectives complete at once (their outputs are uninitialized on real
    tensors, shapes only under `FakeTensorMode`). Raises if a world is
    already initialized; the caller destroys it
    (`dist.destroy_process_group`)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None,
                         fake: bool = False):
    """The reference's production mesh, (16, 16) ("data", "model") or
    (2, 16, 16) ("pod", "data", "model"): a `DeviceMesh` where the
    initialized world has that many ranks, else its `AbstractMesh`. With
    ``fake`` and no world initialized, first a fake world of that many
    ranks (`init_fake_world`; the caller destroys it), and the mesh is a
    "cpu" one unless ``device_type`` says otherwise."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    if fake:
        if not dist.is_initialized():
            init_fake_world(n)
        device_type = device_type or "cpu"
    if dist.is_initialized() and dist.get_world_size() == n:
        return make_mesh(shape, axes, device_type)
    return AbstractMesh.of(shape, axes)


def stages_through_host(group, device: torch.device) -> bool:
    """True where a tensor on ``device`` crosses ``group`` through host
    memory: a CUDA tensor on any backend but NCCL (gloo takes only CPU
    tensors for point-to-point and gathers)."""
    return device.type == "cuda" and dist.get_backend(group) != "nccl"


# ---------------------------------------------------------------------------
# a world of ranks on this host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, backend: str, store: str, out: str,
               fn: Callable, args: tuple) -> None:
    path = pathlib.Path(out)
    # the host's cores shared out: a rank's intra-op threads spinning on
    # another rank's cores slow every rank by an order of magnitude
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, path / f"rank{rank}.pt")
    except BaseException:
        (path / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


@contextlib.contextmanager
def _environ(values: Mapping[str, str]):
    """``values`` in `os.environ` where it has no such key (a spawned
    process copies the environment when it starts), restored after."""
    added = [k for k in values if k not in os.environ]
    os.environ.update({k: values[k] for k in added})
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def run_ranks(fn: Callable, world: int, args: tuple = (),
              backend: str = "gloo", timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``backend`` process group; each rank's return value, in rank
    order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable by `torch.save`; a rank chooses its own card
    (`torch.cuda.set_device`) and gets an equal share of the host's cores
    for its intra-op threads, and `RANK_ENV` in its environment. If a rank
    raises, exits non-zero or the world outlives ``timeout_s``, every rank
    still running is terminated and RuntimeError (TimeoutError) carries
    the first failure."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, backend, store, tmp, fn, tuple(args)))
            for r in range(world)]
        with _environ(RANK_ENV):
            for p in procs:
                p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
        for r, p in enumerate(procs):
            err = pathlib.Path(tmp, f"rank{r}.err")
            if err.exists():
                raise RuntimeError(f"rank {r} of {world} failed:\n"
                                   f"{err.read_text()}")
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {world} exited with "
                                   f"{p.exitcode}")
        return [torch.load(pathlib.Path(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]

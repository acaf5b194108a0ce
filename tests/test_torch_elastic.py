"""Port vs reference: the elastic restore (repro_torch.runtime.elastic),
`best_mesh` / `mesh_shape` (repro_torch.serve.fleet) and the mesh-aware
`CheckpointManager.restore`.

  * `mesh_shape` equals the shape of the reference's `best_mesh` on a grid
    of device counts and model-parallel degrees (devices ``[d] * n``, as
    tests/test_fleet.py does), and `best_mesh` raises as the reference's;
  * in a 4-rank gloo world of CPU processes: `best_mesh` builds
    ("data", "model") `DeviceMesh`es; the twin of
    tests/test_halo.py::test_elastic_reshard_restore saves a tree sharded
    on a (2, 2) mesh and restores it through `ElasticRestore` onto
    `best_mesh(n_devices=2, model_parallel=2)`: the full tensors equal,
    two local shards; a checkpoint written by the reference's
    `CheckpointManager` restores onto the mesh too;
  * in this process: that checkpoint restores leaf for leaf with no mesh,
    and the runtime's `best_mesh` is the fleet's.

The ranks import this module, which imports jax only inside the tests.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.parallel import sharding
from repro_torch.runtime import ElasticRestore
from repro_torch.runtime import best_mesh as runtime_best_mesh
from repro_torch.serve import best_mesh, mesh_shape

WORLD = 4


def _w_gate() -> torch.Tensor:
    return torch.arange(64, dtype=torch.float32).reshape(8, 8)


def _ref_tree():
    return {"layers": {"w_gate": np.arange(64, dtype=np.float32).reshape(
                8, 8),
                       "w_down": np.linspace(-1, 1, 48, dtype=np.float32
                                             ).reshape(6, 8)},
            "step": np.int32(7)}


def test_mesh_shape_equals_reference_best_mesh():
    import jax
    from repro.serve import best_mesh as jbest_mesh
    d = jax.devices()[0]
    for n in range(1, 13):
        for mp in (0, 1, 2, 3, 4, 5, 8, 16):
            want = jbest_mesh(n_devices=n, model_parallel=mp,
                              devices=[d] * n).devices.shape
            assert mesh_shape(n, mp) == want, (n, mp)


def test_best_mesh_errors_and_runtime_reexport():
    with pytest.raises(RuntimeError, match="no ranks"):
        best_mesh(device_type="cpu")               # no initialized world
    with pytest.raises(RuntimeError, match="no ranks"):
        best_mesh(ranks=[], device_type="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        best_mesh(n_devices=9, ranks=[0, 1, 2, 3], device_type="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        runtime_best_mesh(n_devices=5, ranks=[0, 1, 2, 3],
                          device_type="cpu")
    with pytest.raises(RuntimeError, match="no ranks"):
        runtime_best_mesh(ranks=[], device_type="cpu")


def _elastic_ranks(rank: int, world: int, save_dir: str,
                   ref_dir: str) -> dict:
    from torch.distributed.tensor import distribute_tensor
    out = {"meshes": {}}
    for n, mp in ((4, 4), (4, 2), (3, 4), (2, 2), (None, 0)):
        m = best_mesh(n_devices=n, model_parallel=mp, device_type="cpu")
        out["meshes"][(n, mp)] = (tuple(m.mesh_dim_names),
                                  tuple(m.shape), m.get_coordinate())
    # save on a (2, 2) mesh, every leaf a DTensor
    mesh4 = make_mesh((2, 2), ("data", "model"), "cpu")
    tree = {"layers": {"w_gate": _w_gate()}}
    specs = sharding.param_specs(tree, mesh4, "train")
    place = sharding.placements(specs["layers"]["w_gate"], mesh4)
    out["saved_placements"] = tuple(place)
    sharded = {"layers": {"w_gate": distribute_tensor(
        _w_gate(), mesh4, place)}}
    ckpt = CheckpointManager(save_dir, keep_k=2)
    ckpt.save(3, sharded)
    # restore onto a DIFFERENT mesh (2 ranks): elastic shrink
    mesh2 = best_mesh(n_devices=2, model_parallel=2, device_type="cpu")
    restored, step = ElasticRestore(ckpt).restore(tree, mesh2)
    w = restored["layers"]["w_gate"]
    out["step"] = step
    out["coord"] = mesh2.get_coordinate()
    out["local"] = w.to_local().numpy()
    out["placements"] = tuple(w.placements)
    if mesh2.get_coordinate() is not None:
        out["full"] = w.full_tensor().numpy()
    # the reference's checkpoint onto the (2, 2) mesh
    ref = CheckpointManager(ref_dir)
    template = {"layers": {"w_gate": torch.zeros(8, 8),
                           "w_down": torch.zeros(6, 8)},
                "step": torch.zeros((), dtype=torch.int32)}
    got, _ = ElasticRestore(ref).restore(template, mesh4)
    out["ref_local"] = {k: v.to_local().numpy()
                        for k, v in got["layers"].items()}
    out["ref_placements"] = {k: tuple(v.placements)
                             for k, v in got["layers"].items()}
    out["ref_full"] = {k: v.full_tensor().numpy()
                       for k, v in got["layers"].items()}
    out["ref_step"] = int(got["step"].full_tensor())
    return out


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    from repro.checkpoint import CheckpointManager as JCheckpointManager
    path = tmp_path_factory.mktemp("ref_ckpt")
    JCheckpointManager(str(path)).save(5, _ref_tree())
    return str(path)


@pytest.fixture(scope="module")
def elastic_world(tmp_path_factory, reference_checkpoint):
    save_dir = str(tmp_path_factory.mktemp("elastic"))
    return run_ranks(_elastic_ranks, WORLD, (save_dir, reference_checkpoint),
                     timeout_s=300)


def test_best_mesh_builds_device_meshes(elastic_world):
    for rank, out in enumerate(elastic_world):
        m = out["meshes"]
        assert m[(4, 4)][:2] == (("data", "model"), (1, 4))
        assert m[(4, 2)][:2] == (("data", "model"), (2, 2))
        assert m[(3, 4)][:2] == (("data", "model"), (3, 1))  # 4 → 2 → 1
        assert m[(2, 2)][:2] == (("data", "model"), (1, 2))
        assert m[(None, 0)][:2] == (("data", "model"), (4, 1))
        # a rank outside the mesh has no coordinate
        assert m[(3, 4)][2] == ((rank, 0) if rank < 3 else None)
        assert m[(2, 2)][2] == ((0, rank) if rank < 2 else None)


def test_elastic_reshard_restore(elastic_world):
    want = _w_gate().numpy()
    from torch.distributed.tensor import Shard
    assert elastic_world[0]["saved_placements"] == (Shard(0), Shard(1))
    shards = []
    for rank, out in enumerate(elastic_world):
        assert out["step"] == 3
        if rank < 2:                  # the two ranks of the new mesh
            assert out["coord"] == (0, rank)
            np.testing.assert_array_equal(out["full"], want)
            assert out["placements"] == (Shard(0), Shard(1))
            shards.append(out["local"])
        else:
            assert out["coord"] is None and out["local"].size == 0
    assert [s.shape for s in shards] == [(8, 4), (8, 4)]   # resharded
    np.testing.assert_array_equal(np.concatenate(shards, axis=1), want)


def test_reference_checkpoint_restores_on_a_mesh(elastic_world):
    from torch.distributed.tensor import Replicate, Shard
    ref = _ref_tree()
    for rank, out in enumerate(elastic_world):
        assert out["ref_step"] == 7
        for k in ("w_gate", "w_down"):
            np.testing.assert_array_equal(out["ref_full"][k],
                                          ref["layers"][k])
        # w_gate (8, 8): ("data", "model"); w_down (6, 8): ("model",
        # "data"), so the data mesh dim shards its dim 1
        assert out["ref_placements"]["w_gate"] == (Shard(0), Shard(1))
        assert out["ref_placements"]["w_down"] == (Shard(1), Shard(0))
        r, c = divmod(rank, 2)
        np.testing.assert_array_equal(
            out["ref_local"]["w_gate"],
            ref["layers"]["w_gate"][4 * r:4 * r + 4, 4 * c:4 * c + 4])
        assert Replicate() not in out["ref_placements"]["w_gate"]


def test_reference_checkpoint_restores_without_a_mesh(reference_checkpoint):
    template = {"layers": {"w_gate": torch.zeros(8, 8),
                           "w_down": torch.zeros(6, 8)},
                "step": torch.zeros((), dtype=torch.int32)}
    got = CheckpointManager(reference_checkpoint).restore(template)
    ref = _ref_tree()
    for k in ("w_gate", "w_down"):
        assert got["layers"][k].dtype == torch.float32
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      ref["layers"][k])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


# ---------------------------------------------------------------------------
# the host-staged gather of `CheckpointManager.save`
# ---------------------------------------------------------------------------

# (name, logical shape, placements on the (2, 2) mesh): uneven
# `torch.chunk` shards (7 = 4 + 3, then 2 + 2 / 2 + 1; 5 = 3 + 2), one
# Replicate dimension, a dim cut twice, and an empty last shard (1 = 1 + 0)
GATHER_CASES = (("shard0_rep", (7, 5), ("S0", "R")),
                ("rep_shard1", (7, 5), ("R", "S1")),
                ("shard0_twice", (7, 5), ("S0", "S0")),
                ("shard1_shard0", (7, 5), ("S1", "S0")),
                ("empty_shard", (1, 5), ("S0", "R")))


def _placement(code: str):
    from torch.distributed.tensor import Replicate, Shard
    return Replicate() if code == "R" else Shard(int(code[1]))


def _gather_tree():
    return {"w": torch.arange(35, dtype=torch.float32).reshape(7, 5) / 7,
            "b": (torch.arange(10, dtype=torch.float32) - 4.5).to(
                torch.bfloat16).reshape(2, 5),
            "n": torch.arange(6, dtype=torch.int32).reshape(3, 2)}


def _gather_ranks(rank: int, world: int, dirs: dict) -> dict:
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor

    from repro_torch.checkpoint import manager
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"gathered": {}}
    for name, shape, codes in GATHER_CASES:
        full = torch.arange(float(np.prod(shape))).reshape(shape) * 1.25 - 3
        t = distribute_tensor(full, mesh, [_placement(c) for c in codes])
        out["gathered"][name] = (
            manager.gather_through_host(t, name).numpy(),
            t.full_tensor().numpy(), tuple(t.to_local().shape))
    plain = _gather_tree()
    place = {"w": ("S0", "S1"), "b": ("R", "S1"), "n": ("S0", "R")}
    sharded = {k: distribute_tensor(v, mesh, [_placement(c)
                                              for c in place[k]])
               for k, v in plain.items()}
    CheckpointManager(dirs["plain"]).save(1, plain)
    CheckpointManager(dirs["full_tensor"]).save(1, sharded)
    manager._gathers_through_host = lambda t: True      # the CUDA-off-NCCL
    CheckpointManager(dirs["host"]).save(1, sharded)    # route, on the CPU
    partial = {"p": DTensor.from_local(torch.ones(2, 2), mesh,
                                       [Partial(), _placement("R")])}
    for route in ("host", "full_tensor"):
        manager._gathers_through_host = lambda t, r=route: r == "host"
        try:
            CheckpointManager(dirs["partial"]).save(2, partial)
            out[f"partial_{route}"] = None
        except ValueError as e:
            out[f"partial_{route}"] = str(e)
    return out


@pytest.fixture(scope="module")
def gather_world(tmp_path_factory):
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in
            ("plain", "full_tensor", "host", "partial")}
    return run_ranks(_gather_ranks, WORLD, (dirs,), timeout_s=300), dirs


@pytest.mark.parametrize("case", [c[0] for c in GATHER_CASES])
def test_host_gather_equals_full_tensor_bitwise(gather_world, case):
    world, _ = gather_world
    shape = dict((c[0], c[1]) for c in GATHER_CASES)[case]
    locals_ = []
    for out in world:
        got, want, local = out["gathered"][case]
        assert got.shape == shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
        locals_.append(local)
    if case == "empty_shard":
        assert sorted(locals_) == [(0, 5), (0, 5), (1, 5), (1, 5)]
    if case == "shard0_twice":
        assert sorted(locals_) == [(1, 5), (2, 5), (2, 5), (2, 5)]


@pytest.mark.parametrize("route", ["full_tensor", "host"])
def test_dtensor_save_equals_plain_save_file_for_file(gather_world, route):
    _, dirs = gather_world
    plain = sorted(pathlib.Path(dirs["plain"], "step_00000001").iterdir())
    got = pathlib.Path(dirs[route], "step_00000001")
    assert [p.name for p in plain] == sorted(p.name for p in got.iterdir())
    assert len(plain) == 4                     # three leaves + manifest
    for p in plain:
        assert (got / p.name).read_bytes() == p.read_bytes(), p.name


@pytest.mark.parametrize("route", ["full_tensor", "host"])
def test_partial_placement_raises_naming_the_leaf(gather_world, route):
    world, _ = gather_world
    for out in world:
        msg = out[f"partial_{route}"]
        assert msg is not None and msg.startswith("p:") and "Partial" in msg

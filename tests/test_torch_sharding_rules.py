"""Port vs reference: the logical-axis sharding rules
(repro_torch.parallel.sharding) and the production meshes
(repro_torch.launch.mesh).

  * twins of tests/test_sharding.py's mesh-rule tests, on the same fake
    mesh (`axis_names` and a `shape` mapping);
  * `param_specs` equals the reference's, path by path, for the parameter
    trees of the port's five configs (reduced) on the 16×16 and 2×16×16
    fake production meshes, in the train, serve and serve_fsdp modes;
  * `_logical_to_spec` equals the reference's for every logical axis;
  * `placements` of a few specs, `mesh_axes` of each mesh type, and
    `logical` on a DTensor in a one-rank gloo world.
"""
import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as tconfigs
from repro_torch.interop import tree_named_leaves
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry as treg
from repro_torch.parallel import sharding


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MODES = ("train", "serve", "serve_fsdp")


def test_moe_rule_fallback_logic():
    # 64 experts divide 16 → EP; 8 experts do not → d_ff TP
    assert sharding.experts_shardable(64, FakeMesh())
    assert not sharding.experts_shardable(8, FakeMesh())
    assert not sharding.experts_shardable(64)           # no mesh set


def test_spec_for_path_divisibility_guard():
    # odd vocab (51866) must NOT shard over model
    spec = sharding._spec_for_path("embed", (51866, 1280), FakeMesh(),
                                   "train")
    assert spec[0] is None and spec[1] == "data"
    # padded vocab shards
    spec = sharding._spec_for_path("embed", (51968, 1280), FakeMesh(),
                                   "train")
    assert spec[0] == "model"
    # mixtral stacked moe_gate: experts replicate, d_ff TP
    spec = sharding._spec_for_path("mu/layers/mlp/moe_gate",
                                   (56, 8, 6144, 16384), FakeMesh(), "train")
    assert tuple(spec) == (None, None, "data", "model")
    # moonshot stacked moe_gate: EP over model, fsdp over data
    spec = sharding._spec_for_path("layers/mlp/moe_gate",
                                   (48, 64, 2048, 1408), FakeMesh(), "train")
    assert tuple(spec) == (None, "model", "data", None)


def test_serve_mode_drops_fsdp():
    train = sharding._spec_for_path("layers/attn/wq", (24, 2048, 16, 128),
                                    FakeMesh(), "train")
    serve = sharding._spec_for_path("layers/attn/wq", (24, 2048, 16, 128),
                                    FakeMesh(), "serve")
    fsdp = sharding._spec_for_path("layers/attn/wq", (24, 2048, 16, 128),
                                   FakeMesh(), "serve_fsdp")
    assert train[1] == "data" and serve[1] is None and fsdp[1] == "data"
    assert train[2] == serve[2] == "model"


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    cfg = tconfigs.get_config(arch, reduced=True)
    return treg.build(cfg).init(torch.Generator().manual_seed(0), "cpu")


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    import jax
    from repro import configs as jconfigs
    from repro.models import registry as jreg
    model = jreg.build(jconfigs.get_config(arch, reduced=True))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _ref_specs(arch: str, mesh, mode: str) -> dict:
    import jax
    from jax.sharding import PartitionSpec
    from repro.parallel import sharding as jsharding
    specs = jsharding.param_specs(_ref_shapes(arch), mesh, mode)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
    return {jsharding._path_str(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", [FakeMesh, FakePodMesh],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_specs_equal_reference(arch, mesh, mode):
    params = _port_params(arch)
    specs = sharding.param_specs(params, mesh(), mode)
    names = [n for n, _ in tree_named_leaves(params)]
    got = dict(zip(names, map(tuple, sharding.spec_leaves(specs))))
    want = _ref_specs(arch, mesh(), mode)
    assert got == want
    assert {n: tuple(t.shape) for n, t in tree_named_leaves(params)} == \
        _ref_flat_shapes(arch)
    # a reduced model's dims rarely divide 16: something still shards
    assert any(any(e is not None for e in s) for s in got.values()) or \
        mode == "serve"


def _ref_flat_shapes(arch: str) -> dict:
    import jax
    from repro.parallel import sharding as jsharding
    flat, _ = jax.tree_util.tree_flatten_with_path(_ref_shapes(arch))
    return {jsharding._path_str(p): tuple(leaf.shape) for p, leaf in flat}


LOGICAL = ("batch", "seq_shard", "heads", "kv_heads", "mlp", "vocab",
           "experts", "ssm_inner", "model", "fsdp", "embed", "seq",
           "head_dim", None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", [FakeMesh, FakePodMesh],
                         ids=["16x16", "2x16x16"])
def test_logical_to_spec_equals_reference(mesh, mode):
    from repro.parallel import sharding as jsharding
    got = tuple(sharding._logical_to_spec(LOGICAL, mesh(), mode))
    assert got == tuple(jsharding._logical_to_spec(LOGICAL, mesh(), mode))
    assert sharding.batch_axes(mesh()) == jsharding.batch_axes(mesh())
    assert sharding.fsdp_axis(mesh()) == jsharding.fsdp_axis(mesh())


def test_path_str_names_paths_as_the_reference():
    import jax
    from repro.parallel import sharding as jsharding
    tree = {"layers": {"attn": {"wq": 0}}, "blocks": [{"w": 0}, {"w": 0}]}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [jsharding._path_str(p) for p, _ in flat]
    assert want == [n for n, _ in tree_named_leaves(tree)]
    assert [sharding._path_str(p.split("/")) for p in want] == want
    assert sharding._path_str(("blocks", 1, "w")) == "blocks/1/w"


def test_partition_spec_entries_match_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [(), (None,), (("data",), None), (("pod", "data"),
                                                     "model", None)]:
        assert tuple(sharding.P(*entries)) == tuple(JP(*entries))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements(sharding.P(), FakeMesh()) == (
        Replicate(), Replicate())
    assert sharding.placements(sharding.P("data", "model"), FakeMesh()) == (
        Shard(0), Shard(1))
    assert sharding.placements(sharding.P(None, "data", "model", None),
                               FakeMesh()) == (Shard(1), Shard(2))
    assert sharding.placements(sharding.P("model", None), FakeMesh()) == (
        Replicate(), Shard(0))
    # a tensor dim over ("pod", "data") is sharded on both mesh dims
    assert sharding.placements(sharding.P(("pod", "data"), None, "model"),
                               FakePodMesh()) == (Shard(0), Shard(0),
                                                  Shard(2))
    tree = {"layers": {"w_gate": torch.zeros(4, 32, 64)}}
    got = sharding.param_shardings(tree, FakeMesh(), "train")
    assert got["layers"]["w_gate"] == (Shard(1), Shard(2))


def test_mesh_axes_and_production_mesh():
    assert sharding.mesh_axes(FakeMesh()) == {"data": 16, "model": 16}
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert isinstance(pod, tmesh.AbstractMesh)        # no 512-rank world
    assert sharding.mesh_axes(pod) == {"pod": 2, "data": 16, "model": 16}
    one = tmesh.make_production_mesh()
    assert sharding.mesh_axes(one) == {"data": 16, "model": 16}
    assert sharding.param_specs({"layers": {"w_gate": torch.zeros(
        4, 32, 64)}}, pod, "train") == {"layers": {"w_gate": sharding.P(
            None, "data", "model")}}
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.AbstractMesh.of((2, 2), ("data",))


def test_logical_is_a_noop_without_a_mesh_and_redistributes_a_dtensor(
        tmp_path):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.ones(4, 6)
    sharding.set_mesh(None)
    assert sharding.logical(x, ("batch", "mlp")) is x
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.fspath(tmp_path / "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
        assert sharding.mesh_axes(mesh) == {"data": 1, "model": 1}
        sharding.set_mesh(mesh, "train")
        assert sharding.get_mesh() is mesh
        assert sharding.logical(x, ("batch", "mlp")) is x  # not a DTensor
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        y = sharding.logical(d, ("batch", "mlp"))
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x)
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()
    np.testing.assert_array_equal(x.numpy(), np.ones((4, 6)))

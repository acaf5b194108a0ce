"""The port's dry run (`repro_torch.launch.dryrun`) on fake production
worlds, and the kernel wrappers' refusal of storage-less tensors.

  * reduced smollm-135m on the 16 × 16 and 2 × 16 × 16 meshes (a fake
    world of 256 / 512 ranks in this process, torn down per cell): status
    "ok" for train_4k, prefill_32k and decode_32k;
  * the argument bytes per rank equal the sum of each input's local shard,
    computed here from the specs and the mesh;
  * qwen3-0.6b × long_500k is "skipped" with the reference's reason;
  * with fused_attention the flash kernels' counted flops equal the
    reference's `attention_costs` × 5.5·L (train) or L (prefill), per chip;
  * a DTensor or a FakeTensor never launches: the launchers raise before
    calling the library, the wrappers raise on a DTensor, and under
    `FakeTensorMode` they return fake outputs with no launch.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.shapes import SHAPES
from repro_torch.interop import tree_leaves
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import flash_attn as fa
from repro_torch.kernels.slstm import slstm as sl
from repro_torch.launch import dryrun, steps
from repro_torch.parallel import sharding

MESHES = pytest.mark.parametrize("multi_pod", (False, True),
                                 ids=("16x16", "2x16x16"))
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
FUSED = {"fused_attention": True, "tp": 16}


@MESHES
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_reduced_smollm_cells_run(shape, multi_pod):
    res = dryrun.run_cell("smollm-135m", shape, multi_pod=multi_pod,
                          reduced=True, verbose=False)
    assert res["status"] == "ok", res.get("error")
    assert not dist.is_initialized()                # torn down
    assert res["chips"] == (512 if multi_pod else 256)
    r = res["roofline"]
    assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    if shape == "train_4k":          # FSDP all-gathers, gradient reductions
        assert r["collective_ring_bytes"] > 0
    m = res["memory"]
    assert m["fits_hbm"] and m["live_bytes_per_chip"] == (
        m["argument_bytes"] + m["temp_bytes"])
    assert res["n_params"] > 0 and res["n_active_params"] > 0


def _local_bytes(shapes_dtypes, specs, mesh_sizes) -> int:
    """Σ over leaves of the bytes of one rank's shard: each sharded dim
    divided by the product of its mesh dims (the specs only shard dims
    that divide)."""
    total = 0
    for (shape, dtype), spec in zip(shapes_dtypes, specs):
        n = 1
        for i, dim in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            div = int(np.prod([mesh_sizes[a] for a in axes])) if axes else 1
            assert dim % div == 0
            n *= dim // div
        total += n * torch.tensor([], dtype=dtype).element_size()
    return total


@MESHES
@pytest.mark.parametrize("shape", ("train_4k", "decode_32k"))
def test_argument_bytes_are_the_local_shard_sum(shape, multi_pod):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import AbstractMesh, PRODUCTION_MESHES
    res = dryrun.run_cell("smollm-135m", shape, multi_pod=multi_pod,
                          reduced=True, verbose=False)
    assert res["status"] == "ok", res.get("error")
    mesh = AbstractMesh.of(*PRODUCTION_MESHES[multi_pod])
    sizes = sharding.mesh_axes(mesh)
    sp = SHAPES[shape]
    cfg = steps.resolve_config("smollm-135m", sp, reduced=True)
    from repro_torch.models import registry
    model = registry.build(cfg)
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        if sp.kind == "train":
            from repro_torch.optim import AdamW
            trees = [(params, sharding.param_specs(params, mesh, "train"))]
            opt = AdamW().init(params)
            trees.append((opt, sharding.param_specs(opt, mesh, "train")))
            batch = {k: v for k, v in steps.input_specs(cfg, sp).items()}
            bspecs = steps.batch_specs(cfg, sp, mesh)
        else:
            trees = [(params, sharding.param_specs(params, mesh, "serve"))]
            state = model.init_serve_state(sp.global_batch, sp.seq_len,
                                           "cpu")
            trees.append((state, steps.serve_state_specs(cfg, state, mesh)))
            batch = {"token": steps.input_specs(cfg, sp)["token"]}
            bspecs = {"token": steps.batch_specs(cfg, sp, mesh)["token"]}
        want = sum(_local_bytes([(tuple(t.shape), t.dtype)
                                 for t in tree_leaves(tree)],
                                sharding.spec_leaves(specs), sizes)
                   for tree, specs in trees)
    want += _local_bytes([(v.shape, v.dtype) for _, v in sorted(
        batch.items())], [bspecs[k] for k in sorted(batch)], sizes)
    assert res["memory"]["argument_bytes"] == want


def test_full_attention_long_context_is_skipped_with_the_reference_reason():
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.launch import steps as jsteps
    res = dryrun.run_cell("qwen3-0.6b", "long_500k", verbose=False)
    ok, reason = jsteps.cell_supported("qwen3-0.6b", JSHAPES["long_500k"])
    assert not ok
    assert res == {"arch": "qwen3-0.6b", "shape": "long_500k",
                   "status": "skipped", "reason": reason}


@pytest.mark.parametrize("shape,factor", (("train_4k", 5.5),
                                          ("prefill_32k", 1.0)))
def test_flash_flops_are_the_kernels_own(shape, factor):
    from repro.kernels.flash_attn import attention_costs as j_costs
    from repro.parallel.sharding import resolve_heads
    res = dryrun.run_cell("smollm-135m", shape, reduced=True,
                          cfg_overrides=FUSED, verbose=False)
    assert res["status"] == "ok", res.get("error")
    cfg = steps.resolve_config("smollm-135m", SHAPES[shape], reduced=True)
    hq, _ = resolve_heads(cfg.n_heads, cfg.n_kv_heads, FUSED["tp"])
    sp = SHAPES[shape]
    per = j_costs(sp.global_batch, sp.seq_len, sp.seq_len, hq, cfg.head_dim,
                  causal=True, window=cfg.window)["flops"]
    want = factor * cfg.n_layers * per / 256
    counted = res["kernel_flops"]
    assert sum(counted.values()) == pytest.approx(want, rel=1e-12)
    assert res["kernel_flops_expected"] == pytest.approx(want, rel=1e-12)
    names = set(counted)
    assert names == ({"repro_torch.flash_attention_fwd",
                      "repro_torch.flash_attention_bwd_dkv",
                      "repro_torch.flash_attention_bwd_dq"}
                     if shape == "train_4k" else
                     {"repro_torch.flash_attention"})


# ---------------------------------------------------------------------------
# no launch from a tensor without storage
# ---------------------------------------------------------------------------

class _Lib:
    """Records any call: a launcher must raise before reaching it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            return 0
        return call


@pytest.fixture
def one_rank_mesh(tmp_path):
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.fspath(tmp_path / "store"), 1),
        rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()


def _dtensor(t, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return distribute_tensor(t, mesh, [Replicate(), Replicate()])


def _fake(t):
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode().from_tensor(t)


def _flash_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 32, generator=g)
    kv = torch.randn(1, 16, 2, 32, generator=g)
    return q, kv


def _slstm_inputs():
    g = torch.Generator().manual_seed(1)
    xg = torch.randn(2, 5, 4 * 2 * 8, generator=g)
    r = torch.randn(4, 2, 8, 8, generator=g)
    st = tuple(torch.zeros(2, 16) for _ in range(4))
    return xg, r, st


@pytest.mark.parametrize("kind", ("dtensor", "fake"))
def test_launchers_refuse_tensors_without_storage(kind, one_rank_mesh):
    wrap = ((lambda t: _dtensor(t, one_rank_mesh)) if kind == "dtensor"
            else _fake)
    q, kv = _flash_inputs()
    lib = _Lib()
    with pytest.raises(TypeError, match="no device memory of its own"):
        fa._launch(lib, wrap(q), kv, kv, torch.empty_like(q), True, 0, 0, 0)
    with pytest.raises(TypeError, match="no device memory of its own"):
        fa._launch_bwd(lib, q, kv, kv, wrap(q), q[..., 0], q[..., 0],
                       (torch.empty_like(q),), True, 0, 0, 0)
    xg, r, st = _slstm_inputs()
    with pytest.raises(TypeError, match="no device memory of its own"):
        sl._launch(lib, wrap(xg), r, st, xg[..., :16],
                   tuple(torch.empty_like(t) for t in st), 0)
    with pytest.raises(TypeError, match="no device memory of its own"):
        sl._launch_bwd(lib, xg, r, xg[..., :16], wrap(xg[..., :16]), st, st,
                       xg, xg, st, 2, 0)
    with pytest.raises(TypeError, match="no device memory of its own"):
        _build.device_ptr("t", wrap(q))
    assert lib.calls == []
    assert _build.device_ptr("q", q) == q.data_ptr()


def test_wrappers_raise_on_a_dtensor_and_never_launch(one_rank_mesh):
    q, kv = _flash_inputs()
    xg, r, st = _slstm_inputs()
    fa.reset_launch_counts()
    sl.reset_launch_counts()
    dq = _dtensor(q, one_rank_mesh)
    dkv = _dtensor(kv, one_rank_mesh)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        fa.flash_attention(dq, dkv, dkv)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        fa.flash_attention_fwd(dq, dkv, dkv)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        sl.slstm_fused(_dtensor(xg, one_rank_mesh), _dtensor(
            r, one_rank_mesh), tuple(_dtensor(t, one_rank_mesh)
                                     for t in st), 2)
    assert all(n == 0 for n in fa.LAUNCHES.values())
    assert all(n == 0 for n in sl.LAUNCHES.values())
    # the models hand them local shards instead (local_map)
    from repro_torch.models import attention as tattn
    sharding.set_mesh(one_rank_mesh, "serve")
    out = tattn.attend_causal(dq, dkv, dkv, fused=True)
    want = fa.flash_attention(q, kv, kv)
    assert torch.equal(out.full_tensor(), want)


def test_fake_cuda_inputs_get_fake_outputs_and_no_launch():
    from torch._subclasses.fake_tensor import FakeTensorMode
    fa.reset_launch_counts()
    sl.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(1, 64, 4, 32, device="cuda", dtype=torch.bfloat16)
        kv = torch.empty(1, 64, 2, 32, device="cuda", dtype=torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, kv, kv)
        dq, dk, dv = fa.flash_attention_bwd(q, kv, kv, o, lse, o)
        xg = torch.empty(2, 5, 64, device="cuda", dtype=torch.bfloat16)
        r = torch.empty(4, 2, 8, 8, device="cuda", dtype=torch.bfloat16)
        st = tuple(torch.empty(2, 16, device="cuda") for _ in range(4))
        hs, new = sl.slstm_fused(xg, r, st, 2)
        dxg, dr, dst = sl.slstm_fused_bwd(xg, r, st, 2, hs, hs, st)
    assert o.shape == q.shape and lse.shape == (1, 64, 4)
    assert lse.dtype == torch.float32 and o.dtype == torch.bfloat16
    assert dk.shape == kv.shape and dq.shape == q.shape
    assert hs.shape == (2, 5, 16) and hs.dtype == torch.float32
    assert dxg.dtype == xg.dtype and dr.shape == r.shape
    assert all(t.shape == (2, 16) for t in new + dst)
    assert all(t.is_cuda for t in (o, dq, hs, dxg))
    assert all(n == 0 for n in fa.LAUNCHES.values())
    assert all(n == 0 for n in sl.LAUNCHES.values())

"""Port vs reference: the per-cell assembly of `repro_torch.launch.steps`,
`transformer.shard_cache` and `launch.train.build(mesh=)`.

  * `resolve_config`, `cell_supported`, `input_specs` (shapes and types)
    and `shape_batch` equal the reference's for every arch × shape;
  * `batch_specs` and `serve_state_specs` equal the reference's
    `PartitionSpec`s on both production meshes (the reference tests' fake
    mesh), for every family and shape;
  * `quantize_weights_int8` and `dequantize_weights` bitwise against the
    reference on seeded numpy weights;
  * a sharded train step, prefill and decode of reduced qwen3 on a 2 × 2
    gloo CPU mesh (one spawned world of 4 ranks), held against the
    reference's `make_lowerable(...).fn` on a (1, 1) JAX CPU mesh with the
    same numpy weights and batch: logits at the LM bound (rtol 1e-4, atol
    1e-4·max|logits|), every parameter after the step within
    1e-3·max|leaf|; in the same world every gradient leaf in its
    parameter's placements (a stacked layer leaf's as autograd returns
    it), `shard_cache`'s placements and `train.build(mesh=)`'s parameter
    placements.

jax is imported inside the tests only: the spawned ranks import this
module and must not load it.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.interop import tree_leaves, tree_named_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as treg
from repro_torch.parallel import sharding


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = pytest.mark.parametrize("mesh", [FakeMesh, FakePodMesh],
                                 ids=["16x16", "2x16x16"])
CELLS = [(a, s) for a in tconfigs.ARCHS for s in SHAPES]
LM_RTOL, LM_ATOL_REL, GRAD_TOL = 1e-4, 1e-4, 1e-3


def _ref_steps():
    from repro.launch import steps as jsteps
    return jsteps


def _cfg_dict(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_config_support_inputs_and_batch_equal_reference(arch, shape):
    jsteps = _ref_steps()
    from repro.configs.shapes import SHAPES as JSHAPES
    sp, jsp = SHAPES[shape], JSHAPES[shape]
    for reduced in (False, True):
        got = tsteps.resolve_config(arch, sp, reduced)
        want = jsteps.resolve_config(arch, jsp, reduced)
        assert _cfg_dict(got) == _cfg_dict(want)
        assert tsteps.shape_batch(got, sp) == jsteps.shape_batch(want, jsp)
    assert tsteps.cell_supported(arch, sp) == jsteps.cell_supported(arch,
                                                                   jsp)
    cfg = tsteps.resolve_config(arch, sp)
    got = tsteps.input_specs(cfg, sp)
    want = jsteps.input_specs(jsteps.resolve_config(arch, jsp), jsp)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def _ref_flat_specs(tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec
    from repro.parallel import sharding as jsharding
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))
    return {jsharding._path_str(p): tuple(s) for p, s in flat}


@MESHES
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_equal_reference(arch, shape, mesh):
    jsteps = _ref_steps()
    from repro.configs.shapes import SHAPES as JSHAPES
    cfg = tsteps.resolve_config(arch, SHAPES[shape])
    got = tsteps.batch_specs(cfg, SHAPES[shape], mesh())
    want = jsteps.batch_specs(jsteps.resolve_config(arch, JSHAPES[shape]),
                              JSHAPES[shape], mesh())
    assert {k: tuple(v) for k, v in got.items()} == _ref_flat_specs(want)


# each family's serve state at a cut capacity (the specs read only the
# leaves' ranks, their batch and head dims and their paths), at the
# shapes' batches: 128 and 32 divide the batch dims, 1 does not
STATE_CAPACITY = 64
STATE_ARCHS = ("qwen3-0.6b", "mixtral-8x22b", "llava-next-34b",
               "zamba2-1.2b", "xlstm-125m", "whisper-large-v3")


@functools.lru_cache(maxsize=None)
def _ref_state_specs(arch: str, batch: int, axes: tuple, sizes: tuple):
    import jax
    from repro import configs as jconfigs
    from repro.models import registry as jreg

    class M:
        axis_names = axes
        shape = dict(zip(axes, sizes))
    cfg = jconfigs.get_config(arch, reduced=True)
    model = jreg.build(cfg)
    st = jax.eval_shape(lambda: model.init_serve_state(batch,
                                                       STATE_CAPACITY))
    return _ref_flat_specs(_ref_steps().serve_state_specs(cfg, st, M()))


@MESHES
@pytest.mark.parametrize("batch", (128, 32, 1))
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_serve_state_specs_equal_reference(arch, batch, mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = tconfigs.get_config(arch, reduced=True)
    with FakeTensorMode():
        state = treg.build(cfg).init_serve_state(batch, STATE_CAPACITY,
                                                 "cpu")
    specs = tsteps.serve_state_specs(cfg, state, mesh())
    names = [n for n, _ in tree_named_leaves(state)]
    got = dict(zip(names, map(tuple, sharding.spec_leaves(specs))))
    m = mesh()
    want = _ref_state_specs(arch, batch, tuple(m.axis_names),
                            tuple(m.shape[a] for a in m.axis_names))
    assert got == want
    assert any(any(e is not None for e in s) for s in got.values()) \
        or batch == 1


def _np_weights():
    rng = np.random.default_rng(11)
    return {"big": (rng.standard_normal((300, 256)) * 0.7).astype(
                np.float32),
            "stack": {"w": rng.standard_normal((3, 128, 256)).astype(
                np.float32)},
            "small": rng.standard_normal((10, 10)).astype(np.float32),
            "vec": rng.standard_normal((70000,)).astype(np.float32)}


def _auto_mesh():
    """A (1, 1) ("data", "model") JAX CPU mesh with Auto axes, which the
    reference's sharding constraints need (`jax.make_mesh` makes Explicit
    axes by default on the installed jax)."""
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def test_int8_weights_bitwise_equal_reference():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    jsteps = _ref_steps()
    w = _np_weights()
    jq = jsteps.quantize_weights_int8(jax.tree.map(jnp.asarray, w))
    tq = tsteps.quantize_weights_int8(
        {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in w.items()})
    assert set(tq) == set(jq) and tsteps._is_qleaf(tq["big"]) \
        and tsteps._is_qleaf(tq["stack"]["w"])
    assert not tsteps._is_qleaf(tq["small"]) and not tsteps._is_qleaf(
        tq["vec"])
    for name in ("big",):
        np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                      np.asarray(jq[name]["q"]))
        assert tq[name]["q"].dtype == torch.int8
        assert tq[name]["s"].item() == float(jq[name]["s"])
    np.testing.assert_array_equal(tq["stack"]["w"]["q"].numpy(),
                                  np.asarray(jq["stack"]["w"]["q"]))
    mesh = _auto_mesh()
    jspecs = jax.tree.map(lambda _: JP(), jq)
    tspecs = {k: ({"q": sharding.P(), "s": sharding.P()}
                  if tsteps._is_qleaf(v) else
                  ({"w": {"q": sharding.P(), "s": sharding.P()}}
                   if k == "stack" else sharding.P()))
              for k, v in tq.items()}
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        with mesh:
            jd = jsteps.dequantize_weights(jq, jspecs, mesh, jdt)
        td = tsteps.dequantize_weights(tq, tspecs, None, dt)
        for a, b in ((td["big"], jd["big"]),
                     (td["stack"]["w"], jd["stack"]["w"])):
            assert a.dtype == dt
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        assert td["small"] is tq["small"]


# ---------------------------------------------------------------------------
# the sharded steps on a 2 x 2 gloo CPU mesh
# ---------------------------------------------------------------------------

ARCH = "qwen3-0.6b"
OVERRIDES = {"fused_attention": True}
TRAIN = ShapeSpec("train_t", 32, 8, "train")
PREFILL = ShapeSpec("prefill_t", 32, 4, "prefill")
DECODE_POS = PREFILL.seq_len


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def sharded_rank(rank, world, params_np, tokens, labels, prompt, dec_tok):
    """One rank of the 2 x 2 world: the train step, the prefill and one
    decode step through `make_lowerable`, the results gathered whole; the
    placements of `shard_cache` and of `train.build(mesh=)`."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.interop import to_torch, tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as ttr
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    params = to_torch(params_np, "cpu")
    out = {}
    low = tsteps.make_lowerable(ARCH, TRAIN, mesh, reduced=True,
                                cfg_overrides=OVERRIDES, params=params)
    batch = low.place(2, {"tokens": torch.from_numpy(tokens),
                          "labels": torch.from_numpy(labels)})
    new_p, new_o, m = low.fn(low.args[0], low.args[1], batch)
    out["train_loss"] = float(_full(m["loss"]))
    out["train_params"] = tree_map(lambda t: _full(t).detach(), new_p)
    out["param_placements"] = [tuple(t.placements)
                               for t in tree_leaves(new_p)]
    out["want_placements"] = [sharding.placements(s, mesh) for s in
                              sharding.spec_leaves(low.specs[0])]
    out["opt_step"] = int(_full(new_o.step))
    # microbatch 0's gradients as autograd returns them, and as the step
    # adds them into its sums
    with tsteps._replication(low.args[0]):
        _, grads = tsteps.loss_and_grads(treg.build(low.cfg), low.args[0],
                                         tree_map(lambda t: t[0], batch))
    out["grad_placements"] = [
        (n, tuple(g.placements), tuple(tsteps._like(g, p).placements))
        for (n, p), g in zip(tree_named_leaves(low.args[0]), grads)]
    del grads

    low = tsteps.make_lowerable(ARCH, PREFILL, mesh, reduced=True,
                                cfg_overrides=OVERRIDES, params=params)
    pb = low.place(1, {"tokens": torch.from_numpy(prompt)})
    logits, state = low.fn(low.args[0], pb, low.args[2])
    out["prefill_logits"] = _full(logits)
    dec = tsteps.build_decode_step(treg.build(low.cfg))
    tok = low.place(1, {"tokens": torch.from_numpy(dec_tok)})["tokens"]
    nxt, logits, state = dec(low.args[0], tok, DECODE_POS, state)
    out["decode_logits"] = _full(logits)
    out["decode_next"] = _full(nxt)

    cache = tree_map(lambda t: distribute_tensor(t, mesh, [Replicate()] * 2),
                     ttr.init_cache(low.cfg, 4, 8, "cpu"))
    sharding.set_mesh(mesh, "serve")
    out["cache_placements"] = {k: tuple(v.placements) for k, v in
                               ttr.shard_cache(cache).items()}
    out["cache_want"] = (Shard(1), Shard(3))

    cfg = dataclasses.replace(tconfigs.get_config(ARCH, reduced=True),
                              **OVERRIDES)
    init_state, step = ttrain.build(cfg, 1e-3, 1, mesh=mesh)
    p, o = init_state()
    out["build_placements"] = [tuple(t.placements) for t in tree_leaves(p)]
    out["build_want"] = [sharding.placements(s, mesh) for s in
                         sharding.spec_leaves(sharding.param_specs(
                             p, mesh, "train"))]
    out["build_opt_placements"] = [tuple(t.placements)
                                   for t in tree_leaves(o)]
    out["build_opt_want"] = [sharding.placements(s, mesh) for s in
                             sharding.spec_leaves(sharding.param_specs(
                                 o, mesh, "train"))]
    _, _, m = step(p, o, {"tokens": torch.from_numpy(tokens),
                          "labels": torch.from_numpy(labels)})
    out["build_loss"] = float(_full(m["loss"]))
    sharding.set_mesh(None)
    return out


@functools.lru_cache(maxsize=None)
def _reference_cell():
    """The reference's reduced qwen3 weights (numpy), a batch, and its
    train / prefill / decode results on a (1, 1) JAX CPU mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs.shapes import ShapeSpec as JShape
    from repro.models import registry as jreg
    from repro.parallel import sharding as jsharding
    jsteps = _ref_steps()
    mesh = _auto_mesh()
    rng = np.random.default_rng(3)
    cfg = jsteps.resolve_config(ARCH, JShape(*dataclasses.astuple(TRAIN)),
                                reduced=True)
    cfg = dataclasses.replace(cfg, **OVERRIDES)
    params = jax.tree.map(np.asarray,
                          jreg.build(cfg).init(jax.random.PRNGKey(5)))

    def fresh():                 # the steps donate their params
        return jax.tree.map(jnp.asarray, params)
    tokens = rng.integers(0, cfg.vocab, (1, TRAIN.global_batch,
                                         TRAIN.seq_len)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, tokens.shape).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (PREFILL.global_batch,
                                         PREFILL.seq_len)).astype(np.int32)
    res = {}
    try:
        with mesh:
            low = jsteps.make_lowerable(ARCH, JShape(*dataclasses.astuple(
                TRAIN)), mesh, reduced=True, cfg_overrides=OVERRIDES)
            from repro.optim import AdamW
            opt = AdamW(lr=1e-3, grad_clip_norm=1.0).init(fresh())
            new_p, _, m = low.fn(fresh(), opt, {"tokens": jnp.asarray(tokens),
                                                "labels": jnp.asarray(labels)})
            res["train_loss"] = float(m["loss"])
            res["train_params"] = jax.tree.map(np.asarray, new_p)
            low = jsteps.make_lowerable(ARCH, JShape(*dataclasses.astuple(
                PREFILL)), mesh, reduced=True, cfg_overrides=OVERRIDES)
            model = jreg.build(low.cfg)
            state = model.init_serve_state(PREFILL.global_batch,
                                           PREFILL.seq_len)
            logits, state = low.fn(fresh(), {"tokens": jnp.asarray(prompt)},
                                   state)
            res["prefill_logits"] = np.asarray(logits, np.float32)
            dec = jax.jit(jsteps.build_decode_step(model))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            res["decode_token"] = np.asarray(tok)
            nxt, logits, _ = dec(fresh(), tok, jnp.int32(DECODE_POS), state)
            res["decode_logits"] = np.asarray(logits, np.float32)
            res["decode_next"] = np.asarray(nxt)
    finally:
        jsharding.set_mesh(None)
    return params, tokens, labels, prompt, res


@functools.lru_cache(maxsize=None)
def _sharded_cell():
    from repro_torch.launch.mesh import run_ranks
    params, tokens, labels, prompt, ref = _reference_cell()
    outs = run_ranks(sharded_rank, 4, (params, tokens, labels, prompt,
                                       ref["decode_token"]), timeout_s=600)
    return outs


def _lm_close(got: torch.Tensor, want: np.ndarray) -> None:
    np.testing.assert_allclose(got.float().numpy(), want, rtol=LM_RTOL,
                               atol=LM_ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("what", ("prefill_logits", "decode_logits"))
def test_sharded_serving_equals_reference(what):
    *_, ref = _reference_cell()
    for out in _sharded_cell():                  # every rank, whole
        _lm_close(out[what], ref[what])
    assert torch.equal(_sharded_cell()[0]["decode_next"],
                       torch.from_numpy(ref["decode_next"].copy()))


def test_sharded_train_step_equals_reference():
    *_, ref = _reference_cell()
    for out in _sharded_cell():
        np.testing.assert_allclose(out["train_loss"], ref["train_loss"],
                                   rtol=1e-5)
        assert out["opt_step"] == 1
        got = dict(tree_named_leaves(out["train_params"]))
        import jax
        from repro.parallel import sharding as jsharding
        flat, _ = jax.tree_util.tree_flatten_with_path(ref["train_params"])
        want = {jsharding._path_str(p): np.asarray(v) for p, v in flat}
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name].float().numpy()
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(g - w).max() <= GRAD_TOL * scale, name
        assert out["param_placements"] == out["want_placements"]


def test_sharded_step_gradients_come_back_in_their_parameters_placements():
    """Every gradient leaf of the sharded step (`loss_and_grads` on
    microbatch 0) is laid out as its parameter once `_like` has reduced
    it, and a stacked layer leaf's already is as autograd returns it: its
    layer loop reduced each layer's gradient to the parameter's shards."""
    for out in _sharded_cell():
        got = out["grad_placements"]
        assert len(got) == len(out["want_placements"])
        stacked = 0
        for (name, raw, laid), want in zip(got, out["want_placements"]):
            assert laid == tuple(want), name
            if name.split("/")[0] == "layers":
                stacked += 1
                assert raw == tuple(want), name
        assert stacked >= 9, got


def test_shard_cache_and_train_build_placements():
    out = _sharded_cell()[0]
    assert out["cache_placements"] == {"k": out["cache_want"],
                                       "v": out["cache_want"]}
    assert out["build_placements"] == out["build_want"]
    assert out["build_opt_placements"] == out["build_opt_want"]
    # something is sharded on each mesh dim
    flat = [p for pl in out["build_placements"] for p in pl]
    assert any(p.is_shard() for p in flat)
    # the built step on a whole batch (laid out by `batch_specs`) takes
    # the loss of the same step without a mesh
    from repro_torch.launch import train as ttrain
    _, tokens, labels, *_ = _reference_cell()
    cfg = dataclasses.replace(tconfigs.get_config(ARCH, reduced=True),
                              **OVERRIDES)
    init_state, step = ttrain.build(cfg, 1e-3, 1, "cpu")
    _, _, m = step(*init_state(), {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)})
    for out in _sharded_cell():
        np.testing.assert_allclose(out["build_loss"], float(m["loss"]),
                                   rtol=1e-5)


def test_train_cli_mesh_on_a_one_rank_world_equals_the_single_card_run(
        tmp_path):
    """`launch.train --mesh 1x1` on an initialized one-rank gloo world:
    DTensor params, state and batch (the checkpoints save them) give the
    losses of the run without a mesh."""
    import os
    import torch.distributed as dist
    from repro_torch.launch import train as ttrain
    args = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-every", "1"]
    plain = ttrain.run(args + ["--ckpt-dir", str(tmp_path / "plain")])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.fspath(tmp_path / "store"), 1),
        rank=0, world_size=1)
    try:
        meshed = ttrain.run(args + ["--mesh", "1x1", "--ckpt-dir",
                                    str(tmp_path / "mesh")])
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()
    assert meshed["restarts"] == plain["restarts"] == 0
    np.testing.assert_allclose(meshed["losses"], plain["losses"], rtol=1e-6)
    assert meshed["losses"][-1] < meshed["losses"][0]


# ---------------------------------------------------------------------------
# int8 weights gathered and dequantized layer by layer
# ---------------------------------------------------------------------------

INT8_ARCHS = ("qwen3-0.6b", "mixtral-8x22b")        # dense, MoE
INT8_OVERRIDES = {"serve_int8_weights": True, "serve_fsdp": True}
INT8_DECODE = ShapeSpec("decode_t", PREFILL.seq_len, PREFILL.global_batch,
                        "decode")


def _layer_qnodes(tree) -> list:
    """The names of the {"q", "s"} nodes under the per-layer keys."""
    return sorted({n.rsplit("/", 1)[0] for n, _ in tree_named_leaves(tree)
                   if n.endswith("/q")
                   and n.split("/")[0] in tsteps._LAYER_KEYS})


def int8_rank(rank, world, cases):
    """One rank of the 2 x 2 world, for each arch: the int8 prefill and one
    decode step through `make_lowerable` (the steps dequantize layer by
    layer) and the same steps on the whole-tree `dequantize_weights`
    output, from fresh serve states, the results gathered whole."""
    from repro_torch.interop import to_torch
    from repro_torch.launch import mesh as tmesh
    # one intra-op thread: under CPU contention, gloo ranks of two threads
    # now and then return values ~1e-5 off, and the paths are compared
    # bitwise
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch, (params_np, prompt, dec_tok) in cases.items():
        params = to_torch(params_np, "cpu")
        low = tsteps.make_lowerable(arch, PREFILL, mesh, reduced=True,
                                    cfg_overrides=INT8_OVERRIDES,
                                    params=params)
        lowd = tsteps.make_lowerable(arch, INT8_DECODE, mesh, reduced=True,
                                     cfg_overrides=INT8_OVERRIDES,
                                     params=params)
        qp = low.args[0]
        model = treg.build(low.cfg)
        gspecs = sharding.param_specs(qp, mesh, "serve")
        whole = tsteps.dequantize_weights(qp, gspecs, mesh,
                                          low.cfg.param_dtype())
        pb = low.place(1, {"tokens": torch.from_numpy(prompt)})
        tok = low.place(1, {"tokens": torch.from_numpy(dec_tok)})["tokens"]
        res = {"layer_qnodes": _layer_qnodes(qp)}
        for how in ("layerwise", "whole"):
            state = low.place(2, model.init_serve_state(
                PREFILL.global_batch, PREFILL.seq_len, "cpu"))
            if how == "layerwise":
                logits, state = low.fn(qp, pb, state)
                nxt, dlogits, _ = lowd.fn(lowd.args[0], tok, DECODE_POS,
                                          state)
            else:
                logits, state = tsteps.build_prefill_step(model)(
                    whole, pb, state)
                nxt, dlogits, _ = tsteps.build_decode_step(model)(
                    whole, tok, DECODE_POS, state)
            res[how] = {"prefill": _full(logits), "decode": _full(dlogits),
                        "next": _full(nxt)}
        out[arch] = res
    sharding.set_mesh(None)
    return out


@functools.lru_cache(maxsize=None)
def _int8_reference(arch: str):
    """The reference's reduced weights (numpy), a prompt and a decode
    token, and its int8 prefill and decode (`make_lowerable(...).fn` with
    serve_int8_weights) on the Auto (1, 1) JAX CPU mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs.shapes import ShapeSpec as JShape
    from repro.models import registry as jreg
    from repro.parallel import sharding as jsharding
    jsteps = _ref_steps()
    mesh = _auto_mesh()
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(jsteps.resolve_config(
        arch, JShape(*dataclasses.astuple(PREFILL)), reduced=True),
        **INT8_OVERRIDES)
    params = jax.tree.map(np.asarray,
                          jreg.build(cfg).init(jax.random.PRNGKey(9)))
    prompt = rng.integers(0, cfg.vocab, (PREFILL.global_batch,
                                         PREFILL.seq_len)).astype(np.int32)
    dec_tok = rng.integers(0, cfg.vocab,
                           (PREFILL.global_batch, 1)).astype(np.int32)
    res = {}
    try:
        with mesh:
            qp = jsteps.quantize_weights_int8(jax.tree.map(jnp.asarray,
                                                           params))
            low = jsteps.make_lowerable(arch, JShape(*dataclasses.astuple(
                PREFILL)), mesh, reduced=True, cfg_overrides=INT8_OVERRIDES)
            lowd = jsteps.make_lowerable(arch, JShape(*dataclasses.astuple(
                INT8_DECODE)), mesh, reduced=True,
                cfg_overrides=INT8_OVERRIDES)
            state = jreg.build(low.cfg).init_serve_state(
                PREFILL.global_batch, PREFILL.seq_len)
            logits, state = low.fn(qp, {"tokens": jnp.asarray(prompt)},
                                   state)
            res["prefill"] = np.asarray(logits, np.float32)
            _, logits, _ = lowd.fn(qp, jnp.asarray(dec_tok),
                                   jnp.int32(DECODE_POS), state)
            res["decode"] = np.asarray(logits, np.float32)
    finally:
        jsharding.set_mesh(None)
    return params, prompt, dec_tok, res


@functools.lru_cache(maxsize=None)
def _int8_cells():
    from repro_torch.launch.mesh import run_ranks
    cases = {a: _int8_reference(a)[:3] for a in INT8_ARCHS}
    return run_ranks(int8_rank, 4, (cases,), timeout_s=600)


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_layerwise_serving_is_bitwise_the_whole_tree_dequant(arch):
    """Each layer's weights gathered and dequantized when its layer runs
    give bitwise the steps on `dequantize_weights`' whole tree; the layer
    weights really are int8 (the reduced configs' big layer leaves clear
    `_INT8_MIN_SIZE`)."""
    for out in _int8_cells():
        res = out[arch]
        qnodes = res["layer_qnodes"]
        assert tsteps._INT8_MIN_SIZE == 1 << 16
        assert any("mlp" in n for n in qnodes) and len(qnodes) >= 3, qnodes
        for what in ("prefill", "decode", "next"):
            got, want = res["layerwise"][what], res["whole"][what]
            assert got.dtype == want.dtype and torch.equal(got, want), what


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_layerwise_serving_equals_reference(arch):
    *_, ref = _int8_reference(arch)
    for out in _int8_cells():
        for what in ("prefill", "decode"):
            _lm_close(out[arch]["layerwise"][what], ref[what])


INT8_FAMILY_ARCHS = ("qwen3-0.6b", "mixtral-8x22b", "llava-next-34b",
                     "zamba2-1.2b", "xlstm-125m", "whisper-large-v3")


def _int8_decode_cell(arch: str, n_layers: int):
    """The reduced int8 decode_32k cell at ``n_layers`` on a fake 16 x 16
    world, one step under `StepCounter`: (its temporaries beyond the
    step's new outputs, one layer's gathered, dequantized weight bytes a
    rank)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import _local_bytes
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(fake=True)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            low = tsteps.make_lowerable(
                arch, SHAPES["decode_32k"], mesh, reduced=True,
                cfg_overrides=dict(INT8_OVERRIDES, n_layers=n_layers))
            counter = roofline.StepCounter()
            out, _, _ = roofline.count_step(low.fn, *low.args,
                                            counter=counter)
            args = {id(t) for t in tree_leaves(low.args)}
            new_out = _local_bytes([t for t in tree_leaves(out)
                                    if id(t) not in args])
            qp = low.args[0]
            sizes = sharding.mesh_axes(mesh)
            specs = dict(zip((n for n, _ in tree_named_leaves(qp)),
                             sharding.spec_leaves(sharding.param_specs(
                                 qp, mesh, "serve"))))
            layer = 0
            for name, leaf in tree_named_leaves(qp):
                if name.rsplit("/", 1)[0] not in _layer_qnodes(qp) \
                        or not name.endswith("/q"):
                    continue
                div = int(np.prod([sizes[a] for e in specs[name]
                                   for a in ((e,) if isinstance(e, str)
                                             else (e or ()))]))
                layer += leaf.numel() // div
        item = low.cfg.param_dtype().itemsize
        return counter.peak_bytes - new_out, layer * item // n_layers
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", INT8_FAMILY_ARCHS)
def test_int8_serving_temporaries_do_not_grow_with_depth(arch, monkeypatch):
    """Every family's reduced int8 decode_32k cell (serve_fsdp) on a fake
    16 x 16 world: its temporaries beyond the step's new outputs (xlstm
    returns its states anew) at 2 and at 8 layers differ by less than one
    layer's dequantized weights, where dequantizing the whole tree up
    front would add six layers' worth. The size floor is set to 1 here, so
    that every layer weight of the reduced configs is int8 at both
    depths."""
    monkeypatch.setattr(tsteps, "_INT8_MIN_SIZE", 1)
    t2, layer2 = _int8_decode_cell(arch, 2)
    t8, layer8 = _int8_decode_cell(arch, 8)
    assert layer8 > 0 and layer2 > 0
    assert abs(t8 - t2) < layer8, (t2, t8, layer8)

"""A batch that the mesh's batch dims do not all divide lies over the
largest set of them it divides (`parallel.sharding.row_axes`), in the
step's inputs (`launch.steps.batch_specs(…, rows=True)`), in every
activation (`sharding.logical`'s "batch" dims, `batch_head_entries`) and
in every weight product, and is whole over the rest.

  * the inputs' layout: where the batch divides every batch dim, the
    reference's `batch_specs` entry; else the largest set it divides
    (llava's and mixtral's 16-row train_4k microbatch on 2 × 16 × 16:
    over ``data``, whole over ``pod``); none where no set divides
    (long_500k's one row);
  * on fake (2, 16, 16) and (16, 16) worlds, one train step of the reduced
    llava and mixtral with a 16-row microbatch under
    `launch.roofline.StepCounter`: the tensors a rank makes at 2 × 16 × 16
    are those it makes at 16 × 16, where the reference's own rule lays
    the rows one a rank, none of them holds more rows than a rank's
    ``data`` share, and the temporaries, flops and ring bytes are those
    of the 16 × 16 step (the two ``pod`` ranks of a row hold the same
    rows, so a weight's gradient is a partial sum over ``data`` alone and
    nothing is reduced over ``pod``);
  * on a (2, 2, 1) ("pod", "data", "model") gloo CPU mesh (one spawned
    world of 4 ranks), the reduced llava and mixtral train steps with a
    2-row microbatch, which divides ``data`` but not ``pod`` × ``data``:
    the loss and every leaf's gradient on microbatch 0 equal the
    reference's (`jax.value_and_grad` of its `loss_fn` on an Auto (1, 1)
    JAX CPU mesh, 1e-3·max|leaf|; the step's loss at rtol 1e-5) and the
    port's unsharded step's; the gradients come back in their parameters'
    placements, none of them a partial sum over ``pod``.

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
from repro_torch.interop import tree_leaves, tree_map, tree_named_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch.roofline import StepCounter
from repro_torch.parallel import sharding

GRAD_TOL = 1e-3
ARCHS = ("llava-next-34b", "mixtral-8x22b")


class _Mesh:
    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch,shape", [(a, s) for a in tconfigs.ARCHS
                                        for s in SHAPES])
def test_inputs_lie_over_the_batch_dims_their_rows_divide(arch, shape,
                                                          mesh):
    m = _Mesh(MESHES[mesh])
    cfg = tsteps.resolve_config(arch, SHAPES[shape])
    got = tsteps.batch_specs(cfg, SHAPES[shape], m, rows=True)
    ref = tsteps.batch_specs(cfg, SHAPES[shape], m)
    rows = tsteps.shape_batch(cfg, SHAPES[shape])
    b_axes = sharding.batch_axes(m)
    size = int(np.prod([m.shape[a] for a in b_axes]))
    if rows % size == 0:
        assert got == ref
        return
    want = sharding.row_axes(rows, m)
    assert all(rows % m.shape[a] == 0 for a in want)
    if (arch, shape, mesh) in (("llava-next-34b", "train_4k", "2x16x16"),
                               ("mixtral-8x22b", "train_4k", "2x16x16")):
        assert want == ("data",)
    if rows == 1:
        assert want == ()
    b = want or None
    for k, spec in got.items():
        if not ref[k]:                       # decode's scalar position
            assert spec == ref[k], k
            continue
        lead = 1 if SHAPES[shape].kind == "train" else 0
        assert spec[lead] == sharding.P(b)[0], (k, spec)
        assert spec[:lead] + spec[lead + 1:] == ref[k][:lead] \
            + ref[k][lead + 1:], k


# ---------------------------------------------------------------------------
# a 16-row microbatch on fake 16 x 16 and 2 x 16 x 16 worlds
# ---------------------------------------------------------------------------

SEQ, IMG, ACCUM, MICRO = 37, 6, 2, 16
ROWS16 = ShapeSpec("train_rows16", SEQ, ACCUM * MICRO, "train")
OVERRIDES = {"llava-next-34b": {"train_accum": ACCUM, "img_tokens": IMG},
             "mixtral-8x22b": {"train_accum": ACCUM}}


class _MadeShapes(StepCounter):
    """A `StepCounter` that also keeps the shape of every tensor an op
    makes."""

    def __init__(self):
        super().__init__()
        self.made = set()

    def _track(self, t, op):
        self.made.add(tuple(t.shape))
        super()._track(t, op)


@functools.lru_cache(maxsize=None)
def _rows16_step(arch: str, multi_pod: bool):
    """(made shapes, temporaries, flops, ring bytes by op) of one train
    step of the reduced ``arch`` with a 16-row microbatch on a fake
    production world."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            low = tsteps.make_lowerable(arch, ROWS16, mesh, reduced=True,
                                        cfg_overrides=OVERRIDES[arch])
            assert tsteps.shape_batch(low.cfg, ROWS16) == MICRO
            counter = _MadeShapes()
            with counter:
                low.fn(*low.args)
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()
    return (counter.made, counter.peak_bytes, counter.flops,
            dict(counter.ring))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_microbatch_the_pods_do_not_divide_is_one_row_a_rank(arch):
    made, peak, flops, ring = _rows16_step(arch, True)
    made16, peak16, flops16, ring16 = _rows16_step(arch, False)
    assert made <= made16, sorted(made - made16)[:8]
    # no tensor holds more than a rank's one row of the 16: no token length
    # (the sequence, llava's text, each less the next-token shift, and the
    # image prefix) follows a leading dim of all 16 rows, and none but the
    # prefix's appears as 2..16 rows' worth of tokens (no weight dim is one)
    text = SEQ - IMG if arch == "llava-next-34b" else SEQ
    lengths = {SEQ, SEQ - 1, text, text - 1}
    flat = {j * n for n in lengths for j in range(2, MICRO + 1)}
    for shape in made:
        assert not flat & set(shape), shape
        assert not (len(shape) >= 2 and shape[0] == MICRO
                    and shape[1] in lengths | {IMG}), shape
    assert peak <= peak16, (peak, peak16)
    assert flops == flops16
    assert ring == ring16


# ---------------------------------------------------------------------------
# a 2-row microbatch on a (2, 2, 1) pod x data x model gloo CPU mesh
# ---------------------------------------------------------------------------

TRAIN = ShapeSpec("train_pods", 16, 4, "train")
POD_OVERRIDES = {"llava-next-34b": {"train_accum": 2, "img_tokens": 4},
                 "mixtral-8x22b": {"train_accum": 2}}
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def pod_rank(rank, world, cases):
    """One rank of the (2, 2, 1) world, for each arch: the rows' layout of
    the step's inputs, every leaf's gradient on microbatch 0 (its
    placements as autograd returns it, and laid out as its parameter,
    gathered whole), then the train step's loss."""
    from repro_torch.interop import to_torch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import registry as treg
    mesh = tmesh.make_mesh(*POD_MESH, "cpu")
    out = {}
    for arch, (params_np, batch_np) in cases.items():
        low = tsteps.make_lowerable(arch, TRAIN, mesh, reduced=True,
                                    cfg_overrides=POD_OVERRIDES[arch],
                                    params=to_torch(params_np, "cpu"))
        params = low.args[0]
        batch = low.place(2, tree_map(torch.from_numpy, batch_np))
        with tsteps._replication(params):
            _, grads = tsteps.loss_and_grads(
                treg.build(low.cfg), params, tree_map(lambda t: t[0], batch))
        names = [n for n, _ in tree_named_leaves(params)]
        res = {"batch_placements": {k: tuple(v.placements)
                                    for k, v in batch.items()},
               "placements": {
                   n: (tuple(p.placements), tuple(g.placements))
                   for n, p, g in zip(names, tree_leaves(params), grads)},
               "grads": {n: _full(tsteps._like(g, p)).detach()
                         for n, p, g in zip(names, tree_leaves(params),
                                            grads)}}
        del grads
        _, _, m = low.fn(params, low.args[1], batch)
        res["loss"] = float(_full(m["loss"]))
        out[arch] = res
    sharding.set_mesh(None)
    return out


@functools.lru_cache(maxsize=None)
def _reference_step(arch: str):
    """The reference's reduced weights and a batch (numpy), the loss of
    its train step and the gradient of every leaf on microbatch 0 on an
    Auto (1, 1) JAX CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs.shapes import ShapeSpec as JShape
    from repro.launch import steps as jsteps
    from repro.models import registry as jreg
    from repro.optim import AdamW
    from repro.parallel import sharding as jsharding
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    shape = JShape(*dataclasses.astuple(TRAIN))
    cfg = dataclasses.replace(jsteps.resolve_config(arch, shape,
                                                    reduced=True),
                              **POD_OVERRIDES[arch])
    model = jreg.build(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(4)
    batch = {}
    for k, v in jsteps.input_specs(cfg, shape).items():
        if v.dtype == jnp.int32:
            batch[k] = rng.integers(0, cfg.vocab, v.shape).astype(np.int32)
        else:
            batch[k] = rng.standard_normal(v.shape).astype(v.dtype)
    try:
        with mesh:
            low = jsteps.make_lowerable(arch, shape, mesh, reduced=True,
                                        cfg_overrides=POD_OVERRIDES[arch])
            fresh = jax.tree.map(jnp.asarray, params)
            jb = jax.tree.map(jnp.asarray, batch)
            opt = AdamW(lr=1e-3, grad_clip_norm=1.0).init(fresh)
            _, _, m = low.fn(fresh, opt, jb)
            loss = float(m["loss"])
            _, grads = jax.jit(jax.value_and_grad(
                model.loss_fn, has_aux=True))(
                    jax.tree.map(jnp.asarray, params),
                    jax.tree.map(lambda t: t[0], jb))
            flat, _ = jax.tree_util.tree_flatten_with_path(grads)
            want = {jsharding._path_str(p): np.asarray(v, np.float32)
                    for p, v in flat}
    finally:
        jsharding.set_mesh(None)
    return params, batch, loss, want


@functools.lru_cache(maxsize=None)
def _unsharded_step(arch: str):
    """The port's step without a mesh on the same weights and batch: (the
    train step's loss, every leaf's gradient on microbatch 0)."""
    from repro_torch.interop import to_torch
    from repro_torch.launch import train as ttrain
    from repro_torch.models import registry as treg
    params_np, batch_np, *_ = _reference_step(arch)
    cfg = dataclasses.replace(tsteps.resolve_config(arch, TRAIN,
                                                    reduced=True),
                              **POD_OVERRIDES[arch])
    params = to_torch(params_np, "cpu")
    batch = tree_map(torch.from_numpy, batch_np)
    _, grads = tsteps.loss_and_grads(treg.build(cfg), params,
                                     tree_map(lambda t: t[0], batch))
    names = [n for n, _ in tree_named_leaves(params)]
    _, step = ttrain.build(cfg, 1e-3, 1, "cpu")
    from repro_torch.optim import AdamW
    _, _, m = step(params, AdamW(lr=1e-3, grad_clip_norm=1.0).init(params),
                   batch)
    return float(m["loss"]), {n: g.detach() for n, g in zip(names, grads)}


@functools.lru_cache(maxsize=None)
def _pod_cells():
    from repro_torch.launch.mesh import run_ranks
    cases = {a: _reference_step(a)[:2] for a in ARCHS}
    return run_ranks(pod_rank, 8, (cases,), timeout_s=600)


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_ranks_share_rows_and_gradients_equal_reference(arch):
    """The sharded step's loss and every leaf's gradient on microbatch 0,
    laid out as its parameter and gathered whole, against the
    reference's and the port's unsharded step's (1e-3·max|leaf|; the
    losses at rtol 1e-5)."""
    *_, loss, want = _reference_step(arch)
    plain_loss, plain = _unsharded_step(arch)
    np.testing.assert_allclose(plain_loss, loss, rtol=1e-5)
    for out in _pod_cells():
        res = out[arch]
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(res["loss"], plain_loss, rtol=1e-5)
        got = res["grads"]
        assert sorted(got) == sorted(want) == sorted(plain)
        for name, w in want.items():
            g = got[name].float().numpy()
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(w).max() > 0, name
            assert np.abs(g - w).max() <= GRAD_TOL * scale, name
            p = plain[name].float().numpy()
            assert np.abs(g - p).max() <= GRAD_TOL * scale, name


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_ranks_gradients_come_back_in_their_parameters_placements(arch):
    """The inputs' rows lie over ``data`` and are whole over ``pod``; no
    leaf's gradient is a partial sum over ``pod`` (its two ranks saw the
    same rows), and every stacked layer leaf's comes back in its
    parameter's placements."""
    from torch.distributed.tensor import Replicate, Shard
    for out in _pod_cells():
        res = out[arch]
        for k, pl in res["batch_placements"].items():
            assert pl == (Replicate(), Shard(1), Replicate()), (k, pl)
        stacked = 0
        for name, (want, got) in res["placements"].items():
            assert got[0] == Replicate(), (name, got)
            if name.split("/")[0] in tsteps._LAYER_KEYS:
                stacked += 1
                assert got == want, name
        assert stacked >= 6, sorted(res["placements"])

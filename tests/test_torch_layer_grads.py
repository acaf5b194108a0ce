"""Each stacked layer's gradient reduced to its parameter's shards inside
the layer's backward (`repro_torch.models.transformer._LayerGrad`, run by
every layer loop that reads `_unbind_layers`).

  * on fake 4 × 4 and 16 × 16 worlds, one train step of a reduced
    transformer with a wide MLP (bf16, d_model 256, d_ff 8192) under
    `launch.roofline.StepCounter`, at 2 and at 6 layers: the temporaries
    that each added layer brings scale with 1 / the shard count, and no
    tensor live at the peak has a stacked leaf's whole (L, ...) shape or
    more bytes than one layer of it (the whole stacked gradient was there
    before: ~136 × a rank's layer shard a layer at 16 × 16);
  * the norms' backward (`models.common._RMSNorm`) is the reference's
    formula bitwise, with at most three f32 tensors of x's size live at
    once (the formula's own form holds six);
  * on a 2 × 2 gloo CPU mesh (one spawned world of 4 ranks), the reduced
    llava, zamba2 and whisper train steps through
    `launch.steps.make_lowerable` (the transformer's, zamba2's and
    whisper's encoder and decoder layer loops): `loss_and_grads` gives
    every stacked layer leaf's gradient in its parameter's placements,
    every leaf's gradient laid out as its parameter equals the
    reference's (`jax.value_and_grad` of its `loss_fn`, 1e-3·max|leaf|),
    the step's loss equals the reference's `make_lowerable(...).fn`'s
    (rtol 1e-5), both on an Auto (1, 1) JAX CPU mesh from the same numpy
    weights and batch, and the step keeps every leaf's placements.

jax is imported inside the tests only: the spawned ranks import this
module and must not load it.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.interop import tree_leaves, tree_map, tree_named_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.parallel import sharding

GRAD_TOL = 1e-3
WIDE = {"d_model": 256, "d_ff": 8192, "vocab": 512, "train_accum": 1,
        "dtype": "bfloat16"}
WIDE_TRAIN = ShapeSpec("train_wide", 8, 16, "train")


def _wide_step(side: int, n_layers: int):
    """(temporaries, a rank's stacked layer bytes, the stacked leaves'
    whole shapes, the tensors live at the peak) of one wide train step on
    a fake side × side world."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import _local_bytes
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    init_fake_world(side * side)
    try:
        mesh = make_mesh((side, side), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            low = tsteps.make_lowerable(
                "qwen3-0.6b", WIDE_TRAIN, mesh, reduced=True,
                cfg_overrides=dict(WIDE, n_layers=n_layers))
            layers = low.args[0]["layers"]
            counter = roofline.StepCounter()
            roofline.count_step(low.fn, *low.args, counter=counter)
            shapes = {tuple(t.shape) for t in tree_leaves(layers)}
            return (counter.peak_bytes, _local_bytes(layers), shapes,
                    counter.peak_live)
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()


def test_stacked_layer_gradient_temporaries_scale_with_the_shard_count():
    growth = {}
    for side in (4, 16):
        t2, _, _, _ = _wide_step(side, 2)
        t6, layer6, shapes, live = _wide_step(side, 6)
        growth[side] = (t6 - t2) / 4
        # each added layer brings a few copies of a rank's shard of it
        # (the f32 sums, the stacked bf16 gradient, the optimizer's
        # temporaries), never a whole layer
        assert growth[side] <= 16 * layer6 / 6, (side, growth, layer6)
        whole_layer = max(int(np.prod(s[1:])) for s in shapes) * 2
        for n, op, shape, _ in live:
            assert tuple(shape) not in shapes, (side, op, shape)
            assert n <= whole_layer, (side, op, shape, n)
    # 16 times the shards: at most 2 / 16 of the growth
    assert growth[16] * 16 <= 2 * growth[4], growth


# ---------------------------------------------------------------------------
# the norms' backward: the same function, fewer f32 copies of x live
# ---------------------------------------------------------------------------

def _rms_bwd_formula(x, scale, g, eps=1e-6):
    """The reference's `_rms_bwd` (`repro.models.common`), written out:
    every f32 intermediate kept until the end."""
    from repro_torch.models.common import upcast
    xf, gf = upcast(x), upcast(g)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gs = gf * upcast(scale)
    dx = r * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dscale.to(scale.dtype)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float64))
def test_rms_norm_backward_is_the_formula_bitwise(dtype):
    from repro_torch.models.common import rms_norm
    gen = torch.Generator().manual_seed(4)
    for shape in ((3, 17, 64), (2, 5, 7, 96)):
        x = (torch.randn(shape, generator=gen) * 3).to(dtype)
        scale = (torch.randn(shape[-1], generator=gen) + 1).to(dtype)
        g = torch.randn(shape, generator=gen).to(dtype)
        xr, sr = x.clone().requires_grad_(True), scale.clone(
            ).requires_grad_(True)
        got = torch.autograd.grad(rms_norm(xr, sr), (xr, sr), g)
        for a, b in zip(got, _rms_bwd_formula(x, scale, g)):
            assert a.dtype == b.dtype and torch.equal(a, b), shape


def test_rms_norm_backward_holds_three_f32_copies():
    """A bf16 stream's norm backward under `StepCounter`: at most three
    f32 tensors of x's size live at once (the formula above holds six)."""
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models.common import rms_norm
    x = torch.randn(4, 64, 256).to(torch.bfloat16).requires_grad_(True)
    scale = torch.ones(256, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(4, 64, 256).to(torch.bfloat16)
    y = rms_norm(x, scale)
    counter = StepCounter()
    with counter:
        torch.autograd.grad(y, (x, scale), g)
    f32 = x.numel() * 4
    assert 3 * f32 <= counter.peak_bytes < 3.1 * f32, counter.peak_live


# ---------------------------------------------------------------------------
# the sharded steps of the other layer loops on a 2 x 2 gloo CPU mesh
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("llava-next-34b", "zamba2-1.2b", "whisper-large-v3")
TRAIN = ShapeSpec("train_t", 32, 8, "train")


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def family_rank(rank, world, cases):
    """One rank of the 2 x 2 world, for each arch: from `loss_and_grads`
    on microbatch 0, the stacked layer leaves' gradient placements (and
    their parameters') and every leaf's gradient laid out as its
    parameter, gathered whole; then the train step's loss and whether it
    kept every leaf's placements."""
    from repro_torch.interop import to_torch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import registry as treg
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch, (params_np, batch_np) in cases.items():
        low = tsteps.make_lowerable(arch, TRAIN, mesh, reduced=True,
                                    params=to_torch(params_np, "cpu"))
        params = low.args[0]
        batch = low.place(2, tree_map(torch.from_numpy, batch_np))
        with tsteps._replication(params):
            _, grads = tsteps.loss_and_grads(
                treg.build(low.cfg), params, tree_map(lambda t: t[0], batch))
        names = [n for n, _ in tree_named_leaves(params)]
        res = {"placements": {
            n: (tuple(p.placements), tuple(g.placements))
            for n, p, g in zip(names, tree_leaves(params), grads)
            if n.split("/")[0] in tsteps._LAYER_KEYS},
            "grads": {n: _full(tsteps._like(g, p)).detach() for n, p, g in
                      zip(names, tree_leaves(params), grads)}}
        del grads
        new_p, _, m = low.fn(params, low.args[1], batch)
        res["loss"] = float(_full(m["loss"]))
        res["placements_after_step"] = all(
            tuple(a.placements) == tuple(b.placements)
            for a, b in zip(tree_leaves(new_p), tree_leaves(params)))
        out[arch] = res
    sharding.set_mesh(None)
    return out


@functools.lru_cache(maxsize=None)
def _reference_step(arch: str):
    """The reference's reduced weights and a batch (numpy), the loss of
    its train step and the gradient of every leaf on microbatch 0 (the
    step's `jax.value_and_grad` of `model.loss_fn`) on an Auto (1, 1) JAX
    CPU mesh."""
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
    cfg = jsteps.resolve_config(arch, shape, reduced=True)
    model = jreg.build(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(3)
    batch = {}
    for k, v in jsteps.input_specs(cfg, shape).items():
        if v.dtype == jnp.int32:
            batch[k] = rng.integers(0, cfg.vocab, v.shape).astype(np.int32)
        else:
            batch[k] = rng.standard_normal(v.shape).astype(v.dtype)
    try:
        with mesh:
            low = jsteps.make_lowerable(arch, shape, mesh, reduced=True)
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
def _family_cells():
    from repro_torch.launch.mesh import run_ranks
    cases = {a: _reference_step(a)[:2] for a in FAMILY_ARCHS}
    return run_ranks(family_rank, 4, (cases,), timeout_s=600)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_stacked_layer_gradients_come_back_in_their_parameters_placements(
        arch):
    for out in _family_cells():
        pl = out[arch]["placements"]
        assert len(pl) >= 6, sorted(pl)
        assert any(any(p.is_shard() for p in want)
                   for want, _ in pl.values())
        for name, (want, got) in pl.items():
            assert got == want, name
        assert out[arch]["placements_after_step"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_family_gradients_equal_reference(arch):
    """The sharded step's loss, and every leaf's gradient on microbatch 0
    laid out as its parameter and gathered whole, against the
    reference's (1e-3·max|leaf|)."""
    *_, loss, want = _reference_step(arch)
    for out in _family_cells():
        res = out[arch]
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
        got = res["grads"]
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name].float().numpy()
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(w).max() > 0, name
            assert np.abs(g - w).max() <= GRAD_TOL * scale, name

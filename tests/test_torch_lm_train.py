"""Port vs reference: the dense LM training path (repro_torch.models
training functions, launch.steps.build_train_step, data.pipeline,
checkpoint, runtime.fault, launch.train).

The same numpy inputs go to both packages: JAX's `init` draws the weights
(the two packages cannot share random streams) and `interop` carries them
across; fused attention runs the Pallas kernels in interpret mode on the
JAX side and the kernels' plain versions on the port's. Bounds:

  * `rms_norm`'s backward: f32 rtol 1e-6 / atol 5e-6 (a few ulps); bf16
    within one bf16 rounding (both round the same f32 math once).
  * `cross_entropy`, `loss_fn` and the gradient of every leaf, qwen3-reduced
    fused and unfused: the LM bound of tests/test_torch_lm.py, rtol 1e-4
    with atol 1e-4 · max|leaf| (measured: 1.5e-6 · max|leaf|).
  * smollm-reduced's gradients: rtol 1e-3 with atol 1e-3 · max|leaf|. Its
    near one-hot softmax (no qk-norm, |k| up to ~40) makes the gradient
    ill-conditioned in f32 in both packages alike: against a float64 run
    of the port on these inputs, JAX's f32 gradients are off by up to
    6.4e-4 · max|leaf| (unfused) and 4.8e-4 (fused), the port's by 1.0e-3,
    and the reference's own fused and unfused paths differ by 1.8e-4 ·
    max|leaf| (`test_smollm_gradients_are_ill_conditioned_in_f32`); port
    and reference differ by up to 5.7e-4 · max|leaf| (3.2× the LM bound,
    0.32 of this one). The loss itself is within 4e-6.
  * Three train steps (accum 2, AdamW with grad_clip_norm 1.0, clipping
    active at every step) from carried-over params and optimizer state
    against the reference's jitted step: the loss at rtol 1e-5, and every
    leaf of the params and of both moments at the LM bound. No leaf needs
    Adam's bound here (an entry whose gradient is rounding noise around 0
    would step ±lr on its sign alone, as the equalizer's BN-fed biases do in
    tests/test_torch_train.py): on these inputs none does.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenSource as JTokenSource
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro.models import transformer as jtr
from repro.optim import AdamW as JAdamW
from repro.optim.adam import AdamState as JAdamState
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import PipelineConfig, TokenSource, lm_batches
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW
from repro_torch.optim.adam import AdamState
from repro_torch.runtime import (FailureInjector, TrainLoopConfig,
                                 WorkerFailure, run_with_restarts)

KEY = jax.random.PRNGKey(0)
B, S = 2, 40
LR = 3e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, rel, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _paths(tree, prefix=""):
    """Leaf names in tree_leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax.tree.map(np.asarray,
                        jreg.build(jconfigs.get_config(arch, True)).init(KEY))


def _tokens(vocab: int, shape=(B, S)) -> np.ndarray:
    return np.asarray(jax.random.randint(KEY, shape, 0, vocab), np.int32)


# ---------------------------------------------------------------------------
# numerics: rms_norm's VJP, cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_matches_jax_vjp(dtype):
    rng = np.random.default_rng(0)
    arrs = [(rng.standard_normal((2, 7, 3, 48)) * 3).astype(np.float32),
            rng.standard_normal(48).astype(np.float32),
            rng.standard_normal((2, 7, 3, 48)).astype(np.float32)]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    x, scale, g = arrs
    y, vjp = jax.vjp(jcommon.rms_norm, jnp.asarray(x), jnp.asarray(scale))
    dx, dscale = vjp(jnp.asarray(g))
    tdt = getattr(torch, dtype)
    tx = _t(x.astype(np.float32)).to(tdt).requires_grad_(True)
    ts = _t(scale.astype(np.float32)).to(tdt).requires_grad_(True)
    ty = tcommon.rms_norm(tx, ts)
    gx, gs = torch.autograd.grad(ty, (tx, ts), _t(g.astype(np.float32))
                                 .to(tdt))
    assert (ty.dtype, gx.dtype, gs.dtype) == (tdt,) * 3
    assert gs.shape == (48,)
    for name, got, want in (("y", ty, y), ("dx", gx, dx),
                            ("dscale", gs, dscale)):
        want = _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=5e-6,
                                       err_msg=name)
        else:   # one bf16 rounding of the same f32 math
            np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7,
                                       atol=1e-6, err_msg=name)


def test_rms_norm_gradient_flows_through_a_stacked_scale_view():
    """q_norm's scale is a view of the (L, dh) stacked leaf: dscale sums
    over every leading axis of x and lands in that layer's row only."""
    stacked = torch.ones(3, 8, requires_grad=True)
    x = torch.randn(2, 5, 4, 8)
    tcommon.rms_norm(x, stacked.unbind(0)[1]).sum().backward()
    assert bool((stacked.grad[[0, 2]] == 0).all())
    assert bool((stacked.grad[1] != 0).any())


def test_cross_entropy_and_its_gradient_match_reference():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 9, 640)) * 4).astype(np.float32)
    labels = rng.integers(0, 600, (2, 9)).astype(np.int32)

    def jce(lg):
        return jtr.cross_entropy(lg, jnp.asarray(labels), 600)
    want, jg = jax.value_and_grad(jce)(jnp.asarray(logits))
    tl = _t(logits).requires_grad_(True)
    got = ttr.cross_entropy(tl, _t(labels), 600)
    (tg,) = torch.autograd.grad(got, (tl,))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-6, atol=5e-9)
    assert bool((tg[..., 600:] == 0).all())        # padded vocab: masked


# ---------------------------------------------------------------------------
# loss and gradients of the whole model, weights carried across
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch: str, fused: bool):
    jm = jreg.build(jconfigs.get_config(arch, True, fused_attention=fused))
    toks = jnp.asarray(_tokens(jm.cfg.vocab))
    (loss, aux), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, _jax_params(arch)),
        {"tokens": toks, "labels": toks})
    return (float(loss), float(aux["ce"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_loss_and_grads(arch: str, fused: bool, **overrides):
    tm = treg.build(tconfigs.get_config(arch, True, fused_attention=fused,
                                        **overrides))
    params = tree_map(lambda p: p.to(tm.cfg.param_dtype()),
                      interop.to_torch(_jax_params(arch), "cpu"))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = _t(_tokens(tm.cfg.vocab)).long()
    loss, aux = tm.loss_fn(tree_unflatten(params, leaves),
                           {"tokens": toks, "labels": toks})
    return loss, aux, torch.autograd.grad(loss, leaves), params


@pytest.mark.parametrize("arch,rel", [("qwen3-0.6b", 1e-4),
                                      ("smollm-135m", 1e-3)])
@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_every_gradient_match_reference(arch, rel, fused):
    jloss, jce, jgrads = _jax_loss_and_grads(arch, fused)
    loss, aux, grads, params = _port_loss_and_grads(arch, fused)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), jce, rtol=1e-5)
    assert float(aux["aux"]) == 0.0
    names = _paths(params)
    assert len(names) == len(grads) == len(jgrads)
    for name, g, jg in zip(names, grads, jgrads):
        assert g.shape == jg.shape, name
        _close(g, jg, rel, f"{arch} fused={fused} {name}")
    attn = dict(zip(names, grads))
    for key in ("wq", "wk", "wv", "wo"):
        assert float(attn[f"/layers/attn/{key}"].abs().max()) > 0, key


def _worst_over_max(grads, truth) -> float:
    return max(float(np.abs(_np(g) - t).max() / np.abs(t).max())
               for g, t in zip(grads, truth))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-135m"])
def test_smollm_gradients_are_ill_conditioned_in_f32(arch):
    """Why smollm-reduced is held at 1e-3: against a float64 run of the
    port (unfused) on the same inputs, the reference's own f32 gradients
    miss the LM bound for smollm-reduced, and its fused and unfused paths
    disagree by more than it; qwen3-reduced's f32 gradients, both
    packages', are within 1e-5 · max|leaf| of float64. Both packages'
    smollm gradients are within 2e-3 · max|leaf| of float64."""
    _, _, truth, _ = _port_loss_and_grads(arch, False, dtype="float64")
    truth = [g.numpy() for g in truth]
    jax_u = _worst_over_max(_jax_loss_and_grads(arch, False)[2], truth)
    jax_f = _worst_over_max(_jax_loss_and_grads(arch, True)[2], truth)
    port_u = _worst_over_max(_port_loss_and_grads(arch, False)[2], truth)
    jax_paths = _worst_over_max(_jax_loss_and_grads(arch, True)[2],
                                _jax_loss_and_grads(arch, False)[2])
    if arch == "qwen3-0.6b":
        assert max(jax_u, jax_f, port_u, jax_paths) < 1e-5
    else:
        assert jax_u > 1e-4 and jax_paths > 1e-4
        assert max(jax_u, jax_f, port_u) < 2e-3


def test_forward_logits_match_reference():
    cfg = jconfigs.get_config("qwen3-0.6b", True, fused_attention=True)
    toks = _tokens(cfg.vocab)
    want, _ = jtr.forward(jax.tree.map(jnp.asarray,
                                       _jax_params("qwen3-0.6b")),
                          jnp.asarray(toks), cfg)
    with torch.no_grad():
        got, aux = ttr.forward(interop.to_torch(_jax_params("qwen3-0.6b"),
                                                "cpu"), _t(toks).long(),
                               tconfigs.get_config("qwen3-0.6b", True,
                                                   fused_attention=True))
    assert got.shape == (B, S, cfg.vocab_padded) and float(aux) == 0.0
    _close(got, want, 1e-4, "logits")


def test_remat_leaves_loss_and_gradients_unchanged():
    """Rematerializing each layer recomputes the same values: loss and
    gradients equal the run without remat bitwise (on the CPU)."""
    a_loss, _, a_grads, _ = _port_loss_and_grads("qwen3-0.6b", True)
    b_loss, _, b_grads, _ = _port_loss_and_grads("qwen3-0.6b", True,
                                                 remat=False)
    assert torch.equal(a_loss, b_loss)
    assert all(torch.equal(a, b) for a, b in zip(a_grads, b_grads))


# ---------------------------------------------------------------------------
# the train step: accumulation, clipping, Adam
# ---------------------------------------------------------------------------

def _step_batches(vocab: int, n: int, accum: int = 2, mb: int = 2,
                  seq: int = 24) -> np.ndarray:
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3),
                                         (n, accum, mb, seq), 0, vocab),
                      np.int32)
    return toks


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_reference_jitted_step(fused):
    arch, steps = "qwen3-0.6b", 3
    jcfg = jconfigs.get_config(arch, True, fused_attention=fused)
    jm = jreg.build(jcfg)
    jopt = JAdamW(lr=LR, grad_clip_norm=1.0)
    jstep = jax.jit(jsteps.build_train_step(jm, jopt))
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    jo = jopt.init(jp)
    # one step first, so the port starts from a carried-over, non-zero
    # optimizer state
    data = _step_batches(jcfg.vocab, steps + 1)
    first = {"tokens": jnp.asarray(data[0]), "labels": jnp.asarray(data[0])}
    jp, jo, _ = jstep(jp, jo, first)
    params = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    opt_state = interop.adam_state_to_torch(jax.tree.map(np.asarray, jo),
                                            "cpu")
    assert isinstance(opt_state, AdamState) and int(opt_state.step) == 1
    grad_norms = []

    tm = treg.build(tconfigs.get_config(arch, True, fused_attention=fused))
    tstep = tsteps.build_train_step(tm, AdamW(lr=LR, grad_clip_norm=1.0))

    @jax.jit
    def grad_norm(p, batch):
        g = [jax.grad(lambda q: jm.loss_fn(q, jax.tree.map(
            lambda a: a[j], batch))[0])(p) for j in range(2)]
        g = jax.tree.map(lambda a, b: (a + b) / 2, *g)
        return jnp.sqrt(sum(jnp.sum(jnp.square(x))
                            for x in jax.tree.leaves(g)))

    for i in range(1, steps + 1):
        batch = {"tokens": jnp.asarray(data[i]),
                 "labels": jnp.asarray(data[i])}
        grad_norms.append(float(grad_norm(jp, batch)))
        jp, jo, jmet = jstep(jp, jo, batch)
        tb = tree_map(lambda a: _t(a).long(), {"tokens": data[i],
                                               "labels": data[i]})
        params, opt_state, met = tstep(params, opt_state, tb)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    assert min(grad_norms) > 1.0           # clipping was active every step
    assert int(opt_state.step) == int(jo.step) == steps + 1
    for what, got, want in (("params", params, jp),
                            ("mu", opt_state.mu, jo.mu),
                            ("nu", opt_state.nu, jo.nu)):
        for name, a, w in zip(_paths(got), tree_leaves(got),
                              jax.tree.leaves(want)):
            _close(a, w, 1e-4, f"{what} {name}")


def test_train_step_accumulates_in_f32_and_averages():
    """accum 2 over the same microbatch twice is the step of accum 1."""
    cfg = tconfigs.get_config("qwen3-0.6b", True, fused_attention=True)
    model = treg.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(lr=LR, grad_clip_norm=1.0)
    step = tsteps.build_train_step(model, opt)
    toks = torch.randint(0, cfg.vocab, (1, 2, 16),
                         generator=torch.Generator().manual_seed(1))
    one = {"tokens": toks, "labels": toks}
    two = tree_map(lambda t: t.repeat(2, 1, 1), one)
    p1, s1, m1 = step(params, opt.init(params), one)
    p2, s2, m2 = step(params, opt.init(params), two)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)
    # nothing was updated in place
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,seq,vocab", [(0, 256, 512), (3, 2048, 151936),
                                            (7, 1, 10), (1, 33, 2)])
def test_token_source_block_is_the_reference_bitwise(seed, seq, vocab):
    j = JTokenSource(JPipelineConfig(seq_len=seq, global_batch=1, seed=seed),
                     vocab)
    t = TokenSource(PipelineConfig(seq_len=seq, global_batch=1, seed=seed),
                    vocab)
    for step in (0, 1, 17):
        for row in (0, 5):
            want, got = j.block(step, row), t.block(step, row)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_lm_batches_lay_rows_out_as_the_reference():
    """Row r of accumulation slot a at step s is block(s, a·mb + r), from
    the requested start step on; tokens and labels are one tensor."""
    from jax.sharding import PartitionSpec as P
    from repro.data.pipeline import lm_batches as jlm_batches
    from repro.launch.mesh import make_mesh
    cfg = tconfigs.get_config("qwen3-0.6b", True)
    pipe = PipelineConfig(seq_len=16, global_batch=6, accum=2, seed=4)
    mesh = make_mesh((1, 1), ("data", "model"))
    spec = {"tokens": P(None, ("data",), None)}
    jit_ = jlm_batches(JPipelineConfig(**dataclasses.asdict(pipe)),
                       jconfigs.get_config("qwen3-0.6b", True), mesh, spec,
                       start_step=2)
    it = lm_batches(pipe, cfg, "cpu", start_step=2)
    for _ in range(2):
        want, got = next(jit_), next(it)
        assert got["tokens"].shape == (2, 3, 16)
        assert got["labels"] is got["tokens"]
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_state(arch="qwen3-0.6b"):
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    jopt = JAdamW(lr=LR)
    jo = jopt.init(jp)
    # non-trivial moments
    jo = JAdamState(step=jnp.asarray(5, jnp.int32),
                    mu=jax.tree.map(lambda p: p * 0.5, jp),
                    nu=jax.tree.map(lambda p: p * p, jp))
    return jp, jo


def _port_template(arch="qwen3-0.6b", dtype=None):
    cfg = tconfigs.get_config(arch, True, **({"dtype": dtype} if dtype
                                             else {}))
    params = treg.build(cfg).init(torch.Generator().manual_seed(9), "cpu")
    return params, AdamW().init(params)


def test_jax_written_f32_checkpoint_restores_in_port_leaf_for_leaf(tmp_path):
    jp, jo = _jax_state()
    JCheckpointManager(str(tmp_path)).save(7, (jp, jo), extra={"step": 7})
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() == 7 and ckpt.extra() == {"step": 7}
    params, opt_state = ckpt.restore(_port_template())
    assert isinstance(opt_state, AdamState)
    assert int(opt_state.step) == 5 and opt_state.step.dtype == torch.int32
    for got, want in zip(tree_leaves((params, opt_state)),
                         jax.tree.leaves((jp, jo))):
        assert got.dtype == torch.float32 or got.dim() == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_written_f32_checkpoint_restores_in_jax(tmp_path):
    jp, jo = _jax_state()
    params = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    opt_state = interop.adam_state_to_torch(jax.tree.map(np.asarray, jo),
                                            "cpu")
    CheckpointManager(str(tmp_path)).save(3, (params, opt_state))
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert "0/layers/attn/wq" in manifest["arrays"]
    assert "1/mu/embed" in manifest["arrays"] and "1/step" in \
        manifest["arrays"]
    rp, ro = JCheckpointManager(str(tmp_path)).restore((jp, jo))
    for got, want in zip(jax.tree.leaves((rp, ro)),
                         jax.tree.leaves((jp, jo))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bf16_checkpoint_round_trips_bitwise_as_uint16(tmp_path):
    params, opt_state = _port_template(dtype="bfloat16")
    params = tree_map(lambda p: p + 0.001 * torch.randn(
        p.shape, generator=torch.Generator().manual_seed(2)).to(p.dtype),
        params)
    ckpt = CheckpointManager(str(tmp_path), keep_k=2)
    ckpt.save(1, (params, opt_state))
    src = tmp_path / "step_00000001"
    manifest = json.loads((src / "manifest.json").read_text())
    meta = manifest["arrays"]["0/layers/attn/wq"]
    assert meta["dtype"] == "bfloat16"
    assert np.load(src / meta["file"]).dtype == np.uint16
    assert manifest["arrays"]["1/mu/layers/attn/wq"]["dtype"] == "float32"
    template = _port_template(dtype="bfloat16")
    rp, ro = ckpt.restore(template)
    for got, want in zip(tree_leaves((rp, ro)), tree_leaves((params,
                                                             opt_state))):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    # a file holding the bits as 2-byte void records reads back the same
    arr = np.load(src / meta["file"])
    np.save(src / meta["file"], arr.view(np.dtype("V2")))
    again, _ = ckpt.restore(template)
    assert torch.equal(again["layers"]["attn"]["wq"],
                       params["layers"]["attn"]["wq"])


def test_checkpoints_keep_k_and_publish_atomically(tmp_path):
    tree = ({"w": torch.arange(4.0)}, AdamW().init({"w": torch.zeros(4)}))
    ckpt = CheckpointManager(str(tmp_path), keep_k=2)
    (tmp_path / "step_00000009.tmp").mkdir()      # a save cut short
    for s in (1, 2, 3):
        ckpt.save(s, tree)
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)
    restored = ckpt.restore(tree, step=2)
    assert torch.equal(restored[0]["w"], tree[0]["w"])


# ---------------------------------------------------------------------------
# the fault-tolerant loop and the CLI
# ---------------------------------------------------------------------------

def _loop(tmp_path, fail_at=(), steps=5):
    cfg = tconfigs.get_config("qwen3-0.6b", True, tp=1,
                              fused_attention=True)
    init_state, train_step = ttrain.build(cfg, LR, 2, "cpu")
    pipe = PipelineConfig(seq_len=16, global_batch=4, accum=2)
    return run_with_restarts(
        TrainLoopConfig(total_steps=steps, checkpoint_every=2, log_every=1),
        CheckpointManager(str(tmp_path)), init_state, train_step,
        lambda s: lm_batches(pipe, cfg, "cpu", start_step=s),
        injector=FailureInjector(fail_at=tuple(fail_at)))


def test_restart_after_injected_failure_ends_bitwise_as_uninterrupted(
        tmp_path):
    clean = _loop(tmp_path / "a")
    failed = _loop(tmp_path / "b", fail_at=(3,))
    assert (clean["restarts"], failed["restarts"]) == (0, 1)
    assert clean["steps"] == failed["steps"] == 5
    for a, b in zip(tree_leaves(clean["final"]),
                    tree_leaves(failed["final"])):
        assert torch.equal(a, b)
    # the replayed steps 3..5 logged the same losses
    assert dict(clean["history"]) == dict(failed["history"])


def test_restarts_are_bounded():
    def init_state():
        return {"w": torch.zeros(1)}, None

    class Always:
        def check(self, step):
            raise WorkerFailure("always")
    with pytest.raises(WorkerFailure):
        run_with_restarts(TrainLoopConfig(total_steps=3, max_restarts=2),
                          _NoCkpt(), init_state, lambda p, o, b: (p, o, {}),
                          lambda s: iter(range(100)), injector=Always())


class _NoCkpt:
    def latest_step(self):
        return None


def test_train_main_on_the_cpu_returns_zero(tmp_path):
    assert ttrain.main(["--device", "cpu", "--arch", "qwen3-0.6b",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--ckpt-dir", str(tmp_path)]) == 0
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_train_run_survives_a_failure_and_reports_losses(tmp_path):
    out = ttrain.run(["--device", "cpu", "--arch", "smollm-135m", "--layers",
                      "1", "--steps", "3", "--batch", "4", "--seq", "16",
                      "--accum", "2", "--ckpt-every", "1", "--fail-at", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 3 and out["restarts"] == 1
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    params, _ = out["final"]
    assert params["layers"]["attn"]["wq"].shape[0] == 1   # --layers 1
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2, 3]


def test_build_draws_seeded_state_and_clips():
    cfg = tconfigs.get_config("smollm-135m", True, tp=1,
                              fused_attention=True)
    init_state, _ = ttrain.build(cfg, LR, 1, "cpu")
    (p1, o1), (p2, _) = init_state(), init_state()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                 tree_leaves(p2)))
    assert int(o1.step) == 0
    assert all(float(m.abs().max()) == 0 for m in tree_leaves(o1.mu))


def test_adam_state_carries_across_and_back():
    jp = jax.tree.map(jnp.asarray, _jax_params("smollm-135m"))
    jo = JAdamState(step=jnp.asarray(4, jnp.int32),
                    mu=jax.tree.map(lambda p: p * 2, jp),
                    nu=jax.tree.map(lambda p: p * p, jp))
    t = interop.adam_state_to_torch(jax.tree.map(np.asarray, jo), "cpu")
    assert isinstance(t, AdamState) and t.step.dtype == torch.int32
    back = JAdamState(*interop.to_numpy(t))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

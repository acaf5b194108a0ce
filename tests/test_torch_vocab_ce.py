"""The vocab-parallel next-token CE (`repro_torch.models.transformer.
next_token_ce` on DTensor logits split over ``model``).

  * on a 2 × 2 gloo CPU mesh (one spawned world of 4 ranks), a padded
    vocab (300 in 384 columns: the padding on the second ``model`` rank
    only), labels in both ranks' slices and a prefix ``start`` > 0: the
    loss equals `_token_ce` on the whole logits, `torch.logsumexp` plus a
    gather, and the reference's `cross_entropy` at the LM bound; its
    gradient equals the plain autograd gradient within 1e-6·max|g| and
    comes back in the logits' placements;
  * on a one-rank (1, 1) mesh the DTensor loss and gradient are bitwise
    the plain ones (the same arithmetic, no collective);
  * on a fake 16 × 16 world at qwen3's vocabulary, under
    `launch.roofline.StepCounter`: the forward and backward's temporaries
    scale with V_pad / 16 (no rank holds the whole vocabulary of its
    rows), the CE's three all-reduces are counted and nothing is
    gathered.

jax is imported inside the tests only: the spawned ranks import this
module and must not load it.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.models import transformer as ttr
from repro_torch.parallel import sharding

VOCAB, V_PAD = 300, 384
B, S, START = 4, 11, 3
LM_RTOL, LM_ATOL_REL, GRAD_REL = 1e-4, 1e-4, 1e-6


def _case(seed: int = 0):
    """f32 logits (B, S, V_PAD) with the padded columns set large (the
    mask must hide them) and text labels (B, S − START) spread over
    both halves of the vocabulary."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V_PAD)) * 3).astype(np.float32)
    logits[..., VOCAB:] += 40.0
    labels = rng.integers(0, VOCAB, (B, S - START)).astype(np.int32)
    labels[:, ::2] = rng.integers(V_PAD // 2, VOCAB, labels[:, ::2].shape)
    labels[:, 1::2] = rng.integers(0, V_PAD // 2, labels[:, 1::2].shape)
    return logits, labels


def _plain(logits: torch.Tensor, labels: torch.Tensor):
    """torch.logsumexp plus a gather, by autograd: (loss, dloss/dlogits),
    in f32 (float64 for float64 logits)."""
    lg = logits.clone().requires_grad_(True)
    lf = lg[:, START:-1].to(torch.promote_types(lg.dtype, torch.float32))
    lf = lf.masked_fill(
        torch.arange(V_PAD) >= VOCAB, -1e30)
    picked = lf.gather(-1, labels[:, 1:, None].long())[..., 0]
    loss = (torch.logsumexp(lf, -1) - picked).mean()
    (g,) = torch.autograd.grad(loss, lg)
    return loss.detach(), g


def vocab_ce_rank(rank, world, logits_np, labels_np):
    """One rank of the 2 × 2 world: the CE of logits laid out (batch, None,
    vocab) and this rank's shard of its gradient, with the gradient's
    placements. Each rank cuts its own shards (`DTensor.from_local`), so
    no collective runs but the CE's and the loss's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    # one intra-op thread: under CPU contention, ranks of two threads
    # now and then return values ~1e-5 off (the whole-vocab CE does too)
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    sharding.set_mesh(mesh, "train")
    try:
        rows = _rows(mesh.get_local_rank("data"))
        cols = _cols(mesh.get_local_rank("model"))
        lg = DTensor.from_local(
            torch.from_numpy(logits_np[rows, :, cols]).requires_grad_(True),
            mesh, [Shard(0), Shard(2)], run_check=False)
        lb = DTensor.from_local(torch.from_numpy(labels_np[rows]), mesh,
                                [Shard(0), Replicate()], run_check=False)
        loss = ttr.next_token_ce(lg, lb, VOCAB, START)
        (g,) = torch.autograd.grad(loss, lg)
        return {"loss": loss.detach().full_tensor(), "grad": g.to_local(),
                "rows": rows, "cols": cols,
                "grad_placements": tuple(g.placements),
                "logit_placements": tuple(lg.placements)}
    finally:
        sharding.set_mesh(None)


def _rows(i: int) -> slice:
    return slice(i * B // 2, (i + 1) * B // 2)


def _cols(i: int) -> slice:
    return slice(i * V_PAD // 2, (i + 1) * V_PAD // 2)


@pytest.fixture(scope="module")
def gloo_ce():
    from repro_torch.launch.mesh import run_ranks
    logits, labels = _case()
    # the labels' slices: both model ranks hold some
    assert (labels[:, 1:] < V_PAD // 2).any() and (
        labels[:, 1:] >= V_PAD // 2).any()
    return logits, labels, run_ranks(vocab_ce_rank, 4, (logits, labels),
                                     timeout_s=300)


def test_vocab_parallel_ce_equals_the_whole_vocab_ce(gloo_ce):
    import jax.numpy as jnp
    from repro.models import transformer as jtr
    logits, labels, outs = gloo_ce
    lg, lb = torch.from_numpy(logits), torch.from_numpy(labels)
    whole = ttr._token_ce(lg[:, START:-1], lb[:, 1:], VOCAB).mean()
    plain, _ = _plain(lg, lb)
    ref = float(jtr.cross_entropy(jnp.asarray(logits[:, START:-1]),
                                  jnp.asarray(labels[:, 1:]), VOCAB))
    for out in outs:
        got = float(out["loss"])
        for want in (float(whole), float(plain), ref):
            np.testing.assert_allclose(got, want, rtol=LM_RTOL,
                                       atol=LM_ATOL_REL * abs(want))
    assert np.isfinite(ref) and ref > 0


def test_vocab_parallel_ce_gradient_equals_autograd_in_place(gloo_ce):
    logits, labels, outs = gloo_ce
    _, want = _plain(torch.from_numpy(logits), torch.from_numpy(labels))
    scale = float(want.abs().max())
    assert scale > 0
    _, exact = _plain(torch.from_numpy(logits).double(),
                      torch.from_numpy(labels))
    g = torch.full_like(want, float("nan"))
    for out in outs:
        assert out["grad_placements"] == out["logit_placements"]
        g[out["rows"], :, out["cols"]] = out["grad"]
    assert g.dtype == want.dtype and not bool(g.isnan().any())
    gap = float((g - want).abs().max())
    assert gap <= GRAD_REL * scale, (
        gap, float((g.double() - exact).abs().max()),
        float((want.double() - exact).abs().max()))
    assert bool((g[:, :START] == 0).all() and (g[:, -1] == 0).all())
    assert bool((g[..., VOCAB:] == 0).all())           # padded: masked


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


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_one_rank_mesh_ce_is_bitwise_the_plain_ce(dtype, one_rank_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    logits, labels = _case(1)
    lg = torch.from_numpy(logits).to(dtype)
    lb = torch.from_numpy(labels)
    plain_lg = lg.clone().requires_grad_(True)
    plain = ttr.next_token_ce(plain_lg, lb, VOCAB, START)
    (plain_g,) = torch.autograd.grad(plain, plain_lg)
    sharding.set_mesh(one_rank_mesh, "train")
    dlg = distribute_tensor(lg, one_rank_mesh,
                            [Shard(0), Shard(2)]).requires_grad_(True)
    dlb = distribute_tensor(lb, one_rank_mesh, [Shard(0), Replicate()])
    loss = ttr.next_token_ce(dlg, dlb, VOCAB, START)
    (g,) = torch.autograd.grad(loss, dlg)
    assert torch.equal(loss.full_tensor(), plain)
    assert torch.equal(g.full_tensor(), plain_g) and g.dtype == dtype


def test_vocab_parallel_ce_temporaries_scale_with_the_local_vocab():
    """qwen3's vocabulary on a fake 16 × 16 world: the CE's forward and
    backward keep under three f32 copies of a rank's (B_l, S, V_pad / 16)
    slice alive at once, where one f32 copy of its rows at the whole
    vocabulary is 16 of them; three all-reduces over ``model``, no
    all-gather."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import configs as tconfigs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import StepCounter
    cfg = tconfigs.get_config("qwen3-0.6b")
    v_pad, batch, seq = cfg.vocab_padded, 32, 17
    mesh = make_production_mesh(fake=True)
    try:
        sharding.set_mesh(mesh, "train")
        sizes = sharding.mesh_axes(mesh)
        b_l, v_l = batch // sizes["data"], v_pad // sizes["model"]
        with FakeTensorMode(allow_non_fake_inputs=True):
            lg = DTensor.from_local(
                torch.empty(b_l, seq, v_l, dtype=torch.bfloat16), mesh,
                [Shard(0), Shard(2)], run_check=False).requires_grad_(True)
            lb = DTensor.from_local(torch.zeros(b_l, seq, dtype=torch.int32),
                                    mesh, [Shard(0), Replicate()],
                                    run_check=False)
            counter = StepCounter()
            with counter:
                loss = ttr.next_token_ce(lg, lb, cfg.vocab)
                (g,) = torch.autograd.grad(loss, lg)
            assert tuple(g.placements) == tuple(lg.placements)
            assert g.to_local().shape == (b_l, seq, v_l)
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()
    local_f32 = b_l * (seq - 1) * v_l * 4
    assert local_f32 <= counter.peak_bytes < 3 * local_f32
    assert counter.peak_bytes < b_l * (seq - 1) * v_pad * 4 / 4
    ops = counter.collectives().count
    assert ops.get("all-reduce", 0) >= 3 and "all-gather" not in ops, ops

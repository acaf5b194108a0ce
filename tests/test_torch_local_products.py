"""Every weight product of a sharded step multiplies each rank's own rows
(`parallel.sharding.weight_products` at the dense MLP, mamba2's and the
xLSTM blocks' projections; `attention.project_heads` / `merge_heads`, the
MoE layer and the LM head before them).

On a fake 4 × 4 ("data", "model") world, one train step and one prefill
of each family whose products run there (qwen3 dense, llava, zamba2,
whisper, xlstm-125m), at the reduced configs widened so that the MLP's
and the blocks' inner widths are at least 32 times a rank's rows: at such
widths DTensor's own strategy gathers the whole microbatch's rows instead
of the weight (its choice is cost-based, so the reduced widths would not
show it). Of the local matrix products a rank runs, as
`launch.roofline.StepCounter` logs them (`products`), none has an
operand dim of more token rows than the rank's batch shard holds: the
batch divides the 4 data ranks, and the sequence lengths are picked so
that no weight dim is a multiple of them. Where the rows do not divide
all the batch dims (llava's 16-row microbatch on 2 × 16 × 16), they split
over the largest set of them they divide (`sharding.row_axes`).

The tests import no jax: it also runs on a host without it.
"""
import pytest
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.interop import tree_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch.roofline import StepCounter
from repro_torch.parallel import sharding

SIDE = 4                   # the fake world is SIDE x SIDE (data, model)
BATCH, SEQ, ENC_LEN, IMG = 8, 13, 11, 4
# d_ff / the blocks' inner widths against a rank's 2 x 13 token rows
WIDE = {"qwen3-0.6b": {"d_model": 256, "d_ff": 8192},
        "llava-next-34b": {"d_ff": 8192, "img_tokens": IMG},
        "zamba2-1.2b": {"d_model": 1024, "d_ff": 8192},
        "whisper-large-v3": {"d_ff": 8192, "enc_len": ENC_LEN},
        "xlstm-125m": {"d_model": 1024}}
KINDS = {"train": ShapeSpec("train_rows", SEQ, BATCH, "train"),
         "prefill": ShapeSpec("prefill_rows", SEQ, BATCH, "prefill")}


def _lengths(cfg) -> set:
    """The token lengths of the family's rows: the sequence, llava's text
    after its image prefix, whisper's encoder frames."""
    out = {SEQ}
    if cfg.family == "vlm":
        out.add(SEQ - cfg.img_tokens)
    if cfg.family == "encdec":
        out.add(cfg.enc_len)
    return out


def _products(arch: str, kind: str):
    """(the local products, (op, operand shapes) → count; the config;
    every weight dim, whole and a rank's shard) of one step of ``kind``
    on the fake world."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    init_fake_world(SIDE * SIDE)
    try:
        mesh = make_mesh((SIDE, SIDE), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            low = tsteps.make_lowerable(
                arch, KINDS[kind], mesh, reduced=True,
                cfg_overrides=dict(WIDE[arch], train_accum=1,
                                   dtype="bfloat16"))
            dims = set()
            for t in tree_leaves(low.args[0]):
                dims.update(t.shape)
                dims.update(getattr(t, "_local_tensor", t).shape)
            counter = StepCounter()
            with counter:
                low.fn(*low.args)
            return counter.products, low.cfg, dims
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", tuple(KINDS))
@pytest.mark.parametrize("arch", tuple(WIDE))
def test_no_rank_multiplies_more_rows_than_its_batch_shard(arch, kind):
    products, cfg, weight_dims = _products(arch, kind)
    shard = BATCH // SIDE
    # the inner widths are wide enough that DTensor's own strategy would
    # gather the rows
    inner = cfg.d_ff or cfg.expand * cfg.d_model
    assert inner >= 32 * shard * SEQ, cfg
    # token rows of more than a rank's batch shard, for each length
    whole = {j * n for n in _lengths(cfg) for j in range(shard + 1,
                                                          BATCH + 1)}
    assert not whole & weight_dims, sorted(whole & weight_dims)
    assert sum(products.values()) > 10, products
    bad = [key for key in products
           if any(d in whole for s in key[1] for d in s)]
    assert not bad, (len(bad), bad[:8])


@pytest.mark.parametrize("batch, want", [
    (64, ("pod", "data")), (32, ("pod", "data")), (16, ("data",)),
    (2, ("pod",)), (3, ()), (1, ())])
def test_rows_split_over_the_largest_set_of_batch_dims_they_divide(
        batch, want):
    """`sharding.row_axes` on the 2 × 16 × 16 mesh: all batch dims where
    the rows divide them (the reference's rule), else the largest set
    they divide (llava's 16-row microbatch over ``data`` alone), none
    where no set divides; () without a mesh."""
    from repro_torch.launch.mesh import AbstractMesh
    assert sharding.row_axes(batch) == ()
    sharding.set_mesh(AbstractMesh.of((2, 16, 16), ("pod", "data",
                                                    "model")))
    try:
        assert sharding.row_axes(batch) == want
    finally:
        sharding.set_mesh(None)

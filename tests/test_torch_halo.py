"""Port vs reference: halo-exchange stream sharding
(repro_torch.parallel.halo) over a 4-rank gloo world of CPU processes.

The reference's own halo tests cannot run under the installed jax (its
`shard_map(check_rep=...)` call fails), so the port's halo is held against
oracles that do run:

  * `halo_exchange` gives rank 1 of 4 the halos [5, 6, 7] / [16, 17, 18]
    of a 32-sample arange, zeros at the stream edges (the twin of
    tests/test_halo.py::test_halo_exchange_unit);
  * `halo_apply` and `halo_apply_batched` through the port's fp32 engine
    equal the reference's `partitioned_apply` with `apply_folded` within
    rtol 1e-6 / atol 5e-6;
  * both equal the port's engine on the unsplit stream BITWISE, at every
    position, on fp32, bf16 and int8 (the kernels' plain versions);
  * int8 equals the reference `EqualizerEngine` on the whole stream
    exactly, and the int8 exchange hands only int8 tensors to the backend
    (the twin of the reference's jaxpr check);
  * one rank, or a halo of 0, only pads; a stream whose symbols do not
    divide by the ranks is refused.

The world is spawned once for the module (`launch.mesh.run_ranks`); its
ranks import this module, which imports jax only inside the tests, so no
rank loads it.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import equalizer as teq
from repro_torch.core.engine import EqualizerEngine
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.parallel import halo

RTOL, ATOL = 1e-6, 5e-6
WORLD = 4
CFG = teq.CNNEqConfig()
N_SYMS = 256 * WORLD
INT8_FMT = tuple((2, 5, 3, 4) for _ in range(CFG.layers))
DATAPATHS = {"fp32": ("fused_fp32", None), "bf16": ("fused_bf16", None),
             "int8": ("fused_int8", INT8_FMT)}


def _engines(folded) -> dict:
    return {dp: EqualizerEngine(cfg=CFG, weights=folded, backend=be,
                                formats=fmt, tile_m=32, device="cpu")
            for dp, (be, fmt) in DATAPATHS.items()}


def _halo_ranks(rank: int, world: int, folded, x: np.ndarray,
                xb: np.ndarray) -> dict:
    """Every scenario of this module on one rank of a gloo world."""
    out = {}
    arange = torch.arange(32, dtype=torch.float32)
    out["exchange"] = halo.halo_exchange(
        arange[rank * 8:(rank + 1) * 8], 3).numpy()
    mesh = make_mesh((world,), ("data",), "cpu")
    xs = halo.local_shard(torch.from_numpy(x), CFG, mesh)
    xbs = halo.local_shard(torch.from_numpy(xb), CFG, mesh)
    for dp, engine in _engines(folded).items():
        out[dp] = halo.halo_apply(engine, xs, CFG, mesh).numpy()
        out[dp + "_batched"] = halo.halo_apply_batched(
            engine, xbs, CFG, mesh).numpy()
    # what the int8 exchange hands to the backend
    sent = []
    real = halo.dist.batch_isend_irecv

    def spy(ops):
        sent.extend(str(op.tensor.dtype) for op in ops)
        return real(ops)

    halo.dist.batch_isend_irecv = spy
    try:
        halo.halo_apply(_engines(folded)["int8"], xs, CFG, mesh)
    finally:
        halo.dist.batch_isend_irecv = real
    out["int8_sent"] = sent
    try:
        halo.local_shard(torch.zeros(2 * (N_SYMS + 2)), CFG, mesh)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _reference():
    import jax
    from repro.core import equalizer as jeq
    jcfg = jeq.CNNEqConfig()
    key = jax.random.PRNGKey(0)
    params = jeq.init(key, jcfg)
    folded = jeq.fold_bn(params, jeq.init_bn_state(jcfg), jcfg)
    weights = tuple((np.asarray(w), np.asarray(b))
                    for w, b in jeq.folded_weights(folded))
    x = np.asarray(jax.random.normal(key, (N_SYMS * CFG.n_os,)), np.float32)
    xb = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                      (3, N_SYMS * CFG.n_os)), np.float32)
    return jcfg, folded, weights, x, xb


@pytest.fixture(scope="module")
def world():
    jcfg, folded, weights, x, xb = _reference()
    ranks = run_ranks(_halo_ranks, WORLD, (weights, x, xb), timeout_s=300)
    return {"jcfg": jcfg, "folded": folded, "weights": weights, "x": x,
            "xb": xb, "ranks": ranks}


def _gather(world, key) -> np.ndarray:
    return np.concatenate([r[key] for r in world["ranks"]], axis=-1)


def test_halo_exchange_unit(world):
    ext = [r["exchange"] for r in world["ranks"]]
    assert all(e.shape == (14,) for e in ext)
    # rank 1 holds [8..16); its halos are [5, 6, 7] and [16, 17, 18]
    np.testing.assert_array_equal(ext[1][:3], [5, 6, 7])
    np.testing.assert_array_equal(ext[1][-3:], [16, 17, 18])
    np.testing.assert_array_equal(ext[1][3:-3], np.arange(8, 16))
    # the stream edges are zero-padded
    np.testing.assert_array_equal(ext[0][:3], [0, 0, 0])
    np.testing.assert_array_equal(ext[3][-3:], [0, 0, 0])


def test_halo_apply_equals_reference_partitioned_apply(world):
    from repro.core import equalizer as jeq
    from repro.core import stream_partition as jsp
    jcfg, folded = world["jcfg"], world["folded"]
    apply_fn = lambda chunks: jeq.apply_folded(folded, chunks, jcfg)
    want = np.asarray(jsp.partitioned_apply(apply_fn, world["x"], WORLD,
                                            jcfg))
    got = _gather(world, "fp32")
    assert got.shape == want.shape == (N_SYMS,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    wantb = np.stack([np.asarray(jsp.partitioned_apply(
        apply_fn, world["xb"][i], WORLD, jcfg)) for i in range(3)])
    np.testing.assert_allclose(_gather(world, "fp32_batched"), wantb,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dp", list(DATAPATHS))
def test_halo_apply_bitwise_vs_unsplit_engine(world, dp):
    engine = _engines(world["weights"])[dp]
    whole = engine(world["x"]).numpy()
    np.testing.assert_array_equal(_gather(world, dp), whole)
    wholeb = engine(world["xb"]).numpy()
    np.testing.assert_array_equal(_gather(world, dp + "_batched"), wholeb)


def test_halo_apply_int8_equals_reference_engine(world):
    from repro.core.engine import EqualizerEngine as JEngine
    jengine = JEngine.from_folded(world["folded"], world["jcfg"],
                                  backend="fused_int8", formats=INT8_FMT,
                                  tile_m=32)
    assert halo._engine_halo_quant(jengine) == (3, 4)
    assert halo._engine_halo_quant(_engines(world["weights"])["int8"]) == \
        (3, 4)
    want = np.asarray(jengine(world["x"]))
    np.testing.assert_array_equal(_gather(world, "int8"), want)


def test_int8_exchange_sends_int8_only(world):
    sent = [set(r["int8_sent"]) for r in world["ranks"]]
    # every rank sends and receives: the end ranks one edge, the rest two
    assert [len(r["int8_sent"]) for r in world["ranks"]] == [2, 4, 4, 2]
    assert all(s == {"torch.int8"} for s in sent), sent


def test_stream_that_does_not_divide_is_refused(world):
    assert all("divide" in r["refused"] for r in world["ranks"])


def test_halo_samples_equal_reference():
    from repro.core import equalizer as jeq
    from repro.parallel import halo as jhalo
    for n in (1, 2, 4, 8, 64):
        assert halo.halo_samples(CFG, n) == jhalo.halo_samples(
            jeq.CNNEqConfig(), n)


def test_one_rank_and_zero_halo_only_pad(tmp_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.fspath(tmp_path / "store"), 1),
        rank=0, world_size=1)
    try:
        x = torch.arange(10, dtype=torch.float32)[None]
        np.testing.assert_array_equal(
            halo.halo_exchange(x, 3).numpy(),
            np.pad(np.arange(10, dtype=np.float32)[None], ((0, 0), (3, 3))))
        assert torch.equal(halo.halo_exchange(x, 0), x)
        mesh = make_mesh((1,), ("data",), "cpu")
        rng = np.random.default_rng(0)
        w = rng.standard_normal(2 * 300).astype(np.float32)
        engine = _engines(teq.folded_weights(teq.fold_bn(
            teq.init(torch.Generator().manual_seed(0), CFG, device="cpu"),
            teq.init_bn_state(CFG, "cpu"), CFG)))["fp32"]
        assert torch.equal(halo.halo_apply(engine, w, CFG, mesh),
                           engine(torch.from_numpy(w)))
        with pytest.raises(ValueError, match="whole symbols"):
            halo.halo_apply(engine, w[:-1], CFG, mesh)
        with pytest.raises(TypeError, match="float32"):
            halo.halo_apply(engine, w.astype(np.float64), CFG, mesh)
    finally:
        dist.destroy_process_group()

"""Port vs reference: stream partitioning and the paper's timing model
(repro_torch.core.{stream_partition, timing_model, seqlen_opt}).

  * the overlap arithmetic (o_sym, o_act, ℓ_inst) equals the reference's
    on a grid of configs and N_i ∈ {1, 2, 4, 8, 64};
  * split and merge are bitwise the JAX functions on the same numpy
    arrays (and keep the input's dtype);
  * `partitioned_apply` through the port's engine (``device="cpu"``, the
    kernels' plain versions) against the reference's `partitioned_apply`
    through the JAX engine, at each datapath's bound (int8 exact; fp32
    rtol 1e-6 / atol 5e-6; bf16 atol 1e-5);
  * inside the port, split == unsplit bitwise on the interior, chunk
    borders included, for N_i ∈ {2, 4, 8} on every datapath (a mirror of
    tests/test_equalizer_system.py's partition tests, which hold the
    reference to 1e-4);
  * the timing model and the sequence-length framework equal the
    reference's on the paper's numbers (tests/test_equalizer_system.py's
    timing-model block).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import equalizer as jeq
from repro.core import seqlen_opt as jseq
from repro.core import stream_partition as jsp
from repro.core import timing_model as jtm
from repro.core.engine import EqualizerEngine as JEngine
from repro_torch import interop
from repro_torch.core import equalizer as teq
from repro_torch.core import seqlen_opt, stream_partition as sp
from repro_torch.core import timing_model as tm
from repro_torch.core.engine import EqualizerEngine

RTOL, ATOL = 1e-6, 5e-6
BF16_ATOL = 1e-5
PAPER = teq.CNNEqConfig()
J_PAPER = jeq.CNNEqConfig()
N_INSTS = (1, 2, 4, 8, 64)
CONFIGS = ((3, 9, 8, 2), (2, 5, 4, 2), (4, 7, 16, 2), (3, 3, 1, 1),
           (5, 9, 8, 4))                       # (L, K, V_p, N_os)
FORMATS = {
    "int8": {"w_int": 2, "w_frac": 5, "a_int": 3, "a_frac": 4},
    "bf16": {"w_int": 3, "w_frac": 8, "a_int": 3, "a_frac": 8},
    "fp32": None,
}
BACKEND = {"int8": "fused_int8", "bf16": "fused_bf16", "fp32": "fused_fp32"}


def _cfgs(layers, kernel, vp, nos):
    return (teq.CNNEqConfig(layers=layers, kernel=kernel, v_parallel=vp,
                            n_os=nos),
            jeq.CNNEqConfig(layers=layers, kernel=kernel, v_parallel=vp,
                            n_os=nos))


def _params(dp, seed):
    """Params drawn by the JAX package (numpy), with QAT widths per
    datapath and a non-trivial BN state."""
    params = jax.tree.map(np.asarray,
                          jeq.init(jax.random.PRNGKey(seed), J_PAPER))
    rng = np.random.default_rng(seed)
    state = {"bn": [{"mean": (0.1 * rng.standard_normal(5)).astype(
                        np.float32),
                     "var": (1 + 0.5 * rng.random(5)).astype(np.float32)}
                    for _ in range(PAPER.layers - 1)]}
    if FORMATS[dp] is not None:
        params["qat"] = {f"layer{i}": {k: np.float32(v)
                                       for k, v in FORMATS[dp].items()}
                         for i in range(PAPER.layers)}
    return params, state


def _wave(seed, n_syms):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n_syms * PAPER.n_os).astype(np.float32)


# ---------------------------------------------------------------------------
# overlap arithmetic, split and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", CONFIGS)
def test_overlap_arithmetic_equals_reference(dims):
    cfg, jcfg = _cfgs(*dims)
    assert sp.overlap_symbols(cfg) == jsp.overlap_symbols(jcfg)
    assert sp.overlap_symbols(cfg) == cfg.receptive_field_syms
    for n in N_INSTS:
        o = sp.actual_overlap(cfg, n)
        assert o == jsp.actual_overlap(jcfg, n)
        assert o >= sp.overlap_symbols(cfg) and o % (cfg.v_parallel * n) == 0
        for total in (n, 7320 * n, 1024 * n):
            assert sp.chunk_lengths(total, n) == jsp.chunk_lengths(total, n)
    assert sp.overlap_symbols(PAPER) == 68
    assert sp.actual_overlap(PAPER, 64) == 1024


def test_stream_that_does_not_divide_raises():
    with pytest.raises(ValueError, match="divide"):
        sp.chunk_lengths(1001, 8)
    with pytest.raises(ValueError, match="divide"):
        sp.split_with_overlap(torch.zeros(2 * 1001), 8, 64, 2)
    engine = EqualizerEngine.from_params(*_params("fp32", 0), PAPER,
                                         device="cpu")
    with pytest.raises(ValueError, match="divide"):
        sp.partitioned_apply(engine, _wave(0, 1001), 8, PAPER)


def test_partitioned_apply_refuses_a_cast():
    engine = EqualizerEngine.from_params(*_params("fp32", 0), PAPER,
                                         device="cpu")
    with pytest.raises(TypeError, match="float32"):
        sp.partitioned_apply(engine, _wave(0, 256).astype(np.float64), 2,
                             PAPER)


@pytest.mark.parametrize("n_inst", N_INSTS)
@pytest.mark.parametrize("n_os", [1, 2])
def test_split_and_merge_bitwise_vs_jax(n_inst, n_os):
    rng = np.random.default_rng(n_inst * 10 + n_os)
    l_inst = 48
    x = rng.standard_normal(l_inst * n_inst * n_os).astype(np.float32)
    o_act = 16 * (1 + n_inst % 3)
    got = sp.split_with_overlap(torch.from_numpy(x), n_inst, o_act, n_os)
    want = np.asarray(jsp.split_with_overlap(jnp.asarray(x), n_inst, o_act,
                                             n_os))
    assert tuple(got.shape) == want.shape == (
        n_inst, (l_inst + 2 * o_act) * n_os)
    np.testing.assert_array_equal(got.numpy(), want)
    # one padded copy, a strided view of it (no per-instance copy)
    assert got.stride() == (l_inst * n_os, 1)
    y = rng.standard_normal((n_inst, l_inst + 2 * o_act)).astype(np.float32)
    merged = sp.merge_with_overlap_removal(torch.from_numpy(y), o_act)
    np.testing.assert_array_equal(
        merged.numpy(),
        np.asarray(jsp.merge_with_overlap_removal(jnp.asarray(y), o_act)))
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        assert sp.split_with_overlap(torch.from_numpy(x).to(dtype), n_inst,
                                     o_act, n_os).dtype == dtype


# ---------------------------------------------------------------------------
# partitioned_apply: port vs JAX, and split == unsplit inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", ["int8", "bf16", "fp32"])
def test_partitioned_apply_vs_jax_engine(dp):
    n_inst, n_syms = 4, 1024
    params, state = _params(dp, 7)
    engine = EqualizerEngine.from_params(params, state, PAPER, device="cpu")
    assert engine.backend == BACKEND[dp]
    x = _wave(8, n_syms)
    got = sp.partitioned_apply(engine, x, n_inst, PAPER).numpy()
    je = JEngine.from_params(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, state), J_PAPER,
                             tile_m=16, interpret=True)
    assert je.backend == BACKEND[dp]
    want = np.asarray(jsp.partitioned_apply(je, jnp.asarray(x), n_inst,
                                            J_PAPER))
    assert got.shape == want.shape == (n_syms,)
    if dp == "int8":
        np.testing.assert_array_equal(got, want)
    elif dp == "bf16":
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_inst", [2, 4, 8])
@pytest.mark.parametrize("dp", ["int8", "bf16", "fp32"])
def test_partitioned_equals_unsplit_interior_bitwise(dp, n_inst):
    engine = EqualizerEngine.from_params(*_params(dp, 20 + n_inst), PAPER,
                                         device="cpu")
    n_syms = 512 * n_inst
    x = torch.from_numpy(_wave(30 + n_inst, n_syms))
    y_split = sp.partitioned_apply(engine, x, n_inst, PAPER)
    y_full = engine(x)
    assert y_split.shape == y_full.shape == (n_syms,)
    assert y_split.dtype == torch.float32
    o = sp.overlap_symbols(PAPER)
    # the interior, every chunk border included, bitwise
    assert torch.equal(y_split[o:-o], y_full[o:-o])


def test_partitioned_apply_with_a_plain_callable():
    """Any callable with the engine's contract works (the oracle form of
    the reference's tests): here the port's per-layer SAME-padded model."""
    params, state = _params("fp32", 3)
    folded = teq.fold_bn(interop.to_torch(params, device="cpu"),
                         interop.to_torch(state, device="cpu"), PAPER)
    fn = lambda chunks: teq.apply_folded(folded, chunks, PAPER)  # noqa: E731
    x = torch.from_numpy(_wave(5, 2048))
    y = sp.partitioned_apply(fn, x, 4, PAPER)
    o = sp.overlap_symbols(PAPER)
    np.testing.assert_allclose(y[o:-o].numpy(), fn(x[None])[0][o:-o].numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# timing model and sequence-length framework (paper §6.1–6.2)
# ---------------------------------------------------------------------------

def _profiles():
    return ((tm.fpga_profile(PAPER, f_clk=200e6),
             jtm.fpga_profile(J_PAPER, f_clk=200e6)),
            (tm.fpga_profile(PAPER), jtm.fpga_profile(J_PAPER)),
            (tm.tpu_profile(PAPER), jtm.tpu_profile(J_PAPER)))


def test_profiles_equal_reference():
    for hw, jhw in _profiles():
        assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)


@pytest.mark.parametrize("n_inst", N_INSTS)
def test_timing_model_equals_reference(n_inst):
    for hw, jhw in _profiles():
        for l_inst in (8, 1024, 7320, 65536):
            assert tm.t_init(PAPER, hw, n_inst, l_inst) == \
                jtm.t_init(J_PAPER, jhw, n_inst, l_inst)
            assert tm.symbol_latency(PAPER, hw, n_inst, l_inst) == \
                jtm.symbol_latency(J_PAPER, jhw, n_inst, l_inst)
            assert tm.processing_time(PAPER, hw, n_inst, l_inst,
                                      l_inst * n_inst) == \
                jtm.processing_time(J_PAPER, jhw, n_inst, l_inst,
                                    l_inst * n_inst)
            assert tm.net_throughput(PAPER, hw, n_inst, l_inst) == \
                jtm.net_throughput(J_PAPER, jhw, n_inst, l_inst)
        assert tm.max_throughput(hw, n_inst) == \
            jtm.max_throughput(jhw, n_inst)
        for t_req in (1e9, 80e9, 3e12):
            assert tm.min_instances(hw, t_req) == \
                jtm.min_instances(jhw, t_req)


def test_timing_model_paper_numbers():
    hw = tm.fpga_profile(PAPER, f_clk=200e6)
    jhw = jtm.fpga_profile(J_PAPER, f_clk=200e6)
    assert tm.max_throughput(hw, 64) == pytest.approx(102.4e9)
    l_inst = seqlen_opt.optimal_l_inst(PAPER, hw, 64, 80e9)
    assert l_inst == jseq.optimal_l_inst(J_PAPER, jhw, 64, 80e9) == 7320
    lam = tm.symbol_latency(PAPER, hw, 64, l_inst)
    assert lam == jtm.symbol_latency(J_PAPER, jhw, 64, l_inst)
    assert lam == pytest.approx(17.5e-6, rel=0.05)
    assert tm.net_throughput(PAPER, hw, 64, l_inst) >= 80e9


def test_timing_monotonicity():
    hw = tm.fpga_profile(PAPER)
    ls = [1024, 4096, 16384, 65536]
    tps = [tm.net_throughput(PAPER, hw, 16, l) for l in ls]
    lats = [tm.symbol_latency(PAPER, hw, 16, l) for l in ls]
    assert all(a < b for a, b in zip(tps, tps[1:]))
    assert all(a < b for a, b in zip(lats, lats[1:]))
    assert tps[-1] < tm.max_throughput(hw, 16)


@pytest.mark.parametrize("n_inst", [8, 16, 64])
def test_lut_and_granularity_equal_reference(n_inst):
    hw, jhw = tm.fpga_profile(PAPER), jtm.fpga_profile(J_PAPER)
    t_max = tm.max_throughput(hw, n_inst)
    t_reqs = [f * t_max for f in (0.2, 0.5, 0.78125, 0.95)]
    lut = seqlen_opt.build_lut(PAPER, hw, n_inst, t_reqs)
    jlut = jseq.build_lut(J_PAPER, jhw, n_inst, t_reqs)
    assert seqlen_opt.granularity(PAPER, n_inst) == \
        jseq.granularity(J_PAPER, n_inst) == 8
    assert list(lut) == list(jlut)
    for t_req in t_reqs:
        assert dataclasses.asdict(lut[t_req]) == \
            dataclasses.asdict(jlut[t_req])
        assert lut[t_req].t_net >= t_req
        assert lut[t_req].l_inst % seqlen_opt.granularity(PAPER, n_inst) == 0
    ls = [lut[t].l_inst for t in t_reqs]
    assert ls == sorted(ls)


def test_infeasible_t_req_raises():
    hw = tm.fpga_profile(PAPER)
    with pytest.raises(ValueError):
        seqlen_opt.optimal_l_inst(PAPER, hw, 4, 80e9)

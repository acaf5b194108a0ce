"""Port vs reference: error-feedback int8 gradient compression
(repro_torch.optim.grad_comp).

  * `compress`, `decompress` and `ef_compress_tree` equal the reference's
    exactly (payload and scale) on seeded numpy inputs, ties at .5 (round
    half to even) and narrower bit widths included;
  * twins of tests/test_substrate.py's round-trip bound and error-feedback
    convergence;
  * `compressed_psum` over a 4-rank gloo world of CPU processes: the mean
    equals Σ scaleᵢ·payloadᵢ / n from the reference's per-rank `compress`
    (summed in float64) within 1e-6 of Σ |scaleᵢ·payloadᵢ| / n, and the
    bounds of tests/test_halo.py::test_grad_compression_psum hold;
  * stochastic rounding with a `torch.Generator` is unbiased (the mean of
    many draws lies within 5 standard errors of g) and repeats for a seed.

The ranks import this module, which imports jax only inside the tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks
from repro_torch.optim import grad_comp

WORLD = 4


def _ref():
    from repro.optim import grad_comp as jgc
    return jgc


def _inputs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(513).astype(np.float32) * (seed + 1)
    if seed == 2:                  # exact halves: max |g| 127 → scale 1
        g[:8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    return g


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_and_decompress_equal_reference(seed, bits):
    jgc = _ref()
    g = _inputs(seed)
    jp, js = jgc.compress(g, jgc.CompressionConfig(bits=bits))
    p, s = grad_comp.compress(torch.from_numpy(g),
                              grad_comp.CompressionConfig(bits=bits))
    assert p.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert s.item() == float(js)
    np.testing.assert_array_equal(
        grad_comp.decompress(p, s).numpy(),
        np.asarray(jgc.decompress(jp, js)))


def test_compress_of_zeros_floors_the_scale():
    jgc = _ref()
    p, s = grad_comp.compress(torch.zeros(16))
    jp, js = jgc.compress(np.zeros(16, np.float32))
    assert s.item() == float(js) == np.float32(1e-12)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_ef_compress_tree_equals_reference():
    jgc = _ref()
    rng = np.random.default_rng(7)
    grads = {"w": rng.standard_normal((8, 16)).astype(np.float32),
             "b": rng.standard_normal(16).astype(np.float32)}
    error = {k: 0.01 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in grads.items()}
    jp, js, je = jgc.ef_compress_tree(grads, error)
    tp, ts, te = grad_comp.ef_compress_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in error.items()})
    for k in grads:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        assert ts[k].item() == float(js[k])
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    zeros = grad_comp.init_error({"w": torch.ones(3, 2,
                                                  dtype=torch.bfloat16)})
    assert zeros["w"].dtype == torch.float32 and not zeros["w"].any()


def test_compress_roundtrip_error_bound():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        512).astype(np.float32))
    p, s = grad_comp.compress(g)
    back = grad_comp.decompress(p, s)
    assert p.dtype == torch.int8
    assert float((back - g).abs().max()) <= float(s) / 2 + 1e-6


def test_error_feedback_mean_converges():
    """EF property: the RUNNING SUM of decompressed grads tracks the true
    sum (error never accumulates unboundedly)."""
    rng = np.random.default_rng(1)
    err = {"w": torch.zeros(64)}
    total_true = torch.zeros(64)
    total_sent = torch.zeros(64)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.standard_normal(64).astype(
            np.float32))}
        payload, scale, err = grad_comp.ef_compress_tree(g, err)
        total_sent += grad_comp.decompress(payload["w"], scale["w"])
        total_true += g["w"]
    # the residual is the CURRENT error buffer, bounded by one quant step
    resid = (total_true - total_sent).numpy()
    np.testing.assert_allclose(resid, err["w"].numpy(), atol=1e-4)
    assert np.max(np.abs(resid)) < 0.05


def test_stochastic_rounding_is_unbiased_and_seeded():
    cfg = grad_comp.CompressionConfig(stochastic=True)
    g = torch.from_numpy(_inputs(0)[:64])
    draws = 4000
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(64, dtype=torch.float64)
    for _ in range(draws):
        p, s = grad_comp.compress(g, cfg, generator=gen)
        acc += grad_comp.decompress(p, s).double()
    mean = acc / draws
    # one draw errs by less than a step s (variance ≤ s²/4), so the mean of
    # `draws` draws lies within 5 standard errors s / (2·√draws) · 5
    s = float(s)
    assert float((mean - g.double()).abs().max()) < 5 * s / (
        2 * np.sqrt(draws))
    # floor(x + u) is within one step of x, never rounds to nearest only
    p1, _ = grad_comp.compress(g, cfg, torch.Generator().manual_seed(3))
    p2, _ = grad_comp.compress(g, cfg, torch.Generator().manual_seed(3))
    assert torch.equal(p1, p2)
    assert float((p1.float() - g / s).abs().max()) < 1.0
    # without a generator the quantizer rounds to nearest, as the reference
    # does without a key
    assert torch.equal(grad_comp.compress(g, cfg)[0],
                       grad_comp.compress(g)[0])


def _psum_ranks(rank: int, world: int, g: np.ndarray, e: np.ndarray) -> dict:
    grads = {"w": torch.from_numpy(g[rank]), "b": torch.from_numpy(
        g[rank, :16] * 3)}
    error = {"w": torch.from_numpy(e[rank]), "b": torch.zeros(16)}
    mean, new_err = grad_comp.compressed_psum(grads, error)
    return {k: (mean[k].numpy(), new_err[k].numpy()) for k in grads}


@pytest.fixture(scope="module")
def psum_world():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((WORLD, 256)).astype(np.float32)
    e = np.zeros((WORLD, 256), np.float32)
    e[:, :4] = 0.003                # a carried residual on some entries
    return g, e, run_ranks(_psum_ranks, WORLD, (g, e), timeout_s=300)


def test_compressed_psum_equals_reference_compress(psum_world):
    jgc = _ref()
    g, e, ranks = psum_world
    for key, rows, err in (("w", g, e),
                           ("b", g[:, :16] * 3, np.zeros((WORLD, 16),
                                                         np.float32))):
        parts = [jgc.compress(rows[i] + err[i]) for i in range(WORLD)]
        terms = np.stack([np.float64(s) * np.asarray(p, np.float64)
                          for p, s in parts])
        want = terms.sum(axis=0) / WORLD
        # 1e-6 relative to the terms' magnitude: the f32 sum's order is
        # the library's, and where the terms cancel only this is defined
        bound = 1e-6 * np.abs(terms).sum(axis=0) / WORLD
        for r in range(WORLD):
            mean, new_err = ranks[r][key]
            assert np.all(np.abs(mean - want) <= bound), key
            p, s = parts[r]
            np.testing.assert_array_equal(
                new_err, (rows[r] + err[r]) - np.asarray(
                    jgc.decompress(p, s)))


def test_compressed_psum_bounds(psum_world):
    """tests/test_halo.py::test_grad_compression_psum's bounds."""
    g, _, ranks = psum_world
    want = g.mean(axis=0)
    scale = float(np.max(np.abs(g))) / 127
    got = ranks[0]["w"][0]
    assert all(np.array_equal(r["w"][0], got) for r in ranks)
    # int8 quantization error is bounded by scale/2 per rank
    assert np.max(np.abs(got - want)) < scale
    # error feedback: residuals are nonzero and bounded
    errs = np.stack([r["w"][1] for r in ranks])
    assert 0 < np.max(np.abs(errs)) < scale

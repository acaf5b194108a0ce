"""Port vs reference: online adaptation (repro_torch.adapt) on the CPU.

Against the JAX package, with the same numpy inputs and weights carried
over (`interop`):

  * collector — the same segments and pilots give the same
    `training_view()` arrays, bitwise, and the same `stats()`;
  * trainer — for the same seed `make_sample_fn` picks the same windows,
    bitwise; `fine_tune_from_buffer` fed the seeds the reference's key
    chain draws gives candidate params within tests/test_torch_train.py's
    fine-tune bound (atol 1e-5, the train-mode-BN conv biases held to
    Adam's bound as there), the QAT widths bitwise;
  * shadow — `engine_ber` / `shadow_evaluate` on engines built from the
    same weights: int8 equal BERs and decisions; fp32 BERs within
    2 / eval_syms (the two packages' fp32 engines differ by ≤ 5e-6, which
    can flip a decision at the slicer's threshold), the same decision
    wherever the candidate's distance from the margin exceeds that;
  * adapter — one `OnlineAdapter` of each package over the same drift
    traffic (the reference's `drift_streams`), the port's window seeds
    replaced by the ones the reference's key chain gives
    (`runtime.py:110`, `:156`, `:259`; `trainer.py:62`): the same sequence
    of actions and weight epochs, and the same swap log.

Then the reference's own tests (tests/test_adapt.py), mirrored against
the port with ``device="cpu"``: collector units, tap reassembly, the
hysteresis units, weight-only fine-tuning, hot-swap bitwise per epoch
(sync and async, fp32 and int8), rollback bit-identical, `install_spec`
refusals, requires-params/idles, the stationary no-thrash case (its base
trained once per module by the JAX package, 600 steps, and carried over),
and the background thread under live async traffic. The drift-recovery
acceptance criterion, with its own 600-step bases, runs on the card in
`chip_smoke.py` [14], not here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapt import OnlineAdapter as JAdapter
from repro.adapt import AdaptPolicy as JAdaptPolicy
from repro.adapt import FineTuneConfig as JFineTune
from repro.adapt import PromotionPolicy as JPromotion
from repro.adapt import SampleCollector as JCollector
from repro.adapt import engine_ber as jengine_ber
from repro.adapt import shadow_evaluate as jshadow_evaluate
from repro.adapt import trainer as jtrainer
from repro.channels.drift import DriftingProakis as JDriftingProakis
from repro.channels.drift import DriftSchedule as JDriftSchedule
from repro.core import equalizer as jeq
from repro.core.train_eq import EqTrainConfig as JEqTrainConfig
from repro.core.train_eq import train_equalizer as jtrain_equalizer
from repro.obs import report as jreport
from repro.serve import BatchPolicy as JPolicy
from repro.serve import ServeRuntime as JRuntime
from repro.serve import TenantSpec as JSpec
from repro.serve import drift_streams as jdrift_streams
from repro.serve import replay_adaptive as jreplay_adaptive
from repro_torch import interop
from repro_torch.adapt import (AdaptPolicy, FineTuneConfig, OnlineAdapter,
                               PromotionPolicy, SampleCollector, engine_ber,
                               fine_tune_from_buffer, hard_decide,
                               make_sample_fn, pam_amplitudes,
                               shadow_evaluate)
from repro_torch.adapt import collector as tcollector
from repro_torch.adapt import trainer as ttrainer
from repro_torch.channels.drift import DriftingProakis, DriftSchedule
from repro_torch.core import equalizer as eq
from repro_torch.core.train_eq import fine_tune_equalizer
from repro_torch.obs import report as treport
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy, ServeRuntime,
                               TenantSpec, chop, drift_streams,
                               replay_adaptive)

CFG = eq.CNNEqConfig()
TS = CFG.v_parallel * CFG.n_os           # samples per engine pass
INT8_QAT = {"w_int": 2.0, "w_frac": 5.0, "a_int": 3.0, "a_frac": 4.0}
ATOL = 1e-5                              # tests/test_torch_train.py's bound


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed, qat=False):
    """Parameters drawn by the JAX package, carried as numpy."""
    p = _np(jeq.init(jax.random.PRNGKey(seed), jeq.CNNEqConfig()))
    if qat:
        p["qat"] = {f"layer{i}": {k: np.float32(v)
                                  for k, v in INT8_QAT.items()}
                    for i in range(CFG.layers)}
    return p


def _bn():
    return _np(jeq.init_bn_state(jeq.CNNEqConfig()))


def _spec(tid, seed, backend="fused_fp32", tile_m=16):
    return TenantSpec(tid, CFG, params=_params(seed, qat=backend == "auto"),
                      bn_state=_bn(), backend=backend, tile_m=tile_m)


def _jspec(spec):
    """The same tenant for the JAX package."""
    return JSpec(spec.tenant_id, jeq.CNNEqConfig(),
                 params=jax.tree.map(jnp.asarray, spec.params),
                 bn_state=jax.tree.map(jnp.asarray, spec.bn_state),
                 backend=spec.backend, tile_m=spec.tile_m)


def _offline(spec, wave):
    return spec.build_engine("cpu")(wave).numpy()


def _runtime(driver, policy):
    cls = AsyncServeRuntime if driver == "async" else ServeRuntime
    return cls(policy, device="cpu")


# ---------------------------------------------------------------------------
# collector: port == reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eval_every,capacity", [(2, 1 << 12), (4, 1500),
                                                 (3, 1 << 15)])
def test_collector_training_view_and_stats_equal_reference(eval_every,
                                                           capacity):
    rng = np.random.default_rng(eval_every)
    cols = [c(n_os=2, levels=2, capacity_syms=capacity,
              eval_every=eval_every) for c in (SampleCollector, JCollector)]
    for i in range(40):
        n = int(rng.integers(1, 120))
        soft = rng.standard_normal(n).astype(np.float32)
        rx = rng.standard_normal(2 * n + 7).astype(np.float32)
        if i % 3 == 0:
            pilots = rng.integers(0, 2, size=int(rng.integers(0, 90)))
            for c in cols:
                c.add_pilots(pilots)
        for c in cols:
            c.on_segment(rx, soft)
    got, want = (c.training_view() for c in cols)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert cols[0].stats() == cols[1].stats()
    assert tcollector.EVAL_BLOCK == 2


def test_numpy_helpers_equal_reference():
    from repro.adapt import hard_decide as jhard, pam_amplitudes as jpam
    soft = np.random.default_rng(0).standard_normal(257).astype(np.float32)
    for levels in (2, 4, 8):
        np.testing.assert_array_equal(pam_amplitudes(levels),
                                      jpam(levels))
        np.testing.assert_array_equal(hard_decide(soft, levels),
                                      jhard(soft, levels))


# ---------------------------------------------------------------------------
# collector units (tests/test_adapt.py)
# ---------------------------------------------------------------------------

def test_collector_decision_labels_and_ring_capacity():
    col = SampleCollector(n_os=2, levels=2, capacity_syms=64, eval_every=4)
    soft = np.array([-0.9, 0.8, -1.1, 1.2] * 8, np.float32)    # 32 syms
    rx = np.zeros((soft.size * 2,), np.float32)
    col.on_segment(rx, soft)
    col.on_segment(rx, soft)
    assert col.total_syms == 64 and col.buffered_syms == 64
    tr_rx, tr_sy, ev_rx, ev_sy = col.training_view()
    np.testing.assert_array_equal(
        np.unique(np.concatenate([tr_sy, ev_sy])), [0, 1])
    assert tr_sy.shape[0] + ev_sy.shape[0] == 64
    np.testing.assert_array_equal(tr_sy[:32], hard_decide(soft, 2))
    col.on_segment(rx, soft)
    assert col.buffered_syms == 64 and col.total_syms == 96


def test_collector_pilot_fifo_consumes_in_lockstep():
    col = SampleCollector(n_os=2, levels=2, eval_every=4)
    col.add_pilots(np.array([1, 1, 1, 1, 1]))        # 5 pilot labels
    soft = np.full((4,), -0.7, np.float32)           # decisions would be 0
    rx = np.zeros((8,), np.float32)
    col.on_segment(rx, soft)                         # 4 piloted
    col.on_segment(rx, soft)                         # 1 pilot + 3 decisions
    tr_rx, tr_sy, ev_rx, ev_sy = col.training_view()
    labels = np.concatenate([tr_sy, ev_sy])
    assert labels.shape[0] == 8
    assert col.pilot_labelled == 5
    assert labels.sum() == 5
    assert col.stats()["pilots_queued"] == 0


def test_collector_eval_split_is_deterministic_blocked_interleave():
    block = tcollector.EVAL_BLOCK
    col = SampleCollector(n_os=1, levels=2, eval_every=3,
                          capacity_syms=1 << 12)
    n_segs = 6 * block
    for i in range(n_segs):
        col.on_segment(np.full((4,), float(i), np.float32),
                       np.full((4,), -1.0, np.float32))
    tr_rx, _, ev_rx, _ = col.training_view()
    want_eval = [float(i) for b in (2, 5)
                 for i in range(b * block, (b + 1) * block)]
    np.testing.assert_array_equal(np.unique(ev_rx), want_eval)
    assert tr_rx.shape[0] == (n_segs - 2 * block) * 4
    assert ev_rx.shape[0] == 2 * block * 4


def test_collector_copies_the_rx_it_keeps():
    col = SampleCollector(n_os=2, levels=2, eval_every=4)
    rx = np.ones((8,), np.float32)
    col.on_segment(rx, np.zeros((4,), np.float32))
    rx[:] = 7.0                      # the launch buffer is reused
    tr_rx, _, _, _ = col.training_view()
    np.testing.assert_array_equal(tr_rx, np.ones((8,), np.float32))


# ---------------------------------------------------------------------------
# descatter tap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["sync", "async"])
def test_tap_segments_reassemble_stream(driver):
    rt = _runtime(driver, BatchPolicy(max_batch=1, max_wait_s=1e9))
    try:
        rt.open(_spec("tap", seed=3))
        sess = rt.sessions.get("tap")
        got_rx, got_sy = [], []
        sess.tap = lambda rx, sy: (got_rx.append(np.array(rx)),
                                   got_sy.append(np.array(sy)))
        wave = np.random.default_rng(5).standard_normal(
            40 * TS).astype(np.float32)
        for c in chop(wave, 200, seed=1):
            rt.submit("tap", c)
        rt.finish("tap")
        rt.drain()
        np.testing.assert_array_equal(np.concatenate(got_rx), wave)
        np.testing.assert_array_equal(np.concatenate(got_sy),
                                      rt.output("tap"))
    finally:
        if driver == "async":
            rt.shutdown()


# ---------------------------------------------------------------------------
# trainer: port == reference
# ---------------------------------------------------------------------------

def _jax_seed(key):
    return int(jax.random.randint(key, (), 0, np.iinfo(np.int32).max))


def _buffer(seed, n=3000):
    rng = np.random.default_rng(seed)
    rx = rng.standard_normal(n * CFG.n_os).astype(np.float32)
    syms = rng.integers(0, CFG.levels, size=n).astype(np.int32)
    return rx, syms


@pytest.mark.parametrize("cfg", [FineTuneConfig(), FineTuneConfig(
    batch=3, seq_syms=64)])
def test_sample_windows_equal_reference_for_the_same_seed(monkeypatch, cfg):
    rx, syms = _buffer(1)
    jcfg = JFineTune(steps=cfg.steps, batch=cfg.batch,
                     seq_syms=cfg.seq_syms, lr=cfg.lr)
    jfn = jtrainer.make_sample_fn(rx, syms, n_os=CFG.n_os,
                                  levels=CFG.levels, cfg=jcfg)
    tfn = make_sample_fn(rx, syms, n_os=CFG.n_os, levels=CFG.levels,
                         cfg=cfg)
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        monkeypatch.setattr(ttrainer, "draw_seed",
                            lambda g, s=_jax_seed(key): s)
        (jx, jy), (tx, ty) = jfn(key), tfn(torch.Generator())
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.shape == (cfg.batch, cfg.seq_syms * CFG.n_os)


def test_draw_seed_is_an_int32_seed_and_repeats():
    a = [ttrainer.draw_seed(torch.Generator().manual_seed(5))
         for _ in range(2)]
    g = torch.Generator().manual_seed(5)
    b = [ttrainer.draw_seed(g) for _ in range(3)]
    assert a[0] == a[1] == b[0] and len(set(b)) == 3
    assert all(0 <= s < np.iinfo(np.int32).max for s in b)


def _fine_tune_seeds(key, steps):
    """The window seeds the reference's `fine_tune_equalizer(key, …)`
    draws: one split per step (`train_eq.py`), then `randint`
    (`trainer.py:62`)."""
    out = []
    for _ in range(steps):
        key, kstep = jax.random.split(key)
        out.append(_jax_seed(kstep))
    return out


def _split_noise(p, state=None):
    """The conv biases that feed a train-mode BN (and the running means
    they shift) apart from the rest: Adam moves them by ±lr a step on
    rounding noise (tests/test_torch_train.py)."""
    p = dict(p)
    n_bn = len(p["bn"])
    noise = [c["b"] for c in p["conv"][:n_bn]]
    p["conv"] = [dict(c, b=None) if i < n_bn else c
                 for i, c in enumerate(p["conv"])]
    if state is None:
        return p, noise
    return p, noise + [s["mean"] for s in state["bn"]], state


def test_fine_tune_from_buffer_matches_reference(monkeypatch):
    rx, syms = _buffer(2)
    params, bn = _params(11, qat=True), _bn()
    cfg = FineTuneConfig(steps=4, batch=4, seq_syms=64, lr=1e-3)
    key = jax.random.PRNGKey(3)
    jp, jbn, jinfo = jtrainer.fine_tune_from_buffer(
        key, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, bn), jeq.CNNEqConfig(), rx, syms,
        JFineTune(steps=4, batch=4, seq_syms=64, lr=1e-3))
    seeds = iter(_fine_tune_seeds(key, cfg.steps))
    monkeypatch.setattr(ttrainer, "draw_seed", lambda g: next(seeds))
    tp, tbn, tinfo = fine_tune_from_buffer(
        torch.Generator().manual_seed(0), params, bn, CFG, rx, syms, cfg,
        device="cpu")
    np.testing.assert_allclose(tinfo["loss_first"], jinfo["loss_first"],
                               rtol=ATOL)
    jp, tp = _np(jp), interop.to_numpy(tp)
    for name, q in tp["qat"].items():          # widths frozen, bitwise
        for k, v in q.items():
            np.testing.assert_array_equal(v, params["qat"][name][k])
            np.testing.assert_array_equal(v, jp["qat"][name][k])
    jrest, jnoise = _split_noise(jp)
    trest, tnoise = _split_noise(tp)
    for a, b in zip(interop.tree_leaves(trest), interop.tree_leaves(jrest)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    for a, b, a0 in zip(tnoise, jnoise, _split_noise(params)[1]):
        assert np.max(np.abs(a - a0)) <= cfg.steps * cfg.lr * 1.001
        assert np.max(np.abs(b - a0)) <= cfg.steps * cfg.lr * 1.001
    for a, b in zip(interop.tree_leaves(interop.to_numpy(tbn)),
                    interop.tree_leaves(_np(jbn))):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=ATOL + 0.1 * 2 * cfg.lr * cfg.steps)


def test_fine_tune_refuses_a_window_off_the_vp_grid():
    rx, syms = _buffer(4)
    with pytest.raises(ValueError, match="multiple of"):
        fine_tune_from_buffer(torch.Generator(), _params(1), _bn(), CFG, rx,
                              syms, FineTuneConfig(seq_syms=60),
                              device="cpu")
    with pytest.raises(ValueError, match="buffer too small"):
        make_sample_fn(rx[:100], syms[:50], n_os=2, levels=2,
                       cfg=FineTuneConfig())


def test_fine_tune_trains_weights_only_formats_bit_identical():
    params = _params(11, qat=True)
    rng = np.random.default_rng(13)

    def sample_fn(generator):
        xs = rng.standard_normal((4, 64 * CFG.n_os)).astype(np.float32)
        ys = rng.standard_normal((4, 64)).astype(np.float32)
        return xs, ys

    new_params, _, info = fine_tune_equalizer(
        torch.Generator().manual_seed(0), params, _bn(), CFG, sample_fn,
        steps=5, lr=1e-2, device="cpu")
    new = interop.to_numpy(new_params)
    for name, q in params["qat"].items():
        for k, v in q.items():
            np.testing.assert_array_equal(v, new["qat"][name][k])
    assert not np.array_equal(params["conv"][0]["w"], new["conv"][0]["w"])
    assert info["steps"] == 5


# ---------------------------------------------------------------------------
# shadow: port == reference, and the hysteresis units
# ---------------------------------------------------------------------------

def _eval_traffic(seed, n):
    rx, syms = JDriftingProakis().at(0.3)(jax.random.PRNGKey(seed), n)
    return np.asarray(rx), np.asarray(syms)


@pytest.mark.parametrize("backend", ["auto", "fused_fp32"])
def test_shadow_equals_reference_on_the_same_weights(backend):
    pol = PromotionPolicy(min_eval_syms=1024, eval_bucket_syms=512)
    jpol = JPromotion(min_eval_syms=1024, eval_bucket_syms=512)
    rx, syms = _eval_traffic(5, 6000)
    specs = [_spec(f"s{i}", seed, backend) for i, seed in
             enumerate((41, 42))]
    t = [s.build_engine("cpu") for s in specs]
    j = [_jspec(s).build_engine() for s in specs]
    assert t[0].backend == j[0].backend == (
        "fused_int8" if backend == "auto" else "fused_fp32")
    bound = 0.0 if backend == "auto" else 2.0
    for te, je in zip(t, j):
        n = (6000 // te.cfg.v_parallel) * te.cfg.v_parallel
        assert abs(engine_ber(te, rx, syms)
                   - jengine_ber(je, rx, syms)) <= bound / n
    for a, c in ((0, 1), (1, 0)):
        got = shadow_evaluate(t[a], t[c], rx, syms, pol)
        want = jshadow_evaluate(j[a], j[c], rx, syms, jpol)
        assert got.eval_syms == want.eval_syms == 5632   # 11 buckets
        slack = bound / got.eval_syms
        assert abs(got.ber_active - want.ber_active) <= slack
        assert abs(got.ber_candidate - want.ber_candidate) <= slack
        margin = max(pol.min_rel_gain * want.ber_active, pol.min_abs_gain)
        if abs(want.ber_active - want.ber_candidate - margin) > 2 * slack:
            assert got.promote == want.promote
        if backend == "auto":
            assert (got.ber_active, got.ber_candidate, got.promote,
                    got.reason) == (want.ber_active, want.ber_candidate,
                                    want.promote, want.reason)


class _FakeEngine:
    """Deterministic engine stub: returns PAM amplitudes of given symbols
    with the first `n_err` of every 100 flipped."""

    device = torch.device("cpu")

    def __init__(self, syms, n_err):
        self.cfg = CFG
        self.total_stride = 1
        const = pam_amplitudes(CFG.levels)
        out = np.array(syms)
        for i in range(0, out.size, 100):
            out[i:i + n_err] ^= 1
        self._soft = torch.from_numpy(const[out].astype(np.float32))

    def __call__(self, x):
        return self._soft[None, : x.shape[1] // self.cfg.n_os]


def test_shadow_promotes_only_on_clear_wins():
    rng = np.random.default_rng(7)
    syms = rng.integers(0, 2, size=4096).astype(np.int32)
    rx = np.zeros((syms.size * CFG.n_os,), np.float32)
    pol = PromotionPolicy(min_eval_syms=2048, min_rel_gain=0.15,
                          min_abs_gain=2e-3, eval_bucket_syms=1024)
    active = _FakeEngine(syms, n_err=10)             # BER 0.10
    rep = shadow_evaluate(active, _FakeEngine(syms, 5), rx, syms, pol)
    assert rep.promote and rep.ber_active == pytest.approx(0.10, rel=0.01)
    rep = shadow_evaluate(active, _FakeEngine(syms, 9), rx, syms, pol)
    assert not rep.promote
    perfect = _FakeEngine(syms, 0)
    rep = shadow_evaluate(perfect, _FakeEngine(syms, 0), rx, syms, pol)
    assert not rep.promote
    rep = shadow_evaluate(active, perfect, rx[:512 * CFG.n_os],
                          syms[:512], pol)
    assert not rep.promote and np.isnan(rep.ber_active)
    assert "insufficient" in rep.reason


# ---------------------------------------------------------------------------
# weight hot-swap invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["sync", "async"])
@pytest.mark.parametrize("backend", ["fused_fp32", "auto"])
def test_hot_swap_bitwise_per_epoch(driver, backend):
    rt = _runtime(driver, BatchPolicy(max_batch=1, max_wait_s=1e9))
    try:
        spec0 = _spec("hs", seed=1, backend=backend)
        sess = rt.open(spec0)
        if backend == "auto":
            assert sess.engine.backend == "fused_int8"
        wave = np.random.default_rng(2).standard_normal(
            60 * TS).astype(np.float32)
        chunks = chop(wave, 300, seed=4)
        half = len(chunks) // 2
        for c in chunks[:half]:
            rt.submit("hs", c)
        epoch = rt.swap_weights(
            "hs", params=_params(99, qat=backend == "auto"),
            bn_state=_bn())
        assert epoch == 1 and sess.weight_epoch == 1
        for c in chunks[half:]:
            rt.submit("hs", c)
        got = rt.close("hs")
        (_, p0), (_, p1) = sess.swap_log
        assert p0 == 0 and p1 > 0
        vp = CFG.v_parallel
        want = np.concatenate([_offline(spec0, wave)[: p1 * vp],
                               _offline(sess.spec, wave)[p1 * vp:]])
        np.testing.assert_array_equal(got, want)
        assert (sess.spec.build_engine("cpu").group_key()
                == spec0.build_engine("cpu").group_key())
    finally:
        if driver == "async":
            rt.shutdown()


@pytest.mark.parametrize("driver", ["sync", "async"])
def test_rollback_restores_weights_bit_identical(driver):
    rt = _runtime(driver, BatchPolicy(max_batch=1, max_wait_s=1e9))
    try:
        spec0 = _spec("rb", seed=7)
        sess = rt.open(spec0)
        wave = np.random.default_rng(8).standard_normal(
            72 * TS).astype(np.float32)
        chunks = chop(wave, 320, seed=9)
        third = len(chunks) // 3
        for c in chunks[:third]:
            rt.submit("rb", c)
        rt.swap_weights("rb", params=_params(55), bn_state=_bn())
        swapped_spec = sess.spec
        for c in chunks[third:2 * third]:
            rt.submit("rb", c)
        assert rt.rollback_weights("rb") == 2
        w_now = sess.spec.build_engine("cpu").weights
        w_orig = spec0.build_engine("cpu").weights
        for (wa, ba), (wb, bb) in zip(w_now, w_orig):
            assert torch.equal(wa, wb) and torch.equal(ba, bb)
        for c in chunks[2 * third:]:
            rt.submit("rb", c)
        got = rt.close("rb")
        (_, _), (_, p1), (_, p2) = sess.swap_log
        vp = CFG.v_parallel
        off_old = _offline(spec0, wave)
        off_new = _offline(swapped_spec, wave)
        want = np.concatenate([off_old[: p1 * vp],
                               off_new[p1 * vp: p2 * vp],
                               off_old[p2 * vp:]])
        np.testing.assert_array_equal(got, want)
    finally:
        if driver == "async":
            rt.shutdown()


def test_install_spec_refuses_identity_changes():
    rt = ServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9), device="cpu")
    sess = rt.open(_spec("guard", seed=4))
    before = sess.spec
    bad_tile = dataclasses.replace(sess.spec, tile_m=32, weight_epoch=1)
    with pytest.raises(ValueError, match="hot-swap would change"):
        sess.install_spec(bad_tile)
    bad_backend = dataclasses.replace(sess.spec, backend="fused_bf16",
                                      weight_epoch=1)
    with pytest.raises(ValueError, match="hot-swap would change"):
        sess.install_spec(bad_backend)
    assert sess.spec is before and sess.weight_epoch == 0
    assert sess.swap_log == [(0, 0)]


# ---------------------------------------------------------------------------
# adapter control loop
# ---------------------------------------------------------------------------

def test_adapter_requires_params_and_idles_without_data():
    rt = ServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9), device="cpu")
    adapter = OnlineAdapter(rt)
    weights_only = TenantSpec(
        "w", CFG, weights=_spec("x", 1).build_engine("cpu").weights,
        backend="fused_fp32", tile_m=16)
    with pytest.raises(ValueError, match="needs params"):
        adapter.attach(weights_only)
    adapter.attach(_spec("a", seed=2))
    (rep,) = adapter.step("a")
    assert rep.action == "idle" and rep.weight_epoch == 0
    assert adapter.stream is None                   # no CUDA stream here


@pytest.fixture(scope="module")
def trained_base():
    """One 600-step stationary training by the JAX package (the
    reference's `trained_base`), carried over as numpy."""
    ch = JDriftingProakis()
    params, bn, info = jtrain_equalizer(
        jax.random.PRNGKey(0), "cnn", jeq.CNNEqConfig(), ch.at(0.0),
        JEqTrainConfig(steps=600, eval_syms=1 << 14))
    return _np(params), _np(bn), info["ber"]


POLICY = dict(min_train_syms=3072, adapt_every_syms=3072, eval_capacity=8192)


def _adaptive_runtime(trained, tids, ft):
    params, bn, _ = trained
    rt = ServeRuntime(BatchPolicy(max_batch=len(tids), max_wait_s=1e9),
                      device="cpu")
    adapter = OnlineAdapter(
        rt, AdaptPolicy(**POLICY, promotion=PromotionPolicy(
            min_eval_syms=1024, eval_bucket_syms=512)), ft)

    def mk(tid):
        return TenantSpec(tid, CFG, params=params, bn_state=bn,
                          backend="fused_fp32", tile_m=16)
    return rt, adapter, mk


def test_adapter_hysteresis_no_thrash_on_stationary_channel(trained_base):
    rt, adapter, mk = _adaptive_runtime(
        trained_base, ["st"], FineTuneConfig(steps=15, lr=1e-4))
    adapter.attach(mk("st"))
    sched = DriftSchedule(hold_bursts=10_000, ramp_bursts=1)   # never drifts
    streams, pilots = drift_streams(DriftingProakis(), sched, ["st"],
                                    n_bursts=8, syms_per_burst=2048, seed=6,
                                    device="cpu")
    replay_adaptive(rt, streams, pilots=pilots, adapter=adapter,
                    step_every=2)
    actions = {r.action for r in adapter.history}
    assert actions <= {"idle", "rejected"}, adapter.history
    assert "rejected" in actions               # the fine-tune did run
    assert rt.sessions.get("st").weight_epoch == 0


def _jax_adapter_seeds(seed, cycles, steps):
    """The window seeds the reference's adapter draws for its first
    tenant: `PRNGKey(seed)` split at attach (`runtime.py:110`), the
    tenant key split per fine-tune cycle (`:259`), each cycle's key split
    per step and `randint` (`trainer.py:62`)."""
    _, tenant = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for _ in range(cycles):
        tenant, ktrain = jax.random.split(tenant)
        out += _fine_tune_seeds(ktrain, steps)
    return out


def test_adapter_actions_and_epochs_equal_reference(trained_base,
                                                    monkeypatch):
    """One adapter of each package over the same drift traffic (the
    reference's draws): the same actions, epochs and swap log."""
    params, bn, _ = trained_base
    ch, sched = JDriftingProakis(), JDriftSchedule(hold_bursts=2,
                                                   ramp_bursts=4)
    streams, pilots = jdrift_streams(ch, sched, ["a"], n_bursts=14,
                                     syms_per_burst=2048, seed=3)
    streams = {t: [np.asarray(c) for c in v] for t, v in streams.items()}
    pilots = {t: [np.asarray(c) for c in v] for t, v in pilots.items()}
    ft = dict(steps=30, batch=8, seq_syms=256, lr=3e-3)
    spec = TenantSpec("a", CFG, params=params, bn_state=bn,
                      backend="fused_fp32", tile_m=16)

    jrt = JRuntime(JPolicy(max_batch=1, max_wait_s=1e9))
    jad = JAdapter(jrt, JAdaptPolicy(**POLICY, promotion=JPromotion(
        min_eval_syms=1024, eval_bucket_syms=512)), JFineTune(**ft))
    jad.attach(_jspec(spec))
    jreplay_adaptive(jrt, streams, pilots=pilots, adapter=jad, step_every=2)

    cycles = sum(r.train_info is not None for r in jad.history)
    seeds = iter(_jax_adapter_seeds(0, cycles, ft["steps"]))
    monkeypatch.setattr(ttrainer, "draw_seed", lambda g: next(seeds))
    rt = ServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9), device="cpu")
    adapter = OnlineAdapter(rt, AdaptPolicy(**POLICY, promotion=(
        PromotionPolicy(min_eval_syms=1024, eval_bucket_syms=512))),
        FineTuneConfig(**ft))
    adapter.attach(spec)
    replay_adaptive(rt, streams, pilots=pilots, adapter=adapter,
                    step_every=2)

    assert ([(r.action, r.weight_epoch) for r in adapter.history]
            == [(r.action, r.weight_epoch) for r in jad.history])
    assert "promoted" in {r.action for r in jad.history}
    assert next(seeds, None) is None           # every seed was drawn
    assert (rt.sessions.get("a").swap_log
            == jrt.sessions.get("a").swap_log)
    snap = rt.obs.snapshot()["adapt"]
    jsnap = jrt.obs.snapshot()["adapt"]
    assert snap["actions"] == jsnap["actions"]
    assert snap["a"]["weight_epoch"] == jsnap["a"]["weight_epoch"]
    got, want = (r.render({"adapt": s}) for r, s in
                 ((treport, snap), (jreport, jsnap)))
    assert got.splitlines()[:3] == want.splitlines()[:3]


def test_adapter_generators_are_per_tenant_and_repeat():
    def history(seed):
        rt = ServeRuntime(BatchPolicy(max_batch=2, max_wait_s=1e9),
                          device="cpu")
        ad = OnlineAdapter(rt, AdaptPolicy(
            min_train_syms=512, adapt_every_syms=256, eval_capacity=4096,
            promotion=PromotionPolicy(min_eval_syms=256,
                                      eval_bucket_syms=256)),
            FineTuneConfig(steps=3, batch=2, seq_syms=64), seed=seed)
        for tid, s in (("x", 5), ("y", 6)):
            ad.attach(_spec(tid, seed=s))
        streams, pilots = drift_streams(
            DriftingProakis(), DriftSchedule(1, 2), ["x", "y"], n_bursts=4,
            syms_per_burst=512, seed=1, device="cpu")
        replay_adaptive(rt, streams, pilots=pilots, adapter=ad)
        gens = [ad._states[t].generator.initial_seed() for t in ("x", "y")]
        return ([(r.tenant_id, r.action, r.weight_epoch, repr(r.shadow))
                 for r in ad.history], gens,
                [rt.output(t) for t in ("x", "y")])

    h1, g1, o1 = history(0)
    h2, g2, o2 = history(0)
    assert h1 == h2 and g1 == g2
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(a, b)
    assert g1[0] != g1[1]
    assert history(1)[1] != g1


def test_adapter_background_thread_with_live_async_traffic():
    ch = DriftingProakis()
    with AsyncServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                           device="cpu") as rt:
        adapter = OnlineAdapter(
            rt,
            AdaptPolicy(min_train_syms=1024, adapt_every_syms=512,
                        eval_capacity=4096,
                        promotion=PromotionPolicy(min_eval_syms=512,
                                                  eval_bucket_syms=256)),
            FineTuneConfig(steps=10, batch=4, seq_syms=128, lr=1e-3))
        adapter.attach(_spec("bg", seed=21))
        streams, pilots = drift_streams(
            ch, DriftSchedule(hold_bursts=2, ramp_bursts=3), ["bg"],
            n_bursts=8, syms_per_burst=1024, seed=11, device="cpu")
        adapter.start(interval_s=0.02)
        try:
            for chunk, labels in zip(streams["bg"], pilots["bg"]):
                adapter.feed_pilots("bg", labels)
                rt.submit("bg", chunk)
            rt.finish("bg")
            rt.drain()
        finally:
            adapter.stop()
        assert adapter.history, "background thread never ran a cycle"
        assert not adapter.errors
        assert not rt.errors
        out = rt.output("bg")
        assert out.shape == (8 * 1024,)      # nothing lost, nothing dup'd
        log = rt.sessions.get("bg").swap_log
        assert [e for e, _ in log] == list(range(len(log)))
        assert all(p1 <= p2 for (_, p1), (_, p2) in zip(log, log[1:]))


def test_report_renders_the_adapt_section_as_the_reference():
    snap = {"adapt": {"tenants": 2, "cycles": 7,
                      "actions": {"idle": 3, "promoted": 1, "rejected": 3},
                      "errors": {"total": 0, "window": 0, "dropped": 0},
                      "a-1": {"weight_epoch": 1.0, "shadow": {
                          "ber_active": 0.25, "ber_candidate": 0.125,
                          "eval_syms": 4096.0}}}}
    assert treport.render(snap) == jreport.render(snap)
    assert "[adapt]" in treport.render(snap)

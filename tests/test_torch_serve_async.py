"""Port vs reference: the threaded serving runtime (repro_torch.serve.
AsyncServeRuntime) and the load generator, on the CPU.

Mirrors the reference's async tests — tests/test_serve.py (per-chunk
futures, the timer's max_wait flush, transient launch failures, a
cancelled future, terminal failure, close/shutdown), tests/test_fault.py
(failover rebuild + replay, a build failure during failover, budget
exhaustion, corrupt output, corrupt-after-swap rollback, the deadline
watchdog, degradation, the six-tenant chaos sweep) and the async uses of
tests/test_obs.py (tracing through the chaos sweep, a frozen clock, the
error deque's retention, the stats schema) — against the port with
``device="cpu"``: every stream bitwise equal to the port's offline engine.
Against the JAX package: int8 async streams equal the JAX `ServeRuntime`'s
exactly, and `chop`, `random_waveforms` and `replay` give the reference's
chunks, waveforms and totals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import equalizer_ht as HT
from repro.core import equalizer as jeq
from repro.serve import BatchPolicy as JPolicy
from repro.serve import ServeRuntime as JRuntime
from repro.serve import TenantSpec as JSpec
from repro.serve import loadgen as jloadgen
from repro_torch.core import equalizer as teq
from repro_torch.obs import Observability, Retention
from repro_torch.runtime.straggler import StragglerConfig
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy, Fault,
                               FaultPlan, MicroBatcher, RecoveryPolicy,
                               ServeRuntime, TenantShedError, TenantSpec,
                               chop, loadgen, random_waveforms, replay)

CFG = teq.CNNEqConfig()
INT8_FMT = tuple((2, 5, 3, 4) for _ in range(CFG.layers))


def _weights(seed):
    """BN-folded weights drawn by the JAX package, carried as numpy."""
    params = jeq.init(jax.random.PRNGKey(seed), HT.CNN)
    folded = jeq.fold_bn(params, jeq.init_bn_state(HT.CNN), HT.CNN)
    return jax.tree.map(np.asarray, jeq.folded_weights(folded))


def _spec(tid, backend, seed, tile_m=32, priority=0):
    return TenantSpec(
        tid, CFG, weights=_weights(seed),
        formats=INT8_FMT if backend == "fused_int8" else None,
        backend=backend, tile_m=tile_m, priority=priority)


def _offline(spec, wave):
    return spec.build_engine("cpu")(wave).numpy()


def _wave(seed, n_syms):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n_syms * CFG.n_os).astype(np.float32)


def _runtime(policy, **kw):
    return AsyncServeRuntime(policy, device="cpu", **kw)


def _feed(rt, streams, with_futures=True):
    """Round-robin submit (sorted tenants), finish each exhausted stream,
    drain; returns each tenant's chunk futures."""
    futs = {t: [] for t in streams}
    iters = {t: iter(c) for t, c in streams.items()}
    live = set(iters)
    while live:
        for t in sorted(live):
            c = next(iters[t], None)
            f = rt.submit(t, c) if c is not None else rt.finish(t)
            if c is None:
                live.discard(t)
            if f is not None and with_futures:
                futs[t].append(f)
    rt.drain()
    return futs


# ---------------------------------------------------------------------------
# tests/test_serve.py: the async runtime
# ---------------------------------------------------------------------------

def test_async_per_chunk_futures_bitwise():
    with _runtime(BatchPolicy(max_batch=2, max_wait_s=1e9)) as rt:
        assert rt.device.type == "cpu" and rt.stream is None
        specs = [_spec(f"fut{i}", "fused_fp32", seed=100 + i)
                 for i in range(2)]
        rng = np.random.default_rng(47)
        waves = [rng.standard_normal(523 * CFG.n_os).astype(np.float32)
                 for _ in range(2)]
        for s in specs:
            rt.open(s)
        streams = {s.tenant_id: chop(w, 300, seed=i, jitter=0.4)
                   for i, (s, w) in enumerate(zip(specs, waves))}
        futs = _feed(rt, streams)
        for s, w in zip(specs, waves):
            want = _offline(s, w)
            parts = [f.result(timeout=10) for f in futs[s.tenant_id]]
            np.testing.assert_array_equal(np.concatenate(parts), want)
            np.testing.assert_array_equal(rt.output(s.tenant_id), want)


def test_async_timer_flushes_max_wait_without_caller_pump():
    with _runtime(BatchPolicy(max_batch=64, max_wait_s=0.05)) as rt:
        spec = _spec("timer", "fused_fp32", seed=110)
        rt.open(spec)
        wave = _wave(53, 128)
        fut = rt.submit("timer", wave)
        assert fut is not None
        syms = fut.result(timeout=30)                # resolved by the timer
        np.testing.assert_array_equal(
            syms, _offline(spec, wave)[:syms.shape[0]])


def test_async_stress_random_chunks_with_transient_launch_failures(
        monkeypatch):
    injected = {"n": 0}
    attempted = {}                                   # id(batch) → batch ref
    orig_execute = MicroBatcher.execute

    def flaky_execute(self, batch):
        if id(batch) not in attempted:
            attempted[id(batch)] = batch             # strong ref: stable ids
            injected["n"] += 1
            if injected["n"] % 3 == 0:
                raise RuntimeError("injected transient device fault")
        return orig_execute(self, batch)

    monkeypatch.setattr(MicroBatcher, "execute", flaky_execute)
    n_per_backend, n_syms = 3, 311
    with _runtime(BatchPolicy(max_batch=3, max_wait_s=1e9),
                  launch_retries=2) as rt:
        specs = [_spec(f"st-{b}-{i}", b, seed=120 + 10 * j + i)
                 for j, b in enumerate(("fused_fp32", "fused_int8"))
                 for i in range(n_per_backend)]
        rng = np.random.default_rng(59)
        waves = {s.tenant_id:
                 rng.standard_normal(n_syms * CFG.n_os).astype(np.float32)
                 for s in specs}
        for s in specs:
            rt.open(s)
        streams = {s.tenant_id: chop(waves[s.tenant_id], 200, seed=i,
                                     jitter=0.9)
                   for i, s in enumerate(specs)}
        futs = _feed(rt, streams)
        assert injected["n"] >= 3                    # faults really fired
        assert not rt.errors                         # …but none terminal
        for s in specs:
            want = _offline(s, waves[s.tenant_id])
            np.testing.assert_array_equal(rt.output(s.tenant_id), want)
            parts = [f.result(timeout=10) for f in futs[s.tenant_id]]
            np.testing.assert_array_equal(np.concatenate(parts), want)


def test_async_cancelled_future_does_not_poison_batch():
    with _runtime(BatchPolicy(max_batch=2, max_wait_s=1e9)) as rt:
        a = _spec("canc-a", "fused_fp32", seed=150)
        b = _spec("canc-b", "fused_fp32", seed=151)
        wa, wb = _wave(71, 600), _wave(72, 600)
        rt.open(a)
        rt.open(b)
        fa = rt.submit("canc-a", wa)       # 1st of 2 → stays pending
        assert fa is not None
        fa.cancel()                        # legal caller-side abandonment
        fb = rt.submit("canc-b", wb)       # completes the batch → launch
        rt.drain()
        assert not rt.errors
        np.testing.assert_array_equal(fb.result(timeout=10),
                                      rt.output("canc-b"))
        np.testing.assert_array_equal(rt.close("canc-a"), _offline(a, wa))


def test_async_terminal_failure_poisons_stream(monkeypatch):
    def dead_execute(self, batch):
        raise RuntimeError("dead device")

    monkeypatch.setattr(MicroBatcher, "execute", dead_execute)
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  launch_retries=1) as rt:
        rt.open(_spec("doomed", "fused_fp32", seed=130))
        fut = rt.submit("doomed", _wave(61, 200))
        rt.drain()
        assert rt.errors
        with pytest.raises(RuntimeError, match="dead device"):
            fut.result(timeout=10)
        with pytest.raises(RuntimeError, match="lost a chunk"):
            rt.output("doomed")


def test_async_close_waits_for_inflight_and_shutdown_rejects():
    rt = _runtime(BatchPolicy(max_batch=4, max_wait_s=1e9))
    try:
        spec = _spec("closer", "fused_fp32", seed=140)
        rt.open(spec)
        wave = _wave(67, 600)
        for c in chop(wave, 300, seed=5):
            rt.submit("closer", c)
        got = rt.close("closer")                     # schedules + waits
        np.testing.assert_array_equal(got, _offline(spec, wave))
        assert "closer" not in rt.sessions
    finally:
        rt.shutdown()
    assert not rt._launcher.is_alive() and not rt._timer.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        rt.submit("closer", np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# tests/test_fault.py: failover, quarantine, deadline, degradation, chaos
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_async_terminal_injected_failure_recovers_bitwise():
    fp = FaultPlan([Fault("launch_error", 0), Fault("launch_error", 1)])
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  launch_retries=1, fault_plan=fp) as rt:
        spec = _spec("phoenix", "fused_fp32", seed=17)
        rt.open(spec)
        wave = _wave(23, 400)
        futs = [rt.submit("phoenix", c) for c in chop(wave, 350, seed=2)]
        futs.append(rt.finish("phoenix"))
        rt.drain()
        for f in futs:
            if f is not None:
                assert np.isfinite(f.result(timeout=30)).all()
        np.testing.assert_array_equal(rt.output("phoenix"),
                                      _offline(spec, wave))
        st = rt.stats()
        assert st["recovery"]["recoveries"] >= 1
        assert st["recovery"]["chunks_replayed"] >= 1
        assert st["recovery"]["engine_rebuilds"] >= 1
        assert st["recovery"]["sessions_poisoned"] == 0
        assert rt.errors and rt.errors_total == len(rt.errors)


@pytest.mark.chaos
def test_async_build_failure_during_failover_is_retried():
    fp = FaultPlan([Fault("launch_error", 0), Fault("launch_error", 1),
                    Fault("build_error", 1)])
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  launch_retries=1, fault_plan=fp) as rt:
        spec = _spec("rebuilder", "fused_fp32", seed=31)
        rt.open(spec)
        wave = _wave(37, 300)
        rt.submit("rebuilder", wave)
        np.testing.assert_array_equal(rt.close("rebuilder"),
                                      _offline(spec, wave))
        assert fp.pending == 0
        assert rt.recovery_stats.engine_rebuilds >= 1


@pytest.mark.chaos
def test_async_recovery_budget_exhaustion_still_poisons(monkeypatch):
    def dead_execute(self, batch):
        raise RuntimeError("dead device")

    monkeypatch.setattr(MicroBatcher, "execute", dead_execute)
    pol = RecoveryPolicy(max_session_recoveries=2, backoff_base_s=1e-4,
                         backoff_max_s=1e-3)
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  launch_retries=0, recovery=pol) as rt:
        rt.open(_spec("doomed", "fused_fp32", seed=41))
        fut = rt.submit("doomed", _wave(43, 250))
        rt.drain()
        with pytest.raises(RuntimeError, match="dead device"):
            fut.result(timeout=30)
        with pytest.raises(RuntimeError, match="lost a chunk"):
            rt.output("doomed")
        s = rt.sessions.get("doomed")
        assert s.recoveries == pol.max_session_recoveries + 1
        assert rt.recovery_stats.sessions_poisoned == 1


@pytest.mark.chaos
def test_async_corrupt_output_quarantined_and_replayed_bitwise():
    fp = FaultPlan([Fault("corrupt", 0, mode="nan"),
                    Fault("corrupt", 1, mode="saturate")])
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  fault_plan=fp) as rt:
        spec = _spec("glitchy", "fused_int8", seed=53)
        rt.open(spec)
        wave = _wave(59, 300)
        for c in chop(wave, 280, seed=4):
            rt.submit("glitchy", c)
        rt.finish("glitchy")
        rt.drain()
        got = rt.output("glitchy")
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, _offline(spec, wave))
        assert rt.recovery_stats.corrupt_detected >= 1
        assert rt.recovery_stats.sessions_poisoned == 0


@pytest.mark.chaos
def test_async_corrupt_after_swap_rolls_back_weights():
    w1 = _weights(67)
    # exec 0 = pre-swap launch; exec 1 = first post-swap launch → corrupt
    fp = FaultPlan([Fault("corrupt", 1, mode="nan")])
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  fault_plan=fp) as rt:
        spec = _spec("swapper", "fused_fp32", seed=61)
        rt.open(spec)
        rt.submit("swapper", _wave(71, 200)).result(timeout=30)
        assert rt.swap_weights("swapper", weights=w1) == 1
        f1 = rt.submit("swapper", _wave(73, 200))
        rt.drain()
        assert np.isfinite(f1.result(timeout=30)).all()
        s = rt.sessions.get("swapper")
        assert s.failed is None and s.rolled_back
        assert rt.recovery_stats.rollbacks == 1
        assert s.spec.weight_epoch == 2            # rollback bumps epoch
        np.testing.assert_array_equal(np.asarray(s.spec.weights[0][0]),
                                      np.asarray(spec.weights[0][0]))


@pytest.mark.chaos
def test_async_launch_deadline_abandons_hung_call():
    """A 3 s injected delay against a 1 s watchdog: the hung attempt is
    abandoned, the retry lands clean, the stream stays bitwise. Exec 0 is
    a fault-free warm-up (on a card, the kernel's first build)."""
    fp = FaultPlan([Fault("launch_delay", 1, delay_s=3.0)])
    with _runtime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                  launch_retries=1, launch_deadline_s=1.0,
                  fault_plan=fp) as rt:
        spec = _spec("sleeper", "fused_fp32", seed=79)
        rt.open(spec)
        wave = _wave(83, 400)
        chunks = list(chop(wave, 220, seed=6))
        rt.submit("sleeper", chunks[0]).result(timeout=60)   # warm-up
        for c in chunks[1:]:
            rt.submit("sleeper", c)
        np.testing.assert_array_equal(rt.close("sleeper"),
                                      _offline(spec, wave))
        assert rt.recovery_stats.deadline_timeouts >= 1
        assert rt.recovery_stats.sessions_poisoned == 0


@pytest.mark.chaos
def test_degradation_shrinks_sheds_lowest_priority_and_restores():
    cfg = StragglerConfig(warmup_steps=2, patience=2, sigma_factor=3.0)
    with _runtime(BatchPolicy(max_batch=8, max_wait_s=1e9),
                  straggler=cfg, degrade_on_slow=True) as rt:
        rt.open(_spec("vip", "fused_fp32", seed=89, priority=5))
        rt.open(_spec("best-effort", "fused_fp32", seed=97, priority=0))
        ctl = rt.degradation
        step = 0
        with rt._lock:
            for _ in range(6):                     # warmup + baseline
                ctl.observe(step, 0.01)
                step += 1
            for _ in range(2):                     # persistent slowness
                ctl.observe(step, 1.0)
                step += 1
        assert ctl.degraded
        assert rt.batcher.policy.max_batch == 4
        assert ctl.shed_ids == ["best-effort"]     # lowest priority first
        with pytest.raises(TenantShedError):
            rt.submit("best-effort", np.zeros(300, np.float32))
        rt.submit("vip", _wave(101, 100))          # VIP keeps serving
        with rt._lock:
            for _ in range(2):                     # health returns
                ctl.observe(step, 0.01)
                step += 1
        assert not ctl.degraded
        assert rt.batcher.policy.max_batch == 8
        assert not rt.sessions.get("best-effort").shed
        rt.submit("best-effort", _wave(103, 80))   # readmitted
        rt.drain()


CHAOS_FAULTS = (Fault("launch_delay", 1, delay_s=0.05),
                Fault("launch_error", 2), Fault("launch_error", 3),
                Fault("corrupt", 5, mode="saturate"),
                Fault("build_error", 6))  # builds 0-5 are the opens


def _chaos_specs():
    backends = ["fused_fp32", "fused_int8"]
    specs = [_spec(f"t{i}", backends[i % 2], seed=200 + i, priority=i)
             for i in range(6)]
    waves = {s.tenant_id: _wave(300 + i, 280 + 16 * i)
             for i, s in enumerate(specs)}
    streams = {t: chop(w, 120 * CFG.n_os, seed=i, jitter=0.5)
               for i, (t, w) in enumerate(sorted(waves.items()))}
    return specs, waves, streams


@pytest.mark.chaos
def test_chaos_sweep_six_tenants_all_fault_kinds_bitwise_zero_loss():
    fp = FaultPlan(list(CHAOS_FAULTS))
    specs, waves, streams = _chaos_specs()
    with _runtime(BatchPolicy(max_batch=3, max_wait_s=1e9),
                  launch_retries=1, fault_plan=fp) as rt:
        for s in specs:
            rt.open(s)
        futs = _feed(rt, streams)
        for fs in futs.values():
            for f in fs:
                assert np.isfinite(f.result(timeout=60)).all()
        for s in specs:
            got = rt.output(s.tenant_id)
            want = _offline(s, waves[s.tenant_id])
            assert got.shape == want.shape         # exactly-once emission
            np.testing.assert_array_equal(got, want)
        st = rt.stats()
        assert fp.pending == 0, f"unfired faults: {fp.summary()}"
        assert set(fp.summary()) == {"launch_error", "launch_delay",
                                     "corrupt", "build_error"}
        assert st["recovery"]["recoveries"] >= 1
        assert st["recovery"]["chunks_replayed"] >= 1
        assert st["recovery"]["sessions_poisoned"] == 0


# ---------------------------------------------------------------------------
# tests/test_obs.py: the async runtime's telemetry
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_chaos_sweep_with_tracing_bitwise_and_trace_integrity():
    fp = FaultPlan(list(CHAOS_FAULTS))
    specs, waves, streams = _chaos_specs()
    obs = Observability(tracing=True)
    emitted = {}
    with _runtime(BatchPolicy(max_batch=3, max_wait_s=1e9),
                  launch_retries=1, fault_plan=fp, obs=obs) as rt:
        for s in specs:
            rt.open(s)
        _feed(rt, streams, with_futures=False)
        for s in specs:
            got = rt.output(s.tenant_id)
            np.testing.assert_array_equal(got,
                                          _offline(s, waves[s.tenant_id]))
            emitted[s.tenant_id] = got.shape[0]
        st = rt.stats()
        assert st["recovery"]["sessions_poisoned"] == 0
        assert st["errors_total"] == st["errors"]
    assert fp.pending == 0
    tracer = obs.tracer
    assert tracer.spans_started == tracer.spans_sealed
    spans = tracer.sealed_spans()
    keys = [(s.tenant, s.seq) for s in spans]
    assert len(keys) == len(set(keys)), "duplicate spans"
    for t, n in emitted.items():
        mine = [s for s in spans if s.tenant == t]
        assert sorted(s.seq for s in mine) == list(range(len(mine)))
        ok = [s for s in mine if s.status == "ok"]
        assert all(s.complete() for s in ok)
        assert sum(s.n_emit for s in ok) * CFG.v_parallel == n
    events = [name for s in spans for (name, _, _) in s.events]
    assert "retry" in events and "replay" in events
    builds = [i for i in tracer.instants if i[0] == "engine_build"]
    assert len(builds) >= len(specs) + 1


def test_frozen_clock_yields_zero_latency_telemetry_async():
    frozen = lambda: 42.0                                    # noqa: E731
    spec = _spec("t0", "fused_fp32", seed=12)
    wave = _wave(6, 300)
    obs = Observability(tracing=True, clock=frozen)
    with _runtime(BatchPolicy(max_batch=3, max_wait_s=1e9), clock=frozen,
                  obs=obs) as rt:
        rt.open(spec)
        _feed(rt, {"t0": chop(wave, 120 * CFG.n_os, seed=0)},
              with_futures=False)
        np.testing.assert_array_equal(rt.output("t0"), _offline(spec, wave))
    for s in obs.tracer.sealed_spans():
        assert set(s.marks.values()) == {42.0}
    snap = obs.snapshot()["serve"]["launch"]
    for key in ("latency_s", "wait_s", "device_s", "descatter_s"):
        assert snap[key]["max"] == 0.0, key


def test_retention_bounds_error_deques():
    rt = _runtime(BatchPolicy(), obs=Observability(
        retention=Retention(errors=2)))
    try:
        assert rt.errors.maxlen == 2
    finally:
        rt.shutdown()


def test_stats_schemas_normalized_over_snapshot():
    with _runtime(BatchPolicy(max_batch=3, max_wait_s=1e9)) as art:
        ast = art.stats()
        assert ast["errors_total"] == ast["errors"] == 0
        asnap = art.obs.snapshot()
        assert asnap["serve"]["errors"] == {
            "total": 0, "window": 0, "dropped": 0}
        assert "recovery" in ast and "degradation" in ast
        spec = _spec("t0", "fused_fp32", seed=31)
        art.open(spec)
        wave = _wave(7, 300)
        _feed(art, {"t0": chop(wave, 120 * CFG.n_os, seed=0)},
              with_futures=False)
        st, snap = art.stats(), art.obs.snapshot()
        assert st["pool"] == {k: v for k, v in snap["serve"]["pool"].items()
                              if k != "build_s"}
        assert st["requests"] == snap["serve"]["latency"]["requests"]
        assert snap["serve"]["inflight"] == st["inflight"] == 0
        assert (snap["serve"]["sessions"]["t0"]["syms_emitted"]
                == art.output("t0").shape[0])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_int8_async_streams_equal_jax_serve_runtime_exactly():
    specs = [_spec(f"ht-{i}", "fused_int8", seed=400 + i, tile_m=64)
             for i in range(3)]
    waves = {s.tenant_id: _wave(410 + i, 500) for i, s in enumerate(specs)}
    streams = {t: chop(w, 700, seed=i) for i, (t, w) in
               enumerate(sorted(waves.items()))}
    with _runtime(BatchPolicy(max_batch=2, max_wait_s=1e9)) as rt:
        for s in specs:
            rt.open(s)
        _feed(rt, streams, with_futures=False)
        got = {t: rt.close(t) for t in waves}
    jrt = JRuntime(JPolicy(max_batch=2, max_wait_s=1e9))
    for s in specs:
        jrt.open(JSpec(s.tenant_id, HT.CNN,
                       weights=jax.tree.map(jnp.asarray, s.weights),
                       formats=INT8_FMT, backend="fused_int8", tile_m=64))
    _feed(jrt, streams, with_futures=False)
    for t in waves:
        want = jrt.close(t)
        assert got[t].shape == want.shape
        np.testing.assert_array_equal(got[t], want)


def test_loadgen_matches_reference():
    for n, syms, os_, seed in ((3, 100, 2, 0), (2, 77, 1, 5)):
        got = random_waveforms(n, syms, n_os=os_, seed=seed)
        want = jloadgen.random_waveforms(n, syms, n_os=os_, seed=seed)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    wave = _wave(9, 1000)
    for size, seed, jitter in ((300, 1, 0.5), (64, 2, 0.0), (999, 3, 0.9),
                               (5000, 4, 0.5)):
        got = chop(wave, size, seed=seed, jitter=jitter)
        want = jloadgen.chop(wave, size, seed=seed, jitter=jitter)
        assert [c.shape for c in got] == [c.shape for c in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # replay: the same traffic through both packages' sync runtimes, and
    # the port's async runtime, gives the reference's totals
    specs = [_spec(f"r{i}", "fused_int8", seed=500 + i, tile_m=64)
             for i in range(3)]
    waves = dict(zip((s.tenant_id for s in specs),
                     random_waveforms(3, 400, seed=11)))
    streams = {t: chop(w, 256, seed=i) for i, (t, w) in
               enumerate(waves.items())}
    jrt = JRuntime(JPolicy(max_batch=3, max_wait_s=1e9))
    for s in specs:
        jrt.open(JSpec(s.tenant_id, HT.CNN,
                       weights=jax.tree.map(jnp.asarray, s.weights),
                       formats=INT8_FMT, backend="fused_int8", tile_m=64))
    want = jloadgen.replay(jrt, streams)
    totals = []
    rt = ServeRuntime(BatchPolicy(max_batch=3, max_wait_s=1e9), device="cpu")
    arts = _runtime(BatchPolicy(max_batch=3, max_wait_s=1e9))
    try:
        for r in (rt, arts):
            for s in specs:
                r.open(s)
            totals.append(replay(r, streams))
            for t in waves:
                np.testing.assert_array_equal(r.output(t), jrt.output(t))
    finally:
        arts.shutdown()
    for got in totals:
        assert set(got) == set(want)
        assert got["total_syms"] == want["total_syms"] == 3 * 400
    assert loadgen.replay is replay

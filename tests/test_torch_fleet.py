"""Port vs reference: fleet serving (repro_torch.serve.fleet) on the CPU.

Mirrors tests/test_fleet.py against the port with ``devices=["cpu"]``
(two workers cycle the one host device, as they cycle ``cuda:0`` on one
card), keeping its `chaos` marker:

  * `worker_devices` cycles its devices, validates the width, raises with
    no device, and without a card raises instead of falling back;
  * a `FaultPlan` kills worker 0 of a 2-worker fleet mid-stream: every
    stream migrates and finishes bitwise equal to the port's offline
    engine, every chunk once, 0 sessions poisoned, the migration in the
    per-worker ledgers; the migrated sessions live on the survivor's
    device (`Session.rebuild_on(pool, device=…)`);
  * `device_slow` feeds the heartbeat without killing the worker;
  * consecutive terminal failures declare the device lost;
  * budget exhaustion poisons only the stream over budget;
  * a fleet with no survivor poisons and refuses opens;
  * shutdown is idempotent.

Against the JAX package: an int8 fleet's streams (with a worker killed)
equal the JAX `FleetRuntime`'s exactly; the report's fleet section
renders as the reference's. The twin of
`test_best_mesh_shapes_and_runtime_reexport` is in
tests/test_torch_elastic.py (`mesh_shape` against the reference's
`best_mesh`, and `best_mesh` building `DeviceMesh`es over gloo ranks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import equalizer as jeq
from repro.obs import report as jreport
from repro.serve import BatchPolicy as JPolicy
from repro.serve import Fault as JFault
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import FleetRuntime as JFleetRuntime
from repro.serve import TenantSpec as JSpec
from repro_torch.core import equalizer as eq
from repro_torch.obs import report as treport
from repro_torch.serve import (BatchPolicy, Fault, FaultPlan, FleetRuntime,
                               FleetWorker, RecoveryPolicy, TenantSpec, chop,
                               worker_devices)

pytestmark = pytest.mark.chaos

CFG = eq.CNNEqConfig()
INT8_FMT = tuple((2, 5, 3, 4) for _ in range(CFG.layers))
CPU = ["cpu"]


def _weights(seed):
    """BN-folded weights drawn by the JAX package, carried as numpy."""
    params = jeq.init(jax.random.PRNGKey(seed), jeq.CNNEqConfig())
    folded = jeq.fold_bn(params, jeq.init_bn_state(jeq.CNNEqConfig()),
                         jeq.CNNEqConfig())
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


def _policy():
    return BatchPolicy(max_batch=3, max_wait_s=1e9)


def _fleet(**kw):
    return FleetRuntime(devices=CPU, **kw)


def _feed(rt, waves):
    """Round-robin jittered chunks (sorted tenants), finish each exhausted
    stream, drain; returns each tenant's output."""
    streams = {t: iter(chop(w, 120 * CFG.n_os, seed=i, jitter=0.5))
               for i, (t, w) in enumerate(sorted(waves.items()))}
    live = set(streams)
    while live:
        for t in sorted(live):
            c = next(streams[t], None)
            if c is None:
                live.discard(t)
                rt.finish(t)
            else:
                rt.submit(t, c)
    rt.drain()
    return {t: rt.output(t) for t in waves}


# ---------------------------------------------------------------------------
# device set
# ---------------------------------------------------------------------------

def test_worker_devices_cycles_and_validates():
    picked = worker_devices(3, devices=CPU)
    assert picked == [torch.device("cpu")] * 3
    two = worker_devices(devices=["cpu", torch.device("cpu")])
    assert two == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="n_workers"):
        worker_devices(0, devices=CPU)
    with pytest.raises(RuntimeError, match="no devices"):
        worker_devices(2, devices=[])


def test_worker_devices_and_fleet_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        worker_devices(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FleetRuntime(n_workers=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        worker_devices(1, devices=["cuda:0"])


# ---------------------------------------------------------------------------
# the acceptance sweep: kill a worker mid-stream, stay bitwise
# ---------------------------------------------------------------------------

def test_fleet_chaos_device_loss_migrates_bitwise_zero_loss():
    fp = FaultPlan([Fault("device_lost", at=0, after=2)])
    specs = [_spec(f"t{i}", ("fused_fp32", "fused_int8")[i % 2],
                   seed=200 + i, priority=i) for i in range(4)]
    waves = {s.tenant_id: _wave(300 + i, 280 + 16 * i)
             for i, s in enumerate(specs)}
    with _fleet(n_workers=2, policy=_policy(), launch_retries=1,
                fault_plan=fp) as rt:
        for s in specs:
            rt.open(s)
        assert rt.stats()["placement"] == {"t0": 0, "t1": 1,
                                           "t2": 0, "t3": 1}
        assert all(isinstance(w, FleetWorker) and w.stream is None
                   for w in rt.workers)
        outputs = _feed(rt, waves)
        st = rt.stats()
        devices = {t: s.device for t, s in rt.sessions.items()}

    for s in specs:
        want = _offline(s, waves[s.tenant_id])
        got = outputs[s.tenant_id]
        assert got.shape == want.shape             # exactly-once emission
        np.testing.assert_array_equal(got, want)   # bitwise == offline
    assert fp.fired == [("device_lost", 0)]
    assert st["migrations"] == 1
    agg = st["recovery"]
    assert agg["sessions_poisoned"] == 0
    assert agg["device_losses"] == 1
    w0, w1 = st["workers"]
    assert not w0["alive"] and "DeviceLost" in w0["reason"]
    assert w0["recovery"]["sessions_migrated_out"] == 2
    assert w1["alive"] and w1["device"] == "cpu"
    assert w1["recovery"]["sessions_migrated_in"] == 2
    assert w1["recovery"]["engine_rebuilds"] >= 2
    assert st["placement"] == {"t0": 1, "t1": 1, "t2": 1, "t3": 1}
    assert set(devices.values()) == {torch.device("cpu")}


def test_fleet_device_slow_fires_without_killing_worker():
    fp = FaultPlan([Fault("device_slow", at=0, after=1, delay_s=0.05)])
    spec = _spec("slowpoke", "fused_fp32", seed=11)
    wave = _wave(13, 300)
    with _fleet(n_workers=2, policy=_policy(), fault_plan=fp) as rt:
        rt.open(spec)
        for c in chop(wave, 100 * CFG.n_os, seed=1):
            rt.submit("slowpoke", c)
        got = rt.close("slowpoke")
        st = rt.stats()
    np.testing.assert_array_equal(got, _offline(spec, wave))
    assert fp.fired == [("device_slow", 0)]
    assert st["workers"][0]["alive"]
    assert st["recovery"]["device_losses"] == 0
    assert st["recovery"]["sessions_poisoned"] == 0


def test_fleet_consecutive_failures_declare_device_lost():
    fp = FaultPlan([Fault("launch_error", 0)])
    pol = RecoveryPolicy(device_lost_after=1, backoff_base_s=1e-4,
                         backoff_max_s=1e-3)
    spec = _spec("flaky", "fused_fp32", seed=23)
    wave = _wave(29, 300)
    with _fleet(n_workers=2, policy=_policy(), launch_retries=0,
                recovery=pol, fault_plan=fp) as rt:
        rt.open(spec)
        for c in chop(wave, 100 * CFG.n_os, seed=2):
            rt.submit("flaky", c)
        got = rt.close("flaky")
        st = rt.stats()
    np.testing.assert_array_equal(got, _offline(spec, wave))
    w0 = st["workers"][0]
    assert not w0["alive"] and "consecutive terminal" in w0["reason"]
    assert st["migrations"] == 1
    assert st["recovery"]["sessions_poisoned"] == 0
    assert st["recovery"]["sessions_migrated_in"] == 1


def test_fleet_budget_exhaustion_poisons_only_the_over_budget_stream():
    fp = FaultPlan([Fault("device_lost", at=0, after=0)])
    pol = RecoveryPolicy(max_session_recoveries=0, backoff_base_s=1e-4,
                         backoff_max_s=1e-3)
    doomed = _spec("doomed", "fused_fp32", seed=31)
    lucky = _spec("lucky", "fused_fp32", seed=37)
    wave_d, wave_l = _wave(41, 300), _wave(43, 300)
    with _fleet(n_workers=2, policy=_policy(), launch_retries=0,
                recovery=pol, fault_plan=fp) as rt:
        rt.open(doomed)                            # → worker 0
        rt.open(lucky)                             # → worker 1
        assert rt.stats()["placement"] == {"doomed": 0, "lucky": 1}
        fut = rt.submit("doomed", wave_d)
        rt.submit("lucky", wave_l)
        rt.finish("doomed")
        rt.finish("lucky")
        rt.drain()
        with pytest.raises(Exception):
            fut.result(timeout=30)
        with pytest.raises(RuntimeError, match="lost a chunk"):
            rt.output("doomed")
        got = rt.output("lucky")
        st = rt.stats()
    np.testing.assert_array_equal(got, _offline(lucky, wave_l))
    assert st["workers"][0]["recovery"]["sessions_poisoned"] == 1
    assert st["recovery"]["sessions_migrated_in"] == 0


def test_fleet_no_survivors_poisons_and_rejects_opens():
    fp = FaultPlan([Fault("device_lost", at=0, after=0)])
    with _fleet(n_workers=1, policy=_policy(), launch_retries=0,
                fault_plan=fp) as rt:
        rt.open(_spec("stranded", "fused_fp32", seed=47))
        rt.submit("stranded", _wave(53, 300))
        rt.finish("stranded")
        rt.drain()
        with pytest.raises(RuntimeError, match="lost a chunk"):
            rt.output("stranded")
        with pytest.raises(RuntimeError, match="no healthy workers"):
            rt.open(_spec("latecomer", "fused_fp32", seed=59))
        st = rt.stats()
    assert st["recovery"]["sessions_poisoned"] == 1
    assert st["recovery"]["device_losses"] == 1


def test_fleet_shutdown_is_idempotent_and_rejects_after():
    rt = _fleet(n_workers=2, policy=_policy())
    rt.shutdown()
    rt.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        rt.open(_spec("late", "fused_fp32", seed=61))


def test_fleet_dead_worker_leaves_its_queue_to_the_migration_sweep(
        monkeypatch):
    """Batches queued behind the launch that kills a worker all migrate.
    The reference's dead launcher kept popping them ("strander"); one
    popped just before a migration sweep and stranded just after it was
    never migrated, and drain() waited for it forever (seen on the card).
    Here every `_run_batch` is slowed by 0.2 s, which would hold such a
    batch across the sweep; the port's dead launcher pops nothing, so the
    sweep finds every batch in the queue and the streams stay bitwise."""
    import threading
    import time
    from repro_torch.serve import fleet as tfleet
    run_batch = tfleet.FleetWorker._run_batch

    def slow(self, batch):
        time.sleep(0.2)
        return run_batch(self, batch)

    monkeypatch.setattr(tfleet.FleetWorker, "_run_batch", slow)
    fp = FaultPlan([Fault("device_lost", at=0, after=0)])
    specs = [_spec(f"s{i}", "fused_fp32", seed=80 + i) for i in range(2)]
    waves = {s.tenant_id: _wave(90 + i, 480) for i, s in enumerate(specs)}
    box = {}
    with _fleet(n_workers=2, policy=BatchPolicy(max_batch=1,
                                                max_wait_s=1e9),
                launch_retries=0, fault_plan=fp) as rt:
        for s in specs:
            rt.open(s)                             # s0 → worker 0

        def feed():
            for c in chop(waves["s0"], 60 * CFG.n_os, seed=5):
                rt.submit("s0", c)                 # queue behind the kill
            for c in chop(waves["s1"], 60 * CFG.n_os, seed=6):
                rt.submit("s1", c)
            box["out"] = _feed(rt, {})             # drain()
        th = threading.Thread(target=feed, daemon=True)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive(), "drain() never returned"
        outs = {t: rt.close(t) for t in waves}
        st = rt.stats()
    assert fp.fired == [("device_lost", 0)] and st["migrations"] == 1
    assert st["recovery"]["sessions_poisoned"] == 0
    for s in specs:
        np.testing.assert_array_equal(outs[s.tenant_id],
                                      _offline(s, waves[s.tenant_id]))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_int8_fleet_equals_reference_fleet_exactly():
    """Three int8 tenants on 2-worker fleets of both packages, worker 0
    lost at its launch: every stream equal exactly (integer datapath), and
    the same placement and migration ledger. Nothing launches before
    drain() (max_batch above every group's requests, no max_wait), so
    worker 0's one batch is the one that dies and nothing queues behind
    it: the reference's dead launcher has nothing to pop, which keeps the
    reference clear of its strander race (see
    test_fleet_dead_worker_leaves_its_queue_to_the_migration_sweep)."""
    specs = [_spec(f"q{i}", "fused_int8", seed=400 + i) for i in range(3)]
    waves = {s.tenant_id: _wave(500 + i, 300 + 24 * i)
             for i, s in enumerate(specs)}
    with _fleet(n_workers=2, policy=BatchPolicy(max_batch=16,
                                                max_wait_s=1e9),
                launch_retries=0,
                fault_plan=FaultPlan([Fault("device_lost", 0, 0)])) as rt:
        for s in specs:
            rt.open(s)
        got = _feed(rt, waves)
        st = rt.stats()
    jspecs = [JSpec(s.tenant_id, jeq.CNNEqConfig(),
                    weights=jax.tree.map(jnp.asarray, s.weights),
                    formats=s.formats, backend=s.backend, tile_m=s.tile_m)
              for s in specs]
    jfp = JFaultPlan([JFault("device_lost", 0, 0)])
    with JFleetRuntime(n_workers=2, policy=JPolicy(max_batch=16,
                                                   max_wait_s=1e9),
                       launch_retries=0, fault_plan=jfp) as jrt:
        for s in jspecs:
            jrt.open(s)
        want = _feed(jrt, waves)
        jst = jrt.stats()
    assert jfp.fired == [("device_lost", 0)]
    assert st["workers"][0]["traffic"] == {}      # its one launch died
    for t in waves:
        assert got[t].shape == want[t].shape
        np.testing.assert_array_equal(got[t], want[t])
    assert st["placement"] == jst["placement"]
    assert st["migrations"] == jst["migrations"] == 1
    for f in ("sessions_migrated_in", "sessions_migrated_out",
              "sessions_poisoned", "device_losses"):
        assert st["recovery"][f] == jst["recovery"][f], f


def test_report_renders_the_fleet_section_as_the_reference():
    snap = {"fleet": {
        "tenants": 2, "inflight": 0, "migrations": 1,
        "errors": {"total": 1, "window": 1, "dropped": 0},
        "recovery": {"device_losses": 1, "sessions_migrated_in": 2},
        "placement": {"a": 1, "b": 1},
        "worker0": {"alive": False, "requests_total": 3,
                    "launches_total": 2,
                    "recovery": {"device_losses": 1}},
        "worker1": {"alive": True, "requests_total": 9,
                    "launches_total": 4,
                    "launch": {"latency_s": {"count": 4, "mean": 0.001,
                                             "p50": 0.001, "p99": 0.002}},
                    "recovery": {}}}}
    got = treport.render(snap)
    assert got == jreport.render(snap)
    assert "[fleet]" in got and "a->w1" in got


def test_fleet_snapshot_renders_in_the_report():
    with _fleet(n_workers=2, policy=_policy()) as rt:
        rt.open(_spec("r", "fused_fp32", seed=71))
        for c in chop(_wave(73, 300), 100 * CFG.n_os, seed=3):
            rt.submit("r", c)
        rt.close("r")
        text = treport.render(rt.obs.snapshot())
    assert "[fleet]" in text and "[worker0] alive=True" in text

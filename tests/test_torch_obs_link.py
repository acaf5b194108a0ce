"""Port vs reference: link-quality estimators, the SLO engine and the
console report (repro_torch.obs.{link, slo, report}).

Mirrors tests/test_link.py against the port — decision-directed EVM/SNR/SER
at known SNR, windowed vs lifetime views, the confidence histogram, SLO
hysteresis (patience, clear edges, no thrash, the min-samples guard, rule
validation, the breach hook and `resolve`) — and the report's sections
(tests/test_obs.py's report test, on the sections the port has). Two taps
share a live session's descatter seam: a `LinkMonitor` attached through the
runtime's ``link=`` hook and a recording tap, and serving stays bitwise
equal to offline (the reference's collector test, whose collector comes
with adaptation). Against the JAX package: the same soft symbols give the
same `LinkEstimate`, gauges and SLO ledger in both packages, exactly.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.core import equalizer as jeq
from repro.obs import LinkMonitor as JLinkMonitor
from repro.obs import Observability as JObservability
from repro.obs import SloEngine as JSloEngine
from repro.obs import SloRule as JSloRule
from repro.obs.link import pam_amplitudes as j_pam_amplitudes
from repro.obs.link import pam_ser as j_pam_ser
from repro.obs.link import q_function as j_q_function
from repro.obs.report import render as j_render
from repro_torch.core import equalizer as teq
from repro_torch.obs import (LinkEstimate, LinkMonitor, Observability,
                             SloEngine, SloRule)
from repro_torch.obs.link import pam_amplitudes, pam_ser, q_function
from repro_torch.obs.report import main as report_main, render
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy, ServeRuntime,
                               TenantSpec, chop)

pytestmark = pytest.mark.link

CFG = teq.CNNEqConfig()


def _pam_stream(levels, snr_db, n, seed=0):
    """Unit-power M-PAM symbols in AWGN at exactly the requested SNR."""
    rng = np.random.default_rng(seed)
    amps = pam_amplitudes(levels)
    tx = amps[rng.integers(0, levels, n)]
    sigma = 10.0 ** (-snr_db / 20.0)        # Es = 1 by construction
    return tx + rng.normal(0.0, sigma, n), tx


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels,snr_db,tol_db", [
    (4, 20.0, 0.3),     # decisions near-perfect: estimate ~unbiased
    (2, 14.0, 0.3),
    (2, 10.0, 0.6),     # mild DD bias allowed
])
def test_dd_snr_estimate_matches_truth(levels, snr_db, tol_db):
    obs = Observability()
    link = LinkMonitor(obs)
    link.watch("t", levels)
    y, _ = _pam_stream(levels, snr_db, 20_000)
    link.observe("t", y)
    est = link.estimate("t")
    assert abs(est.snr_db_lifetime - snr_db) < tol_db
    assert abs(est.evm_lifetime - 10.0 ** (-est.snr_db_lifetime / 20.0)) < 1e-9
    ser_ref = pam_ser(10.0 ** (est.snr_db_lifetime / 10.0), levels)
    assert est.ser_proxy_lifetime == pytest.approx(ser_ref, rel=0.1)
    assert obs.registry.instrument("link.t.snr_db").value == est.snr_db


def test_windowed_vs_lifetime_views():
    obs = Observability()
    link = LinkMonitor(obs, window=4096)
    link.watch("t", 2)
    hi, _ = _pam_stream(2, 20.0, 8192, seed=1)
    lo, _ = _pam_stream(2, 8.0, 4096, seed=2)
    link.observe("t", hi)
    link.observe("t", lo)
    est = link.estimate("t")
    assert abs(est.snr_db - 8.0) < 1.0
    assert est.snr_db < est.snr_db_lifetime < 20.0
    assert est.syms == 8192 + 4096


def test_confidence_histogram_sees_boundary_symbols():
    obs = Observability()
    link = LinkMonitor(obs)
    link.watch("t", 2)
    amps = pam_amplitudes(2)
    link.observe("t", np.repeat(amps, 64))            # on-grid: margin 1
    clean = obs.registry.instrument("link.t.confidence").window_mean()
    assert clean == pytest.approx(1.0)
    link.observe("t", np.zeros(128))                  # boundary: margin 0
    mixed = obs.registry.instrument("link.t.confidence").window_mean()
    assert mixed == pytest.approx(0.5, abs=0.05)


def test_observe_unwatched_tenant_raises():
    link = LinkMonitor(Observability())
    with pytest.raises(KeyError):
        link.observe("ghost", np.ones(4))
    with pytest.raises(ValueError):
        link.watch("t", levels=1)
    with pytest.raises(ValueError):
        LinkMonitor(Observability(), window=0)


@pytest.mark.parametrize("levels", [2, 4, 8])
def test_estimates_equal_reference_exactly(levels):
    """The same soft symbols, in the same segments, through both packages:
    every LinkEstimate field and every gauge equal, float for float."""
    obs, jobs = Observability(), JObservability()
    link, jlink = LinkMonitor(obs, window=3000), JLinkMonitor(jobs,
                                                              window=3000)
    for m in (link, jlink):
        m.watch("a", levels)
        m.watch("b", levels)
    rng = np.random.default_rng(levels)
    for seg, snr in enumerate((25.0, 12.0, 6.0, 18.0)):
        for tid in ("a", "b"):
            y, _ = _pam_stream(levels, snr + (tid == "b"),
                               int(rng.integers(1, 2500)), seed=seg)
            soft = y.astype(np.float32)
            link.observe(tid, soft)
            jlink.observe(tid, soft)
            got, want = link.estimate(tid), jlink.estimate(tid)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    snap, jsnap = obs.snapshot()["link"], jobs.snapshot()["link"]
    assert snap == jsnap
    np.testing.assert_array_equal(pam_amplitudes(levels),
                                  j_pam_amplitudes(levels))
    for snr in (0.5, 3.0, 40.0):
        assert pam_ser(snr, levels) == j_pam_ser(snr, levels)
        assert q_function(snr) == j_q_function(snr)


def test_empty_and_unobserved_estimates():
    link = LinkMonitor(Observability())
    link.watch("t", 2)
    link.observe("t", np.zeros(0))                    # no-op
    est = link.estimate("t")
    assert isinstance(est, LinkEstimate) and est.syms == 0
    assert np.isnan(est.snr_db) and np.isnan(est.evm_lifetime)
    assert link.tenants == ("t",)


# ---------------------------------------------------------------------------
# SLO hysteresis
# ---------------------------------------------------------------------------

def _engine_with_gauge(patience=3, threshold=10.0, **rule_kw):
    obs = Observability()
    g = obs.registry.gauge("q.value")
    slo = SloEngine(obs, rules=(SloRule(
        "floor", "q.value", threshold=threshold, direction="below",
        patience=patience, **rule_kw),))
    return obs, g, slo


def test_breach_latches_only_after_patience():
    _, g, slo = _engine_with_gauge(patience=3)
    g.set(5.0)
    assert slo.step() == [] and slo.step() == []
    edges = slo.step()                       # third consecutive breach
    assert [e["state"] for e in edges] == ["breach"]
    assert slo.breached() == ["floor"]
    assert slo.step() == []                  # latched: no repeat edges


def test_clear_edge_after_patience_clean():
    _, g, slo = _engine_with_gauge(patience=2)
    g.set(5.0)
    slo.step(), slo.step()
    assert slo.breached() == ["floor"]
    g.set(15.0)
    assert slo.step() == []
    edges = slo.step()
    assert [e["state"] for e in edges] == ["clear"]
    assert slo.breached() == []
    assert [a["state"] for a in slo.alerts] == ["breach", "clear"]


def test_oscillating_metric_never_thrashes():
    _, g, slo = _engine_with_gauge(patience=2)
    for v in (5.0, 15.0) * 8:                # flips every evaluation
        g.set(v)
        assert slo.step() == []
    assert slo.breached() == [] and len(slo.alerts) == 0


def test_above_direction_and_histogram_metric():
    obs = Observability()
    h = obs.registry.histogram("lat.p")
    slo = SloEngine(obs, rules=(SloRule(
        "ceiling", "lat.p", threshold=0.5, direction="above", patience=1,
        min_samples=3),))
    h.observe(0.9)
    h.observe(0.9)
    assert slo.step() == []                  # 2 < min_samples
    h.observe(0.9)
    assert [e["state"] for e in slo.step()] == ["breach"]


def test_min_samples_guard_freezes_cold_streams():
    obs = Observability()
    g = obs.registry.gauge("q.value")
    n = obs.registry.counter("q.n")
    slo = SloEngine(obs, rules=(SloRule(
        "floor", "q.value", threshold=10.0, patience=1,
        min_samples=100, samples="q.n"),))
    g.set(5.0)
    assert slo.step() == [] and slo.breached() == []   # cold: not judged
    n.inc(100)
    assert [e["state"] for e in slo.step()] == ["breach"]


def test_rule_validation():
    with pytest.raises(ValueError):
        SloRule("r", "m", 1.0, direction="sideways")
    with pytest.raises(ValueError):
        SloRule("r", "m", 1.0, patience=0)
    with pytest.raises(ValueError):
        SloRule("r", "m", 1.0, min_samples=-1)
    with pytest.raises(ValueError):
        SloRule("r", "m", 1.0, window=0)
    obs = Observability()
    slo = SloEngine(obs, rules=(SloRule("r", "m", 1.0),))
    with pytest.raises(ValueError):
        slo.add_rule(SloRule("r", "m2", 2.0))          # duplicate name


def test_tenant_rule_breach_hook_and_resolve():
    obs = Observability(tracing=True)
    slo = SloEngine(obs)
    requests = []
    slo.on_breach = lambda tenant, rule, value: requests.append(tenant)
    slo.add_rule(SloRule("snr_floor", "link.{tenant}.snr_db",
                         threshold=12.0, patience=2))
    link = LinkMonitor(obs, slo=slo)         # steps the engine per segment
    link.watch("a", 2)
    good, _ = _pam_stream(2, 20.0, 2048, seed=3)
    bad, _ = _pam_stream(2, 6.0, 2048, seed=4)
    link.observe("a", good)
    link.observe("a", good)
    assert slo.breached("a") == [] and requests == []
    link.observe("a", bad)                   # window still mostly clean
    link.observe("a", bad)
    link.observe("a", bad)
    assert slo.breached("a") == ["snr_floor"]
    assert slo.breached_tenants() == ["a"]
    assert requests == ["a"]                 # the closed-loop seam fired
    assert slo.resolve("a", reason="promoted") == 1
    assert slo.breached("a") == []
    assert [a["state"] for a in slo.alerts] == ["breach", "resolved"]
    assert slo.alerts[-1]["reason"] == "promoted"
    snap = obs.snapshot()
    assert snap["slo"]["state"]["alerts_total"] == 2
    assert snap["slo"]["state"]["latches"]["snr_floor[a]"]["breached"] \
        is False
    assert any(i[0] == "slo_breach" for i in obs.tracer.instants)


def test_slo_ledger_equals_reference():
    """One gauge trajectory through both packages' engines (frozen clocks):
    the same edges, ledger and latch states."""
    clock = lambda: 3.0                                      # noqa: E731
    obs, jobs = Observability(clock=clock), JObservability(clock=clock)
    engines = []
    for o, eng, rule in ((obs, SloEngine, SloRule),
                         (jobs, JSloEngine, JSloRule)):
        g = o.registry.gauge("q.value")
        e = eng(o, rules=(rule("floor", "q.value", threshold=10.0,
                               patience=2),), ledger_max=3)
        engines.append((g, e))
    for v in (5, 5, 5, 15, 15, 5, 15, 5, 5, 5, 15, 15, 15):
        for g, e in engines:
            g.set(float(v))
        edges = [e.step() for _, e in engines]
        assert edges[0] == edges[1]
    (_, e), (_, je) = engines
    assert list(e.alerts) == list(je.alerts)
    assert e.alerts_total == je.alerts_total > 3
    assert obs.snapshot()["slo"] == jobs.snapshot()["slo"]


# ---------------------------------------------------------------------------
# two taps on a live session, through the runtimes' link= hook
# ---------------------------------------------------------------------------

def _spec():
    params = jax.tree.map(np.asarray, jeq.init(jax.random.PRNGKey(0),
                                                jeq.CNNEqConfig()))
    return TenantSpec("t", CFG, params=params, backend="fused_fp32",
                      tile_m=16)


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_link_and_recording_tap_share_the_tap_bitwise(runtime):
    spec = _spec()
    rng = np.random.default_rng(9)
    wave = rng.standard_normal(240 * CFG.n_os).astype(np.float32)
    offline = spec.build_engine("cpu")(wave).numpy()

    obs = Observability(tracing=True)
    slo = SloEngine(obs, rules=(SloRule("snr_floor", "link.{tenant}.snr_db",
                                        threshold=-1e9, patience=1),))
    link = LinkMonitor(obs, slo=slo)
    policy = BatchPolicy(max_batch=1, max_wait_s=1e9)
    rt = (ServeRuntime(policy, obs=obs, link=link, device="cpu")
          if runtime == "sync" else
          AsyncServeRuntime(policy, obs=obs, link=link, device="cpu"))
    try:
        session = rt.open(spec)              # the link tap, via link=
        seen = []
        session.add_tap(lambda rx, soft: seen.append(
            (np.array(rx), np.array(soft))))
        for c in chop(wave, 100, seed=1):
            rt.submit("t", c)
        out = rt.close("t")
    finally:
        if runtime == "async":
            rt.shutdown()
    assert np.array_equal(out, offline)
    # both consumers observed the whole stream, and observation changed
    # nothing; the recording tap saw exactly the emitted symbols
    assert link.estimate("t").syms == out.shape[0]
    np.testing.assert_array_equal(np.concatenate([s for _, s in seen]), out)
    assert sum(r.shape[0] for r, _ in seen) == out.shape[0] * CFG.n_os
    assert link.tenants == ("t",) and slo.breached() == []
    # the reference's monitor on the same emitted symbols agrees
    jlink = JLinkMonitor(JObservability())
    jlink.watch("t", CFG.levels)
    for _, s in seen:
        jlink.observe("t", s)
    assert link.estimate("t") == LinkEstimate(
        **dataclasses.asdict(jlink.estimate("t")))


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def test_report_renders_link_and_slo(tmp_path, capsys):
    obs = Observability()
    slo = SloEngine(obs, rules=(SloRule(
        "snr_floor", "link.{tenant}.snr_db", threshold=12.0, patience=1),))
    link = LinkMonitor(obs, slo=slo)
    link.watch("a", 2)
    bad, _ = _pam_stream(2, 6.0, 1024, seed=5)
    link.observe("a", bad)                   # breaches immediately
    path = tmp_path / "snap.json"
    obs.write_snapshot(str(path))
    assert report_main([str(path)]) == 0
    text = capsys.readouterr().out
    assert "[link]" in text and "snr_db=" in text and "lifetime:" in text
    assert "confidence" in text
    assert "[slo]" in text and "BREACHED snr_floor[a]" in text
    assert "ledger (recent):" in text and "breach" in text
    json.loads(path.read_text())


def test_report_renders_all_port_sections(capsys, tmp_path):
    obs = Observability(tracing=True, clock=lambda: 0.0)  # uptime frozen
    s = obs.scope("serve")
    s.counter("requests_total").inc(9)
    s.histogram("launch.latency_s").observe(0.01)
    s.callback("sessions", lambda: {
        "t0": {"syms_emitted": 300, "weight_epoch": 1, "recoveries": 0,
               "inflight": 0, "shed": False, "failed": None}})
    s.callback("errors", lambda: {"total": 2, "window": 2, "dropped": 0})
    s.callback("recovery", lambda: {"recoveries": 1, "rollbacks": 0})
    s.callback("degradation", lambda: {"degraded": False, "max_batch": 8})
    link = LinkMonitor(obs)
    link.watch("t0", 2)
    link.observe("t0", _pam_stream(2, 15.0, 512)[0])
    SloEngine(obs, rules=(SloRule("snr", "link.{tenant}.snr_db", 3.0),))

    snap = obs.snapshot()
    txt = render(snap)
    for frag in ("[serve]", "[link]", "[slo]", "[trace]", "requests=9",
                 "latency_s", "t0", "epoch=1", "errors: total=2",
                 "recoveries=1", "degradation:", "max_batch=8",
                 "enabled=True", "rules=1"):
        assert frag in txt, frag
    # the port's sections render as the reference's do
    assert txt == j_render(snap)
    path = tmp_path / "snap.json"
    obs.write_snapshot(str(path))
    assert report_main([str(path)]) == 0
    assert capsys.readouterr().out.rstrip("\n") == txt
    assert render({}) == "observability snapshot — empty"

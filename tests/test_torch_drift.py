"""Port vs reference: the drifting channels (repro_torch.channels.drift)
and the drift traffic of the load generator (`serve.loadgen.drift_streams`,
`replay_adaptive`), on the CPU.

Mirrors the drift tests of tests/test_channels.py (reproducible under a
fixed generator state, t = 1 differs from t = 0 on the same tx data, taps
rotate and renormalize, the schedule holds then ramps, the IM/DD wrapper
moves fiber and SNR). Against the JAX package: the two frameworks draw
different random numbers, so the reference's draws are made with its own
keys, split as `simulate_proakis_taps` / `simulate_imdd_fiber` split them,
and handed to the port's deterministic propagation with the drifted taps,
SNR and fiber length; it must reproduce the reference within atol 1e-4
(the channels' bound: FFT rounding through two pocketfft builds, the CD
phase in float32). At t = 0 the port's drifting channel equals its
stationary simulator on the same generator within the same bound.
`drift_streams` keeps the reference's per-(burst, tenant) structure, each
draw from its own seeded generator; `replay_adaptive` makes the
reference's calls in the reference's order against a duck-typed adapter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels import drift as jdrift
from repro.channels import imdd as jimdd
from repro.channels import proakis as jproakis
from repro.serve import loadgen as jloadgen
from repro_torch.channels import drift, imdd, proakis
from repro_torch.channels.drift import (DriftingIMDD, DriftingProakis,
                                        DriftSchedule)
from repro_torch.serve import loadgen

CH_ATOL = 1e-4
KEY = jax.random.PRNGKey(42)


def _gen(seed=42):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# tests/test_channels.py: the drift wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel", [DriftingProakis(), DriftingIMDD()],
                         ids=["proakis", "imdd"])
def test_drift_reproducible_and_actually_drifts(channel):
    fn0, fn1 = channel.at(0.0, device="cpu"), channel.at(1.0, device="cpu")
    rx0a, sy0a = fn0(_gen(), 512)
    rx0b, sy0b = fn0(_gen(), 512)
    assert torch.equal(rx0a, rx0b) and torch.equal(sy0a, sy0b)
    assert rx0a.shape == (512 * channel.n_os,) and rx0a.dtype == torch.float32
    # same generator state ⇒ same tx data at every drift state; different
    # waveform
    rx1, sy1 = fn1(_gen(), 512)
    assert torch.equal(sy0a, sy1)
    assert not torch.equal(rx0a, rx1)


def test_proakis_drift_taps_rotate_and_renormalize():
    ch = DriftingProakis()
    h0, h1 = ch.taps_at(0.0), ch.taps_at(1.0)
    np.testing.assert_allclose(np.linalg.norm(h0), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(h1), 1.0, rtol=1e-6)
    # default drift target: Proakis-B rolled one tap (postcursor-heavy)
    np.testing.assert_allclose(h1, np.roll(h0, 1), rtol=1e-6)
    assert ch.snr_at(1.0) == pytest.approx(ch.cfg.snr_db - 4.0)
    ref = jdrift.DriftingProakis()
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(ch.taps_at(t), ref.taps_at(t))
        assert ch.snr_at(t) == ref.snr_at(t)
    custom = dict(taps_from=(1.0, 0.0, 0.0), taps_to=(1.0, 0.0, 0.0),
                  snr_delta_db=-6.0)
    np.testing.assert_array_equal(DriftingProakis(**custom).taps_at(0.7),
                                  jdrift.DriftingProakis(**custom).taps_at(0.7))


def test_drift_schedule_holds_then_ramps_monotonically():
    sch = DriftSchedule(hold_bursts=3, ramp_bursts=4)
    ts = [sch.t_at(b) for b in range(10)]
    assert ts[:3] == [0.0, 0.0, 0.0]
    assert ts == sorted(ts) and ts[-1] == 1.0
    assert sch.total_to_settle == 7
    assert sch.t_at(sch.total_to_settle) == 1.0
    for hold, ramp in ((3, 4), (8, 8), (2, 0), (0, 5)):
        ref = jdrift.DriftSchedule(hold, ramp)
        assert [DriftSchedule(hold, ramp).t_at(b) for b in range(20)] == \
            [ref.t_at(b) for b in range(20)]


def test_imdd_drift_moves_fiber_and_snr():
    ch = DriftingIMDD(fiber_delta_km=6.0, snr_delta_db=-3.0)
    assert ch.fiber_at(0.0) == pytest.approx(ch.cfg.fiber_km)
    assert ch.fiber_at(1.0) == pytest.approx(ch.cfg.fiber_km + 6.0)
    assert ch.snr_at(1.0) == pytest.approx(ch.cfg.snr_db - 3.0)


# ---------------------------------------------------------------------------
# the port's propagation vs the reference's simulators, on JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0.0, 0.4, 1.0])
def test_proakis_drift_propagate_reproduces_reference(t):
    n_syms = 400
    jch, cfg = jdrift.DriftingProakis(), jproakis.ProakisConfig()
    h, snr = jnp.asarray(jch.taps_at(t)), jnp.float32(jch.snr_at(t))
    key = jax.random.PRNGKey(7)
    want_rx, want_syms = jdrift.simulate_proakis_taps(key, cfg, n_syms, h,
                                                      snr)
    kbits, knoise = jax.random.split(key)
    syms = jax.random.randint(kbits, (n_syms,), 0, cfg.levels)
    noise = jax.random.normal(knoise, (n_syms * cfg.n_os,), jnp.float32)
    np.testing.assert_array_equal(np.asarray(syms), np.asarray(want_syms))
    ch = DriftingProakis()
    got = proakis._propagate(_t(syms), _t(noise), ch.cfg,
                             torch.from_numpy(ch.taps_at(t)),
                             float(np.float32(ch.snr_at(t))))
    assert got.shape == (n_syms * cfg.n_os,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_rx), rtol=0,
                               atol=CH_ATOL)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0])
def test_imdd_drift_propagate_reproduces_reference(t):
    n_syms = 300
    jch, cfg = jdrift.DriftingIMDD(), jimdd.IMDDConfig()
    key = jax.random.PRNGKey(3)
    want_rx, want_syms = jdrift.simulate_imdd_fiber(
        key, cfg, n_syms, jnp.float32(jch.fiber_at(t)),
        jnp.float32(jch.snr_at(t)))
    kbits, knoise = jax.random.split(key)
    syms = jax.random.randint(kbits, (n_syms,), 0, cfg.levels)
    knoise, kase = jax.random.split(knoise)
    shape = (n_syms * cfg.sim_os,)
    ase_re = jax.random.normal(kase, shape)
    ase_im = jax.random.normal(jax.random.fold_in(kase, 1), shape)
    noise = jax.random.normal(knoise, shape, jnp.float32)
    np.testing.assert_array_equal(np.asarray(syms), np.asarray(want_syms))
    ch = DriftingIMDD()
    fiber = float(np.float32(ch.fiber_at(t)))
    cd = drift._cd_allpass(shape[0], ch.cfg, fiber, torch.device("cpu"))
    got = imdd._propagate(_t(syms), _t(ase_re), _t(ase_im), _t(noise),
                          ch.cfg, cd=cd,
                          snr_db=float(np.float32(ch.snr_at(t))))
    assert got.shape == (n_syms * cfg.n_os,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_rx), rtol=0,
                               atol=CH_ATOL)


@pytest.mark.parametrize("kind", ["proakis", "imdd"])
def test_drift_at_zero_is_the_stationary_simulator(kind):
    """The same generator state through the drifting channel at t = 0 and
    through the stationary simulator: the same symbols, and waveforms
    within the channels' bound (the drifted CD phase is float32, the
    stationary one float64 rounded to float32; Proakis-B is renormalized
    to unit energy, a scale the AWGN and the normalization take out)."""
    if kind == "proakis":
        ch, sim = DriftingProakis(), proakis.simulate
    else:
        ch, sim = DriftingIMDD(), imdd.simulate
    rx_d, sy_d = ch.at(0.0, device="cpu")(_gen(5), 700, batch=3)
    rx_s, sy_s = sim(_gen(5), ch.cfg, 700, batch=3, device="cpu")
    assert rx_d.shape == (3, 1400)
    assert torch.equal(sy_d, sy_s)
    np.testing.assert_allclose(rx_d.numpy(), rx_s.numpy(), rtol=0,
                               atol=CH_ATOL)


# ---------------------------------------------------------------------------
# drift traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel", [DriftingProakis(), DriftingIMDD()],
                         ids=["proakis", "imdd"])
def test_drift_streams_structure_and_seeded_draws(channel):
    sch = DriftSchedule(2, 2)
    ids = ["a", "b", "c"]
    streams, pilots = loadgen.drift_streams(channel, sch, ids, 5, 96,
                                            seed=3, device="cpu")
    assert list(streams) == ids and list(pilots) == ids
    for t in ids:
        assert len(streams[t]) == len(pilots[t]) == 5
        for rx, sy in zip(streams[t], pilots[t]):
            assert rx.dtype == np.float32 and rx.shape == (96 * 2,)
            assert sy.dtype == np.int32 and sy.shape == (96,)
    # each (burst, tenant) draw is its own seeded generator on the device
    for burst in range(5):
        fn = channel.at(sch.t_at(burst), device="cpu")
        for i, t in enumerate(ids):
            rx, sy = fn(loadgen._burst_generator(3, burst, i,
                                                 torch.device("cpu")), 96)
            np.testing.assert_array_equal(streams[t][burst], rx.numpy())
            np.testing.assert_array_equal(pilots[t][burst], sy.numpy())
    # tenants draw independently; the same seed repeats bitwise
    assert not np.array_equal(streams["a"][0], streams["b"][0])
    again, _ = loadgen.drift_streams(channel, sch, ids, 5, 96, seed=3,
                                     device="cpu")
    assert all(np.array_equal(x, y) for t in ids
               for x, y in zip(streams[t], again[t]))
    other, _ = loadgen.drift_streams(channel, sch, ids, 1, 96, seed=4,
                                     device="cpu")
    assert not np.array_equal(other["a"][0], streams["a"][0])


class _Recorder:
    """A duck-typed runtime and adapter that log every call."""

    def __init__(self, log, adapted=()):
        self.log = log
        self.tenants = list(adapted)
        self.sessions = {}

    def submit(self, t, chunk):
        self.log.append(("submit", t, float(np.sum(chunk))))

    def finish(self, t):
        self.log.append(("finish", t))

    def pump(self):
        self.log.append(("pump",))

    def drain(self):
        self.log.append(("drain",))

    def feed_pilots(self, t, labels):
        self.log.append(("pilots", t, int(np.sum(labels))))

    def step(self):
        self.log.append(("step",))


@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("step_every", [1, 2])
def test_replay_adaptive_calls_like_the_reference(adapt, step_every):
    rng = np.random.default_rng(0)
    ids = ["t0", "t1", "t2"]
    streams = {t: [rng.standard_normal(8 + i).astype(np.float32)
                   for i in range(3 + k)] for k, t in enumerate(ids)}
    pilots = {t: [rng.integers(0, 2, 4) for _ in streams[t]]
              for t in ids[:2]}
    logs = []
    for fn in (loadgen.replay_adaptive, jloadgen.replay_adaptive):
        log = []
        rt = _Recorder(log)
        adapter = _Recorder(log, adapted=("t0", "t2")) if adapt else None
        acct = fn(rt, streams, pilots, adapter=adapter,
                  step_every=step_every)
        logs.append((log, acct["rounds"], acct["total_syms"]))
    assert logs[0] == logs[1]
    # set iteration order is the same in both packages; the calls are too
    log = logs[0][0]
    assert (("pilots", "t0", int(np.sum(pilots["t0"][0]))) in log) == adapt
    assert not any(c[0] == "pilots" and c[1] == "t1" for c in log)

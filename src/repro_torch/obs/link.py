"""Streaming link-quality estimation from served symbols (signal health).

Port of `repro.obs.link`: float64 numpy on the host, the same estimators,
so the same soft symbols give the same `LinkEstimate` in both packages.

The system metrics see launches, latencies, and retries — never the
SIGNAL: a tenant whose channel drifts keeps serving fast, traced, and
silently garbage. The real-time equalizer demonstrators report live
EVM/BER as THE operational metric and retrain when it degrades; this
module is that signal plane for the serving stack.

`LinkMonitor` hangs off the `Session.tap` seam (the descatter hook an
adaptation collector also uses — `Session.add_tap` fans them out) and
incrementally estimates, per tenant, from every emitted chunk:

  * EVM   — decision-directed error-vector magnitude: the RMS distance of
            the soft symbols to their nearest constellation points, over
            the RMS of the decided points:  sqrt(E|y - ŷ|² / E|ŷ|²).
  * SNR   — the matching decision-directed SNR estimate,
            10·log10(E|ŷ|² / E|y - ŷ|²) dB. At operating SNRs almost all
            decisions are correct, so the residual IS noise+ISI and the
            estimate tracks the true channel SNR ramp.
  * SER proxy — the predicted nearest-constellation-point disagreement
            rate: the probability that a decision differs from the
            transmitted symbol under the Gaussian residual model,
            2·(1−1/M)·Q(d_min/2σ) for M-PAM with measured residual σ —
            a live BER-shaped health number with no pilots needed.
  * confidence — a histogram of per-symbol decision margins,
            (d₂ − d₁)/d_min ∈ [0, 1] (distance to the runner-up point
            minus distance to the decided point, in units of the
            half-grid): mass near 0 means symbols sitting on decision
            boundaries — degradation visible before errors are.

Everything is windowed (last `window` symbols, the live view) AND
lifetime (stream totals), registered as ``link.<tenant>.*`` gauges /
histograms in the hub's `MetricsRegistry` (tenant ids sanitized with
`safe_segment`).

Contract #11 (extended): estimation is pure host-side numpy over symbols
that were ALREADY emitted — it never touches launch order, launch inputs,
or the device, so serving with link telemetry on stays bitwise-equal to
offline.

An attached `SloEngine` is stepped after every segment (for that tenant
only), so SLO edges fire with segment granularity without any polling
thread.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from .hub import Observability
from .metrics import DEFAULT_WINDOW, safe_segment
from .slo import SloEngine


def pam_amplitudes(levels: int) -> np.ndarray:
    """Unit-power M-PAM constellation (numpy twin of channels.common —
    kept local so obs stays dependency-free)."""
    pts = 2.0 * np.arange(levels, dtype=np.float32) - (levels - 1)
    return pts / np.sqrt(np.mean(pts**2))


def q_function(x: float) -> float:
    """Gaussian tail probability Q(x) = P(N(0,1) > x)."""
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def pam_ser(snr_linear: float, levels: int) -> float:
    """Analytic M-PAM symbol-error rate at a given SNR (Es/N0, linear) —
    the closed form the SER proxy inverts; exposed for estimator tests."""
    m = levels
    if m < 2:
        return 0.0
    # unit-power constellation: d_min/2 = sqrt(3/(M²−1)) · sqrt(Es)
    arg = math.sqrt(3.0 / (m * m - 1.0) * snr_linear)
    return 2.0 * (1.0 - 1.0 / m) * q_function(arg)


@dataclasses.dataclass(frozen=True)
class LinkEstimate:
    """One tenant's link-quality readout (windowed + lifetime)."""
    tenant_id: str
    syms: int                   # lifetime symbols observed
    evm: float                  # windowed
    snr_db: float
    ser_proxy: float
    evm_lifetime: float
    snr_db_lifetime: float
    ser_proxy_lifetime: float


class _TenantLink:
    """Per-tenant accumulator: bounded window + lifetime sums."""

    __slots__ = ("err2", "sig2", "err2_life", "sig2_life", "syms",
                 "g_evm", "g_snr", "g_ser", "g_evm_l", "g_snr_l", "g_ser_l",
                 "c_syms", "c_segs", "h_conf")

    def __init__(self, window: int, scope) -> None:
        self.err2: Deque[float] = deque(maxlen=window)
        self.sig2: Deque[float] = deque(maxlen=window)
        self.err2_life = 0.0
        self.sig2_life = 0.0
        self.syms = 0
        self.g_evm = scope.gauge("evm")
        self.g_snr = scope.gauge("snr_db")
        self.g_ser = scope.gauge("ser_proxy")
        self.g_evm_l = scope.gauge("lifetime.evm")
        self.g_snr_l = scope.gauge("lifetime.snr_db")
        self.g_ser_l = scope.gauge("lifetime.ser_proxy")
        self.c_syms = scope.counter("syms")
        self.c_segs = scope.counter("segments")
        self.h_conf = scope.histogram("confidence")


class LinkMonitor:
    """Per-tenant streaming EVM/SNR/SER estimation over the tap seam.

    obs:    the runtime's `Observability` hub (gauges land in its registry,
            names ``<scope>.<tenant>.*``, scope default "link").
    window: symbols in the live window (default `DEFAULT_WINDOW`).
    slo:    optional `SloEngine` — watched per tenant at attach and stepped
            after every segment, the event-driven alternative to polling.

    `attach(session)` wires the monitor into a live session via
    `Session.add_tap`, composing with any tap already installed;
    the PAM order comes from the session's own `CNNEqConfig.levels`.
    `observe(tenant, soft)` is the raw entry point for tests and for
    callers without a session object (call `watch` first).
    """

    def __init__(self, obs: Observability, window: int = DEFAULT_WINDOW,
                 slo: Optional[SloEngine] = None,
                 scope: str = "link") -> None:
        if window < 1:
            raise ValueError("LinkMonitor window must be >= 1")
        self.obs = obs
        self.window = window
        self.slo = slo
        self._scope = obs.scope(scope)
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantLink] = {}
        self._amps: Dict[str, np.ndarray] = {}
        self._dmin: Dict[str, float] = {}

    # -- wiring ----------------------------------------------------------------

    def watch(self, tenant_id: str, levels: int) -> None:
        """Register a tenant (idempotent): create its accumulator, its
        ``link.<tenant>.*`` instruments, and its constellation grid."""
        if levels < 2:
            raise ValueError("LinkMonitor needs a PAM order >= 2")
        with self._lock:
            if tenant_id in self._tenants:
                return
            seg = safe_segment(tenant_id)
            self._tenants[tenant_id] = _TenantLink(
                self.window, self._scope.scope(seg))
            amps = np.sort(pam_amplitudes(levels))
            self._amps[tenant_id] = amps
            self._dmin[tenant_id] = float(np.min(np.diff(amps)))
        if self.slo is not None:
            self.slo.watch(tenant_id)

    def attach(self, session) -> None:
        """Wire this monitor into a live session's descatter tap (fans out
        with any existing tap)."""
        tid = session.spec.tenant_id
        self.watch(tid, session.spec.cfg.levels)

        def _tap(rx, soft, _tid=tid):
            self.observe(_tid, soft)

        session.add_tap(_tap)

    @property
    def tenants(self):
        with self._lock:
            return tuple(self._tenants)

    # -- estimation --------------------------------------------------------------

    def observe(self, tenant_id: str, soft_syms) -> None:
        """Fold one emitted chunk's soft symbols into the tenant's
        estimators and publish the gauges. Host-side numpy only; copies
        nothing it keeps beyond scalar sums (contract #11)."""
        y = np.asarray(soft_syms, np.float64).reshape(-1)
        if y.size == 0:
            return
        with self._lock:
            st = self._tenants.get(tenant_id)
            amps = self._amps.get(tenant_id)
            d_min = self._dmin.get(tenant_id, 0.0)
        if st is None:
            raise KeyError(f"tenant {tenant_id!r} not watched "
                           f"(call watch/attach first)")
        d = np.abs(y[:, None] - amps[None, :])         # (n, M), M small
        near = np.argmin(d, axis=1)
        decided = amps[near]
        err2 = (y - decided) ** 2
        sig2 = decided.astype(np.float64) ** 2
        if amps.size > 1:
            dp = np.partition(d, 1, axis=1)
            conf = np.clip((dp[:, 1] - dp[:, 0]) / d_min, 0.0, 1.0)
        else:
            conf = np.ones_like(err2)
        m = int(amps.size)
        with self._lock:
            st.err2.extend(err2.tolist())
            st.sig2.extend(sig2.tolist())
            st.err2_life += float(err2.sum())
            st.sig2_life += float(sig2.sum())
            st.syms += int(y.size)
            e_w = math.fsum(st.err2) / len(st.err2)
            s_w = math.fsum(st.sig2) / len(st.sig2)
            e_l = st.err2_life / st.syms
            s_l = st.sig2_life / st.syms
        st.h_conf.observe_many(conf)
        st.c_syms.inc(int(y.size))
        st.c_segs.inc()
        st.g_evm.set(self._evm(e_w, s_w))
        st.g_snr.set(self._snr_db(e_w, s_w))
        st.g_ser.set(self._ser(e_w, s_w, d_min, m))
        st.g_evm_l.set(self._evm(e_l, s_l))
        st.g_snr_l.set(self._snr_db(e_l, s_l))
        st.g_ser_l.set(self._ser(e_l, s_l, d_min, m))
        if self.slo is not None:
            self.slo.step(tenant_id)

    # the decided points carry the constellation's power; a dead stream
    # (all-zero symbols decided to the innermost points) still has s > 0
    # for every unit-power M-PAM with even M, and the guards below keep
    # odd/degenerate grids from dividing by zero

    SNR_CAP_DB = 99.0          # reported when the residual is exactly zero

    @staticmethod
    def _evm(e: float, s: float) -> float:
        return math.sqrt(e / s) if s > 0 else float("inf")

    @classmethod
    def _snr_db(cls, e: float, s: float) -> float:
        if s <= 0:
            return -cls.SNR_CAP_DB
        if e <= 0:
            return cls.SNR_CAP_DB
        return min(cls.SNR_CAP_DB, 10.0 * math.log10(s / e))

    @staticmethod
    def _ser(e: float, s: float, d_min: float, m: int) -> float:
        if m < 2 or d_min <= 0:
            return 0.0
        sigma = math.sqrt(max(e, 1e-300))
        return 2.0 * (1.0 - 1.0 / m) * q_function(d_min / (2.0 * sigma))

    # -- readout -----------------------------------------------------------------

    def estimate(self, tenant_id: str) -> LinkEstimate:
        with self._lock:
            st = self._tenants[tenant_id]
            d_min = self._dmin[tenant_id]
            m = int(self._amps[tenant_id].size)
            if st.syms == 0:
                return LinkEstimate(tenant_id, 0, *(float("nan"),) * 6)
            e_w = math.fsum(st.err2) / len(st.err2)
            s_w = math.fsum(st.sig2) / len(st.sig2)
            e_l = st.err2_life / st.syms
            s_l = st.sig2_life / st.syms
            syms = st.syms
        return LinkEstimate(
            tenant_id, syms,
            evm=self._evm(e_w, s_w),
            snr_db=self._snr_db(e_w, s_w),
            ser_proxy=self._ser(e_w, s_w, d_min, m),
            evm_lifetime=self._evm(e_l, s_l),
            snr_db_lifetime=self._snr_db(e_l, s_l),
            ser_proxy_lifetime=self._ser(e_l, s_l, d_min, m))

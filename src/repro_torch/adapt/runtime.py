"""OnlineAdapter — the control loop that closes collect → fine-tune →
shadow-eval → promote/rollback over a serving runtime.

One adapter manages any number of ADAPTIVE tenants on one
`ServeRuntime`/`AsyncServeRuntime`. Per tenant it owns a
`SampleCollector` (wired into the session's descatter tap at attach), and
on each `step()` runs at most one adaptation cycle:

  1. ROLLBACK CHECK — if the last action was a promotion, re-score the
     pre-swap engine against the active one on fresh held-out traffic;
     if the old weights now win by the promotion hysteresis, the
     promotion was wrong (or the channel moved again in its favour) and
     the stream rolls back bit-identically.
  2. CADENCE — skip unless `adapt_every_syms` new labelled symbols
     arrived since the last fine-tune (background training should track
     the drift rate, not spin).
  3. FINE-TUNE — weight-only QAT resume from the ACTIVE params on the
     buffered training slice (`repro_torch.adapt.trainer`).
  4. SHADOW EVAL — candidate vs active on the held-out slice
     (`repro_torch.adapt.shadow`); the candidate engine is built through the
     same pinned-formats spec the hot-swap would install, so the score is
     of the real deployed artifact.
  5. PROMOTE — on a hysteresis-guarded win, hot-swap the weights into the
     live stream (`swap_weights`: lands at a chunk boundary, bitwise
     within each weight epoch); otherwise the candidate is discarded.

`step()` is synchronous and deterministic — the form the tests and the
sync benches drive. `start()` runs the same cycles from a daemon thread
(`interval_s` cadence) against an `AsyncServeRuntime`, whose swap barrier
makes hot-swaps safe under concurrent traffic; pair it with the sync
`ServeRuntime` only if nothing else touches that runtime concurrently
(the sync runtime is single-threaded by contract).

Port of `repro.adapt.runtime`. What differs from the reference:

  * RANDOMNESS — the reference splits one `jax.random` key per attach and
    per cycle. The port keeps one `torch.Generator` per tenant, on the
    session's device, seeded from `np.random.SeedSequence([seed,
    attach_index])`, and hands it to every fine-tune of that tenant (each
    batch's window seed is drawn from it, `trainer.draw_seed`). The draws
    differ from JAX's by construction; the same adapter run twice gives
    the same history and the same weights.
  * DEVICE — the fine-tune, the candidate engine and the rollback's
    `prev_spec` engine all run on the session's device (`Session.device`).
  * STREAMS — on the card the adapter's own work (fine-tune, candidate
    and pre-swap engine builds, shadow evaluations) runs on a CUDA stream
    of its own (`OnlineAdapter.stream`). Before it hands weights to the
    runtime (`swap_weights` / `rollback_weights`, called on the caller's
    stream) it SYNCHRONIZES that stream, so the candidate's weights are
    complete whatever stream the runtime's launcher reads them from; the
    runtime's swap then builds the engine it installs (see
    `AsyncServeRuntime._swap_barrier`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..obs.metrics import safe_segment
from ..serve.session import Session, TenantSpec
from .collector import SampleCollector
from .shadow import PromotionPolicy, ShadowReport, shadow_evaluate
from .trainer import FineTuneConfig, fine_tune_from_buffer


@dataclasses.dataclass(frozen=True)
class AdaptPolicy:
    """When to adapt, and how candidate promotion is guarded.

    min_train_syms:   don't fine-tune before this many buffered TRAINING
                      symbols (default 4096; must also exceed the
                      fine-tune window).
    adapt_every_syms: cadence — new labelled symbols between cycles
                      (default 4096). The knob that balances tracking
                      speed against background compute.
    eval_capacity:    collector ring bound in symbols (default 32768).
    eval_every:       collector holdout interleave (default 4 → 25%).
    promotion:        the `PromotionPolicy` hysteresis for both the
                      promote and the rollback comparisons.
    """
    min_train_syms: int = 4096
    adapt_every_syms: int = 4096
    eval_capacity: int = 1 << 15
    eval_every: int = 4
    promotion: PromotionPolicy = PromotionPolicy()


@dataclasses.dataclass
class AdaptReport:
    """One adaptation cycle's outcome for one tenant.

    action ∈ {"idle", "rejected", "promoted", "rolled_back",
    "swap_refused"}; `shadow` carries the BER evidence when an evaluation
    ran; `weight_epoch` is the tenant's epoch AFTER the cycle.
    """
    tenant_id: str
    action: str
    weight_epoch: int
    shadow: Optional[ShadowReport] = None
    train_info: Optional[dict] = None


@dataclasses.dataclass
class _TenantState:
    collector: SampleCollector
    generator: torch.Generator
    last_adapt_syms: int = 0
    check_rollback: bool = False     # set after a promotion
    requested: bool = False          # event-driven bypass of the cadence
                                     # guard (request_adapt / SLO breach)


class OnlineAdapter:
    """Background adaptation controller over one serving runtime."""

    # recent-error window: a daemon loop failing every interval_s forever
    # must not grow host memory without bound
    ERRORS_MAX = 256

    def __init__(self, runtime, policy: Optional[AdaptPolicy] = None,
                 fine_tune: Optional[FineTuneConfig] = None, seed: int = 0):
        self.runtime = runtime
        self.policy = policy or AdaptPolicy()
        self.fine_tune = fine_tune or FineTuneConfig()
        self.seed = seed
        self._states: Dict[str, _TenantState] = {}
        self._attached = 0               # attach index (generator seeds)
        dev = getattr(runtime, "device", None)
        # the adapter's own CUDA stream (None on the CPU): see the module
        # docstring, STREAMS
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=dev)
            if dev is not None and dev.type == "cuda" else None)
        self.history: List[AdaptReport] = []
        # observability rides the RUNTIME's hub (one snapshot tree per
        # deployment) — older runtimes without one fall back to no-op
        self.obs = getattr(runtime, "obs", None)
        errors_max = (self.obs.retention.errors if self.obs is not None
                      else self.ERRORS_MAX)
        # background-loop failures land here (mirrors
        # AsyncServeRuntime.errors) — a persistently failing adapter must
        # be distinguishable from a healthy idle one. The deque keeps the
        # RECENT failures; `errors_total` keeps the RATE observable after
        # the window wraps (errors_total - len(errors) = dropped).
        self.errors: Deque[BaseException] = deque(maxlen=errors_max)
        self.errors_total = 0
        # closed-loop seam (repro_torch.obs.slo): called with the tenant id
        # after every promotion — an SloEngine resolves the tenant's latched
        # breaches here, completing breach → request_adapt → promote → clear
        self.on_promoted: Optional[Callable[[str], None]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._m_actions: Dict[str, object] = {}
        if self.obs is not None:
            scope = self.obs.scope("adapt")
            for action in ("idle", "rejected", "promoted", "rolled_back",
                           "swap_refused"):
                self._m_actions[action] = scope.counter(f"actions.{action}")
            scope.callback("errors", lambda: {
                "total": self.errors_total,
                "window": len(self.errors),
                "dropped": self.errors_total - len(self.errors)})
            scope.callback("cycles", lambda: len(self.history))
            scope.callback("tenants", lambda: len(self._states))

    # -- tenant lifecycle --------------------------------------------------

    def attach(self, spec: TenantSpec) -> Session:
        """Open the tenant on the serving runtime AND wire its descatter
        tap into a fresh collector. Adaptive tenants must be opened with
        `params` (fine-tuning resumes from them; a weights-only spec has
        nothing to train)."""
        if spec.params is None:
            raise ValueError(
                f"tenant {spec.tenant_id!r}: adaptation needs params "
                f"(weight-only specs cannot be fine-tuned)")
        session = self.runtime.open(spec)
        seq = np.random.SeedSequence([self.seed, self._attached])
        self._attached += 1
        gen = torch.Generator(device=session.device).manual_seed(
            int(seq.generate_state(1, np.uint64)[0]))
        col = SampleCollector(n_os=spec.cfg.n_os, levels=spec.cfg.levels,
                              capacity_syms=self.policy.eval_capacity,
                              eval_every=self.policy.eval_every)
        session.add_tap(col.on_segment)
        self._states[spec.tenant_id] = _TenantState(collector=col,
                                                    generator=gen)
        return session

    def request_adapt(self, tenant_id: str) -> None:
        """Ask for a fine-tune on the NEXT step regardless of cadence — the
        event-driven entry point (SLO breach handlers call this). The data
        sufficiency guard still applies: a request cannot conjure training
        symbols, only skip the adapt_every_syms wait."""
        self._states[tenant_id].requested = True

    def feed_pilots(self, tenant_id: str, syms: np.ndarray) -> None:
        """Queue true tx symbols (stream order) as labels for the tenant's
        next served symbols — see `SampleCollector.add_pilots`."""
        self._states[tenant_id].collector.add_pilots(syms)

    def collector(self, tenant_id: str) -> SampleCollector:
        return self._states[tenant_id].collector

    @property
    def tenants(self):
        """IDs of the tenants attached to this adapter."""
        return tuple(self._states)

    # -- the adaptation cycle ----------------------------------------------

    def _on_stream(self):
        """Context for the adapter's own device work (its CUDA stream on
        the card; nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _hand_over(self, fn, *args, **kwargs):
        """Call a runtime's swap/rollback once the adapter's stream has
        finished its work (weights complete on the device), on the
        caller's stream."""
        if self.stream is not None:
            self.stream.synchronize()
        return fn(*args, **kwargs)

    def step(self, tenant_id: Optional[str] = None) -> List[AdaptReport]:
        """Run one adaptation cycle for `tenant_id` (or every attached
        tenant). Returns the per-tenant reports (also appended to
        `history`)."""
        ids = [tenant_id] if tenant_id is not None else list(self._states)
        out = []
        for tid in ids:
            rep = self._step_one(tid)
            self.history.append(rep)
            self._record(rep)
            out.append(rep)
        return out

    def _record(self, rep: AdaptReport) -> None:
        """Publish one cycle's outcome into the runtime's obs hub: action
        counters, per-tenant shadow-BER gauges, and trace instants for the
        actions that change the live stream (promote / rollback)."""
        if rep.action == "promoted" and self.on_promoted is not None:
            self.on_promoted(rep.tenant_id)
        if self.obs is None:
            return
        m = self._m_actions.get(rep.action)
        if m is not None:
            m.inc()
        # tenant ids are user-chosen; keep only metric-name-safe chars
        tid = safe_segment(rep.tenant_id)
        scope = self.obs.scope("adapt")
        scope.gauge(f"{tid}.weight_epoch").set(rep.weight_epoch)
        if rep.shadow is not None:
            sh = rep.shadow
            if not np.isnan(sh.ber_active):
                scope.gauge(f"{tid}.shadow.ber_active").set(sh.ber_active)
            if not np.isnan(sh.ber_candidate):
                scope.gauge(f"{tid}.shadow.ber_candidate").set(
                    sh.ber_candidate)
            scope.gauge(f"{tid}.shadow.eval_syms").set(sh.eval_syms)
        if rep.action in ("promoted", "rolled_back"):
            self.obs.tracer.instant(
                f"adapt_{rep.action}", tenant=rep.tenant_id,
                epoch=rep.weight_epoch,
                reason=rep.shadow.reason if rep.shadow else "")

    def _step_one(self, tid: str) -> AdaptReport:
        st = self._states[tid]
        session = self.runtime.sessions.get(tid)
        pol = self.policy
        dev = session.device

        _, _, eval_rx, eval_syms = st.collector.training_view()

        # 1. rollback check — did the last promotion survive fresh data?
        if st.check_rollback and session.prev_spec is not None:
            with self._on_stream():
                prev_engine = session.prev_spec.build_engine(dev)
                rb = shadow_evaluate(session.engine, prev_engine,
                                     eval_rx, eval_syms, pol.promotion)
            if rb.promote:           # the OLD weights win → undo the swap
                epoch = self._hand_over(self.runtime.rollback_weights, tid)
                st.check_rollback = False
                st.last_adapt_syms = st.collector.total_syms
                return AdaptReport(tid, "rolled_back", epoch, shadow=rb)
            if not np.isnan(rb.ber_active):
                st.check_rollback = False      # verdict reached: it holds

        # 2. cadence + data sufficiency — an explicit request (SLO breach)
        # waives the cadence wait but never the data floor
        train_rx, train_syms, _, _ = st.collector.training_view()
        fresh = st.collector.total_syms - st.last_adapt_syms
        if ((fresh < pol.adapt_every_syms and not st.requested)
                or train_syms.shape[0] < max(pol.min_train_syms,
                                             self.fine_tune.seq_syms + 1)):
            return AdaptReport(tid, "idle", session.weight_epoch)
        st.requested = False

        with self._on_stream():
            # 3. fine-tune from the ACTIVE params (weight-only, frozen
            # formats); the round ends by reading its last loss back, so
            # its wall time covers the device work
            t0 = time.perf_counter()
            params, bn_state, info = fine_tune_from_buffer(
                st.generator, session.spec.params, session.spec.bn_state,
                session.spec.cfg, train_rx, train_syms, self.fine_tune,
                device=dev)
            info["wall_s"] = time.perf_counter() - t0
            st.last_adapt_syms = st.collector.total_syms

            # 4. shadow-evaluate the REAL candidate artifact (pinned
            # formats)
            engine = session.engine
            cand_spec = dataclasses.replace(
                session.spec, params=params, bn_state=bn_state, weights=None,
                formats=engine.formats, backend=engine.backend,
                tile_m=engine.resolved_tile_m())
            shadow = shadow_evaluate(engine, cand_spec.build_engine(dev),
                                     eval_rx, eval_syms, pol.promotion)
        if not shadow.promote:
            return AdaptReport(tid, "rejected", session.weight_epoch,
                               shadow=shadow, train_info=info)

        # 5. promote — hot-swap at a chunk boundary
        try:
            epoch = self._hand_over(self.runtime.swap_weights, tid,
                                    params=params, bn_state=bn_state)
        except ValueError:
            # the swap guard refused (deployment identity would change) —
            # the stream keeps its weights; recorded, not raised: the loop
            # must keep running for the other tenants
            return AdaptReport(tid, "swap_refused", session.weight_epoch,
                               shadow=shadow, train_info=info)
        st.check_rollback = True
        return AdaptReport(tid, "promoted", epoch, shadow=shadow,
                           train_info=info)

    # -- background mode ---------------------------------------------------

    def start(self, interval_s: float = 0.25) -> None:
        """Run `step()` cycles from a daemon thread every `interval_s`.
        Use with `AsyncServeRuntime` (its swap barrier serializes against
        live traffic); the sync runtime is only safe here if no other
        thread drives it. Cycle failures never kill the thread (the
        stream itself is not at risk) but are recorded in `errors` —
        check it when a tenant that should be adapting is not."""
        if self._thread is not None:
            raise RuntimeError("adapter already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception as e:   # noqa: BLE001 — keep adapting
                    self.errors.append(e)          # bounded (ERRORS_MAX)
                    self.errors_total += 1
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, name="online-adapter",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

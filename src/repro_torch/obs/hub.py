"""The Observability hub: one object the runtimes thread everywhere.

`Observability` bundles the `MetricsRegistry`, the chunk `Tracer`, and the
`Retention` policy that bounds every history the stack keeps (the
scheduler's completed-request latency window, `Session.swap_log`, runtime
error deques, the trace ring).  Runtimes accept it as `obs=`; when omitted
they build a private hub with tracing off, so instrumentation costs one
attribute read on hot paths and nothing else.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from .metrics import MetricsRegistry, Scope
from .trace import Tracer


@dataclasses.dataclass(frozen=True)
class Retention:
    """Single configurable bound for every history buffer in the stack.

    latency_window  — completed-request records kept per micro-batcher
                      (feeds `latency_stats()` and the launch histograms);
    swap_log        — (weight_epoch, first_position) entries kept per
                      `Session` (oldest trimmed; the log stays a list);
    errors          — recent-exception windows on the async/fleet runtimes;
    trace_capacity  — sealed spans / instants held in the tracer ring.
    """

    latency_window: int = 8192
    swap_log: int = 256
    errors: int = 256
    trace_capacity: int = 65536

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"Retention.{f.name} must be an int >= 1, "
                                 f"got {v!r}")


class Observability:
    """Registry + tracer + retention behind one handle.

    Parameters
    ----------
    tracing:   enable chunk-lifecycle spans and trace instants (metrics
               are always on — they are O(1) counter bumps).
    clock:     injectable time source shared by registry and tracer;
               runtimes pass their own clock so tests stay deterministic.
    retention: a `Retention` bound set (defaults apply when omitted).
    """

    def __init__(self, tracing: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 retention: Optional[Retention] = None) -> None:
        self.clock = clock
        self.retention = retention or Retention()
        self.registry = MetricsRegistry(clock=clock)
        self.tracer = Tracer(enabled=tracing,
                             capacity=self.retention.trace_capacity,
                             clock=clock)
        self.registry.callback("trace", self.tracer.stats)

    def scope(self, prefix: str) -> Scope:
        return self.registry.scope(prefix)

    # -- export -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The one tree that replaces the four ad-hoc `stats()` schemas
        (those remain as thin compat wrappers — see docs/OBSERVABILITY.md
        for the key map)."""
        return self.registry.snapshot()

    def to_json(self, indent: Optional[int] = None) -> str:
        return self.registry.to_json(indent=indent)

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def write_snapshot(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.registry.to_json(indent=2))

    def chrome_trace(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        return self.tracer.export_chrome(tenant)

    def write_chrome_trace(self, path: str,
                           tenant: Optional[str] = None) -> None:
        self.tracer.write_chrome(path, tenant)

    def export_bundle(self, path_prefix: str) -> Dict[str, str]:
        """Write `<prefix>.snapshot.json` + `<prefix>.trace.json` and
        return the paths (convenience for incident capture)."""
        snap = f"{path_prefix}.snapshot.json"
        trace = f"{path_prefix}.trace.json"
        self.write_snapshot(snap)
        self.write_chrome_trace(trace)
        return {"snapshot": snap, "trace": trace}

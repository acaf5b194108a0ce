"""repro_torch.obs — the observability core of the serving stack.

Port of `repro.obs` (these modules are host-side and framework-free):

  * `metrics`  — Counter/Gauge/Histogram with bounded reservoirs behind a
    `MetricsRegistry` of dotted names, exported as one nested
    `snapshot()` tree, JSON, or Prometheus text;
  * `trace`    — per-chunk lifecycle spans (submit -> assemble -> launch ->
    execute -> descatter -> emit) in a bounded ring, exportable as Chrome
    `trace_event` JSON;
  * `hub`      — the `Observability` facade (registry + tracer +
    `Retention`) that runtimes accept via their `obs=` parameter;
  * `link`     — streaming per-tenant link-quality estimators (decision-
    directed EVM / SNR / symbol-error proxy / confidence histograms) fed
    from the `Session.tap` seam, published as `link.<tenant>.*`;
  * `slo`      — declarative per-tenant `SloRule`s evaluated against the
    registry with hysteresis-latched breach/clear edges and a bounded
    alert ledger in `snapshot()`;
  * `report`   — `python -m repro_torch.obs.report` console summary from a
    live runtime snapshot or an exported JSON file.

Observation never changes launch order or numerics: estimation reads
symbols already emitted, on the host.
"""
from .hub import Observability, Retention
from .link import LinkEstimate, LinkMonitor
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Scope,
                      safe_segment)
from .slo import SloEngine, SloRule
from .trace import PHASES, ChunkSpan, Tracer

__all__ = ["ChunkSpan", "Counter", "Gauge", "Histogram", "LinkEstimate",
           "LinkMonitor", "MetricsRegistry", "Observability", "PHASES",
           "Retention", "Scope", "SloEngine", "SloRule", "Tracer",
           "safe_segment"]

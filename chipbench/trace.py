"""Reading the profiler's trace of the traced window.

`traced` runs a function under `torch.profiler` (host and device
activities) inside a "chipbench.window" range, and `summarize` reduces
the events to what the per-layer readers and the result's breakdown need:
the window's length, the time some device activity ran (the union of
kernel, copy and set intervals inside the window), each device activity
by name, and the idle gaps between them, each named by the innermost host
operation running at its middle. The ranges the harness itself opens
("chipbench.*") and the profiler's own step ranges appear on the device
timeline too, and are no device work.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

WINDOW = "chipbench.window"


def traced(fn: Callable[[], object], warm: Callable[[], object]):
    """(fn's result, the profiler's events) with fn run in the window.
    ``warm`` runs under the profiler before the window opens, so that the
    profiler's own start (its first activity buffers) falls outside."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, prof.events()


def _own(name: str) -> bool:
    return name.startswith("chipbench.") or name.startswith("ProfilerStep")


def summarize(events, device_type=None) -> Dict:
    """Window, busy time, device activities and idle gaps, in seconds.
    ``events``: the profiler's FunctionEvents (or anything with ``name``,
    ``device_type`` and ``time_range`` in microseconds)."""
    if device_type is None:
        from torch.autograd import DeviceType
        device_type = DeviceType.CUDA
    host, dev = [], []
    win = None
    for e in events:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == device_type:
            if not _own(e.name):
                dev.append((t0, t1, e.name))
        elif e.name == WINDOW:
            win = (t0, t1)
        else:
            host.append((t0, t1, e.name))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    lo, hi = win
    dev = sorted((max(a, lo), min(b, hi), n) for a, b, n in dev
                 if b > lo and a < hi)
    merged: List[List[float]] = []
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [t for iv in merged for t in iv] + [hi]
    gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]
    host.sort()
    starts = [a for a, _, _ in host]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "device_events": len(dev), "by_name": by_name,
            "gaps": [(_host_at(host, starts, (a + b) / 2), (b - a) * 1e-6)
                     for a, b in gaps]}


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float) -> str:
    """The innermost host range running at time t: of the ranges that
    hold t, the one that started last (``host`` sorted by start), looked
    for among the 4096 that started last before t."""
    j = bisect.bisect_right(starts, t) - 1
    for k in range(j, max(-1, j - 4096), -1):
        if host[k][1] >= t:
            return host[k][2]
    return "no host range"


def breakdown(summary: Dict, top: int = 10, width: int = 160) -> Dict:
    """The device operations that took most time and the longest idle
    gaps, by name (its first ``width`` characters), each summed over its
    occurrences."""
    gaps: Dict[str, float] = {}
    for name, s in summary["gaps"]:
        gaps[name] = gaps.get(name, 0.0) + s
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:width], s] for n, s in ops],
            "idle_gaps": [[n[:width], s] for n, s in idle]}

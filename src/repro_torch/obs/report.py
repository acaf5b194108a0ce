"""Console summary over an observability snapshot.

Port of `repro.obs.report`, with all of its sections: `serve`, `fleet`
(one per `fleet*` subtree), `adapt`, `net`, `link`, `slo` and `trace`.
`render(snapshot)` turns the nested registry tree (the dict returned by
`Observability.snapshot()` / `MetricsRegistry.snapshot()`, or the JSON
written by `Observability.write_snapshot`) into a compact human-readable
report: launch latency quantiles, throughput, per-tenant session state,
recovery and degradation, fleet placement and per-worker health, the
adaptation loop's actions and shadow BERs, the wire's frame and
impairment counters and its ingress-to-emit latency, link quality, SLO
latches and alerts, and trace-ring occupancy.

CLI:

    python -m repro_torch.obs.report snapshot.json
    python -m repro_torch.obs.report -          # read JSON from stdin

Every section is optional — the report renders whatever subtrees the
snapshot actually carries.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def _fmt(v: Any, nd: int = 4) -> str:
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or abs(v) < 1e-3:
            return f"{v:.3g}"
        return f"{v:.{nd}g}"
    return str(v)


def _hist_line(label: str, h: Optional[Dict[str, Any]]) -> Optional[str]:
    """One line for a Histogram.summary() dict; None when absent/empty."""
    if not isinstance(h, dict) or not h.get("count"):
        return None
    parts = [f"n={h['count']}"]
    for k in ("mean", "p50", "p90", "p99", "max"):
        if k in h:
            parts.append(f"{k}={_fmt(h[k])}")
    return f"  {label:<22} {'  '.join(parts)}"


def _batcher_lines(node: Dict[str, Any]) -> List[str]:
    """Shared micro-batcher block (used by `serve` and every fleet
    worker): request/launch counters plus the launch histograms."""
    out: List[str] = []
    req = node.get("requests_total")
    lau = node.get("launches_total")
    if req is not None or lau is not None:
        pend = node.get("pending")
        out.append(f"  requests={_fmt(req or 0)}  launches={_fmt(lau or 0)}"
                   + (f"  pending={_fmt(pend)}" if pend is not None else ""))
    launch = node.get("launch")
    if isinstance(launch, dict):
        for key, label in (("latency_s", "latency_s"),
                           ("wait_s", "wait_s"),
                           ("device_s", "device_s"),
                           ("descatter_s", "descatter_s"),
                           ("occupancy", "occupancy"),
                           ("width_samples", "width_samples")):
            line = _hist_line(label, launch.get(key))
            if line:
                out.append(line)
    pool = node.get("pool")
    if isinstance(pool, dict) and "hits" in pool:
        out.append(f"  pool: size={pool.get('size')}/"
                   f"{pool.get('max_engines')}  hits={pool.get('hits')}  "
                   f"misses={pool.get('misses')}  "
                   f"evictions={pool.get('evictions')}")
    line = _hist_line("pool.build_s",
                      pool.get("build_s") if isinstance(pool, dict) else None)
    if line:
        out.append(line)
    return out


def _errors_line(node: Any) -> Optional[str]:
    if isinstance(node, dict) and "total" in node:
        return (f"  errors: total={node['total']}  window={node['window']}"
                f"  dropped={node['dropped']}")
    if isinstance(node, (int, float)):
        return f"  errors: total={_fmt(node)}"
    return None


def _recovery_line(node: Any) -> Optional[str]:
    if not isinstance(node, dict):
        return None
    interesting = [(k, v) for k, v in sorted(node.items())
                   if isinstance(v, (int, float)) and v]
    if not interesting:
        return "  recovery: clean"
    return "  recovery: " + "  ".join(f"{k}={_fmt(v)}"
                                      for k, v in interesting)


def _serve_section(serve: Dict[str, Any]) -> List[str]:
    out = ["[serve]"]
    out += _batcher_lines(serve)
    for key in ("tenants", "inflight"):
        if key in serve and not isinstance(serve[key], dict):
            out.append(f"  {key}={_fmt(serve[key])}")
    line = _errors_line(serve.get("errors"))
    if line:
        out.append(line)
    line = _recovery_line(serve.get("recovery"))
    if line:
        out.append(line)
    deg = serve.get("degradation")
    if isinstance(deg, dict) and deg:
        out.append("  degradation: " + "  ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(deg.items())
            if not isinstance(v, dict)))
    sessions = serve.get("sessions")
    if isinstance(sessions, dict) and sessions:
        out.append("  sessions:")
        for tid, s in sorted(sessions.items()):
            if not isinstance(s, dict):
                continue
            out.append(f"    {tid:<12} syms={_fmt(s.get('syms_emitted', 0))}"
                       f"  epoch={s.get('weight_epoch', 0)}"
                       f"  recoveries={s.get('recoveries', 0)}"
                       f"  inflight={s.get('inflight', 0)}"
                       + ("  FAILED" if s.get("failed") else ""))
    return out


def _fleet_section(fleet: Dict[str, Any]) -> List[str]:
    out = ["[fleet]"]
    head = []
    for key in ("tenants", "inflight", "migrations"):
        if key in fleet and not isinstance(fleet[key], dict):
            head.append(f"{key}={_fmt(fleet[key])}")
    if head:
        out.append("  " + "  ".join(head))
    line = _errors_line(fleet.get("errors"))
    if line:
        out.append(line)
    line = _recovery_line(fleet.get("recovery"))
    if line:
        out.append(line)
    placement = fleet.get("placement")
    if isinstance(placement, dict) and placement:
        out.append("  placement: " + "  ".join(
            f"{tid}->w{w}" for tid, w in sorted(placement.items())))
    workers = sorted(k for k in fleet
                     if k.startswith("worker") and isinstance(fleet[k], dict))
    for wk in workers:
        w = fleet[wk]
        alive = w.get("alive")
        out.append(f"  [{wk}] alive={alive}")
        out += ["  " + ln for ln in _batcher_lines(w)]
        line = _recovery_line(w.get("recovery"))
        if line:
            out.append("  " + line)
    return out


def _adapt_section(adapt: Dict[str, Any]) -> List[str]:
    out = ["[adapt]"]
    head = []
    for key in ("tenants", "cycles"):
        if key in adapt and not isinstance(adapt[key], dict):
            head.append(f"{key}={_fmt(adapt[key])}")
    if head:
        out.append("  " + "  ".join(head))
    actions = adapt.get("actions")
    if isinstance(actions, dict) and actions:
        out.append("  actions: " + "  ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(actions.items())))
    line = _errors_line(adapt.get("errors"))
    if line:
        out.append(line)
    for tid, node in sorted(adapt.items()):
        if tid in ("actions", "errors", "cycles", "tenants"):
            continue
        if not isinstance(node, dict):
            continue
        sh = node.get("shadow")
        parts = [f"epoch={_fmt(node.get('weight_epoch', 0))}"]
        if isinstance(sh, dict):
            for k in ("ber_active", "ber_candidate", "eval_syms"):
                if k in sh:
                    parts.append(f"{k}={_fmt(sh[k])}")
        out.append(f"    {tid:<12} " + "  ".join(parts))
    return out


def _net_section(net: Dict[str, Any]) -> List[str]:
    out = ["[net]"]
    frames = []
    for k in ("frames_in", "frames_out", "frames_dropped", "frames_parked"):
        if k in net:
            frames.append(f"{k.split('_', 1)[1]}={_fmt(net[k])}")
    if frames:
        out.append("  frames: " + "  ".join(frames))
    wire = []
    for k in ("crc_errors", "duplicates", "reordered", "gaps",
              "nacks_sent", "credits_granted"):
        if k in net:
            wire.append(f"{k}={_fmt(net[k])}")
    if wire:
        out.append("  wire:   " + "  ".join(wire))
    line = _hist_line("ingress_to_emit_s", net.get("ingress_to_emit_s"))
    if line:
        out.append(line)
    return out


def _link_section(link: Dict[str, Any]) -> List[str]:
    out = ["[link]"]
    for tid, node in sorted(link.items()):
        if not isinstance(node, dict):
            continue
        parts = []
        for k in ("snr_db", "evm", "ser_proxy"):
            if k in node:
                parts.append(f"{k}={_fmt(node[k])}")
        for k in ("syms", "segments"):
            if k in node:
                parts.append(f"{k}={_fmt(node[k])}")
        out.append(f"    {tid:<12} " + "  ".join(parts))
        life = node.get("lifetime")
        if isinstance(life, dict):
            out.append("    " + " " * 13 + "lifetime: " + "  ".join(
                f"{k}={_fmt(v)}" for k, v in sorted(life.items())))
        line = _hist_line("confidence", node.get("confidence"))
        if line:
            out.append("  " + line)
    return out


def _slo_section(slo: Dict[str, Any]) -> List[str]:
    out = ["[slo]"]
    head = []
    for k in ("rules", "watched", "breached"):
        if k in slo and not isinstance(slo[k], dict):
            head.append(f"{k}={_fmt(slo[k])}")
    if head:
        out.append("  " + "  ".join(head))
    state = slo.get("state")
    if isinstance(state, dict):
        out.append(f"  alerts: total={_fmt(state.get('alerts_total', 0))}"
                   f"  dropped={_fmt(state.get('alerts_dropped', 0))}")
        latches = state.get("latches")
        if isinstance(latches, dict):
            for name, l in sorted(latches.items()):
                if isinstance(l, dict) and l.get("breached"):
                    out.append(f"    BREACHED {name}  "
                               f"value={_fmt(l.get('value'))}")
    alerts = slo.get("alerts")
    if isinstance(alerts, list) and alerts:
        out.append("  ledger (recent):")
        for a in alerts[-5:]:
            if isinstance(a, dict):
                out.append(f"    {a.get('state', '?'):<9}"
                           f" {a.get('rule', '?')}"
                           f" [{a.get('tenant') or '-'}]"
                           f"  {a.get('metric', '')}"
                           f"  value={_fmt(a.get('value'))}"
                           f" vs {_fmt(a.get('threshold'))}")
    return out


def _trace_section(trace: Dict[str, Any]) -> List[str]:
    out = ["[trace]"]
    out.append("  " + "  ".join(
        f"{k}={_fmt(v)}" for k, v in sorted(trace.items())
        if not isinstance(v, dict)))
    return out


def render(snapshot: Dict[str, Any]) -> str:
    """Render a snapshot tree into the console report (a newline-joined
    string; always ends without a trailing newline)."""
    lines: List[str] = []
    meta = snapshot.get("meta")
    if isinstance(meta, dict):
        lines.append(f"observability snapshot — uptime "
                     f"{_fmt(meta.get('uptime_s', 0.0))}s, "
                     f"{meta.get('metric_names', 0)} metrics, "
                     f"{meta.get('callback_names', 0)} callbacks")
    if isinstance(snapshot.get("serve"), dict):
        lines += _serve_section(snapshot["serve"])
    fleets = [k for k in sorted(snapshot)
              if k.startswith("fleet") and isinstance(snapshot[k], dict)]
    for k in fleets:
        lines += _fleet_section(snapshot[k])
    if isinstance(snapshot.get("adapt"), dict):
        lines += _adapt_section(snapshot["adapt"])
    if isinstance(snapshot.get("net"), dict):
        lines += _net_section(snapshot["net"])
    if isinstance(snapshot.get("link"), dict):
        lines += _link_section(snapshot["link"])
    if isinstance(snapshot.get("slo"), dict):
        lines += _slo_section(snapshot["slo"])
    if isinstance(snapshot.get("trace"), dict):
        lines += _trace_section(snapshot["trace"])
    if not lines:
        lines.append("observability snapshot — empty")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render an observability snapshot (JSON) as a console "
                    "summary.")
    p.add_argument("path", help="snapshot JSON file, or '-' for stdin")
    args = p.parse_args(argv)
    if args.path == "-":
        snap = json.load(sys.stdin)
    else:
        with open(args.path) as f:
            snap = json.load(f)
    print(render(snap))
    return 0


if __name__ == "__main__":
    sys.exit(main())

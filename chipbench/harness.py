"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result.

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`, its configuration file (`configs/<config>.json`, which
names the system module `systems/<system>.py`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<cell>.json`) and each
per-layer metric's reader (`metrics/<metric>.py`). Adding a cell adds
files and entries; it edits none of these modules.

The window is a closed loop over a ring of device-resident batches with
at most ``in_flight`` batches in flight, as a receiver's ping-pong buffers
hold them: before each submission the host waits, in order, for the
oldest batch while that many are in flight. A batch's latency is the host
clock from the start of its submission to the host seeing its completion
event, so the host's enqueue and its wake-up are in it. The system module
turns the window into its end-to-end numbers (`System.end_to_end`); the
harness adds `setup_s`. A reservoir, drawn from the seed, keeps
``compare_batches`` of the window's outputs (kept by reference, never
copied), which the reference judges once the window has closed and the
program's state is gone. The import guard runs at the end of set-up and
again as the last step before the result is printed (`run.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from chipbench import trace as trace_lib

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "chipbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def guard(where: str) -> None:
    hits = forbidden_modules()
    if hits:
        raise ForbiddenImport(f"{where}: loaded {', '.join(hits)}")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json and its files."""
    m = load_json(root / "BENCHMARK.json")
    wls = [w for w in m["workloads"] if w["name"] == name]
    if not wls:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = wls[0]
    conf = [c for c in m["configs"] if c["name"] == wl["config"]][0]
    here = root / "chipbench"

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])
    return Cell(wl, load_json(root / conf["file"]),
                load_json(here / "traffic" / f"{wl['traffic']}.json"),
                load_json(here / "limits" / f"{name}.json"),
                [e for e in m["end_to_end"] if applies(e)],
                [p for p in m["per_layer"] if applies(p)])


def reader(name: str, root: Path = ROOT) -> Callable:
    """The `read(ctx)` of metrics/<name>.py."""
    path = root / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class DeviceMarks:
    """A completion event after a batch's last kernel, which the host
    waits on."""

    @staticmethod
    def end():
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(end) -> None:
        end.synchronize()


class HostMarks:
    """For the CPU runs of the tests: every call there returns with its
    work done."""

    @staticmethod
    def end():
        return None

    @staticmethod
    def wait(end) -> None:
        pass


class Sampler:
    """Reservoir of k (batch index, output) pairs, uniform over the
    batches offered."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.kept = k, rng, 0, []

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = (i, out)


def window(system, marks, *, depth: int, start: int,
           seconds: Optional[float] = None, batches: Optional[int] = None,
           sampler: Optional[Sampler] = None, annotate: bool = False) -> dict:
    """Submit batches start, start + 1, … for ``seconds`` (or ``batches``
    of them), then wait for the last."""
    from torch.profiler import record_function
    span = record_function if annotate else contextlib.nullcontext
    inflight: deque = deque()
    lat: List[float] = []
    submit: List[float] = []
    i = start
    t_first = time.perf_counter()
    t_last = t_first

    def finish():
        nonlocal t_last
        j, t_sub, end, out = inflight.popleft()
        with span("chipbench.wait"):
            marks.wait(end)
        t_last = time.perf_counter()
        lat.append((t_last - t_sub) * 1e3)
        if sampler is not None:
            sampler.offer(j, out)

    while (i - start < batches if batches is not None
           else time.perf_counter() - t_first < seconds):
        while len(inflight) >= depth:
            finish()
        t_sub = time.perf_counter()
        with span("chipbench.submit"):
            out = system.call(i)
        submit.append(time.perf_counter() - t_sub)
        inflight.append((i, t_sub, marks.end(), out))
        i += 1
    while inflight:
        finish()
    return {"batches": i - start, "seconds": t_last - t_first,
            "latency_ms": lat, "submit_s": submit, "next": i}


def quantile(values: List[float], q: float) -> float:
    """Nearest-rank quantile q of values."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def compare(system, samples, limits: Dict[str, float],
            datapath: dict) -> tuple:
    """Judge each sampled output against the reference of its input.

    Returns ({name: value}, batches over a limit). ``max_gap``: the largest
    |output - reference| over every compared symbol, over the reference's
    RMS; ``rms_gap``: the RMS of the difference over the reference's RMS.
    An output of another shape, or not finite, reads inf."""
    refs: Dict[int, torch.Tensor] = {}
    worst, sq, ref_sq, n, failed = 0.0, 0.0, 0.0, 0, 0
    for i, out in samples:
        key = i % len(system.inputs)
        if key not in refs:
            refs[key] = system.reference(i, datapath)
        r = refs[key].double()
        if out is None or tuple(out.shape) != tuple(r.shape):
            worst = sq = math.inf
            failed += 1
            continue
        d = out.to(r.device).double() - r
        b_worst = float(d.abs().max())
        b_sq, b_ref = float((d * d).sum()), float((r * r).sum())
        scale = math.sqrt(b_ref / r.numel())
        b = {"max_gap": b_worst / scale,
             "rms_gap": math.sqrt(b_sq / r.numel()) / scale}
        failed += not within(b, limits)
        worst = max(worst, b_worst) if math.isfinite(b_worst) else math.nan
        sq, ref_sq, n = sq + b_sq, ref_sq + b_ref, n + r.numel()
    scale = math.sqrt(ref_sq / n) if n else math.nan
    return ({"max_gap": worst / scale, "rms_gap": math.sqrt(sq / n) / scale
             if n else math.inf}, failed)


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        wrap: Optional[Callable] = None,
        traffic: Optional[dict] = None) -> tuple:
    """One run of cell ``name``. Returns (result, lines for standard
    output before the result, lines for the end of standard error).

    ``wrap`` replaces the timed entry by wrap(entry) and ``traffic``
    overrides traffic parameters: the tests' way to break the program or
    to shrink the cell."""
    t_enter = time.perf_counter()
    spec = cell(name)
    if traffic:
        spec.traffic.update(traffic)
    t = spec.traffic
    system = importlib.import_module(
        f"chipbench.systems.{spec.config['system']}").System(
            spec.config, t, seed, device)
    t_built = time.perf_counter()
    if wrap is not None:
        system.step = wrap(system.step)
    cuda = device.type == "cuda"
    marks = DeviceMarks() if cuda else HostMarks()
    depth, k = t["in_flight"], t["compare_batches"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    warm = window(system, marks, depth=depth, start=0, batches=depth + k,
                  sampler=Sampler(k, random.Random(0)))
    sync()
    guard("set-up")
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    sampler = Sampler(k, random.Random(seed))
    win = window(system, marks, depth=depth, start=warm["next"],
                 seconds=seconds, sampler=sampler)
    out_lines: List[str] = []
    ctx = SimpleNamespace(config=spec.config, traffic=t, window=win,
                          system=system)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1}
    if trace:
        ctx.calls = system.probe()

        def profiler_warm():
            system.call(0)
            system.reset_launch_counts()
        ctx.traced, events = trace_lib.traced(
            lambda: window(system, marks, depth=depth, start=win["next"],
                           batches=t["trace_batches"], sampler=sampler,
                           annotate=True),
            warm=profiler_warm)
        out_lines.append(system.launch_summary(ctx.traced["batches"]))
        ctx.trace = trace_lib.summarize(events)
        del ctx.calls[0]                # the profiler's warm batch
        if not ctx.trace["device_events"]:
            raise RuntimeError("the profiler saw no device event in the "
                               "traced window: no per-layer number")
        device_info.update(busy_s=ctx.trace["busy_s"],
                           window_s=ctx.trace["window_s"])
    sync()
    device_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device)) if cuda else 0)
    attempted = win["batches"] + (ctx.traced["batches"] if trace else 0)
    samples = sampler.kept
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed = compare(system, samples, spec.limits,
                              system.datapath())
    correct = within(numbers, spec.limits)

    metrics = {}
    if trace:
        for m in spec.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(system.end_to_end(win), setup_s=setup_s)
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    # a gap that is not a number (a broken output) is printed as its
    # name, so that the line stays JSON
    compared = {k2: {"value": (numbers[k2] if math.isfinite(numbers[k2])
                               else str(numbers[k2])),
                     "limit": spec.limits[k2]}
                for k2 in spec.limits}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = trace_lib.breakdown(ctx.trace)
    result["compared"] = compared
    err_lines = [f"set-up: {t_enter - t_start:.3f} s to start, "
                 f"{t_built - t_enter:.3f} s for weights, waveforms and "
                 f"engines, {t_warm - t_built:.3f} s for the warm batches"]
    err_lines += [f"window: {win['batches']} batches in {win['seconds']:.6f} s"
                 f", latency p50 {quantile(win['latency_ms'], 0.5):.6f} ms"
                 f", host submit mean "
                 f"{1e3 * sum(win['submit_s']) / len(win['submit_s']):.6f} ms"]
    err_lines += [f"compared {k2}: {v['value']!r} limit {v['limit']!r}"
                  for k2, v in compared.items()]
    return result, out_lines, err_lines

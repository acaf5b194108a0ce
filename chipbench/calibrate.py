"""Readings that the limits of `limits/<cell>.json` are set from.

    python3 chipbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 [--out calib.jsonl]

For each seed of ``--seeds``: the cell at its own size, the program's
timed entry over in_flight + compare_batches batches, every one judged
against the reference (the lower readings: the largest over the seeds).
For each of ``--control-seeds``: the reference computed in the nearest
precision below the configured one (`references.cnn_eq.lower_precision`:
int4 for int8, float8 for bfloat16), put in the program's place and
judged the same way (the upper reading: the smallest). Prints one JSON
line per seed and a summary; the benchmark's own runs never call this.
"""
import argparse
import importlib
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name, seeds, control_seeds, device):
    import torch
    from chipbench import harness
    from chipbench.references import cnn_eq as ref

    spec = harness.cell(name)
    t = spec.traffic
    mod = importlib.import_module(
        f"chipbench.systems.{spec.config['system']}")
    marks = (harness.DeviceMarks() if device.type == "cuda"
             else harness.HostMarks())
    rows = []
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        t0 = time.perf_counter()
        system = mod.System(spec.config, t, seed, device)
        n = t["in_flight"] + t["compare_batches"]
        datapath = system.datapath()
        if kind == "program":
            sampler = harness.Sampler(n, random.Random(seed))
            harness.window(system, marks, depth=t["in_flight"], start=0,
                           batches=n, sampler=sampler)
            samples = sampler.kept
        else:
            low = ref.lower_precision(datapath)
            samples = [(i, system.reference(i, low)) for i in range(n)]
        system.release()
        numbers, failed = harness.compare(system, samples, spec.limits,
                                          datapath)
        row = {"cell": name, "kind": kind, "seed": seed, **numbers,
               "batches_over_limit": failed,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del system, samples
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"cell": name}
    for key in spec.limits:
        prog = [r[key] for r in rows if r["kind"] == "program"]
        ctrl = [r[key] for r in rows if r["kind"] == "control"]
        summary[key] = {"lower": max(prog) if prog else None,
                        "upper": min(ctrl) if ctrl else None,
                        "limit": spec.limits[key]}
    print(json.dumps(summary), flush=True)
    return rows, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rows, summary = readings(a.workload, a.seeds, a.control_seeds, device)
    if a.out:
        with open(a.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

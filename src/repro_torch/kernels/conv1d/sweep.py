"""Time the conv1d kernels' alternatives on the card.

    PYTHONPATH=src python -m repro_torch.kernels.conv1d.sweep \\
        [--out reports/conv1d_sweep.json]

At the deploy path's three layer shapes (the equalizer's CNN at 64 rows ×
14 640 samples: (1 → 5, stride 8) on the waveform, (5 → 5, stride 1) and
(5 → 8, stride 2) on 1830 positions), each SAME_LOWER-padded as
`ops.conv1d_same_lower` pads it, with random weights and inputs from a
seed, it times by torch.profiler's device time per launch (mean of CALLS
launches, every variant of a layer in one profiler session):
- the plan's run of conv1d_kernel_rb (the library's `conv1d_plan`);
- conv1d_kernel_rb at every run W of RUNS (`conv1d_rb_launch_at`, at the
  source's P, 128 threads a block);
- conv1d_kernel_rb built from copies of the source with P = 1 and P = 4
  positions a thread (the source's is 2; `VARIANTS`, built under
  build/kernels, one nvcc each, all started together), at every run of
  RUNS;
- the generic kernel, conv1d_kernel, forced on the same inputs at each
  tile_w of TILES (its F.pad copy is not in its time).
Every variant is first held bitwise against the plain version
(`ref.conv1d` on the padded input). It prints the -Xptxas -v registers and
spills of every conv1d_kernel_rb instance. The result is one JSON object,
printed and written to --out. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import pathlib
import re
import sys

import torch
import torch.nn.functional as F

from .. import _build
from ..cnn_eq.sweep import device_ms, on
from . import conv1d as C1
from . import ref

ROWS, WIDTH = 64, 14640
RUNS = (64, 128, 256, 512, 1024)
TILES = (64, 128, 256, 512, 1024)
VARIANTS = {"p1": ("#define C1_PPOS 2", "#define C1_PPOS 1"),
            "p4": ("#define C1_PPOS 2", "#define C1_PPOS 4")}


def layers(dev, seed: int = 0) -> list:
    """(x, w, b, stride) of the three layers at the deploy shapes: random
    weights and a random input to each layer, from a seed."""
    g = torch.Generator().manual_seed(seed)
    out, width = [], WIDTH
    for k, c_in, c_out, stride in C1._RB_DIMS:
        x = torch.randn((ROWS, c_in, width), generator=g)
        w = 0.3 * torch.randn((c_out, c_in, k), generator=g)
        b = torch.randn(c_out, generator=g)
        out.append(tuple(t.to(dev) for t in (x, w, b)) + (stride,))
        width = (width - 1) // stride + 1
    return out


def ptxas(log: str) -> dict:
    """registers and spill bytes of each conv1d_kernel_rb instance."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            name = m.group(1)
        if name is None or "conv1d_kernel_rb" not in name:
            continue
        m = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        key = f"{','.join(m.groups()[:4])} P={m.group(5)}"
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if s:
            out.setdefault(key, {})["spill_bytes"] = int(s.group(1)) + int(
                s.group(2))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            out.setdefault(key, {})["registers"] = int(r.group(1))
    return out


def variant_libs() -> dict:
    """Each VARIANTS copy of the source, built (one nvcc each, all started
    together) and bound; name -> (lib, ptxas summary)."""
    src = C1.CSRC.read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        paths[name] = out_dir / f"conv1d_{name}.cu"
        paths[name].write_text(src.replace(old, new))
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        logs = dict(zip(paths, pool.map(lambda p: _build.build(p)[1],
                                        paths.values())))
    return {name: (_build.load(path, C1._bind), ptxas(logs[name]))
            for name, path in paths.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("reports/conv1d_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _, log = C1.build()
    result = {"card": torch.cuda.get_device_name(0), "ptxas": ptxas(log),
              "plan": {}, "layers": {}}
    print(f"ptxas: {json.dumps(result['ptxas'])}", flush=True)
    variants = variant_libs()
    result["variant_ptxas"] = {n: v[1] for n, v in variants.items()}
    print(f"variant ptxas: {json.dumps(result['variant_ptxas'])}",
          flush=True)
    for x, w, b, stride in layers(dev):
        dims = C1._dims(w, stride)
        key = ",".join(map(str, dims))
        plan = C1._lib_plan(C1._load(), dims)
        if plan.instance != C1._plan(dims):
            raise RuntimeError(f"{key}: _plan {C1._plan(dims)} != "
                               f"conv1d_plan {plan}")
        result["plan"][key] = plan._asdict()
        k = int(w.shape[2])
        pad = (k // 2, k - 1 - k // 2)
        want = ref.conv1d(F.pad(x, pad), w, b, stride)
        rows_out, fns = [], []

        def record(kind, fn, **kw):
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"{key} {kind} {kw}: kernel != plain (max |diff| "
                    f"{float((got - want).abs().max()):.3e})")
            rows_out.append({"kind": kind, **kw})
            fns.append(fn)

        record("plan", functools.partial(C1._conv1d, x, w, b, stride, 256,
                                         pad), **plan._asdict())
        for w_run in RUNS:
            forced = functools.partial(C1._forced, "rb", x, w, b, stride,
                                       pad=pad, w_run=w_run)
            record("rb", forced, w_run=w_run)
            for name, (lib, _) in variants.items():
                record(name, on(lib, forced, C1), w_run=w_run)
        for tile in TILES:
            record("generic", functools.partial(
                C1._forced, "generic", x, w, b, stride, tile, pad=pad),
                tile_w=tile)
        for row, ms in zip(rows_out, device_ms(fns, kernel="conv1d_kernel")):
            row["device_ms"] = ms
            print(f"{key} {json.dumps(row)}", flush=True)
        result["layers"][key] = rows_out
    print(json.dumps(result))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

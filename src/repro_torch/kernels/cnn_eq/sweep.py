"""Time the CNN-equalizer kernels' alternatives on the card.

    PYTHONPATH=src python -m repro_torch.kernels.cnn_eq.sweep \\
        [--parent PATH/cnn_eq.cu] [--out chiprun_out/cnn_eq_sweep.json]

At the deployment shape (64 rows × 14 640 samples = 7320 symbols each) and
a serving shape (4 rows × 4096 samples), both with stacked weights (one
random BN-folded set per row from a seed, fp32, cast to bf16 or quantized
to int8 at Q2.5 weights / Q3.4 activations), it times by torch.profiler's
device time per launch (mean of CALLS launches, every variant of a shape
and datapath in one profiler session):
- the plan's geometry of cnn_eq_kernel_rb (the library's `cnn_eq_plan`)
  for fp32, bf16 and int8;
- cnn_eq_kernel_rb at every final-position run W of RUNS
  (`cnn_eq_rb_launch_at`, at the source's P, 128 threads a block; W = 60
  and 124 make layer 1's 2W + 7 positions fill whole warps);
- the generic kernel, cnn_eq_kernel, forced on the same inputs at each
  tile_m of TILES;
- cnn_eq_kernel_rb built from copies of the source with one piece
  rewritten (`VARIANTS`, built under build/kernels, one nvcc each, all
  started together), at every run of RUNS: P = 4 positions a thread (the
  source's is 2), the register cap __launch_bounds__ sets (64, the
  source's, against 80 and 128 a thread), fp32's layer 1 reading each
  (tap, C_in) pair's inputs from shared memory where it uses them
  (RB_FP32_L1_REGS 0; the source holds its C input windows in
  registers), the tasks without their compiler fence (task_fence), which
  lets the compiler hoist the weight reads out of the task loops, weights
  read as the used scalars instead of whole float4s of the padded row,
  and the input staged one read a thread at a time (RB_STAGE 1, not 8);
  a variant that rewrites only one datapath's code is timed in that
  datapath alone;
- with --parent, the generic kernel of another copy of the source (an
  earlier commit's) and, for each datapath whose plan there is the
  register-blocked kernel, that plan, on the same inputs in the same
  process.
A variant's or the parent's library takes the wrappers' launches through
`built_from`, which stands it in for the source's own library.
Every variant is first held bitwise against the plain version
(`ref.cnn_eq`, `ref.cnn_eq_bf16`, `ref.cnn_eq_int8`) at both shapes. It
prints the -Xptxas -v registers and spills of every cnn_eq_kernel_rb
instance. The
result is one JSON object, printed and written to --out. int8 has one
packing here (4 channels of one tap a word; layer 0: 4 taps of its one
channel). Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import functools
import json
import pathlib
import re
import sys

import numpy as np
import torch

from .. import _build
from ...configs import equalizer_ht as HT
from ...core import equalizer as eq
from . import cnn_eq as K
from . import ref

SHAPES = {"deploy": (64, 14640), "serve": (4, 4096)}
RUNS = (16, 32, 60, 64, 124, 128)
TILES = (16, 32, 64, 128)
CALLS = 20
FORMATS = ((2, 5, 3, 4),) * 3
MODES = {"fp32": K.MODE_FP32, "bf16": K.MODE_BF16, "int8": K.MODE_INT8}
# source variants: name -> ((text in csrc/cnn_eq.cu, its replacement), ...)
# and the datapaths whose code the rewrite touches (None: all)
VARIANTS = {
    "p4": ((("#define RB_PPOS 2", "#define RB_PPOS 4"),), None),
    "regs128": ((("#define RB_MIN_BLOCKS 8", "#define RB_MIN_BLOCKS 4"),),
                None),
    "regs80": ((("#define RB_MIN_BLOCKS 8", "#define RB_MIN_BLOCKS 6"),),
               None),
    "l1_smem": ((("#define RB_FP32_L1_REGS 1", "#define RB_FP32_L1_REGS 0"),),
                ("fp32",)),
    "no_fence": ((('asm volatile("" ::: "memory");', ""),), None),
    "stage1": ((("#define RB_STAGE 8", "#define RB_STAGE 1"),), None),
    "scalar_w": ((("""  float4 q[cdiv(N, 4)];
#pragma unroll
  for (int i = 0; i < cdiv(N, 4); ++i)
    q[i] = reinterpret_cast<const float4*>(src)[i];
#pragma unroll
  for (int c = 0; c < N; ++c) dst[c] = reinterpret_cast<const float*>(q)[c];""",
                   "  for (int c = 0; c < N; ++c) dst[c] = src[c];"),),
                 ("fp32", "bf16")),
}


@contextlib.contextmanager
def built_from(lib: ctypes.CDLL, module=K):
    """Inside, the wrappers of a kernel module (cnn_eq's by default) launch
    from `lib` (a variant's or the parent's build of its source) instead of
    the source's own library."""
    load = module._load
    module._load = lambda: lib
    try:
        yield
    finally:
        module._load = load


def on(lib: ctypes.CDLL, fn, module=K):
    """fn, called with its launches from `lib` (`built_from`)."""
    def call():
        with built_from(lib, module):
            return fn()
    return call


def variant_libs() -> dict:
    """Each VARIANTS copy of the source, built (one nvcc each, all started
    together) and bound; name -> (lib, ptxas summary)."""
    src = K.CSRC.read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (edits, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        paths[name] = out_dir / f"cnn_eq_{name}.cu"
        paths[name].write_text(text)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        logs = dict(zip(paths, pool.map(lambda p: _build.build(p)[1],
                                        paths.values())))
    return {name: (_build.load(path, K._bind), ptxas(logs[name]))
            for name, path in paths.items()}


def inputs(dev, rows: int, width: int, seed: int = 0) -> dict:
    """x and stacked per-row weights for each datapath, from seeds."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, width)).astype(
        np.float32)).to(dev)
    per = []
    for r in range(rows):
        p = eq.init(torch.Generator().manual_seed(seed * 1000 + r), HT.CNN,
                    device="cpu")
        per.append(eq.folded_weights(eq.fold_bn(
            p, eq.init_bn_state(HT.CNN, device="cpu"), HT.CNN)))
    q = [K.quantize_weights_int8(w, FORMATS) for w in per]

    def stack(ws):
        return tuple((torch.stack([w[l][0] for w in ws]).to(dev),
                      torch.stack([w[l][1] for w in ws]).to(dev))
                     for l in range(3))
    return {"x": x, "fp32": stack(per), "bf16": stack(per), "int8": stack(q)}


def device_ms(fns: list, calls: int = CALLS,
              kernel: str = "cnn_eq_kernel", sessions: int = 3) -> list:
    """Mean device time per launch of each function in fns (each launches
    one kernel whose name holds `kernel` a call), from one torch.profiler
    session: every function runs once in the schedule's warm-up step (a
    session after many others can miss its first kernel events), then
    `calls` times each, in turn, in the active step; the session's events
    of that kernel, in launch order, split into runs of `calls`. A session
    that still misses some of the launches (seen late in a long sweep) is
    run again, up to `sessions` in all; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    want = calls * len(fns)
    for _ in range(sessions):
        box = {}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: box.update(
                         events=list(p.events()))) as prof:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            prof.step()
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
            prof.step()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in box.get("events", [])
                       if e.device_type == DeviceType.CUDA
                       and kernel in e.name)
        if len(spans) == want:
            return [float(np.mean([e - b for b, e in spans[i:i + calls]]))
                    / 1e3 for i in range(0, len(spans), calls)]
    raise RuntimeError(f"profiler saw {len(spans)} {kernel} launches of "
                       f"{want} in each of {sessions} sessions")


def ptxas(log: str) -> dict:
    """registers and spill bytes of each cnn_eq_kernel_rb instance."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            name = m.group(1)
        if name is None or "cnn_eq_kernel_rb" not in name:
            continue
        m = re.search(r"ILi(\d)ELi9ELi5ELi8ELi2ELi(\d)E", name)
        key = f"{('fp32', 'bf16', 'int8')[int(m.group(1))]} P={m.group(2)}"
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if s:
            out.setdefault(key, {})["spill_bytes"] = int(s.group(1)) + int(
                s.group(2))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            out.setdefault(key, {})["registers"] = int(r.group(1))
    return out


def parent_lib(path: pathlib.Path) -> ctypes.CDLL:
    """Another copy of csrc/cnn_eq.cu, built and bound (its generic launch
    only, where it has no register-blocked kernel)."""
    def bind(lib):
        try:
            K._bind(lib)
        except AttributeError:
            lib.cnn_eq_launch.restype = ctypes.c_int
            lib.cnn_eq_launch.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 4)
    return _build.load(path.resolve(), bind)


def parent_plans(lib: ctypes.CDLL) -> set:
    """The datapaths whose plan at the paper's widths is the register-
    blocked kernel in another copy of the source."""
    if not hasattr(lib, "cnn_eq_plan"):
        return set()
    return {dp for dp, mode in MODES.items()
            if K._lib_plan(lib, mode, K._RB_DIMS).instance == "rb"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/cnn_eq_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _, log = K.build()
    result = {"card": torch.cuda.get_device_name(0), "ptxas": ptxas(log),
              "plan": {}, "shapes": {}}
    print(f"ptxas: {json.dumps(result['ptxas'])}", flush=True)
    parent = parent_lib(args.parent) if args.parent else None
    parent_rb = parent_plans(parent) if parent is not None else set()
    variants = variant_libs()
    result["variant_ptxas"] = {n: v[1] for n, v in variants.items()}
    print(f"variant ptxas: {json.dumps(result['variant_ptxas'])}",
          flush=True)
    st = eq.layer_strides(HT.CNN)
    for dp, mode in MODES.items():
        plan = K._lib_plan(K._load(), mode, K._RB_DIMS)
        if plan.instance != K._plan(mode, K._RB_DIMS):
            raise RuntimeError(f"{dp}: _plan {K._plan(mode, K._RB_DIMS)} "
                               f"!= cnn_eq_plan {plan}")
        result["plan"][dp] = plan._asdict()
    for shape, (rows, width) in SHAPES.items():
        d = inputs(dev, rows, width)
        x = d["x"]
        res = result["shapes"][shape] = {}
        for dp, mode in MODES.items():
            w = d[dp]
            fmts = FORMATS if dp == "int8" else None
            want = {"fp32": lambda: ref.cnn_eq(x, w, st),
                    "bf16": lambda: ref.cnn_eq_bf16(x, w, st),
                    "int8": lambda: ref.cnn_eq_int8(x, w, st, FORMATS)}[dp]()
            rows_out, fns = [], []

            def record(kind, fn, **kw):
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(
                        f"{shape} {dp} {kind} {kw}: kernel != plain (max "
                        f"|diff| {float((got - want).abs().max()):.3e})")
                rows_out.append({"kind": kind, **kw})
                fns.append(fn)

            plan_call = {
                "fp32": lambda: K.cnn_eq_fused(x, w, st),
                "bf16": lambda: K.cnn_eq_fused_bf16(x, w, st),
                "int8": lambda: K.cnn_eq_fused_int8(x, w, st, FORMATS)}[dp]
            record("plan", plan_call, **result["plan"][dp])
            if dp in parent_rb:
                record("parent_plan", on(parent, plan_call))
            for w_run in RUNS:
                record("rb", functools.partial(
                    K._forced, "rb", mode, x, w, st, formats=fmts,
                    w_run=w_run), w_run=w_run)
            for name, (lib, _) in variants.items():
                only = VARIANTS[name][1]
                if only is not None and dp not in only:
                    continue
                for w_run in RUNS:
                    record(name, on(lib, functools.partial(
                        K._forced, "rb", mode, x, w, st, formats=fmts,
                        w_run=w_run)), w_run=w_run)
            for tile in TILES:
                generic = functools.partial(
                    K._forced, "generic", mode, x, w, st, tile,
                    formats=fmts)
                record("generic", generic, tile_m=tile)
                if parent is not None:
                    record("parent", on(parent, generic), tile_m=tile)
            for row, ms in zip(rows_out, device_ms(fns)):
                row["device_ms"] = ms
                print(f"{shape} {dp} {json.dumps(row)}", flush=True)
            res[dp] = rows_out
    print(json.dumps(result))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

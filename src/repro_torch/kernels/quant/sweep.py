"""Time the fixed-point-quantize kernels' alternatives on the card.

    PYTHONPATH=src python -m repro_torch.kernels.quant.sweep \\
        [--parent PATH/quant.cu] [--out chiprun_out/quant_sweep.json]

Two shapes, random inputs from a seed, widths Q3.4 on the card as 0-d
float32 tensors (as learned widths arrive):
- large: 64 × 14 640 samples in float32 and bfloat16, and the float32 one
  viewed from its second element (a base off the 16-byte boundary). It
  times `quant_kernel` by torch.profiler's device time per launch (mean of
  CALLS launches, every variant of an input in one profiler session): the
  source's (16-byte vectors, one a thread an iteration), and copies of
  the source with one piece rewritten (`VARIANTS`, built under
  build/kernels, one nvcc each, all started together): 4- and 8-byte
  vectors, 2, 4 and 8 vectors a thread; with --parent, the per-tensor
  kernel of another copy of the source (an earlier commit's: float32
  only, widths as a 2-float device tensor) on the same float32 input.
- deploy: the deployed CNN's six tensors (5·1·9, 5, 5·5·9, 5, 8·5·9, 8 =
  648 floats): `fixed_point_quantize_many` (one launch of
  quant_many_kernel) against six `fixed_point_quantize` launches and, with
  --parent, six launches of the earlier kernel, each after its
  `torch.stack` of the widths (that commit's wrapper); device time summed
  over a call's launches, and host time per call by CUDA events (mean of
  ITERS calls after warm-up).
Every variant is first held bitwise against the plain version
(`ref.fixed_point_quantize`). The result is one JSON object, printed and
written to --out. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import pathlib
import sys

import numpy as np
import torch

from .. import _build
from ..cnn_eq.sweep import device_ms, on
from . import quant as Q
from . import ref

ROWS, WIDTH = 64, 14640
DEPLOY_SHAPES = ((5, 1, 9), (5,), (5, 5, 9), (5,), (8, 5, 9), (8,))
ITERS = 200
VARIANTS = {"bytes4": ("#define QV_BYTES 16 ", "#define QV_BYTES 4 "),
            "bytes8": ("#define QV_BYTES 16 ", "#define QV_BYTES 8 "),
            "unroll2": ("#define QV_UNROLL 1 ", "#define QV_UNROLL 2 "),
            "unroll4": ("#define QV_UNROLL 1 ", "#define QV_UNROLL 4 "),
            "unroll8": ("#define QV_UNROLL 1 ", "#define QV_UNROLL 8 ")}


def variant_libs() -> dict:
    """Each VARIANTS copy of the source, built (one nvcc each, all started
    together) and bound; name -> lib."""
    src = Q.CSRC.read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        paths[name] = out_dir / f"quant_{name}.cu"
        paths[name].write_text(src.replace(old, new))
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(_build.build, paths.values()))
    return {name: _build.load(path, Q._bind) for name, path in paths.items()}


def parent_lib(path: pathlib.Path) -> ctypes.CDLL:
    """Another copy of csrc/quant.cu with the float32-only per-tensor
    launcher quant_launch(x, y, bits, n, stream), built and bound."""
    def bind(lib):
        lib.quant_launch.restype = ctypes.c_int
        lib.quant_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_long, ctypes.c_void_p]
    return _build.load(path.resolve(), bind)


def parent_call(lib: ctypes.CDLL, x: torch.Tensor, wi, wf) -> torch.Tensor:
    """The earlier per-tensor kernel as its wrapper called it: the widths
    stacked into a (2,) tensor on the card, then one launch."""
    bits = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(
        x.device).reshape(()) for v in (wi, wf)])
    xc = x.contiguous()
    out = torch.empty_like(xc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.quant_launch(xc.data_ptr(), out.data_ptr(), bits.data_ptr(),
                          xc.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"parent quant_launch failed with code {rc}")
    return out


def host_ms(fn, iters: int = ITERS, warmup: int = 10) -> float:
    """Mean ms per call of fn by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/quant_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    Q.build()
    parent = parent_lib(args.parent) if args.parent else None
    variants = variant_libs()
    wi = torch.tensor(3.0, device=dev)
    wf = torch.tensor(4.0, device=dev)
    g = torch.Generator().manual_seed(0)
    big = (4 * torch.randn(ROWS * WIDTH + 1, generator=g)).to(dev)
    result = {"card": torch.cuda.get_device_name(0), "large": {},
              "deploy": {}}
    large = {"f32": big[:-1].view(ROWS, WIDTH),
             "bf16": big[:-1].to(torch.bfloat16).view(ROWS, WIDTH),
             "f32_offset1": big[1:].view(ROWS, WIDTH)}
    for name, x in large.items():
        want = ref.fixed_point_quantize(x, wi, wf)
        rows_out, fns = [], []

        def record(kind, fn):
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} {kind}: kernel != plain")
            rows_out.append({"kind": kind})
            fns.append(fn)

        call = functools.partial(Q.fixed_point_quantize, x, wi, wf)
        record("source", call)
        for vname, lib in variants.items():
            record(vname, on(lib, call, Q))
        if parent is not None and x.dtype == torch.float32:
            record("parent", functools.partial(parent_call, parent, x, wi,
                                               wf))
        for row, ms in zip(rows_out, device_ms(fns, kernel="quant_kernel")):
            row["device_ms"] = ms
            print(f"large {name} {json.dumps(row)}", flush=True)
        result["large"][name] = rows_out

    xs = [torch.randn(s, generator=g).to(dev) for s in DEPLOY_SHAPES]
    widths = [(wi, wf)] * len(xs)
    wants = [ref.fixed_point_quantize(x, wi, wf) for x in xs]
    calls = {"many": [functools.partial(Q.fixed_point_quantize_many, xs,
                                        widths)],
             "six_tensor": [functools.partial(Q.fixed_point_quantize, x, wi,
                                              wf) for x in xs]}
    if parent is not None:
        calls["six_parent"] = [functools.partial(parent_call, parent, x, wi,
                                                 wf) for x in xs]
    for kind, fns in calls.items():
        outs = [fn() for fn in fns]
        got = outs[0] if kind == "many" else outs
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, wants)):
            raise RuntimeError(f"deploy {kind}: kernel != plain")
        dev_ms = device_ms(fns, kernel="quant")
        row = {"launches": len(fns), "device_ms": float(np.sum(dev_ms)),
               "call_ms": host_ms(lambda: [fn() for fn in fns])}
        print(f"deploy {kind} {json.dumps(row)}", flush=True)
        result["deploy"][kind] = row
    print(json.dumps(result))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

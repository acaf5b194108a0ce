"""Time the Volterra kernels' alternatives on the card.

    PYTHONPATH=src python -m repro_torch.kernels.volterra.sweep \\
        [--parent PATH/volterra.cu] [--out chiprun_out/volterra_sweep.json]

At the deploy shape (64 rows × 14 640 samples = 7320 symbols each, the
deployed baseline (M1, M2, M3) = (25, 9, 0) at N_os = 2, random weights
and input from a seed), in float32, bfloat16 and float16, it times by
torch.profiler's device time per launch (mean of CALLS launches, every
variant of a type in one profiler session):
- the plan's run of volterra_kernel_rb (the library's `volterra_plan`),
  through the wrapper `volterra.volterra`;
- volterra_kernel_rb at every run W of RUNS (`volterra_rb_launch_at`, at
  the source's P, 128 threads a block);
- volterra_kernel_rb built from copies of the source with one piece
  rewritten (`VARIANTS`, built under build/kernels, one nvcc each, all
  started together), at every run of RUNS: P = 1 and 2 symbols a thread
  (the source's is 4), and W2 read in its stored layout (VR_W2T 0: one
  scalar a MAC, where the source reads W2 transposed as float4s);
- the generic kernel, volterra_kernel, forced at each tile of TILES (its
  F.pad copy is not in its time);
- with --parent, the generic kernel of another copy of the source (an
  earlier commit's, whose launcher takes float32 only) at each tile, on
  the same float32 input.
A variant's library takes the wrapper's launches through
`cnn_eq.sweep.built_from`. Every variant is first held bitwise against the
plain version (`ref.volterra`). It prints the -Xptxas -v registers and
spills of every volterra_kernel_rb instance. The result is one JSON
object, printed and written to --out. Needs a CUDA card; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import pathlib
import re
import sys

import torch
import torch.nn.functional as F

from .. import _build
from ..cnn_eq.sweep import device_ms, on
from . import ref
from . import volterra as V

ROWS, WIDTH, STRIDE = 64, 14640, 2
DIMS = (25, 9, 0, STRIDE)
RUNS = (64, 128, 256, 512, 1024)
TILES = (64, 128, 256, 512)
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
VARIANTS = {"p1": ("#define VR_PSYM 4", "#define VR_PSYM 1"),
            "p2": ("#define VR_PSYM 4", "#define VR_PSYM 2"),
            "w2_stored": ("#define VR_W2T 1", "#define VR_W2T 0")}
_TYPE_OF = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def inputs(dev, dtype, seed: int = 0):
    """(x, [w0, w1, w2, None]) at the deploy shape, from a seed."""
    g = torch.Generator().manual_seed(seed)
    ws = [torch.tensor(0.05), 0.3 * torch.randn(DIMS[0], generator=g),
          0.1 * torch.randn((DIMS[1], DIMS[1]), generator=g)]
    x = torch.randn((ROWS, WIDTH), generator=g).to(dtype)
    return x.to(dev), [w.to(dev) for w in ws] + [None]


def ptxas(log: str) -> dict:
    """registers and spill bytes of each volterra_kernel_rb instance, by
    type and P."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            name = m.group(1)
        if name is None or "volterra_kernel_rb" not in name:
            continue
        m = re.search(r"volterra_kernel_rbI(f|13__nv_bfloat16|6__half)"
                      r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        key = (f"{_TYPE_OF[m.group(1)]} {m.group(2)},{m.group(3)} "
               f"S={m.group(4)} P={m.group(5)}")
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
    src = V.CSRC.read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        paths[name] = out_dir / f"volterra_{name}.cu"
        paths[name].write_text(src.replace(old, new))
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        logs = dict(zip(paths, pool.map(lambda p: _build.build(p)[1],
                                        paths.values())))
    return {name: (_build.load(path, V._bind), ptxas(logs[name]))
            for name, path in paths.items()}


def parent_lib(path: pathlib.Path) -> ctypes.CDLL:
    """Another copy of csrc/volterra.cu with the float32-only generic
    launcher (no type argument), built and bound."""
    def bind(lib):
        lib.volterra_launch.restype = ctypes.c_int
        lib.volterra_launch.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 11
                                        + [ctypes.c_void_p])
    return _build.load(path.resolve(), bind)


def parent_call(lib: ctypes.CDLL, x: torch.Tensor, ws, tile: int):
    """The float32 generic kernel of `parent_lib`, padded and tiled as its
    wrapper did."""
    batch, width = x.shape
    n_out = width // STRIDE
    m1, m2, m3 = ref.memory_lengths(*ws[1:])
    halo = max(m1 // 2, m2 // 2, m3 // 2)
    n_tiles = -(-n_out // tile)
    in_tile = (tile - 1) * STRIDE + 2 * halo + 1
    needed = (n_tiles - 1) * tile * STRIDE + in_tile
    xp = F.pad(x, (halo, max(0, needed - width - halo))).contiguous()
    out = torch.empty((batch, n_tiles * tile), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.volterra_launch(
        xp.data_ptr(), out.data_ptr(),
        *[0 if w is None else w.data_ptr() for w in ws], batch, n_tiles,
        xp.shape[1], out.shape[1], tile, STRIDE, m1, m2, m3, halo, in_tile,
        stream)
    if rc != 0:
        raise RuntimeError(f"parent volterra_launch failed with code {rc}")
    return out[:, :n_out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/volterra_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _, log = V.build()
    plan = V._lib_plan(V._load(), DIMS)
    if plan.instance != V._plan(DIMS):
        raise RuntimeError(f"_plan {V._plan(DIMS)} != volterra_plan {plan}")
    result = {"card": torch.cuda.get_device_name(0), "ptxas": ptxas(log),
              "plan": plan._asdict(), "types": {}}
    print(f"ptxas: {json.dumps(result['ptxas'])}", flush=True)
    parent = parent_lib(args.parent) if args.parent else None
    variants = variant_libs()
    result["variant_ptxas"] = {n: v[1] for n, v in variants.items()}
    print(f"variant ptxas: {json.dumps(result['variant_ptxas'])}",
          flush=True)
    for tname, dtype in TYPES.items():
        x, ws = inputs(dev, dtype)
        want = ref.volterra(x, *ws, STRIDE)
        rows_out, fns = [], []

        def record(kind, fn, **kw):
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"{tname} {kind} {kw}: kernel != plain (max |diff| "
                    f"{float((got.float() - want.float()).abs().max()):.3e})")
            rows_out.append({"kind": kind, **kw})
            fns.append(fn)

        record("plan", functools.partial(V.volterra, x, *ws, stride=STRIDE),
               **plan._asdict())
        for w_run in RUNS:
            forced = functools.partial(V._forced, "rb", x, *ws,
                                       stride=STRIDE, w_run=w_run)
            record("rb", forced, w_run=w_run)
            for name, (lib, _) in variants.items():
                record(name, on(lib, forced, V), w_run=w_run)
        for tile in TILES:
            record("generic", functools.partial(
                V._forced, "generic", x, *ws, stride=STRIDE, tile=tile),
                tile=tile)
            if parent is not None and dtype == torch.float32:
                record("parent", functools.partial(parent_call, parent, x,
                                                   ws, tile), tile=tile)
        for row, ms in zip(rows_out, device_ms(fns,
                                               kernel="volterra_kernel")):
            row["device_ms"] = ms
            print(f"{tname} {json.dumps(row)}", flush=True)
        result["types"][tname] = rows_out
    print(json.dumps(result))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `chipbench/` and
the program under `src/`. Standard output ends with one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``compared``: each number the comparison with the reference read, beside
its limit, which also end standard error. Exits 2, printing no result,
without as many CUDA cards as the cell asks for, and 3, printing no
result, if a module of JAX or of the JAX package is loaded at the end of
set-up or once everything but the printing is done. Builds and kernel
caches stay under the checkout's `build/`.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card(chips: int):
    """The first CUDA card with its context made, or None without as many
    cards as ``chips``."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)          # the CUDA context, in set-up
    return device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    t_python = time.perf_counter()
    import torch  # noqa: F401
    t_torch = time.perf_counter()
    from chipbench import harness

    spec = harness.cell(a.workload)
    t_harness = time.perf_counter()
    device = card(int(spec.workload["chips"]))
    if device is None:
        return 2
    t_card = time.perf_counter()
    try:
        result, out_lines, err_lines = harness.run(
            a.workload, a.seed, a.seconds, bool(a.trace), device, T_START)
    except harness.ForbiddenImport as e:
        print(f"forbidden import: {e}", file=sys.stderr)
        return 3
    hits = harness.forbidden_modules()
    if hits:
        print(f"forbidden import: loaded {', '.join(hits)} by the time "
              f"the result was ready", file=sys.stderr)
        return 3
    for line in out_lines:
        print(line)
    print(f"start: {t_python - T_START:.3f} s Python and the arguments, "
          f"{t_torch - t_python:.3f} s import torch, "
          f"{t_harness - t_torch:.3f} s the harness and the cell's files, "
          f"{t_card - t_harness:.3f} s the CUDA context", file=sys.stderr)
    for line in err_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

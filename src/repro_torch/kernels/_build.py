"""Build and bind the port's CUDA sources: one nvcc path for every kernel.

Each kernel directory keeps its source under ``csrc/`` with a plain
``extern "C"`` launcher. `build` compiles one source for sm_90a into a
shared library under ``build/kernels/`` (named by `source_tag`, a hash of
the source, of every header it includes with a quoted ``#include`` and of
the flags, so an edited source or header rebuilds and an unchanged one is
reused);
`load` builds at first use, opens the library with ctypes, declares its
functions' types and caches it for the process. Nothing here falls back:
a missing nvcc, a failed build or a library that does not load raises.

The flags keep ``--fmad=false``: every kernel fixes a scalar order of
operations that its plain PyTorch version repeats, and an FMA contraction
would round differently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, Tuple

from ..device import FLOAT_DTYPES

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# the type code a launcher takes for a float32, bfloat16 or float16 tensor
# (the sources' DT_F32, DT_BF16 and DT_F16)
DTYPE_CODE = {dt: i for i, dt in enumerate(FLOAT_DTYPES)}

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_libs: Dict[pathlib.Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's CUDA kernels cannot "
                       "be built")


def source_tag(csrc: pathlib.Path) -> str:
    """16 hex digits of the sha256 of ``csrc``, of each header it reaches
    through quoted ``#include`` lines (resolved beside the including file,
    as nvcc finds them; each once) and of the nvcc flags."""
    digest = hashlib.sha256()
    seen = set()

    def add(path: pathlib.Path) -> None:
        if path in seen:
            return
        seen.add(path)
        data = path.read_bytes()
        digest.update(data)
        for name in _INCLUDE.findall(data):
            add((path.parent / name.decode()).resolve())

    add(pathlib.Path(csrc).resolve())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build(csrc: pathlib.Path) -> Tuple[pathlib.Path, str]:
    """Compile ``csrc`` for sm_90a (once per source and flag set).

    Returns (shared library path, nvcc's output). The output holds the
    `-Xptxas -v` register, shared-memory and spill summary of each kernel.
    Raises RuntimeError when nvcc is missing or fails.
    """
    lib_path = BUILD_DIR / f"lib{csrc.stem}_{source_tag(csrc)}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists() and log_path.exists():
        return lib_path, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {csrc}:\n"
                           f"{log}")
    os.replace(tmp, lib_path)
    log_path.write_text(log)
    return lib_path, log


def load(csrc: pathlib.Path,
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The built library of ``csrc``, opened once per process; ``bind``
    declares its functions' argtypes and restype."""
    with _lock:
        lib = _libs.get(csrc)
        if lib is None:
            path, _ = build(csrc)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[csrc] = lib
        return lib

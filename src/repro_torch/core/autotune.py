"""tile_m autotuning for the fused equalizer kernels.

Port of `repro.core.autotune`. The fused kernel's sequence-tile width
`tile_m` sets how many positions one block computes and how much halo each
tile re-reads; the best value depends on the topology and the backend, so
each (topology, backend, platform) gets its own sweep.

Timing: on the card, CUDA events around the calls and a synchronize; on the
CPU (the plain versions) the host clock. Results are cached in-process and
on disk in reports/autotune_tile_m_torch.json — a file of the port's own,
keyed with a platform such as ``cuda-sm90`` or ``cpu``, so it never shares
keys with the JAX package's cache.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .equalizer import CNNEqConfig

DEFAULT_TILES: Tuple[int, ...] = (16, 32, 64, 128, 256)
CACHE_PATH = (pathlib.Path(__file__).resolve().parents[3]
              / "reports" / "autotune_tile_m_torch.json")

_memory_cache: Dict[Tuple, int] = {}


def platform_key(device: DeviceLike) -> str:
    """``cpu``, or ``cuda-sm<major><minor>`` of the card."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda-sm{major}{minor}"


def cache_key(cfg: CNNEqConfig, backend: str, device: DeviceLike) -> Tuple:
    # the platform is part of the key: a CPU sweep must not pin the tile
    # for the card (and vice versa)
    return (cfg.layers, cfg.kernel, cfg.channels, cfg.v_parallel, cfg.n_os,
            backend, platform_key(device))


def _key_str(key: Tuple) -> str:
    l, k, c, vp, nos, backend, platform = key[:7]
    s = f"L{l}_K{k}_C{c}_Vp{vp}_Nos{nos}__{backend}__{platform}"
    if len(key) > 7:                   # batched-serving sweep (probe_batch>1)
        s += f"__B{key[7]}"
    if len(key) > 8:                   # serve-aware sweep: live-traffic width
        s += f"_S{key[8]}"
    return s


def _load_disk() -> Dict[str, int]:
    try:
        return json.loads(CACHE_PATH.read_text())
    except (OSError, ValueError):
        return {}


def _store_disk(key: Tuple, tile_m: int) -> None:
    data = _load_disk()
    data[_key_str(key)] = tile_m
    try:
        CACHE_PATH.parent.mkdir(parents=True, exist_ok=True)
        CACHE_PATH.write_text(json.dumps(data, indent=2, sort_keys=True))
    except OSError:
        pass                       # read-only checkout: in-memory cache only


def time_callable(fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor, iters: int = 3) -> float:
    """Mean seconds per call after one warm-up call (which builds the kernel
    on first use). CUDA events on the card, the host clock on the CPU."""
    fn(x)
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        torch.cuda.synchronize(x.device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return (time.perf_counter() - t0) / iters


def best_tile_m(cfg: CNNEqConfig, backend: str,
                make_fn: Callable[[int], Callable[[torch.Tensor],
                                                  torch.Tensor]],
                candidates: Optional[Iterable[int]] = None,
                probe_syms: int = 4096,
                use_disk: bool = True,
                probe_batch: int = 1,
                device: DeviceLike = "cuda") -> int:
    """Sweep tile_m candidates for (cfg, backend, platform); return the
    fastest.

    make_fn(tile_m) returns a callable (B, W) → (B, S). The probe input is
    `probe_batch` rows of `probe_syms` symbols, drawn from a fixed seed.
    probe_batch > 1 models the multi-tenant serving shape and gets its own
    cache slot, keyed on both the batch and the probe width.
    """
    dev = resolve_device(device)
    if candidates is None:
        candidates = DEFAULT_TILES       # resolved at call time (testable)
    key = cache_key(cfg, backend, dev)
    if probe_batch != 1:
        key = key + (probe_batch, probe_syms)
    if key in _memory_cache:
        return _memory_cache[key]
    if use_disk:
        hit = _load_disk().get(_key_str(key))
        if hit is not None:
            _memory_cache[key] = int(hit)
            return int(hit)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((probe_batch, probe_syms * cfg.n_os), generator=gen,
                    dtype=torch.float32).to(dev)
    timings: Dict[int, float] = {}
    for tile_m in candidates:
        timings[int(tile_m)] = time_callable(make_fn(int(tile_m)), x)
    best = min(timings, key=timings.get)
    _memory_cache[key] = best
    if use_disk:
        _store_disk(key, best)
    return best


def clear_cache(disk: bool = False) -> None:
    _memory_cache.clear()
    if disk:
        try:
            CACHE_PATH.unlink()
        except OSError:
            pass

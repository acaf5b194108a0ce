"""Parameter trees between the JAX reference (as numpy) and the port.

The two frameworks cannot share random number streams, so weights are drawn
once (by `repro`'s ``eq.init``, or with numpy), handed over as numpy arrays,
and carried across here. A tree is any nesting of dicts, lists and tuples;
the leaves that are arrays (numpy arrays, numpy scalars, tensors) convert,
every other leaf (python numbers, strings, None) passes through unchanged.
This covers ``eq.init`` params, BN state, ``params["qat"]`` and folded
``((w, b), …)`` tuples.

bfloat16 numpy arrays (the ``ml_dtypes`` dtype) become bf16 tensors; a bf16
tensor comes back as float32 numpy, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _map(tree: Any, leaf_fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, leaf_fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map(v, leaf_fn) for v in tree)
    return leaf_fn(tree)


def _array_to_tensor(a: Any, dev: torch.device) -> Any:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    if not isinstance(a, (np.ndarray, np.generic)) and not hasattr(
            a, "__array__"):
        return a                                   # python scalar, str, None
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _tensor_to_array(t: Any) -> Any:
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def to_torch(tree: Any, device: DeviceLike = "cuda") -> Any:
    """numpy (or array-like) leaves → tensors on ``device``."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _array_to_tensor(a, dev))


def to_numpy(tree: Any) -> Any:
    """Tensor leaves → numpy arrays on the host (bf16 → float32)."""
    return _map(tree, _tensor_to_array)

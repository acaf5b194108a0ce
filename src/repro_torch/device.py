"""Device resolution and the fp32 policy of the port.

Every public entry point of `repro_torch` takes ``device=`` and defaults to
``"cuda"``. `resolve_device` turns that argument into a `torch.device` and
raises when a card is asked for and none is present: the port never runs
on the CPU unless the caller asks for it (the CPU tests pass
``device="cpu"``, which runs each kernel's plain PyTorch version).

fp32 policy: float32 means float32, and the same float32 on every run.
TF32 keeps about three decimal digits, and cuDNN uses it for fp32
convolutions by default; cuDNN may also pick, per call, an algorithm that
sums with atomics in a varying order. So every `F.conv1d` the port runs on
the card, and the backward pass through it, sits inside `fp32_exact()`,
which turns TF32 off for cuDNN and for matmuls and holds cuDNN to its
deterministic algorithms (no benchmark search).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

DEFAULT_DEVICE = "cuda"

# the float types the deploy kernels read and write (the reference's
# conv1d, volterra and fixed_point_quantize take any of them, compute in
# float32 and return x's type)
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def resolve_device(device: DeviceLike = DEFAULT_DEVICE) -> torch.device:
    """``device`` → `torch.device`; raises RuntimeError for an absent card.

    ``None`` means the default, ``"cuda"``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """Run the body with TF32 off for cuDNN convolutions and matmuls and
    with cuDNN's deterministic algorithms only."""
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled, benchmark=False,
                deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul


def as_float32(a, device: torch.device) -> torch.Tensor:
    """A tensor or array-like as a float32 tensor on ``device`` (arrays are
    copied, so read-only numpy views, such as JAX's, are fine)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def as_float(a, device: torch.device) -> torch.Tensor:
    """A tensor or array-like on ``device`` that keeps a float32, bfloat16
    or float16 type (numpy's float16 and bfloat16 arrays, such as JAX's,
    too); any other type becomes float32, as `as_float32` makes it."""
    if isinstance(a, torch.Tensor):
        return a.to(device, a.dtype if a.dtype in FLOAT_DTYPES
                    else torch.float32)
    arr = np.asarray(a)
    if arr.dtype == np.float16:
        return torch.from_numpy(np.array(arr)).to(device)
    if arr.dtype.name == "bfloat16":      # exact through float32
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device, torch.bfloat16)
    return as_float32(arr, device)

"""The fused L-layer CNN equalizer on Hopper: wrappers, host helpers, build.

Port of `repro.kernels.cnn_eq.cnn_eq`. Three datapaths, one CUDA source
(csrc/cnn_eq.cu, built for sm_90a at first use, bound with ctypes):

  * `cnn_eq_fused`       fp32 tap dots, fp32 accumulation;
  * `cnn_eq_fused_bf16`  bf16 operands, fp32 accumulation — QAT formats of
                         9–16 bits;
  * `cnn_eq_fused_int8`  int8 × int8 dots, int32 accumulation, requant
                         between layers, per-channel power-of-two rescale —
                         QAT formats that fit 8 bits.

All three take SHARED weights, w: (C_out, C_in, K), b: (C_out,), or one set
per batch row, w: (B, C_out, C_in, K), b: (B, C_out): the stacked form is
the multi-tenant serving path (one launch, one weight set per row).

Two kernels, one chosen by the plan (`_plan(mode, dims)`, mirrored by the
library's `cnn_eq_plan`): a plain function of the datapath and the layer
dims, with no switch, no environment variable and no fallback.

  * "rb" — `cnn_eq_kernel_rb`, register-blocked and specialized to the
    paper's widths (L = 3, K = 9, C = 5, V_p = 8, N_os = 2, both equalizer
    configs), in all three datapaths. It reads the unpadded input, takes
    zeros outside it, splits each row into its own runs of final positions
    (the library's plan gives their length) and ignores `tile_m`.
  * "generic" — `cnn_eq_kernel`, for every other shape. It keeps
    the reference's padding and tiling: the input is padded with one halo
    on the left and up to the last tile's window on the right, the grid is
    (n_tiles, B), and each tile of `tile_m` positions computes from its own
    window of ``in_tile`` samples. `tile_m` is never shrunk to the stream
    length: a short stream pads a whole tile, exactly as the serving
    layer's launches do.

Where the work runs. On a CUDA tensor a wrapper launches the planned
kernel, or raises (a failed build, a refused launch): there is no
fallback. On a CPU tensor it runs the kernel's plain version (`ref.py`),
tile by tile over the padded windows. Every path accumulates every output
in the same fixed order, so the result depends on neither the kernel,
`tile_m` nor the batch composition.

`LAUNCHES` counts the kernel launches of each wrapper and
`INSTANCE_LAUNCHES` those of each kernel, "rb" and "generic" (plain
integers, bumped only where a kernel is launched); `reset_launch_counts`
zeroes both. Under a profiler each ctypes call into the library records
the span `eq.cnn_eq.launch` (`repro_torch.obs.trace`).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ...obs.trace import span
from . import ref
from .ref import _wformat_cols, receptive_halo, requant_int8

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "cast_weights_bf16", "cnn_eq_fused",
           "cnn_eq_fused_bf16", "cnn_eq_fused_int8", "dequant_int8",
           "quantize_weights_int8", "requant_int8", "reset_launch_counts",
           "takes_tile_m"]

MODE_FP32, MODE_BF16, MODE_INT8 = 0, 1, 2
_MAX_SMEM_BYTES = 232448          # 227 KB: one block's opt-in limit
_MAX_LAYERS = 8
_MAX_ROWS = 65535                 # gridDim.y

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "cnn_eq.cu"

LAUNCHES: Dict[str, int] = {"cnn_eq_fused": 0, "cnn_eq_fused_bf16": 0,
                            "cnn_eq_fused_int8": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {"rb": 0, "generic": 0}


def reset_launch_counts() -> None:
    for table in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in table:
            table[name] = 0


# ---------------------------------------------------------------------------
# the plan (csrc/cnn_eq.cu: cnn_eq_plan)
# ---------------------------------------------------------------------------

# the widths cnn_eq_kernel_rb is instantiated for, as (k, c_in, c_out,
# stride) per layer: the paper's K = 9, C = 5, V_p = 8, N_os = 2
_RB_DIMS = ((9, 1, 5, 8), (9, 5, 5, 1), (9, 5, 8, 2))


class Plan(NamedTuple):
    """The library's plan of a call (`_lib_plan`): `instance` "rb" or
    "generic"; for "rb" the final positions a block `w_run`, the positions
    a thread `p` (layers 0 and 1; p / N_os in the last), the block's
    `threads` and its dynamic shared memory `smem` in bytes (all 0 for
    "generic")."""
    instance: str
    w_run: int
    p: int
    threads: int
    smem: int


def _dims(weights, strides) -> Tuple[Tuple[int, int, int, int], ...]:
    """(k, c_in, c_out, stride) of each layer."""
    return tuple((int(w.shape[-1]), int(w.shape[-2]), int(w.shape[-3]),
                  int(s)) for (w, _), s in zip(weights, strides))


def _plan(mode: int, dims) -> str:
    """The kernel a call runs: "rb" at the paper's widths, in every
    datapath, "generic" for every other shape. The geometry of "rb" is the
    library's (`_lib_plan`)."""
    if (mode in (MODE_FP32, MODE_BF16, MODE_INT8)
            and tuple(map(tuple, dims)) == _RB_DIMS):
        return "rb"
    return "generic"


def takes_tile_m(mode: int, weights, strides) -> bool:
    """Whether tile_m reaches the kernel a call with these weights runs on
    the card: the generic kernel tiles by it, cnn_eq_kernel_rb does not."""
    return _plan(mode, _dims(weights, strides)) == "generic"


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/cnn_eq.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


# cnn_eq_rb_launch's argument types (`_rb_call` marshals them)
RB_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
               + [ctypes.c_void_p] * 4)


def _bind(lib: ctypes.CDLL) -> None:
    lib.cnn_eq_launch.restype = ctypes.c_int
    lib.cnn_eq_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 9
        + [ctypes.c_void_p] * 4)
    lib.cnn_eq_rb_launch.restype = ctypes.c_int
    lib.cnn_eq_rb_launch.argtypes = RB_ARGTYPES
    lib.cnn_eq_rb_launch_at.restype = ctypes.c_int
    lib.cnn_eq_rb_launch_at.argtypes = [ctypes.c_int] + RB_ARGTYPES
    lib.cnn_eq_plan.restype = ctypes.c_int
    lib.cnn_eq_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]


def _load() -> ctypes.CDLL:
    return _build.load(CSRC, _bind)


def _lib_plan(lib: ctypes.CDLL, mode: int, dims) -> Plan:
    """The plan the built library's `cnn_eq_plan` gives: the kernel the
    wrappers launch and, for "rb", its geometry."""
    flat = [int(v) for d in dims for v in d]
    kcs = (ctypes.c_int * max(1, len(flat)))(*flat)
    geom = (ctypes.c_int * 4)()
    rb = lib.cnn_eq_plan(mode, len(dims), kcs, geom)
    return Plan("rb" if rb else "generic", *geom)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def _layer_spans(tile_m: int, kernels: Sequence[int],
                 strides: Sequence[int]) -> list:
    """Positions needed at each level to produce tile_m final positions."""
    spans = [tile_m]
    for k, s in zip(reversed(kernels), reversed(strides)):
        spans.append((spans[-1] - 1) * s + k)
    return list(reversed(spans))  # spans[0] = input samples per tile


def dequant_int8(q: torch.Tensor, a_frac: int) -> torch.Tensor:
    """int8 grid values → fp32 real units (inverse scale of requant_int8)."""
    return q.float() * float(2.0 ** -a_frac)


def cast_weights_bf16(weights) -> Tuple:
    """bf16 deployment cast: fp32 folded weights → bf16; biases stay fp32."""
    return tuple((w.to(torch.bfloat16), b.float()) for w, b in weights)


def quantize_weights_int8(weights, formats) -> Tuple:
    """fp32 folded weights → int8 at 2^w_frac; biases stay fp32.

    formats[l] = (w_int, w_frac, a_int, a_frac); requires w_int+w_frac+1 ≤ 8.
    w_int/w_frac may be per-output-channel tuples (`qat.per_channel_formats`):
    each channel is then quantized on its own 2^w_frac[c] grid.
    """
    out = []
    for (w, b), (wi, wf, _, _) in zip(weights, formats):
        wi_col, wf_col = _wformat_cols(wi, wf)
        bits = int(np.max(wi_col + wf_col)) + 1
        if bits > 8:
            raise ValueError(f"format Q{wi}.{wf} needs {bits} bits > int8")

        def col(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, np.float32).reshape(-1, 1, 1)).to(
                    w.device)
        hi = col(np.exp2(wi_col + wf_col) - 1.0)
        lo = col(-np.exp2(wi_col + wf_col))
        scale = col(np.exp2(wf_col))
        wq = torch.minimum(torch.maximum(torch.round(w.float() * scale), lo),
                           hi).to(torch.int8)
        out.append((wq, b.float()))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _device_scales(formats, c_outs: Tuple[int, ...], device: str) -> Tuple:
    """The int8 rescale columns on ``device``, made once per deployment:
    a host→device copy per launch would wait for the work queued before
    it."""
    return tuple(torch.from_numpy(ref.rescale_column(fmt, c)).to(device)
                 for fmt, c in zip(formats, c_outs))


def _check_formats_int8(formats, n_layers: int) -> None:
    if len(formats) != n_layers:
        raise ValueError(f"{len(formats)} formats for {n_layers} layers")
    for i, (wi, wf, ai, af) in enumerate(formats):
        wi_col, wf_col = _wformat_cols(wi, wf)
        if int(np.max(wi_col + wf_col)) + 1 > 8 or ai + af + 1 > 8:
            raise ValueError(
                f"layer {i} format (Q{wi}.{wf} w / Q{ai}.{af} a) does not "
                f"fit int8; the int8 requant would wrap silently")


# ---------------------------------------------------------------------------
# the shared launch plumbing
# ---------------------------------------------------------------------------

_W_DTYPES = {MODE_FP32: torch.float32, MODE_BF16: torch.bfloat16,
             MODE_INT8: torch.int8}


def _check(mode: int, x: torch.Tensor, weights, strides) -> bool:
    """Validate shapes, dtypes, devices and contiguity; returns `stacked`."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a (B, W) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch (the grid's "
                         f"y dimension), got {int(x.shape[0])}")
    if not 1 <= len(weights) <= _MAX_LAYERS or len(strides) != len(weights):
        raise ValueError(f"need 1..{_MAX_LAYERS} layers and one stride per "
                         f"layer, got {len(weights)} and {len(strides)}")
    stacked = weights[0][0].dim() == 4
    c_prev = 1
    for i, (w, b) in enumerate(weights):
        if w.dim() != (4 if stacked else 3) or b.dim() != w.dim() - 2:
            raise ValueError(f"layer {i}: weights must be all shared "
                             f"(C_out, C_in, K) or all stacked "
                             f"(B, C_out, C_in, K), biases to match")
        if stacked and (w.shape[0] != x.shape[0] or b.shape[0] != x.shape[0]):
            raise ValueError(
                f"stacked weights carry {int(w.shape[0])} rows but x has "
                f"batch {int(x.shape[0])}")
        if int(w.shape[-2]) != c_prev or int(b.shape[-1]) != int(w.shape[-3]):
            raise ValueError(f"layer {i}: channel mismatch, w "
                             f"{tuple(w.shape)}, b {tuple(b.shape)}, "
                             f"C_in expected {c_prev}")
        c_prev = int(w.shape[-3])
        if w.dtype != _W_DTYPES[mode] or b.dtype != torch.float32:
            raise ValueError(f"layer {i}: expected {_W_DTYPES[mode]} weights "
                             f"and float32 biases, got {w.dtype}, {b.dtype}")
        if w.device != x.device or b.device != x.device:
            raise ValueError(f"layer {i}: weights on {w.device}, x on "
                             f"{x.device}")
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"layer {i}: weights must be contiguous")
    return stacked


def _fused_call(name: str, mode: int, x: torch.Tensor, weights,
                strides: Sequence[int], tile_m: int, formats=None,
                scales=None) -> torch.Tensor:
    """Check and run one datapath; (B, W) → (B, W//(V_p·N_os)·V_p)."""
    strides = tuple(int(s) for s in strides)
    stacked = _check(mode, x, weights, strides)
    if x.is_cuda and _plan(mode, _dims(weights, strides)) == "rb":
        return _call_rb(name, mode, x, weights, strides, stacked, formats,
                        scales)
    return _call_tiled(name, mode, x, weights, strides, tile_m, stacked,
                       formats, scales)


def _shape(x: torch.Tensor, weights, strides) -> Tuple[int, int, int]:
    """(n_pos, V_p, total stride) of a call."""
    total_stride = int(np.prod(strides))
    return (int(x.shape[1]) // total_stride, int(weights[-1][0].shape[-3]),
            total_stride)


def _call_tiled(name, mode, x, weights, strides, tile_m, stacked, formats,
                scales) -> torch.Tensor:
    """The padded, tiled path: the generic kernel on a CUDA tensor, the
    plain version on a CPU one."""
    batch, width = x.shape
    kernels = tuple(int(w.shape[-1]) for w, _ in weights)
    n_pos, v_parallel, total_stride = _shape(x, weights, strides)
    n_syms = n_pos * v_parallel
    if n_pos == 0 or batch == 0:
        return x.new_zeros((batch, n_syms))

    # always tile at the REQUESTED tile_m, even for a stream shorter than
    # one tile: the result is independent of the tiling, and the serving
    # layer's launches bucket at whole tiles
    tile_m = max(1, int(tile_m))
    n_tiles = -(-n_pos // tile_m)
    halo = receptive_halo(kernels, strides)
    spans = _layer_spans(tile_m, kernels, strides)
    in_tile = spans[0]
    tile_step = tile_m * total_stride

    # pad: halo on the left; halo + tile rounding on the right
    needed = (n_tiles - 1) * tile_step + in_tile
    xp = F.pad(x, (halo, max(0, needed - width - halo))).contiguous()

    if x.is_cuda:
        out = _launch(name, mode, xp, weights, kernels, strides, spans,
                      stacked, n_tiles, tile_step, v_parallel, formats,
                      scales)
    else:
        out = _plain_tiles(mode, xp, weights, strides, tile_m, n_tiles,
                           in_tile, tile_step, stacked, formats, scales)
    return out[:, :n_syms]


def _plain_tiles(mode, xp, weights, strides, tile_m, n_tiles, in_tile,
                 tile_step, stacked, formats, scales) -> torch.Tensor:
    """The kernel's plain version over the kernel's own tile windows."""
    batch = xp.shape[0]
    win = xp.unfold(1, in_tile, tile_step)[:, :n_tiles]
    win = win.reshape(batch * n_tiles, in_tile)
    if stacked:                      # each window row keeps its row's weights
        weights = tuple((w.repeat_interleave(n_tiles, 0),
                         b.repeat_interleave(n_tiles, 0))
                        for w, b in weights)
    if mode == MODE_INT8:
        y = ref._stack_valid_int8(win, weights, strides, tile_m, formats,
                                  scales)
    else:
        conv = (ref.conv_valid_taps_bf16 if mode == MODE_BF16
                else ref.conv_valid_taps)
        y = ref._stack_valid(win, weights, strides, tile_m, conv_fn=conv)
    return y.reshape(batch, -1)


def _aq_ptrs(mode, weights, formats, scales) -> Tuple[list, list]:
    """Each layer's int8 requant (a_scale, a_lo, a_hi) and its (w, b,
    scale) pointers, as the C launchers take them."""
    aq, ptrs = [], []
    for i, (w, b) in enumerate(weights):
        if mode == MODE_INT8:
            _, _, ai, af = formats[i]
            n = float(2 ** (ai + af))
            aq += [float(2.0 ** af), -n, n - 1.0]
            ptrs += [w.data_ptr(), b.data_ptr(), scales[i].data_ptr()]
        else:
            aq += [0.0, 0.0, 0.0]
            ptrs += [w.data_ptr(), b.data_ptr(), 0]
    return aq, ptrs


def _launch(name, mode, xp, weights, kernels, strides, spans, stacked,
            n_tiles, tile_step, v_parallel, formats, scales) -> torch.Tensor:
    """Launch the generic kernel on the current stream; raises on any
    error."""
    lib = _load()
    batch = xp.shape[0]
    out = torch.empty((batch, n_tiles * spans[-1] * v_parallel),
                      dtype=torch.float32, device=xp.device)
    n_layers = len(weights)
    dims = []
    for i, (w, b) in enumerate(weights):
        dims += [kernels[i], int(w.shape[-2]), int(w.shape[-3]), strides[i],
                 spans[i + 1]]
    aq, ptrs = _aq_ptrs(mode, weights, formats, scales)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_aq = (ctypes.c_float * len(aq))(*aq)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        with span("eq.cnn_eq.launch"):
            rc = lib.cnn_eq_launch(
                mode, xp.data_ptr(), out.data_ptr(), batch, n_tiles,
                xp.shape[1], out.shape[1], tile_step, spans[0], spans[-1],
                n_layers, int(stacked), ctypes.addressof(c_dims),
                ctypes.addressof(c_aq), ctypes.addressof(c_ptrs), stream)
    if rc == -2:
        raise ValueError(f"{name}: tile_m={spans[-1]} needs more than "
                         f"{_MAX_SMEM_BYTES} bytes of shared memory per "
                         f"block; use a smaller tile_m")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with code {rc}")
    LAUNCHES[name] += 1
    INSTANCE_LAUNCHES["generic"] += 1
    return out


def _rb_call(lib: ctypes.CDLL, mode: int, x: torch.Tensor, out: torch.Tensor,
             weights, strides, stacked: bool, formats, scales, stream: int,
             w_run=None) -> int:
    """Marshal one call of `cnn_eq_rb_launch`, or with a run of w_run
    final positions a block of `cnn_eq_rb_launch_at`; returns its code.
    x: (B, W) fp32 with unit stride along W; out: (B, n_pos·V_p)
    contiguous."""
    flat = [v for d in _dims(weights, strides) for v in d]
    aq, ptrs = _aq_ptrs(mode, weights, formats, scales)
    c_kcs = (ctypes.c_int * len(flat))(*flat)
    c_aq = (ctypes.c_float * len(aq))(*aq)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    n_pos = out.shape[1] // int(weights[-1][0].shape[-3])
    args = (mode, x.data_ptr(), out.data_ptr(), int(x.shape[0]),
            int(x.shape[1]), int(x.stride(0)), n_pos, int(stacked),
            ctypes.addressof(c_kcs), ctypes.addressof(c_aq),
            ctypes.addressof(c_ptrs), stream)
    with span("eq.cnn_eq.launch"):
        if w_run is None:
            return lib.cnn_eq_rb_launch(*args)
        return lib.cnn_eq_rb_launch_at(int(w_run), *args)


def _call_rb(name, mode, x, weights, strides, stacked, formats, scales,
             w_run=None) -> torch.Tensor:
    """Launch cnn_eq_kernel_rb on the current stream (at the plan's run,
    or at runs of w_run final positions); raises on any error."""
    n_pos, v_parallel, _ = _shape(x, weights, strides)
    batch = int(x.shape[0])
    if n_pos == 0 or batch == 0:
        return x.new_zeros((batch, n_pos * v_parallel))
    if x.stride(1) != 1:
        x = x.contiguous()
    lib = _load()
    out = torch.empty((batch, n_pos * v_parallel), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _rb_call(lib, mode, x, out, weights, strides, stacked, formats,
                      scales, stream, w_run)
    if rc == -2:
        raise ValueError(f"{name}: runs of {w_run} positions need more "
                         f"than {_MAX_SMEM_BYTES} bytes of shared memory "
                         f"per block")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with code {rc}")
    LAUNCHES[name] += 1
    INSTANCE_LAUNCHES["rb"] += 1
    return out


_NAMES = {MODE_FP32: "cnn_eq_fused", MODE_BF16: "cnn_eq_fused_bf16",
          MODE_INT8: "cnn_eq_fused_int8"}


def _forced(instance: str, mode: int, x: torch.Tensor, weights,
            strides: Sequence[int], tile_m: int = 64, formats=None,
            w_run=None) -> torch.Tensor:
    """A wrapper's call on a CUDA tensor with the kernel named, not
    planned: "generic" at tile_m, or "rb" at the plan's run or at runs of
    w_run final positions. For the card tests, chip_smoke.py and the
    sweep, which hold the two kernels against each other; the wrappers
    never call it."""
    if not x.is_cuda:
        raise ValueError(f"a forced {instance!r} launch needs a CUDA tensor, "
                         f"got one on {x.device}")
    strides = tuple(int(s) for s in strides)
    scales = None
    if mode == MODE_BF16:
        weights = cast_weights_bf16(weights)
    elif mode == MODE_INT8:
        _check_formats_int8(formats, len(weights))
        scales = _int8_scales(formats, weights, x.device)
    stacked = _check(mode, x, weights, strides)
    if instance == "rb":
        return _call_rb(_NAMES[mode], mode, x, weights, strides, stacked,
                        formats, scales, w_run)
    return _call_tiled(_NAMES[mode], mode, x, weights, strides, tile_m,
                       stacked, formats, scales)


def _int8_scales(formats, qweights, device) -> Tuple:
    key = tuple(tuple(tuple(int(c) for c in v) if isinstance(v, (list, tuple))
                      else int(v) for v in fmt) for fmt in formats)
    return _device_scales(key, tuple(int(w.shape[-3]) for w, _ in qweights),
                          str(device))


# ---------------------------------------------------------------------------
# the three wrappers
# ---------------------------------------------------------------------------

def cnn_eq_fused(x: torch.Tensor, weights, strides: Sequence[int],
                 tile_m: int = 64) -> torch.Tensor:
    """Fused fp32 equalizer forward. x: (B, W) → (B, W//N_os) symbols.

    weights: ((w_1, b_1), …, (w_L, b_L)), BN pre-folded, shared or stacked
    per row; strides: (V_p, 1, …, N_os).
    """
    return _fused_call("cnn_eq_fused", MODE_FP32, x, weights, strides,
                       tile_m)


def cnn_eq_fused_bf16(x: torch.Tensor, bweights, strides: Sequence[int],
                      tile_m: int = 64) -> torch.Tensor:
    """Fused bf16 equalizer forward: bf16 operands, fp32 accumulation.

    bweights from `cast_weights_bf16` (fp32 weights are cast here).
    """
    return _fused_call("cnn_eq_fused_bf16", MODE_BF16, x,
                       cast_weights_bf16(bweights), strides, tile_m)


def cnn_eq_fused_int8(x: torch.Tensor, qweights, strides: Sequence[int],
                      formats, tile_m: int = 64) -> torch.Tensor:
    """Fused INT8 equalizer forward.

    qweights: ((w_q int8, b fp32), …) from `quantize_weights_int8`.
    formats:  per-layer (w_int, w_frac, a_int, a_frac); w_int/w_frac may be
              per-output-channel tuples. Every format must fit a signed
              8-bit grid (ValueError otherwise), because the requant casts
              to int8.
    """
    _check_formats_int8(formats, len(qweights))
    scales = _int8_scales(formats, qweights, x.device)
    return _fused_call("cnn_eq_fused_int8", MODE_INT8, x, qweights, strides,
                       tile_m, formats=formats, scales=scales)

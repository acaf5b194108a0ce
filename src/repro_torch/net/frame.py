"""Versioned binary frame codec — the serving stack's wire format.

Port of `repro.net.frame`, byte for byte: a frame encoded by either
package decodes in the other with equal fields and payload. The paper's
FPGA equalizer is a receiver FRONT-END: samples arrive on a wire, not
from an in-process generator. The real-time demonstrator feeds its ANN
core from UDP payloads over 1G/10G Ethernet; one datagram = one frame:

    offset  size  field
    0       2     magic       b"EQ"
    2       1     version     1, or 2 when the trace extension is present
    3       1     ftype       FrameType (DATA/EOS/CREDIT/NACK/CTRL/ACK)
    4       1     dtype       payload sample dtype (NONE/INT8/BF16/FP32)
    5       1     a_int       int8 payload quant grid, integer bits
    6       1     a_frac      int8 payload quant grid, fraction bits
    7       1     tid_len     tenant-id length (1..MAX_TENANT_ID bytes)
    8       4     seq         u32 per-tenant stream sequence number
    12      4     payload_len u32 payload byte length
    16      ...   tenant id   UTF-8
    ...     16    trace ext   version 2 only: u64 trace id + f64 client
                              send timestamp (cross-wire span propagation)
    ...     ...   payload
    ...     4     crc32       CRC-32 over every preceding byte

All integers little-endian. Every decode failure raises a typed
`FrameError` subclass — never a bare crash, and a corrupted frame can
never decode to a silently-wrong payload (CRC-32 detects all single-bit
flips; structural damage fails the length/field validation first).
A version-1-only decoder (`decode_frame(..., versions=(1,))`) rejects v2
frames with `BadVersion` instead of misreading the extension as payload.

Payload sample codecs (`encode_samples` / `decode_samples`):

  * INT8 — samples requantized to the tenant engine's LAYER-0 activation
    grid Q(a_int).(a_frac): q = clip(round(x·2^a_frac)) in float32, round
    half to even, as int8 bytes, 4× less wire traffic than fp32. These are
    the codes of the int8 kernel's entry requant
    (`repro_torch.kernels.cnn_eq.ref.requant_int8`), and the decode is its
    `dequant_int8`; requantization is idempotent, so int8-backend tenants
    fed from an int8 wire produce symbols bitwise-equal to feeding the
    original fp32 waveform.
  * BF16 — raw little-endian bfloat16, rounded to nearest even from fp32
    through torch's bfloat16 cast (no `ml_dtypes`). A NaN is written as
    the quiet NaN 0x7FC0 with the input's sign, which is what the
    reference's `ml_dtypes` cast writes (torch's own cast gives 0xFFFF for
    every NaN on the host); finite values, ±inf and values that round past
    the bf16 maximum (to ±inf) give the reference's bytes.
  * FP32 — raw little-endian float32 (lossless).
"""
from __future__ import annotations

import dataclasses
import enum
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

MAGIC = b"EQ"
WIRE_VERSION = 1
WIRE_VERSION_TRACE = 2            # v1 + 16-byte trace extension
WIRE_VERSIONS = (WIRE_VERSION, WIRE_VERSION_TRACE)
MAX_TENANT_ID = 64
# fits a single unfragmented UDP datagram (65507 max) with header slack
MAX_PAYLOAD = 60_000

_HEADER = struct.Struct("<2sBBBBBBII")          # 16 bytes
_TRACE_EXT = struct.Struct("<Qd")               # 16 bytes (v2 frames only)
_CRC = struct.Struct("<I")
MIN_FRAME = _HEADER.size + 1 + _CRC.size        # 1-byte tenant id, no payload

_BF16_QNAN = np.uint16(0x7FC0)


class FrameType(enum.IntEnum):
    """On-wire frame types. DATA/EOS ride the per-tenant data seq space;
    CREDIT/NACK flow back on the egress path; CTRL/ACK carry the control
    plane's register commands and their per-command acknowledgements."""
    DATA = 1
    EOS = 2
    CREDIT = 3
    NACK = 4
    CTRL = 5
    ACK = 6


class WireDtype(enum.IntEnum):
    NONE = 0
    INT8 = 1
    BF16 = 2
    FP32 = 3


# -- typed decode errors ------------------------------------------------------

class FrameError(ValueError):
    """Base for every frame decode failure (typed, never a crash)."""


class BadMagic(FrameError):
    """First two bytes are not the EQ magic."""


class BadVersion(FrameError):
    """Unknown wire version."""


class BadLength(FrameError):
    """Truncated datagram, or lengths inconsistent with the buffer."""


class BadCRC(FrameError):
    """CRC-32 trailer mismatch (bit corruption in header or payload)."""


class BadField(FrameError):
    """Structurally intact frame with an invalid field value."""


# -- frame object -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Frame:
    """One decoded wire frame (see module docstring for the layout)."""
    ftype: FrameType
    tenant: str
    seq: int
    payload: bytes = b""
    dtype: WireDtype = WireDtype.NONE
    a_int: int = 0
    a_frac: int = 0
    # version-2 trace extension: present ⟺ trace_id is not None
    trace_id: Optional[int] = None
    t_client: float = 0.0

    def samples(self) -> np.ndarray:
        """Decode the payload as fp32 samples on this frame's dtype/grid."""
        return decode_samples(self.payload, self.dtype,
                              self.a_int, self.a_frac)


# -- encode / decode ----------------------------------------------------------

def encode_frame(ftype: FrameType, tenant: str, seq: int,
                 payload: bytes = b"",
                 dtype: WireDtype = WireDtype.NONE,
                 a_int: int = 0, a_frac: int = 0,
                 trace_id: Optional[int] = None,
                 t_client: float = 0.0) -> bytes:
    """Serialize one frame. Raises ValueError (not FrameError — encode
    bugs are the caller's) on out-of-range fields. Passing a `trace_id`
    emits a version-2 frame carrying the 16-byte trace extension."""
    tid = tenant.encode("utf-8")
    if not 1 <= len(tid) <= MAX_TENANT_ID:
        raise ValueError(f"tenant id must encode to 1..{MAX_TENANT_ID} "
                         f"bytes, got {len(tid)}")
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload {len(payload)} bytes exceeds "
                         f"MAX_PAYLOAD={MAX_PAYLOAD}")
    if not 0 <= seq <= 0xFFFFFFFF:
        raise ValueError(f"seq {seq} out of u32 range")
    if not (0 <= a_int <= 255 and 0 <= a_frac <= 255):
        raise ValueError(f"quant grid ({a_int},{a_frac}) out of u8 range")
    ext = b""
    version = WIRE_VERSION
    if trace_id is not None:
        if not 0 <= trace_id <= 0xFFFFFFFFFFFFFFFF:
            raise ValueError(f"trace id {trace_id} out of u64 range")
        ext = _TRACE_EXT.pack(trace_id, float(t_client))
        version = WIRE_VERSION_TRACE
    head = _HEADER.pack(MAGIC, version, int(ftype), int(dtype),
                        a_int, a_frac, len(tid), seq, len(payload))
    body = head + tid + ext + payload
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def decode_frame(data: bytes,
                 versions: Tuple[int, ...] = WIRE_VERSIONS) -> Frame:
    """Parse one datagram into a `Frame`. Every failure raises a
    `FrameError` subclass (see module docstring for the taxonomy).

    `versions` narrows what this decoder accepts — a pre-trace deployment
    is `decode_frame(data, versions=(1,))` and rejects v2 frames with
    `BadVersion` instead of misparsing the extension as payload."""
    if len(data) < MIN_FRAME:
        raise BadLength(f"datagram {len(data)} bytes < minimum {MIN_FRAME}")
    (magic, version, ftype, dtype, a_int, a_frac, tid_len, seq,
     payload_len) = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise BadMagic(f"bad magic {magic!r}")
    if version not in WIRE_VERSIONS or version not in versions:
        raise BadVersion(f"wire version {version} not in {versions}")
    ext_len = _TRACE_EXT.size if version == WIRE_VERSION_TRACE else 0
    total = _HEADER.size + tid_len + ext_len + payload_len + _CRC.size
    if len(data) != total:
        raise BadLength(f"datagram {len(data)} bytes, header promises "
                        f"{total}")
    (crc,) = _CRC.unpack_from(data, total - _CRC.size)
    if zlib.crc32(data[:total - _CRC.size]) & 0xFFFFFFFF != crc:
        raise BadCRC("CRC-32 mismatch")
    if tid_len < 1:
        raise BadField("empty tenant id")
    try:
        ftype_e = FrameType(ftype)
        dtype_e = WireDtype(dtype)
    except ValueError as e:
        raise BadField(str(e)) from None
    try:
        tenant = data[_HEADER.size:_HEADER.size + tid_len].decode("utf-8")
    except UnicodeDecodeError as e:
        raise BadField(f"tenant id not UTF-8: {e}") from None
    trace_id: Optional[int] = None
    t_client = 0.0
    if ext_len:
        trace_id, t_client = _TRACE_EXT.unpack_from(
            data, _HEADER.size + tid_len)
    off = _HEADER.size + tid_len + ext_len
    payload = bytes(data[off:off + payload_len])
    if dtype_e == WireDtype.BF16 and payload_len % 2:
        raise BadField(f"bf16 payload length {payload_len} is odd")
    if dtype_e == WireDtype.FP32 and payload_len % 4:
        raise BadField(f"fp32 payload length {payload_len} not a "
                       f"multiple of 4")
    return Frame(ftype=ftype_e, tenant=tenant, seq=seq, payload=payload,
                 dtype=dtype_e, a_int=a_int, a_frac=a_frac,
                 trace_id=trace_id, t_client=t_client)


# -- payload sample codecs ----------------------------------------------------

def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (uint16), round to nearest even; a
    NaN becomes the quiet NaN with the input's sign."""
    bits = (torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
            .numpy().view(np.uint16).copy())
    nan = np.isnan(x)
    if nan.any():
        sign = (x.view(np.uint32)[nan] >> 16).astype(np.uint16) & 0x8000
        bits[nan] = _BF16_QNAN | sign
    return bits


def encode_samples(x: np.ndarray, dtype: WireDtype,
                   a_int: int = 0, a_frac: int = 0) -> bytes:
    """fp32 samples → payload bytes on the given wire dtype/grid.

    INT8 matches `repro_torch.kernels.cnn_eq.ref.requant_int8` bit for
    bit: the multiply runs in float32 and np.round is round-half-to-even,
    the same arithmetic the kernel's entry requant performs — so the
    decoded (dequantized) samples requantize back to identical codes."""
    x = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
    if dtype == WireDtype.FP32:
        return x.astype("<f4").tobytes()
    if dtype == WireDtype.BF16:
        return _bf16_bits(x).astype("<u2").tobytes()
    if dtype == WireDtype.INT8:
        hi = float(2 ** (a_int + a_frac)) - 1.0
        lo = -float(2 ** (a_int + a_frac))
        q = np.clip(np.round(x * np.float32(2.0 ** a_frac)), lo, hi)
        return q.astype(np.int8).tobytes()
    raise ValueError(f"cannot encode samples as {dtype!r}")


def decode_samples(payload: bytes, dtype: WireDtype,
                   a_int: int = 0, a_frac: int = 0) -> np.ndarray:
    """Payload bytes → fp32 samples (inverse of `encode_samples`; int8
    dequantizes on the frame's Q(a_int).(a_frac) grid — exact, the scale
    is a power of two, as `cnn_eq.dequant_int8`)."""
    if dtype == WireDtype.FP32:
        return np.frombuffer(payload, dtype="<f4").astype(np.float32)
    if dtype == WireDtype.BF16:
        bits = np.frombuffer(payload, dtype="<i2").astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
    if dtype == WireDtype.INT8:
        q = np.frombuffer(payload, dtype=np.int8)
        return q.astype(np.float32) * np.float32(2.0 ** -a_frac)
    raise ValueError(f"cannot decode samples from {dtype!r}")


def samples_per_frame(dtype: WireDtype,
                      max_payload: int = MAX_PAYLOAD) -> int:
    """How many samples fit one frame at this wire dtype."""
    width = {WireDtype.INT8: 1, WireDtype.BF16: 2, WireDtype.FP32: 4}[dtype]
    return max_payload // width


def wire_grid(engine) -> tuple:
    """(a_int, a_frac) of an engine's FIRST layer activation format — the
    int8 on-wire quant grid. (0, 0) when the engine carries no formats."""
    formats = getattr(engine, "formats", None)
    if not formats:
        return (0, 0)
    _, _, a_int, a_frac = formats[0]
    return (int(a_int), int(a_frac))

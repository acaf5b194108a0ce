"""Register-style control plane carried in CTRL/ACK frames.

Port of `repro.net.control` onto the port's runtimes: OPEN builds a
`repro_torch.serve.TenantSpec` from `repro_torch.core.equalizer.
CNNEqConfig` and the blob's numpy weights, READ_STATS makes
`runtime.stats()` JSON-safe (a tensor becomes a list, a torch device or
dtype its name — never a `repr`), and SET_POLICY retunes the runtime's
batcher (every worker's, for a runtime with ``workers``).

Modeled on the FPGA demonstrator's APB register interface: the host does
not reach into the datapath — it posts a write to a typed register, the
core applies it at a safe boundary (here: the existing runtime APIs,
whose swap barrier already lands weight changes at a chunk boundary),
and a per-command ACK frame reports success or a typed error. Commands
are validated against the register map BEFORE anything is applied, so a
malformed or unknown-register command returns an error ack and leaves
every session untouched.

Register map (`Reg`):

  OPEN        admit a tenant: CNNEqConfig fields + folded weights (npz
              blob) + optional formats/backend/tile_m; replies with the
              granted credit total and the int8 wire grid.
  CLOSE       release a finished tenant; replies with the emitted count.
              Refused (error ack) while symbols are still in flight —
              close cannot be allowed to strand un-framed symbols.
  SWAP_WEIGHTS  hot-swap folded weights mid-stream (npz blob); replies
              with the new weight epoch (PR 5 splice contract holds).
  ROLLBACK    restore the pre-swap weights; replies with the new epoch.
  SET_POLICY  retune `BatchPolicy` knobs on every batcher (fleet: all
              workers); replies with the resulting policy.
  READ_STATS  JSON-sanitized `runtime.stats()` snapshot.

Wire encoding of a CTRL payload: ``u32 json_len | json | npz?`` — the
JSON dict carries ``{"reg": int, **fields}``, the optional npz blob the
weight arrays (w0,b0,w1,b1,...). The ACK payload is the same encoding
with ``{"ok": bool, ...result-or-error}`` and no blob; the ACK's seq
echoes the command's seq (the command id the client matches on).
"""
from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .frame import Frame, FrameType, WireDtype, encode_frame, wire_grid

_JLEN = struct.Struct("<I")


class ControlError(ValueError):
    """Typed command rejection (unknown register, bad/missing fields)."""


# -- payload codec ------------------------------------------------------------

def pack_control(fields: dict, arrays: Optional[dict] = None) -> bytes:
    import json
    blob = b""
    if arrays:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getvalue()
    body = json.dumps(fields).encode("utf-8")
    return _JLEN.pack(len(body)) + body + blob


def unpack_control(payload: bytes) -> Tuple[dict, dict]:
    import json
    if len(payload) < _JLEN.size:
        raise ControlError("control payload shorter than its length prefix")
    (jlen,) = _JLEN.unpack_from(payload, 0)
    if _JLEN.size + jlen > len(payload):
        raise ControlError("control payload truncated")
    try:
        fields = json.loads(payload[_JLEN.size:_JLEN.size + jlen])
    except (UnicodeDecodeError, ValueError) as e:
        raise ControlError(f"control JSON undecodable: {e}") from None
    if not isinstance(fields, dict):
        raise ControlError("control JSON must be an object")
    arrays: dict = {}
    blob = payload[_JLEN.size + jlen:]
    if blob:
        try:
            with np.load(io.BytesIO(blob)) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            raise ControlError(f"weight blob undecodable: {e}") from None
    return fields, arrays


def _jsonable(obj):
    """Best-effort JSON sanitizer for stats/ack payloads."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, (torch.device, torch.dtype)):
        return str(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


# -- register map -------------------------------------------------------------

class Reg:
    """The typed register map (u16 register ids on the wire)."""
    OPEN = 1
    CLOSE = 2
    SWAP_WEIGHTS = 3
    ROLLBACK = 4
    SET_POLICY = 5
    READ_STATS = 6


@dataclasses.dataclass(frozen=True)
class RegSpec:
    """One register's schema: required/optional field names → types
    (checked before the handler runs) and whether a weight blob may ride
    along."""
    name: str
    required: Dict[str, type]
    optional: Dict[str, type]
    arrays: bool = False


_NUM = (int, float)
REGISTERS: Dict[int, RegSpec] = {
    Reg.OPEN: RegSpec("open", {"cfg": dict},
                      {"backend": str, "tile_m": (int, str),
                       "formats": list, "per_channel": bool,
                       "priority": int, "credits": int}, arrays=True),
    Reg.CLOSE: RegSpec("close", {}, {}),
    Reg.SWAP_WEIGHTS: RegSpec("swap_weights", {}, {}, arrays=True),
    Reg.ROLLBACK: RegSpec("rollback", {}, {}),
    Reg.SET_POLICY: RegSpec("set_policy", {},
                            {"max_batch": int, "max_wait_s": _NUM,
                             "width_bucket": int, "retune_after": int}),
    Reg.READ_STATS: RegSpec("read_stats", {}, {}),
}


def _validate(spec: RegSpec, fields: dict, arrays: dict) -> None:
    for k, t in spec.required.items():
        if k not in fields:
            raise ControlError(f"{spec.name}: missing field {k!r}")
    for k, v in fields.items():
        if k == "reg":
            continue
        t = spec.required.get(k) or spec.optional.get(k)
        if t is None:
            raise ControlError(f"{spec.name}: unknown field {k!r}")
        if not isinstance(v, t):
            raise ControlError(f"{spec.name}: field {k!r} wants "
                               f"{t}, got {type(v).__name__}")
    if arrays and not spec.arrays:
        raise ControlError(f"{spec.name}: takes no weight blob")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def weights_to_arrays(weights) -> dict:
    """Folded (w, b) pairs, numpy or tensors on any device → the npz
    naming convention (w0,b0,w1,b1,...) as host numpy."""
    out = {}
    for i, (w, b) in enumerate(weights):
        out[f"w{i}"] = _host(w)
        out[f"b{i}"] = _host(b)
    return out


def arrays_to_weights(arrays: dict) -> tuple:
    layers = sum(1 for k in arrays if k.startswith("w"))
    if layers == 0 or any(f"b{i}" not in arrays or f"w{i}" not in arrays
                          for i in range(layers)):
        raise ControlError("weight blob wants w0,b0,...,wN,bN arrays")
    return tuple((arrays[f"w{i}"], arrays[f"b{i}"]) for i in range(layers))


# -- server side --------------------------------------------------------------

class ControlPlane:
    """Executes validated register commands against the runtime and acks
    every command (success or typed error) on the gateway's transport."""

    #: how many executed (tenant, seq) command ids to remember for
    #: duplicate suppression — an impaired wire may duplicate a CTRL
    #: frame, and commands must execute at most once (a doubled
    #: SWAP_WEIGHTS would silently burn a weight epoch).
    ACK_CACHE = 256

    def __init__(self, runtime, gateway):
        self.runtime = runtime
        self.gateway = gateway
        self.commands = runtime.obs.scope("net").counter("ctrl_commands")
        self.errors = runtime.obs.scope("net").counter("ctrl_errors")
        self._acked: Dict[Tuple[str, int], bytes] = {}
        self._acked_order: list = []

    def handle(self, frame: Frame) -> None:
        key = (frame.tenant, frame.seq)
        cached = self._acked.get(key)
        if cached is not None:      # duplicate command: resend ack, don't
            self.gateway.transport.send(cached)   # execute again
            return
        self.commands.inc()
        try:
            fields, arrays = unpack_control(frame.payload)
            reg = fields.get("reg")
            spec = REGISTERS.get(reg)
            if spec is None:
                raise ControlError(f"unknown register {reg!r}")
            _validate(spec, fields, arrays)
            result = getattr(self, f"_do_{spec.name}")(frame.tenant,
                                                       fields, arrays)
            ack = {"ok": True, **_jsonable(result)}
        except Exception as e:
            self.errors.inc()
            ack = {"ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        wire_ack = encode_frame(FrameType.ACK, frame.tenant, frame.seq,
                                pack_control(ack))
        self._acked[key] = wire_ack
        self._acked_order.append(key)
        if len(self._acked_order) > self.ACK_CACHE:
            self._acked.pop(self._acked_order.pop(0), None)
        self.gateway.transport.send(wire_ack)

    # -- handlers (one per register) -----------------------------------------

    def _do_open(self, tenant: str, fields: dict, arrays: dict) -> dict:
        from ..core.equalizer import CNNEqConfig
        from ..serve.session import TenantSpec
        cfg = CNNEqConfig(**fields["cfg"])
        formats = fields.get("formats")
        if formats is not None:
            formats = tuple(tuple(f) for f in formats)
        spec = TenantSpec(
            tenant, cfg, weights=arrays_to_weights(arrays),
            formats=formats, backend=fields.get("backend", "auto"),
            tile_m=fields.get("tile_m", "auto"),
            per_channel=fields.get("per_channel", False),
            priority=fields.get("priority", 0))
        session = self.runtime.open(spec)
        state = self.gateway.ingress.register(tenant,
                                              credits=fields.get("credits"))
        a_int, a_frac = wire_grid(session.engine)
        wire_dtype = (WireDtype.INT8 if spec.backend == "fused_int8"
                      else WireDtype.FP32)
        return {"granted": state.granted_total, "a_int": a_int,
                "a_frac": a_frac, "wire_dtype": int(wire_dtype),
                "backend": session.engine.backend}

    def _do_close(self, tenant: str, fields: dict, arrays: dict) -> dict:
        ingress = self.gateway.ingress
        state = ingress.tenants.get(tenant)
        egress = self.gateway.egress.streams.get(tenant)
        if state is not None:
            if not state.eos_done:
                raise ControlError("close before EOS: stream unfinished")
            if egress is not None and (egress.fifo or not egress.eos_sent):
                raise ControlError("close while symbols in flight")
        stream = self.runtime.close(tenant)
        ingress.release(tenant)
        return {"syms_emitted": int(stream.shape[0])}

    def _do_swap_weights(self, tenant: str, fields: dict,
                         arrays: dict) -> dict:
        epoch = self.runtime.swap_weights(
            tenant, weights=arrays_to_weights(arrays))
        return {"epoch": int(epoch)}

    def _do_rollback(self, tenant: str, fields: dict, arrays: dict) -> dict:
        return {"epoch": int(self.runtime.rollback_weights(tenant))}

    def _do_set_policy(self, tenant: str, fields: dict,
                       arrays: dict) -> dict:
        knobs = {k: v for k, v in fields.items() if k != "reg"}
        if not knobs:
            raise ControlError("set_policy: no knobs given")
        batchers = ([w.batcher for w in self.runtime.workers]
                    if hasattr(self.runtime, "workers")
                    else [self.runtime.batcher])
        for b in batchers:
            b.policy = dataclasses.replace(b.policy, **knobs)
        return {"policy": dataclasses.asdict(batchers[0].policy)}

    def _do_read_stats(self, tenant: str, fields: dict,
                       arrays: dict) -> dict:
        return {"stats": _jsonable(self.runtime.stats())}

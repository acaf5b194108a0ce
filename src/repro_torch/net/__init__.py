"""Packetized network front-end for the serving stack (port of
`repro.net`; imports neither jax nor ml_dtypes).

The wire the paper's FPGA receiver implies: a framed sample data plane
(`frame.py` codec, `gateway.py` ingress/egress with bounded-reorder
reassembly and credit-based backpressure), a register-style control
plane (`control.py`), a driving client (`client.py`), and pluggable
transports (`transport.py`: deterministic impaired loopback + real UDP).
"""
from .client import ControlAckError, NetClient
from .control import (ControlError, ControlPlane, Reg, arrays_to_weights,
                      pack_control, unpack_control, weights_to_arrays)
from .frame import (Frame, FrameError, FrameType, WireDtype, BadCRC,
                    BadField, BadLength, BadMagic, BadVersion, decode_frame,
                    decode_samples, encode_frame, encode_samples,
                    samples_per_frame, wire_grid)
from .gateway import (NetEgress, NetGateway, NetIngress, Reassembler,
                      handle_done, handle_result)
from .transport import (LoopbackTransport, UdpTransport, WireSchedule,
                        loopback_pair)

__all__ = [
    "BadCRC", "BadField", "BadLength", "BadMagic", "BadVersion",
    "ControlAckError", "ControlError", "ControlPlane", "Frame",
    "FrameError", "FrameType", "LoopbackTransport", "NetClient",
    "NetEgress", "NetGateway", "NetIngress", "Reassembler", "Reg",
    "UdpTransport", "WireDtype", "WireSchedule", "arrays_to_weights",
    "decode_frame", "decode_samples", "encode_frame", "encode_samples",
    "handle_done", "handle_result", "loopback_pair", "pack_control",
    "samples_per_frame", "unpack_control", "weights_to_arrays",
    "wire_grid",
]

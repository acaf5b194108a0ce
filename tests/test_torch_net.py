"""Port vs reference: the packetized wire (repro_torch.net) and
`serve.loadgen.replay_wire`, on the CPU.

Mirrors tests/test_net.py against the port with ``device="cpu"`` (the
fleet runtime's with ``devices=["cpu"]``): the codec's
totality (every truncation and single-bit flip a typed `FrameError`), the
reassembler and the seeded impaired loopback, wire-served streams bitwise
equal to the port's offline engine under reordering and duplication (fp32,
int8 and bf16 wires; sync, async and fleet runtimes), loud gaps, credit
isolation, and the control plane (open, swap splice, rollback, malformed
commands, policy, stats, refused close). Against the JAX package: frames
encoded by either package decode in the other with equal fields and
payload, and the BF16 and INT8 payload bytes equal the reference's (INT8
equal to the port's `requant_int8`, its decode to `dequant_int8`); the
loopback schedule delivers in the reference's order; either package's
client drives the other's gateway; an int8 tenant served over the wire
equals the JAX `ServeRuntime` exactly, fp32 and bf16 tenants hold the JAX
engine's bounds (rtol 1e-6 / atol 5e-6, atol 1e-5).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equalizer_ht as HT
from repro.core import equalizer as jeq
from repro.kernels.cnn_eq import cnn_eq as jcnn
from repro.kernels.cnn_eq import ref as jref
from repro.net import frame as jframe
from repro.net import NetClient as JClient
from repro.net import NetGateway as JGateway
from repro.net import transport as jtransport
from repro.obs import report as jreport
from repro.serve import BatchPolicy as JPolicy
from repro.serve import ServeRuntime as JRuntime
from repro.serve import TenantSpec as JSpec
from repro_torch.core import equalizer as eq
from repro_torch.kernels.cnn_eq import cnn_eq as tcnn
from repro_torch.kernels.cnn_eq import ref as tref
from repro_torch.net import (BadCRC, BadLength, BadMagic, BadVersion,
                             ControlAckError, FrameError, FrameType,
                             NetClient, NetGateway, Reassembler, UdpTransport,
                             WireDtype, WireSchedule, decode_frame,
                             decode_samples, encode_frame, encode_samples,
                             loopback_pair, wire_grid)
from repro_torch.net.control import ControlPlane, _jsonable
from repro_torch.obs import report as treport
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy, FleetRuntime,
                               ServeRuntime, TenantSpec, chop, replay_wire)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

pytestmark = pytest.mark.net

CFG = eq.CNNEqConfig()
TILE_M = 32
INT8_FMT = tuple((2, 5, 3, 4) for _ in range(CFG.layers))
CHUNK = 60 * CFG.n_os
RTOL, ATOL = 1e-6, 5e-6
BF16_ATOL = 1e-5


@pytest.fixture
def loopback_wire():
    """The port's deterministic impaired loopback pairs (the conftest
    fixture of the same name builds the reference's): make(seed=0,
    reorder_window=0, dup_prob=0.0, drop_idx=(), impair_both=True) →
    (client_end, server_end); with impair_both the server→client direction
    runs the schedule too under seed+1."""
    made = []

    def make(seed: int = 0, reorder_window: int = 0, dup_prob: float = 0.0,
             drop_idx=(), drop_prob: float = 0.0, impair_both: bool = True):
        fwd = WireSchedule(seed=seed, reorder_window=reorder_window,
                           dup_prob=dup_prob, drop_idx=drop_idx,
                           drop_prob=drop_prob)
        back = (WireSchedule(seed=seed + 1, reorder_window=reorder_window,
                             dup_prob=dup_prob)
                if impair_both else None)
        client_end, server_end = loopback_pair(fwd, back)
        made.extend((client_end, server_end))
        return client_end, server_end

    yield make
    for t in made:
        t.close()


def _weights(seed: int):
    """BN-folded weights drawn by the JAX package, carried as numpy."""
    params = jeq.init(jax.random.PRNGKey(seed), HT.CNN)
    folded = jeq.fold_bn(params, jeq.init_bn_state(HT.CNN), HT.CNN)
    return jax.tree.map(np.asarray, jeq.folded_weights(folded))


def _spec(tid: str, seed: int, backend: str = "fused_fp32") -> TenantSpec:
    return TenantSpec(tid, CFG, weights=_weights(seed),
                      formats=INT8_FMT if backend == "fused_int8" else None,
                      backend=backend, tile_m=TILE_M)


def _offline(spec: TenantSpec, wave: np.ndarray) -> np.ndarray:
    return spec.build_engine("cpu")(wave).numpy()


def _wave(seed: int, n_syms: int = 480) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n_syms * CFG.n_os).astype(np.float32)


def _sync(policy):
    return ServeRuntime(policy, device="cpu")


def _attach(rt, gw, client, spec: TenantSpec, credits=None):
    """Open a tenant on the runtime + both wire ends (data plane only)."""
    sess = rt.open(spec)
    gw.open_wire(spec.tenant_id, credits=credits)
    if spec.backend == "fused_int8":
        client.attach(spec.tenant_id, WireDtype.INT8,
                      grid=wire_grid(sess.engine))
    else:
        client.attach(spec.tenant_id, WireDtype.FP32)
    return sess


# ---------------------------------------------------------------------------
# frame codec: round-trip + corruption totality
# ---------------------------------------------------------------------------

def _assert_roundtrip(tenant, seq, ftype, payload, dtype, a_int, a_frac):
    data = encode_frame(ftype, tenant, seq, payload, dtype=dtype,
                        a_int=a_int, a_frac=a_frac)
    f = decode_frame(data)
    assert (f.ftype, f.tenant, f.seq, f.payload) == (ftype, tenant, seq,
                                                     bytes(payload))
    assert (f.dtype, f.a_int, f.a_frac) == (dtype, a_int, a_frac)
    # the reference's codec writes the same bytes
    assert jframe.encode_frame(ftype, tenant, seq, payload, dtype=dtype,
                               a_int=a_int, a_frac=a_frac) == data


if HAVE_HYPOTHESIS:
    @settings(max_examples=80, deadline=None)
    @given(tenant=st.text(st.characters(min_codepoint=33,
                                        max_codepoint=0x2FF),
                          min_size=1, max_size=16),
           seq=st.integers(0, 2**32 - 1),
           ftype=st.sampled_from(list(FrameType)),
           payload=st.binary(max_size=256),
           grid=st.tuples(st.integers(0, 7), st.integers(0, 7)))
    def test_frame_roundtrip_property(tenant, seq, ftype, payload, grid):
        _assert_roundtrip(tenant, seq, ftype, payload, WireDtype.NONE,
                          *grid)

    @settings(max_examples=80, deadline=None)
    @given(data=st.binary(max_size=128))
    def test_frame_decode_total_on_garbage(data):
        try:
            decode_frame(data)
        except FrameError:
            pass                         # typed rejection is the contract
else:
    def test_frame_roundtrip_property():
        rng = np.random.default_rng(0)
        alphabet = "abcdefgh0123456789_-αβγδ"
        for _ in range(80):
            tenant = "".join(rng.choice(list(alphabet),
                                        size=rng.integers(1, 16)))
            _assert_roundtrip(
                tenant, int(rng.integers(0, 2**32)),
                FrameType(int(rng.integers(1, 7))),
                rng.bytes(int(rng.integers(0, 256))),
                WireDtype.NONE, int(rng.integers(0, 8)),
                int(rng.integers(0, 8)))

    def test_frame_decode_total_on_garbage():
        rng = np.random.default_rng(1)
        for _ in range(200):
            try:
                decode_frame(rng.bytes(int(rng.integers(0, 128))))
            except FrameError:
                pass


def test_truncation_always_typed():
    data = encode_frame(FrameType.DATA, "t0", 7,
                        encode_samples(np.arange(8.0), WireDtype.FP32),
                        dtype=WireDtype.FP32)
    for n in range(len(data)):           # every proper prefix
        with pytest.raises(FrameError):
            decode_frame(data[:n])
    with pytest.raises(BadLength):       # trailing garbage too
        decode_frame(data + b"x")


def test_every_single_bitflip_raises_typed():
    data = encode_frame(FrameType.DATA, "t", 3, b"\x01\x02\x03\x04")
    for byte in range(len(data)):
        for bit in range(8):
            corrupt = bytearray(data)
            corrupt[byte] ^= 1 << bit
            with pytest.raises(FrameError):
                decode_frame(bytes(corrupt))


def test_bad_magic_version_crc_are_distinct_types():
    data = bytearray(encode_frame(FrameType.DATA, "t", 0, b"abcd"))
    bad_magic = bytes(b"XX") + bytes(data[2:])
    with pytest.raises(BadMagic):
        decode_frame(bad_magic)
    bad_ver = bytearray(data)
    bad_ver[2] = 99
    with pytest.raises(BadVersion):
        decode_frame(bytes(bad_ver))
    bad_crc = bytearray(data)
    bad_crc[-1] ^= 0xFF
    with pytest.raises(BadCRC):
        decode_frame(bytes(bad_crc))
    assert all(issubclass(t, (FrameError, ValueError))
               for t in (BadMagic, BadVersion, BadCRC, BadLength))


def test_sample_codec_fp32_bf16_roundtrip():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(257).astype(np.float32)
    assert np.array_equal(
        decode_samples(encode_samples(x, WireDtype.FP32), WireDtype.FP32), x)
    xb = decode_samples(encode_samples(x, WireDtype.BF16), WireDtype.BF16)
    # bf16 is lossy from fp32 but must be idempotent through the wire
    assert np.array_equal(
        decode_samples(encode_samples(xb, WireDtype.BF16), WireDtype.BF16),
        xb)


def test_int8_codec_matches_kernel_requant_and_is_idempotent():
    a_int, a_frac = 3, 4
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(513) * 4).astype(np.float32)
    wire = encode_samples(x, WireDtype.INT8, a_int, a_frac)
    q_kernel = tref.requant_int8(torch.from_numpy(x), a_int, a_frac)
    assert np.array_equal(np.frombuffer(wire, np.int8), q_kernel.numpy())
    deq = decode_samples(wire, WireDtype.INT8, a_int, a_frac)
    assert np.array_equal(deq, tcnn.dequant_int8(q_kernel, a_frac).numpy())
    # requant ∘ dequant ∘ requant == requant: the wire is transparent
    assert encode_samples(deq, WireDtype.INT8, a_int, a_frac) == wire


# ---------------------------------------------------------------------------
# the two packages' codecs: the same bytes, both ways
# ---------------------------------------------------------------------------

FRAMES = [
    dict(ftype=FrameType.DATA, tenant="t0", seq=7, payload=b"\x01\x02\x03\x04",
         dtype=WireDtype.FP32),
    dict(ftype=FrameType.DATA, tenant="ht-3", seq=2**32 - 1,
         payload=bytes(range(200)), dtype=WireDtype.INT8, a_int=3, a_frac=4),
    dict(ftype=FrameType.DATA, tenant="αβ", seq=12, payload=b"\x00\x80" * 9,
         dtype=WireDtype.BF16, trace_id=2**64 - 1, t_client=12.5),
    dict(ftype=FrameType.EOS, tenant="t", seq=99),
    dict(ftype=FrameType.CREDIT, tenant="t", seq=0,
         payload=(64).to_bytes(4, "little")),
    dict(ftype=FrameType.NACK, tenant="t", seq=5, payload=b"stream_gap"),
    dict(ftype=FrameType.CTRL, tenant="_", seq=3, payload=b"\x02\x00\x00\x00{}"),
    dict(ftype=FrameType.ACK, tenant="x" * 64, seq=1, payload=b"ok"),
]


@pytest.mark.parametrize("fields", FRAMES,
                         ids=[f"{f['ftype'].name}-{i}"
                              for i, f in enumerate(FRAMES)])
def test_frames_cross_packages_both_ways(fields):
    port = encode_frame(**fields)
    ref = jframe.encode_frame(**{**fields,
                                 "ftype": jframe.FrameType(fields["ftype"]),
                                 "dtype": jframe.WireDtype(
                                     fields.get("dtype", 0))})
    assert port == ref
    from_ref, from_port = decode_frame(ref), jframe.decode_frame(port)
    for f in (from_ref, from_port):
        assert (int(f.ftype), f.tenant, f.seq, f.payload, int(f.dtype),
                f.a_int, f.a_frac, f.trace_id, f.t_client) == (
            int(fields["ftype"]), fields["tenant"], fields["seq"],
            fields.get("payload", b""), int(fields.get("dtype", 0)),
            fields.get("a_int", 0), fields.get("a_frac", 0),
            fields.get("trace_id"), fields.get("t_client", 0.0))


def _bf16_cases() -> np.ndarray:
    rng = np.random.default_rng(4)
    finite = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 3,
        rng.uniform(-1e38, 1e38, 512).astype(np.float32),
        (rng.standard_normal(256) * 1e-39).astype(np.float32),  # subnormal
        np.array([0.0, -0.0, 1.0, -1.0, 1.00390625, 1.01171875],
                 np.float32)])           # ties that round to even both ways
    edges = np.array([np.inf, -np.inf,
                      3.3895314e38,      # the bf16 maximum itself
                      3.3961776e38,      # above it: rounds to inf
                      np.finfo(np.float32).max, -np.finfo(np.float32).max],
                     np.float32)
    return np.concatenate([finite, edges])


def test_bf16_codec_bytes_equal_reference():
    x = _bf16_cases()
    wire = encode_samples(x, WireDtype.BF16)
    assert wire == jframe.encode_samples(x, jframe.WireDtype.BF16)
    np.testing.assert_array_equal(
        decode_samples(wire, WireDtype.BF16),
        jframe.decode_samples(wire, jframe.WireDtype.BF16))
    # round to nearest even: the port's codes are torch's own bf16 cast
    np.testing.assert_array_equal(
        decode_samples(wire, WireDtype.BF16),
        torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def test_bf16_codec_nan_bytes_equal_reference():
    """A NaN of either sign and any payload goes out as the quiet NaN with
    its sign (0x7FC0 / 0xFFC0), the reference's bytes; torch's own cast on
    the host would write 0xFFFF for each."""
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                     0x7FC12345, 0xFFFFFFFF], np.uint32)
    x = np.concatenate([bits.view(np.float32),
                        np.array([1.5, -2.0], np.float32)])
    with np.errstate(invalid="ignore"):
        want = jframe.encode_samples(x, jframe.WireDtype.BF16)
    wire = encode_samples(x, WireDtype.BF16)
    assert wire == want
    assert np.frombuffer(wire, "<u2")[:6].tolist() == [
        0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0]
    back = decode_samples(wire, WireDtype.BF16)
    assert np.isnan(back[:6]).all() and back[6:].tolist() == [1.5, -2.0]


@pytest.mark.parametrize("grid", [(3, 4), (2, 5), (0, 7), (7, 0), (1, 1)])
def test_int8_codec_bytes_equal_reference_and_kernel(grid):
    a_int, a_frac = grid
    rng = np.random.default_rng(5)
    x = np.concatenate([(rng.standard_normal(1000) * 2 ** a_int * 1.5),
                        np.arange(-40, 40) / 2 ** (a_frac + 1)]
                       ).astype(np.float32)   # half-steps: ties to even
    wire = encode_samples(x, WireDtype.INT8, a_int, a_frac)
    assert wire == jframe.encode_samples(x, jframe.WireDtype.INT8, a_int,
                                         a_frac)
    q_jax = np.asarray(jcnn.requant_int8(jnp.asarray(x), a_int, a_frac))
    q_port = tref.requant_int8(torch.from_numpy(x), a_int, a_frac).numpy()
    assert np.frombuffer(wire, np.int8).tolist() == q_port.tolist() \
        == q_jax.tolist()
    deq = decode_samples(wire, WireDtype.INT8, a_int, a_frac)
    np.testing.assert_array_equal(
        deq, jframe.decode_samples(wire, jframe.WireDtype.INT8, a_int,
                                   a_frac))
    np.testing.assert_array_equal(
        deq, tcnn.dequant_int8(torch.from_numpy(q_port), a_frac).numpy())


# ---------------------------------------------------------------------------
# reassembler + loopback transport determinism
# ---------------------------------------------------------------------------

def test_reassembler_reorder_dup_gap():
    r = Reassembler(window=3)
    assert r.offer(0, "a") == ["a"]
    assert r.offer(2, "c") == []                   # held
    assert r.offer(2, "c") == [] and r.duplicates == 1
    assert r.offer(1, "b") == ["b", "c"]           # drains in order
    assert r.offer(0, "a") == [] and r.duplicates == 2
    assert r.gap is None
    assert r.offer(7, "z") == []                   # 7 - 3 > window
    assert r.gap == 3
    assert r.offer(3, "d") == []                   # latched: stream is dead


def test_loopback_schedule_is_deterministic(loopback_wire):
    def deliver(pair):
        a, b = pair
        for i in range(20):
            a.send(bytes([i]))
        out = []
        while (d := b.recv()) is not None:
            out.append(d[0])
        return out, a.stats

    kw = dict(seed=9, reorder_window=4, dup_prob=0.3, drop_idx=(5,))
    out1, stats1 = deliver(loopback_wire(impair_both=False, **kw))
    out2, _ = deliver(loopback_wire(impair_both=False, **kw))
    assert out1 == out2                    # same seed, same wire
    assert 5 not in out1                   # the scheduled drop happened
    assert len(out1) == 19 + stats1["duplicated"]
    assert set(out1) == set(range(20)) - {5}   # everything else delivered
    assert out1 != sorted(out1)            # ...and actually reordered
    # the reference's schedule on the same seed: the same wire
    ref, ref_stats = deliver(jtransport.loopback_pair(
        jtransport.WireSchedule(**kw), None))
    assert ref == out1 and ref_stats == stats1


# ---------------------------------------------------------------------------
# adversarial data plane: bitwise exactly-once under impairment
# ---------------------------------------------------------------------------

def _run_wire(rt, cli_t, srv_t, specs, waves, burst=3, credits=None,
              **gw_kw):
    gw = NetGateway(rt, srv_t, **gw_kw)
    client = NetClient(cli_t)
    for s in specs:
        _attach(rt, gw, client, s,
                credits=(credits or {}).get(s.tenant_id))
    streams = {s.tenant_id: chop(waves[s.tenant_id], CHUNK, seed=i,
                                 jitter=0.5)
               for i, s in enumerate(specs)}
    acct = replay_wire(gw, client, streams, burst=burst)
    return gw, client, acct


def test_wire_bitwise_exactly_once_reorder_dup(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=21, reorder_window=5, dup_prob=0.25)
    specs = [_spec("f32", 100), _spec("i8", 101, "fused_int8")]
    waves = {s.tenant_id: _wave(300 + i) for i, s in enumerate(specs)}
    rt = _sync(BatchPolicy(max_batch=2, max_wait_s=1e9))
    gw, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves)
    assert not acct["errors"]
    net = rt.obs.snapshot()["net"]
    assert net["duplicates"] > 0, "impairment never fired: vacuous test"
    for s in specs:                        # bitwise AND exactly once
        got = client.symbols(s.tenant_id)
        np.testing.assert_array_equal(got, _offline(s, waves[s.tenant_id]))
    assert net["gaps"] == 0 and net["crc_errors"] == 0


def test_wire_micro_stream_lengths_bitwise(loopback_wire):
    """Stream lengths around (and under) one tile_m=32 tile: the wire
    contract (#12) is unconditional in stream length."""
    for i, n_syms in enumerate((240, 250, 264, 320)):
        cli_t, srv_t = loopback_wire(seed=40 + i, reorder_window=2,
                                     dup_prob=0.2)
        specs = [_spec("f32", 100), _spec("i8", 101, "fused_int8")]
        waves = {s.tenant_id: _wave(360 + i, n_syms=n_syms) for s in specs}
        rt = _sync(BatchPolicy(max_batch=2, max_wait_s=1e9))
        gw, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves)
        assert not acct["errors"]
        for s in specs:
            np.testing.assert_array_equal(
                client.symbols(s.tenant_id),
                _offline(s, waves[s.tenant_id]),
                err_msg=f"n_syms={n_syms} backend={s.backend}")


def test_wire_trace_propagation_client_to_emit(loopback_wire):
    """v2 DATA frames carry (trace_id, t_client); the ingress queues the
    context on the session and the next chunk span starts at the client:
    every sealed span shows client_send/net_ingress events, the Chrome
    export gains a "wire" slice, and a version-1-only decoder rejects the
    extended frames loudly (total-decode contract)."""
    from repro_torch.obs import Observability
    cli_t, srv_t = loopback_wire(seed=45, impair_both=False)
    spec = _spec("tr", 107)
    wave = _wave(370, n_syms=480)
    obs = Observability(tracing=True)
    rt = ServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9), obs=obs,
                      device="cpu")
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t, tracing=True, clock=obs.clock)
    _attach(rt, gw, client, spec)
    acct = replay_wire(gw, client, {"tr": chop(wave, CHUNK, seed=0)},
                       burst=4)
    assert not acct["errors"]
    np.testing.assert_array_equal(client.symbols("tr"),
                                  _offline(spec, wave))
    spans = obs.tracer.sealed_spans("tr")
    assert spans, "tracing on but no sealed spans"
    names = [n for s in spans for n, _, _ in s.events]
    assert "client_send" in names and "net_ingress" in names
    # every client frame's context landed on exactly one span
    n_ctx = sum(1 for n in names if n == "client_send")
    assert n_ctx == client.streams["tr"].tx_seq - 1   # DATA frames only
    # each context's send precedes its span's submit → a "wire" slice
    chrome = obs.tracer.export_chrome("tr")["traceEvents"]
    assert any(e["name"] == "wire" and e["ph"] == "X" for e in chrome)
    # an old (v1-only) decoder must reject the extended frames LOUDLY
    data = encode_frame(FrameType.DATA, "tr", 0, b"abcd",
                        dtype=WireDtype.FP32, trace_id=9, t_client=0.5)
    with pytest.raises(BadVersion):
        decode_frame(data, versions=(1,))
    f = decode_frame(data)                  # current decoder: fine
    assert f.trace_id == 9 and f.t_client == 0.5


def test_wire_bf16_tenant_parity(loopback_wire):
    """bf16 wire is lossy vs the original wave — parity is defined vs
    offline on the DECODED (bf16-rounded) waveform, chunk-split exact."""
    cli_t, srv_t = loopback_wire(seed=23, reorder_window=3, dup_prob=0.2)
    spec = _spec("b16", 102)
    wave = _wave(310)
    dec = decode_samples(encode_samples(wave, WireDtype.BF16),
                         WireDtype.BF16)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    rt.open(spec)
    gw.open_wire("b16")
    client.attach("b16", WireDtype.BF16)
    acct = replay_wire(gw, client, {"b16": chop(wave, CHUNK, seed=0)},
                       burst=3)
    assert not acct["errors"]
    np.testing.assert_array_equal(client.symbols("b16"),
                                  _offline(spec, dec))


def test_drop_surfaces_stream_gap_not_silent_hole(loopback_wire):
    # datagram 3 of a single-tenant stream is dropped; ≥window later
    # frames overflow the reorder window → loud per-tenant stream_gap
    cli_t, srv_t = loopback_wire(seed=25, reorder_window=0, drop_idx=(3,),
                                 impair_both=False)
    spec = _spec("t0", 103)
    wave = _wave(320, n_syms=480)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t, reorder_window=2)
    client = NetClient(cli_t)
    _attach(rt, gw, client, spec)
    acct = replay_wire(gw, client,
                       {"t0": chop(wave, CHUNK, seed=0)}, burst=8)
    assert "t0" in acct["errors"]
    assert "stream_gap" in acct["errors"]["t0"]
    assert gw.ingress.error("t0") is not None
    assert "stream_gap" in gw.ingress.error("t0")
    assert client.errors("t0"), "client never saw the NACK"
    assert rt.obs.snapshot()["net"]["gaps"] == 1


def test_idle_stream_gap_swept_at_end(loopback_wire):
    # the drop lands near the END of the stream — too few frames follow
    # to overflow the window, so only the idle sweep can flag it
    cli_t, srv_t = loopback_wire(seed=26, reorder_window=0, drop_idx=(4,),
                                 impair_both=False)
    spec = _spec("t0", 104)
    wave = _wave(321, n_syms=480)   # ~8 chunks: index 4 is a mid-stream
    # DATA frame (dropping EOS would be a sender fault, not a wire gap)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t, reorder_window=32)
    client = NetClient(cli_t)
    _attach(rt, gw, client, spec)
    acct = replay_wire(gw, client,
                       {"t0": chop(wave, CHUNK, seed=0)}, burst=8)
    assert "t0" in acct["errors"] and "stream_gap" in acct["errors"]["t0"]
    assert "idle" in gw.ingress.error("t0")


def test_gap_tenant_does_not_poison_others(loopback_wire):
    # round-robin burst=1: datagrams alternate gap/ok — index 2 is gap's
    # second DATA frame; tenant "ok" must still finish bitwise
    cli_t, srv_t = loopback_wire(seed=27, reorder_window=0, drop_idx=(2,),
                                 impair_both=False)
    specs = [_spec("gap", 105), _spec("ok", 106, "fused_int8")]
    waves = {"gap": _wave(330, n_syms=480), "ok": _wave(331, n_syms=480)}
    rt = _sync(BatchPolicy(max_batch=2, max_wait_s=1e9))
    gw, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves, burst=1,
                                 reorder_window=2)
    assert set(acct["errors"]) == {"gap"}
    np.testing.assert_array_equal(client.symbols("ok"),
                                  _offline(specs[1], waves["ok"]))


def test_credit_starved_tenant_blocks_without_stalling_others(
        loopback_wire):
    cli_t, srv_t = loopback_wire(seed=28, impair_both=False)
    specs = [_spec("tiny", 107), _spec("big", 108)]
    waves = {s.tenant_id: _wave(340 + i) for i, s in enumerate(specs)}
    rt = _sync(BatchPolicy(max_batch=2, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    _attach(rt, gw, client, specs[0], credits=1)   # starved
    _attach(rt, gw, client, specs[1])              # default window
    client.poll()                                  # learn initial grants
    chunks = {t: chop(waves[t], CHUNK, seed=0) for t in waves}
    for c in chunks["tiny"]:
        client.send_samples("tiny", c)
    for c in chunks["big"]:
        client.send_samples("big", c)
    # the starved tenant is credit-blocked with a client-side backlog;
    # the healthy tenant's whole stream is already on the wire
    assert client.credits("tiny") == 0 and client.backlog("tiny") > 0
    assert client.backlog("big") == 0
    client.finish("tiny")
    client.finish("big")
    acct = replay_wire(gw, client, {"tiny": [], "big": []})
    assert not acct["errors"]
    for s in specs:
        np.testing.assert_array_equal(client.symbols(s.tenant_id),
                                      _offline(s, waves[s.tenant_id]))


def test_rude_sender_parks_bounded_then_overflows_loud(loopback_wire):
    """A sender ignoring its credit window: in-order frames park (bounded)
    and drain correctly while within `park_max`; beyond it they drop with
    a credit_overflow NACK — the queue can never grow unbounded."""
    spec = _spec("rude", 109)
    wave = _wave(350, n_syms=480)
    chunks = chop(wave, CHUNK, seed=0)

    def rude_blast(park_max):
        cli_t, srv_t = loopback_wire(seed=29, impair_both=False)
        rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
        gw = NetGateway(rt, srv_t, initial_credits=2, park_max=park_max)
        rt.open(_spec("rude", 109))
        gw.open_wire("rude")
        for seq, c in enumerate(chunks):   # no credit discipline at all
            cli_t.send(encode_frame(
                FrameType.DATA, "rude", seq,
                encode_samples(c, WireDtype.FP32), dtype=WireDtype.FP32))
        cli_t.send(encode_frame(FrameType.EOS, "rude", len(chunks)))
        gw.settle()
        client = NetClient(cli_t)
        client.attach("rude", WireDtype.FP32)
        client.poll(max_datagrams=256)
        return rt, client

    rt, client = rude_blast(park_max=len(chunks) + 1)
    net = rt.obs.snapshot()["net"]
    assert net["frames_parked"] > 0        # parking really happened
    np.testing.assert_array_equal(client.symbols("rude"),
                                  _offline(spec, wave))

    rt2, client2 = rude_blast(park_max=2)
    net2 = rt2.obs.snapshot()["net"]
    assert net2["frames_dropped"] > 0 and net2["nacks_sent"] > 0
    assert any("credit_overflow" in e for e in client2.errors("rude"))


def test_wire_async_runtime_bitwise(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=31, reorder_window=4, dup_prob=0.2)
    specs = [_spec("a0", 110), _spec("a1", 111, "fused_int8")]
    waves = {s.tenant_id: _wave(360 + i) for i, s in enumerate(specs)}
    with AsyncServeRuntime(BatchPolicy(max_batch=2, max_wait_s=2e-3),
                           device="cpu") as rt:
        gw, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves)
        assert not acct["errors"]
        for s in specs:
            np.testing.assert_array_equal(
                client.symbols(s.tenant_id),
                _offline(s, waves[s.tenant_id]))


def test_wire_fleet_runtime_bitwise(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=32, reorder_window=4, dup_prob=0.2)
    specs = [_spec("w0", 112), _spec("w1", 113, "fused_int8")]
    waves = {s.tenant_id: _wave(370 + i) for i, s in enumerate(specs)}
    with FleetRuntime(n_workers=2,
                      policy=BatchPolicy(max_batch=2, max_wait_s=2e-3),
                      devices=["cpu"]) as rt:
        gw, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves)
        assert not acct["errors"]
        for s in specs:
            np.testing.assert_array_equal(
                client.symbols(s.tenant_id),
                _offline(s, waves[s.tenant_id]))


# ---------------------------------------------------------------------------
# against the JAX package: the runtimes and the other package's wire ends
# ---------------------------------------------------------------------------

def _jspec(spec: TenantSpec) -> JSpec:
    return JSpec(spec.tenant_id, jeq.CNNEqConfig(),
                 weights=jax.tree.map(jnp.asarray, spec.weights),
                 formats=spec.formats, backend=spec.backend,
                 tile_m=spec.tile_m)


def _jax_offline(spec: TenantSpec, wave: np.ndarray) -> np.ndarray:
    """The reference's oracle on the tenant's folded weights."""
    st = jeq.layer_strides(HT.CNN)
    w = jax.tree.map(jnp.asarray, spec.weights)
    x = jnp.asarray(wave[None])
    if spec.backend == "fused_int8":
        y = jref.cnn_eq_quant(x, w, st, spec.formats)
    elif spec.backend == "fused_bf16":
        y = jref.cnn_eq_bf16(x, w, st)
    else:
        y = jref.cnn_eq(x, w, st)
    return np.asarray(y)[0]


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_wire_int8_tenant_equals_jax_serve_runtime(loopback_wire, runtime):
    """An int8 tenant served over the impaired wire equals the JAX
    `ServeRuntime` on the same chunks exactly (int8 leaves no rounding
    freedom), through either port runtime."""
    cli_t, srv_t = loopback_wire(seed=51, reorder_window=6, dup_prob=0.2)
    specs = [_spec("i8a", 131, "fused_int8"), _spec("i8b", 132, "fused_int8")]
    waves = {s.tenant_id: _wave(500 + i, n_syms=600)
             for i, s in enumerate(specs)}
    policy = BatchPolicy(max_batch=2, max_wait_s=1e9 if runtime == "sync"
                         else 2e-3)
    rt = (_sync(policy) if runtime == "sync"
          else AsyncServeRuntime(policy, device="cpu"))
    try:
        _, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves)
    finally:
        if runtime == "async":
            rt.shutdown()
    assert not acct["errors"]
    jrt = JRuntime(JPolicy(max_batch=2, max_wait_s=1e9))
    for i, s in enumerate(specs):
        jrt.open(_jspec(s))
        for c in chop(waves[s.tenant_id], CHUNK, seed=i, jitter=0.5):
            jrt.submit(s.tenant_id, c)
    for s in specs:
        want = np.asarray(jrt.close(s.tenant_id))
        got = client.symbols(s.tenant_id)
        assert got.shape == want.shape == (600,)
        np.testing.assert_array_equal(got, want)


def test_wire_fp32_bf16_tenants_hold_jax_engine_bounds(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=52, reorder_window=6, dup_prob=0.2)
    specs = [_spec("f32", 141), _spec("b16", 142, "fused_bf16")]
    waves = {s.tenant_id: _wave(510 + i) for i, s in enumerate(specs)}
    rt = _sync(BatchPolicy(max_batch=2, max_wait_s=1e9))
    _, client, acct = _run_wire(rt, cli_t, srv_t, specs, waves)
    assert not acct["errors"]
    for s in specs:
        got = client.symbols(s.tenant_id)
        np.testing.assert_array_equal(got, _offline(s, waves[s.tenant_id]))
        want = _jax_offline(s, waves[s.tenant_id])
        if s.backend == "fused_bf16":
            np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("direction", ["port_client_ref_gateway",
                                       "ref_client_port_gateway"])
def test_either_packages_client_drives_the_others_gateway(direction):
    """The two packages speak one wire: a client of one package opens an
    int8 tenant over the control plane of the other's gateway, streams
    int8 frames through an impaired loopback and closes; the symbols equal
    the JAX oracle exactly."""
    spec = _spec("x8", 151, "fused_int8")
    wave = _wave(520)
    sch = dict(seed=53, reorder_window=4, dup_prob=0.2)
    if direction == "port_client_ref_gateway":
        cli_t, srv_t = loopback_pair(WireSchedule(**sch),
                                     WireSchedule(**{**sch, "seed": 54}))
        # the ends cross: the port's client writes into the reference's
        # gateway through the port's pipes, which carry plain bytes
        rt = JRuntime(JPolicy(max_batch=1, max_wait_s=1e9))
        gw, client = JGateway(rt, srv_t), NetClient(cli_t)
    else:
        cli_t, srv_t = jtransport.loopback_pair(
            jtransport.WireSchedule(**sch),
            jtransport.WireSchedule(**{**sch, "seed": 54}))
        rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
        gw, client = NetGateway(rt, srv_t), JClient(cli_t)
    ack = client.open("x8", CFG, spec.weights, formats=INT8_FMT,
                      backend="fused_int8", tile_m=TILE_M, pump=gw.step)
    assert ack["backend"] == "fused_int8" and int(ack["wire_dtype"]) == 1
    assert (ack["a_int"], ack["a_frac"]) == INT8_FMT[0][2:]
    acct = replay_wire(gw, client, {"x8": chop(wave, CHUNK, seed=0)},
                       burst=3)
    assert not acct["errors"]
    np.testing.assert_array_equal(client.symbols("x8"),
                                  _jax_offline(spec, wave))
    assert client.close("x8", pump=gw.step)["syms_emitted"] == 480


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

def test_control_open_swap_splice_close(loopback_wire):
    """Two tenants opened via wire OPEN; t_swap hot-swaps weights via a
    control frame mid-stream — the bitwise-per-epoch splice must hold
    end-to-end through the wire; the other tenant is untouched."""
    cli_t, srv_t = loopback_wire(seed=41, reorder_window=3, dup_prob=0.15)
    rt = _sync(BatchPolicy(max_batch=2, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    w_old, w_new = _weights(120), _weights(121)
    ack0 = client.open("swp", CFG, w_old, backend="fused_fp32",
                       tile_m=TILE_M, pump=gw.step)
    ack1 = client.open("i8", CFG, _weights(122), formats=INT8_FMT,
                       backend="fused_int8", tile_m=TILE_M, pump=gw.step)
    assert ack0["ok"] and ack0["granted"] > 0
    assert ack1["backend"] == "fused_int8" and ack1["a_frac"] == INT8_FMT[0][3]

    waves = {"swp": _wave(380), "i8": _wave(381)}
    chunks = {t: chop(waves[t], CHUNK, seed=0) for t in waves}
    half = len(chunks["swp"]) // 2
    for t in waves:
        for c in chunks[t][:half]:
            client.send_samples(t, c)
    gw.settle()
    client.poll(max_datagrams=256)

    swap_ack = client.swap_weights("swp", w_new, pump=gw.step)
    assert swap_ack["epoch"] == 1

    for t in waves:
        for c in chunks[t][half:]:
            client.send_samples(t, c)
        client.finish(t)
    acct = replay_wire(gw, client, {"swp": [], "i8": []})
    assert not acct["errors"]

    sess = rt.sessions.get("swp")
    (_, p0), (_, p1) = sess.swap_log
    assert p0 == 0 and p1 > 0
    vp = CFG.v_parallel
    off_old = _offline(_spec("swp", 120), waves["swp"])
    off_new = _offline(dataclasses.replace(_spec("swp", 121),
                                           weights=w_new), waves["swp"])
    want = np.concatenate([off_old[: p1 * vp], off_new[p1 * vp:]])
    np.testing.assert_array_equal(client.symbols("swp"), want)
    np.testing.assert_array_equal(
        client.symbols("i8"),
        _offline(_spec("i8", 122, "fused_int8"), waves["i8"]))

    assert client.close("swp", pump=gw.step)["syms_emitted"] == want.shape[0]
    assert client.close("i8", pump=gw.step)["ok"]
    assert "swp" not in rt.sessions and "i8" not in rt.sessions


def test_control_rollback_over_wire(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=42, impair_both=False)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    client.open("rb", CFG, _weights(130), backend="fused_fp32",
                tile_m=TILE_M, pump=gw.step)
    assert client.swap_weights("rb", _weights(131),
                               pump=gw.step)["epoch"] == 1
    assert client.rollback_weights("rb", pump=gw.step)["epoch"] == 2


def test_control_duplicate_command_executes_once(loopback_wire):
    """A CTRL frame the wire duplicates executes once: the second copy
    draws the cached ack and burns no weight epoch; the ack cache keeps at
    most `ACK_CACHE` command ids."""
    cli_t, srv_t = loopback_wire(seed=46, impair_both=False)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    client.open("d", CFG, _weights(135), backend="fused_fp32",
                tile_m=TILE_M, pump=gw.step)
    from repro_torch.net import Reg, pack_control, weights_to_arrays
    swap = encode_frame(FrameType.CTRL, "d", 500, pack_control(
        {"reg": Reg.SWAP_WEIGHTS}, weights_to_arrays(_weights(136))))
    cli_t.send(swap)
    cli_t.send(swap)
    gw.step()
    acks = []
    while (d := cli_t.recv()) is not None:
        f = decode_frame(d)
        if f.ftype == FrameType.ACK:
            acks.append(d)
    assert len(acks) == 2 and acks[0] == acks[1]
    assert rt.sessions.get("d").weight_epoch == 1
    assert rt.obs.snapshot()["net"]["ctrl_commands"] == 2   # open + swap
    for seq in range(1000, 1000 + ControlPlane.ACK_CACHE + 10):
        cli_t.send(encode_frame(FrameType.CTRL, "_", seq, pack_control(
            {"reg": Reg.READ_STATS})))
    gw.settle()
    assert len(gw.control._acked) == ControlPlane.ACK_CACHE


def test_control_malformed_and_unknown_leave_sessions_untouched(
        loopback_wire):
    cli_t, srv_t = loopback_wire(seed=43, impair_both=False)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    spec = _spec("live", 140)
    wave = _wave(390)
    client.open("live", CFG, _weights(140), backend="fused_fp32",
                tile_m=TILE_M, pump=gw.step)
    before = rt.stats()["tenants"]

    with pytest.raises(ControlAckError, match="unknown register"):
        client.command("live", {"reg": 999}, pump=gw.step)
    with pytest.raises(ControlAckError):   # wrong field type
        client.command("live", {"reg": 5, "max_batch": "huge"},
                       pump=gw.step)
    # raw garbage in a CTRL frame: error ack, not a crash
    cli_t.send(encode_frame(FrameType.CTRL, "live", 7777, b"\x00garbage"))
    gw.step()
    client.poll()
    assert client._acks.pop(7777)["ok"] is False
    # swap for a tenant that does not exist: error ack, sessions intact
    with pytest.raises(ControlAckError):
        client.swap_weights("ghost", _weights(1), pump=gw.step)

    assert rt.stats()["tenants"] == before
    sess = rt.sessions.get("live")
    assert sess.weight_epoch == 0 and sess.swap_log == [(0, 0)]
    # ... and the session still serves, bitwise
    acct = replay_wire(gw, client, {"live": chop(wave, CHUNK, seed=0)})
    assert not acct["errors"]
    np.testing.assert_array_equal(client.symbols("live"),
                                  _offline(spec, wave))


def test_control_policy_and_stats(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=44, impair_both=False)
    rt = _sync(BatchPolicy(max_batch=8, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    ack = client.set_policy(max_batch=2, pump=gw.step)
    assert ack["policy"]["max_batch"] == 2
    assert rt.batcher.policy.max_batch == 2
    assert rt.batcher.policy.max_wait_s == 1e9      # untouched knob
    stats = client.read_stats(pump=gw.step)["stats"]
    assert stats["tenants"] == 0


def test_control_stats_of_a_live_async_runtime_are_json():
    """READ_STATS of a runtime that has served: every value JSON-native,
    none a `repr`; tensors become lists, torch devices and dtypes names."""
    with AsyncServeRuntime(BatchPolicy(max_batch=2, max_wait_s=2e-3),
                           device="cpu") as rt:
        spec = _spec("s0", 160, "fused_int8")
        rt.open(spec)
        rt.submit("s0", _wave(530))
        rt.close("s0")
        clean = _jsonable(rt.stats())
    assert json.loads(json.dumps(clean)) == clean
    assert "tensor(" not in json.dumps(clean)
    extra = _jsonable({"t": torch.arange(3, dtype=torch.int8),
                       "d": torch.device("cpu"), "dt": torch.bfloat16,
                       "b": np.bool_(True), "f": np.float32(0.5)})
    assert extra == {"t": [0, 1, 2], "d": "cpu", "dt": "torch.bfloat16",
                     "b": True, "f": 0.5}


def test_close_while_symbols_in_flight_is_refused(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=45, impair_both=False)
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    gw = NetGateway(rt, srv_t)
    client = NetClient(cli_t)
    client.open("c0", CFG, _weights(150), backend="fused_fp32",
                tile_m=TILE_M, pump=gw.step)
    client.send_samples("c0", _wave(400))
    with pytest.raises(ControlAckError, match="close before EOS"):
        client.close("c0", pump=gw.step)
    # the refusal changed nothing — the stream is still attached (close()
    # only detaches on success): finish cleanly and close for real
    assert "c0" in client.streams
    client.finish("c0")
    acct = replay_wire(gw, client, {"c0": []})
    assert not acct["errors"]
    assert client.close("c0", pump=gw.step)["ok"]


def test_report_net_section_matches_reference(loopback_wire):
    cli_t, srv_t = loopback_wire(seed=47, reorder_window=3, dup_prob=0.2)
    specs = [_spec("r0", 170)]
    rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
    _run_wire(rt, cli_t, srv_t, specs, {"r0": _wave(540)})
    net = rt.obs.snapshot()["net"]
    text = treport.render({"net": net})
    assert text == "\n".join(jreport._net_section(net))
    assert "frames:" in text and "ingress_to_emit_s" in text


# ---------------------------------------------------------------------------
# UDP transport smoke
# ---------------------------------------------------------------------------

def test_udp_transport_end_to_end():
    try:
        srv_t = UdpTransport(bind=("127.0.0.1", 0))
        cli_t = UdpTransport(bind=("127.0.0.1", 0), remote=srv_t.address)
    except OSError as e:
        pytest.skip(f"no UDP sockets in this sandbox: {e}")
    try:
        spec = _spec("udp", 160)
        wave = _wave(410)
        rt = _sync(BatchPolicy(max_batch=1, max_wait_s=1e9))
        gw = NetGateway(rt, srv_t)
        client = NetClient(cli_t)
        # over real sockets the CLIENT must speak first (the server only
        # learns its peer from the first datagram) — so open over the
        # control plane, exactly as a remote deployment would
        ack = client.open("udp", CFG, _weights(160), backend="fused_fp32",
                          tile_m=TILE_M, pump=gw.step)
        assert ack["ok"]
        acct = replay_wire(gw, client, {"udp": chop(wave, CHUNK, seed=0)},
                           max_rounds=2_000)
        assert not acct["errors"]
        np.testing.assert_array_equal(client.symbols("udp"),
                                      _offline(spec, wave))
        assert client.close("udp", pump=gw.step)["ok"]
    finally:
        srv_t.close()
        cli_t.close()

"""Card-only tests of the port: the hand-written kernels on an NVIDIA card.

Every test here needs a CUDA card and skips without one (the decision is
made inside the `cuda_device` fixture, never at import). This file imports
no jax, so it also runs on the card's host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain version (`ref.py`) bitwise on the card at
any tile width, stacked or shared weights, and the serving path must run
through the kernels. The register-blocked kernel (`cnn_eq_kernel_rb`,
fp32, bf16 and int8) also equals the generic one forced on the same
inputs, at one row and at 64, shorter than the receptive field, at one
position, at a run that ends past the positions, at 7320 symbols, at any
tile_m (8192 too), with per-channel int8 formats and with saturating int8
inputs; `_plan` names the library's `cnn_eq_plan`, every run the sweep
times covers every position bitwise, and other widths take the generic
kernel. The same holds for the Volterra, fixed-point-quantize and conv1d
kernels, in float32, bfloat16 and float16 (x's type out): the
register-blocked Volterra kernel (`volterra_kernel_rb`, the deployed
baseline (25, 9, 0) at N_os = 2) equals the plain version and the generic
kernel forced at a run shorter than the plan's, at n_out not a multiple of
P, at an odd width, at one row, at one symbol and on a strided view, and
`volterra._plan` names the library's `volterra_plan`; the per-tensor
quant kernel holds at lengths 1 to 64 × 14 640 and at views that start
off a 16-byte boundary; `quantize_params` makes one launch; the
register-blocked conv1d kernel (`conv1d_kernel_rb`, the
deployed CNN's three layer shapes) equals the plain version and the
generic kernel forced, with no padding and with SAME_LOWER padding read
in the kernel, at a width shorter than one run, at one output position
and on a strided view, and `conv1d._plan` names the library's
`conv1d_plan`; the training path runs on the card. Two QAT
trainings of the CNN from one seed give bitwise-equal parameters and
widths (cuDNN held to its deterministic algorithms). The flash-attention
kernel agrees with its plain version within f32 atol 2e-5 and bf16 atol
2e-2 (its online softmax sums in another order, so not bitwise), also at
the bf16 tensor-core tiles' edges (S = 63, 64, 65, 129, 2049; D = 80,
112; a window ending inside a tile); its f32 instances give bitwise the
output they gave before the bf16 redesign; the bf16 wrappers refuse rows
that do not start on 16-byte boundaries and launch nothing; and LM
serving launches it once per layer per prefill and never while
decoding. The training kernels (forward with lse, dK/dV, dQ) agree
with their plain versions (o f32 atol 2e-5 / bf16 2e-2, lse atol 1e-5,
backward f32 atol 5e-4 — the bound the reference holds its own backward
to — and bf16 within one bf16 rounding: |diff| ≤ 1e-2·|want| +
1e-3·max|want|, since kernel and plain both round an f32 result once and
their f32 sums differ only in order); the bf16 tensor-core backward
holds that bound at its tiles' edges (S = 1 at an offset, 63, 64, 65,
127, 129, 2049; D = 48, 80, 112, 128; GQA 1, 2, 4, 8) and gives the same
bits on a second call, its f32 instances give bitwise the dq, dk, dv they
gave before the redesign, and the backward wrappers refuse an unaligned
bf16 do while the training Function copies one; a fused model's loss has
gradients through attention on the card, and training launches the three
training kernels and never the serving one. The sLSTM kernels agree with their plain
version within atol 1e-4 (the reference's bound on its own kernel) in f32
and bf16, through the plan the shape takes (which must be the library's
own, and whose kernel must be the one that ran): the cluster kernel at
dh = 192, 99 (ragged columns), 32 and 8, with a ragged row group (B = 5)
and at S = 1, and the stream kernel at dh = 1024; the cluster kernel
also at geometries the plan does not take (CTAs with no column at Q = 16,
ragged row groups at RB = 2 and 4, Q = 7). The cluster kernel gives the
same bits on a second launch, a split pass equals one pass bitwise, the
wrapper refuses a bad type, a bad shape and autograd, and xlstm serving
launches the cluster kernel once per sLSTM block per prefill and decode
step. The streaming slice: `partitioned_apply` over 8 and 64 instances of
7320 symbols equals the unsplit engine bitwise on the interior in every
datapath, through the register-blocked kernel; under the profiler, the
hot spans (`repro_torch.obs.trace`) of 64 x 468,480-symbol int8 batches
record one launch a batch, mirror nothing onto the device timeline, time
the partition's copies with their CUDA events within 10 % of the
profiler's device time, and leave the outputs bitwise; `AsyncServeRuntime`
on the card equals `ServeRuntime` and the offline engine bitwise, and every
execute — on the launcher thread or the deadline watchdog's worker — runs
on the runtime's own CUDA stream. The wire slice: streams served over the
impaired loopback (int8, BF16 and fp32 wires; sync and async runtimes)
equal the offline engine bitwise through the register-blocked kernel, an
int8 wire equals an fp32 wire, and `drift_streams` draws on the card,
repeating bitwise and at t = 0 within 1e-4 of the stationary simulator.
The adaptation and fleet slice: a weight hot-swap mid-stream (sync and
async, fp32 and int8) equals each epoch's offline engine bitwise through
the register-blocked kernel; a two-worker `FleetRuntime` on one card
migrates every stream bitwise when worker 0 is lost, each worker executing
on its own stream; the `OnlineAdapter`'s thread (on its own stream) runs
under live async traffic with no error, losing and duplicating nothing;
one adapter run twice gives the same history and weights bitwise.
The parallel slice: two gloo ranks on one card shard a stream through the
int8 halo exchange and give the unsplit engine's symbols bitwise, one
kernel launch a rank; `grad_comp.compress` on the card equals the host's.
"""
import dataclasses
import hashlib
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs as lm_configs
from repro_torch.configs import equalizer_ht as HT
from repro_torch.core import equalizer as teq
from repro_torch.core import fir as tfir
from repro_torch.core import qat
from repro_torch.core import train_eq as ttrain
from repro_torch.core.engine import EqualizerEngine, stacked_engine_fn
from repro_torch.data import equalizer_data as tdata
from repro_torch.kernels.cnn_eq import cnn_eq as kern
from repro_torch.kernels.cnn_eq import ref
from repro_torch.kernels.conv1d import conv1d as c1_kern
from repro_torch.kernels.conv1d import ops as c1_ops
from repro_torch.kernels.conv1d import ref as c1_ref
from repro_torch.kernels.flash_attn import flash_attn as fa
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.quant import ops as q_ops
from repro_torch.kernels.quant import quant as q_kern
from repro_torch.kernels.quant import ref as q_ref
from repro_torch.kernels.slstm import ref as sl_ref
from repro_torch.kernels.slstm import slstm as sl_kern
from repro_torch.kernels.volterra import volterra as v_kern
from repro_torch.kernels.volterra import ref as v_ref
from repro_torch.data import pipeline as lm_data
from repro_torch.device import fp32_exact
from repro_torch import interop
from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.models import attention as lm_attn
from repro_torch.models import registry as lm_registry
from repro_torch.core import stream_partition as sp
from repro_torch import net
from repro_torch.channels import imdd, proakis
from repro_torch.channels.drift import (DriftingIMDD, DriftingProakis,
                                        DriftSchedule)
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy, MicroBatcher,
                               ServeRuntime, TenantSpec, chop, loadgen,
                               replay_wire)

FMTS = ((2, 5, 3, 4),) * 3
QAT = {"w_int": 2.0, "w_frac": 5.0, "a_int": 3.0, "a_frac": 4.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda", 0)


def _folded(seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    p = teq.init(gen, HT.CNN, device="cpu")
    w = teq.folded_weights(teq.fold_bn(
        p, teq.init_bn_state(HT.CNN, device="cpu"), HT.CNN))
    return tuple((wi.to(device), bi.to(device)) for wi, bi in w)


def _x(rows, n_syms, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((rows, n_syms * 2)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_kernels_equal_plain_versions_on_card(cuda_device, stacked):
    st = teq.layer_strides(HT.CNN)
    rows = 4
    per = [_folded(s, cuda_device) for s in range(rows)]
    if stacked:
        w = tuple((torch.stack([p[l][0] for p in per]),
                   torch.stack([p[l][1] for p in per])) for l in range(3))
        q = tuple((torch.stack([kern.quantize_weights_int8(p, FMTS)[l][0]
                                for p in per]), w[l][1]) for l in range(3))
    else:
        w, q = per[0], kern.quantize_weights_int8(per[0], FMTS)
    x_cpu = _x(rows, 1003, seed=1)
    x = x_cpu.to(cuda_device)
    wants = {"fp32": ref.cnn_eq(x, w, st), "bf16": ref.cnn_eq_bf16(x, w, st),
             "int8": ref.cnn_eq_int8(x, q, st, FMTS)}
    for tile_m in (16, 64, 256):
        before = dict(kern.LAUNCHES)
        got = {"fp32": kern.cnn_eq_fused(x, w, st, tile_m),
               "bf16": kern.cnn_eq_fused_bf16(x, w, st, tile_m),
               "int8": kern.cnn_eq_fused_int8(x, q, st, FMTS, tile_m)}
        torch.cuda.synchronize()
        for name in kern.LAUNCHES:
            assert kern.LAUNCHES[name] == before[name] + 1
        for dp in got:
            assert got[dp].is_cuda
            assert torch.equal(got[dp], wants[dp]), (dp, tile_m)
    # the card's kernels also equal the plain versions run on the host
    w_cpu = tuple((a.cpu(), b.cpu()) for a, b in w)
    assert torch.equal(got["fp32"].cpu(), ref.cnn_eq(x_cpu, w_cpu, st))


@pytest.mark.cuda
def test_engine_defaults_to_card_and_stacks(cuda_device):
    engines = [EqualizerEngine(cfg=HT.CNN, weights=_folded(s), tile_m=64)
               for s in (5, 6)]
    assert engines[0].device.type == "cuda"
    x = _x(2, 700, seed=2).to(cuda_device)
    y = stacked_engine_fn(engines)(x)
    for i, e in enumerate(engines):
        assert torch.equal(y[i:i + 1], e(x[i:i + 1]))


@pytest.mark.cuda
def test_serve_runtime_on_card_is_bitwise_offline(cuda_device):
    rng = np.random.default_rng(3)
    specs = []
    for i, qat in enumerate([QAT, QAT, None]):
        p = teq.init(torch.Generator().manual_seed(10 + i), HT.CNN,
                     device="cpu")
        if qat is not None:
            p["qat"] = {f"layer{l}": dict(qat) for l in range(3)}
        specs.append(TenantSpec(f"t{i}", HT.CNN, params=p, tile_m=32))
    waves = {s.tenant_id: rng.standard_normal(2 * 900).astype(np.float32)
             for s in specs}
    kern.reset_launch_counts()
    rt = ServeRuntime(BatchPolicy(max_batch=2))
    for s in specs:
        rt.open(s)
    for start in range(0, 1800, 333):
        for tid, w in waves.items():
            rt.submit(tid, w[start:start + 333])
    outs = {tid: rt.close(tid) for tid in waves}
    assert kern.LAUNCHES["cnn_eq_fused_int8"] > 0
    assert kern.LAUNCHES["cnn_eq_fused"] > 0
    for s in specs:
        want = s.build_engine()(waves[s.tenant_id]).cpu().numpy()
        np.testing.assert_array_equal(outs[s.tenant_id], want)


SLICE_QAT = {"int8": QAT, "bf16": {"w_int": 3.0, "w_frac": 8.0,
                                   "a_int": 3.0, "a_frac": 8.0},
             "fp32": None}
SLICE_BACKEND = {"int8": "fused_int8", "bf16": "fused_bf16",
                 "fp32": "fused_fp32"}


def _slice_spec(tid, dp, seed):
    p = teq.init(torch.Generator().manual_seed(seed), HT.CNN, device="cpu")
    if SLICE_QAT[dp] is not None:
        p["qat"] = {f"layer{l}": dict(SLICE_QAT[dp]) for l in range(3)}
    return TenantSpec(tid, HT.CNN, params=p)


@pytest.mark.cuda
@pytest.mark.parametrize("dp", ["int8", "bf16", "fp32"])
def test_partitioned_equals_unsplit_bitwise_on_card(cuda_device, dp):
    engine = _slice_spec("p", dp, 40).build_engine(cuda_device)
    assert engine.backend == SLICE_BACKEND[dp]
    for n_inst in (8, 64):
        x = _x(1, 7320 * n_inst, seed=n_inst)[0].to(cuda_device)
        kern.reset_launch_counts()
        y_split = sp.partitioned_apply(engine, x, n_inst, HT.CNN)
        y_full = engine(x)
        assert kern.INSTANCE_LAUNCHES == {"rb": 2, "generic": 0}
        o = sp.overlap_symbols(HT.CNN)
        assert y_split.shape == y_full.shape == (7320 * n_inst,)
        assert torch.equal(y_split[o:-o], y_full[o:-o]), (dp, n_inst)
        # the split's chunks are a view whose rows overlap (row stride <
        # width), read by the kernel with no copy: kernel == plain there
        o_act = sp.actual_overlap(HT.CNN, n_inst)
        chunks = sp.split_with_overlap(x, n_inst, o_act, HT.CNN.n_os)
        assert chunks.stride(0) < chunks.shape[1]
        strides = teq.layer_strides(HT.CNN)
        w = engine._layer_weights()
        want = (ref.cnn_eq_int8(chunks, w, strides, engine.formats)
                if dp == "int8" else
                ref.cnn_eq_bf16(chunks, w, strides) if dp == "bf16" else
                ref.cnn_eq(chunks, w, strides))
        got = engine(chunks)
        assert torch.equal(got, want), (dp, n_inst)
        assert torch.equal(sp.merge_with_overlap_removal(got, o_act),
                           y_split)


@pytest.mark.cuda
def test_hot_spans_time_the_partition_on_card(cuda_device):
    """Under the profiler, 64 x 468,480 int8 stream batches record one
    `eq.cnn_eq.launch` a batch (as many as the rb kernel's launches), the
    spans mirror nothing onto the device timeline, the split's and
    merge's CUDA events time the kernels other than cnn_eq's within 10 %,
    and the outputs equal those with the spans off bitwise. A spin kernel
    first keeps the card busy while the batches are enqueued, so that the
    events time the device's work and not the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import trace
    engine = _slice_spec("spans", "int8", 41).build_engine(cuda_device)
    assert engine.backend == "fused_int8"
    n_inst, l_inst, batches = 64, 468480, 8
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(n_inst * l_inst * HT.CNN.n_os, generator=gen,
                    device=cuda_device)
    y_off = sp.partitioned_apply(engine, x, n_inst, HT.CNN)
    torch.cuda.synchronize()
    trace.clear_spans()
    kern.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000_000)
        ys = [sp.partitioned_apply(engine, x, n_inst, HT.CNN)
              for _ in range(batches)]
        torch.cuda.synchronize()
    try:
        recs = trace.span_records()
    finally:
        trace.clear_spans()
    assert all(torch.equal(y, y_off) for y in ys)
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert len(by["eq.partition"]) == batches
    assert len(by["eq.cnn_eq.launch"]) == batches
    assert kern.INSTANCE_LAUNCHES == {"rb": batches, "generic": 0}
    engines = {r.sid for r in by["eq.engine"]}
    assert all(r.parent in engines for r in by["eq.cnn_eq.launch"])
    spans_ms = sum(r.device_ms for r in by["eq.partition.split"]
                   + by["eq.partition.merge"])
    dev = [(e.name, e.time_range.elapsed_us() * 1e-3) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    assert not [n for n, _ in dev if n.startswith("eq.")], dev
    other_ms = sum(ms for n, ms in dev
                   if "cnn_eq" not in n and "spin_kernel" not in n)
    assert abs(spans_ms - other_ms) <= 0.1 * other_ms, (spans_ms, other_ms,
                                                        sorted(set(dev)))


def _slice_tenants():
    specs = [_slice_spec(f"{dp}-{i}", dp, 50 + 3 * i + j)
             for j, dp in enumerate(("int8", "bf16", "fp32"))
             for i in range(2)]
    rng = np.random.default_rng(4)
    waves = {s.tenant_id: rng.standard_normal(2 * 1500).astype(np.float32)
             for s in specs}
    streams = {t: chop(w, 400, seed=i) for i, (t, w) in
               enumerate(sorted(waves.items()))}
    return specs, waves, streams


def _serve_streams(rt, specs, streams):
    for s in specs:
        rt.open(s)
    iters = {t: iter(c) for t, c in streams.items()}
    live = set(iters)
    while live:
        for t in sorted(live):
            c = next(iters[t], None)
            if c is None:
                live.discard(t)
            else:
                rt.submit(t, c)
    return {t: rt.close(t) for t in sorted(streams)}


@pytest.mark.cuda
def test_async_runtime_on_card_equals_sync_bitwise(cuda_device):
    specs, waves, streams = _slice_tenants()
    sync = _serve_streams(ServeRuntime(BatchPolicy(max_batch=3)), specs,
                          streams)
    kern.reset_launch_counts()
    with AsyncServeRuntime(BatchPolicy(max_batch=3)) as rt:
        assert rt.device.type == "cuda" and rt.stream is not None
        got = _serve_streams(rt, specs, streams)
    assert kern.INSTANCE_LAUNCHES["generic"] == 0
    assert kern.INSTANCE_LAUNCHES["rb"] == sum(kern.LAUNCHES.values()) > 0
    for s in specs:
        tid = s.tenant_id
        np.testing.assert_array_equal(got[tid], sync[tid])
        want = s.build_engine(cuda_device)(waves[tid]).cpu().numpy()
        np.testing.assert_array_equal(got[tid], want)


@pytest.mark.cuda
@pytest.mark.parametrize("deadline", [None, 60.0])
def test_async_launches_run_on_the_launchers_stream_on_card(
        cuda_device, monkeypatch, deadline):
    """Every execute — on the launcher thread, or on the watchdog's worker
    thread when a deadline is set — runs with the runtime's own stream
    current, never the default stream."""
    kern._load()                      # built before any deadline runs
    seen = []
    orig = MicroBatcher.execute

    def recording_execute(self, batch):
        seen.append((torch.cuda.current_stream(batch.device).cuda_stream,
                     threading.current_thread().name))
        return orig(self, batch)

    monkeypatch.setattr(MicroBatcher, "execute", recording_execute)
    specs, waves, streams = _slice_tenants()
    with AsyncServeRuntime(BatchPolicy(max_batch=3),
                           launch_deadline_s=deadline) as rt:
        own = rt.stream.cuda_stream
        got = _serve_streams(rt, specs, streams)
    assert seen
    assert own != torch.cuda.default_stream(cuda_device).cuda_stream
    assert {s for s, _ in seen} == {own}
    want_thread = ("serve-watchdog-exec" if deadline is not None
                   else "serve-launcher")
    assert {t for _, t in seen} == {want_thread}
    for s in specs:
        want = s.build_engine(cuda_device)(waves[s.tenant_id]).cpu().numpy()
        np.testing.assert_array_equal(got[s.tenant_id], want)


def _wire_serve(rt, specs, streams, wire_of, seed):
    """`replay_wire` of the streams through a NetClient, an impaired
    loopback (reorder window 6, duplicates 0.2, both ways) and a
    NetGateway over ``rt``; returns the client, the accounting and the
    runtime's net counters."""
    cli_t, srv_t = net.loopback_pair(
        net.WireSchedule(seed, reorder_window=6, dup_prob=0.2),
        net.WireSchedule(seed + 1, reorder_window=6, dup_prob=0.2))
    gw, client = net.NetGateway(rt, srv_t), net.NetClient(cli_t)
    for s in specs:
        sess = rt.open(s)
        gw.open_wire(s.tenant_id)
        client.attach(s.tenant_id, wire_of[s.tenant_id],
                      grid=net.wire_grid(sess.engine))
    acct = replay_wire(gw, client, streams, burst=4)
    return client, acct, rt.obs.snapshot()["net"]


@pytest.mark.cuda
@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_wire_serving_bitwise_on_card(cuda_device, runtime):
    """The packetized wire on the card: int8 tenants on an int8 wire (and
    one on an fp32 wire: the same symbols, contract #12), a bf16 tenant on
    a BF16 wire (offline on the decoded waveform), the rest fp32; every
    stream == its offline engine bitwise under reordering and duplication,
    through the register-blocked kernel."""
    specs, waves, _ = _slice_tenants()
    twin = dataclasses.replace(specs[0], tenant_id="int8-0-fp32wire")
    specs.append(twin)
    waves[twin.tenant_id] = waves[specs[0].tenant_id]
    wire_of = {s.tenant_id: (net.WireDtype.INT8 if s.tenant_id.startswith(
        "int8") else net.WireDtype.FP32) for s in specs}
    wire_of["bf16-0"] = net.WireDtype.BF16
    wire_of[twin.tenant_id] = net.WireDtype.FP32
    streams = {s.tenant_id: chop(waves[s.tenant_id], 400, seed=i)
               for i, s in enumerate(specs)}
    kern.reset_launch_counts()
    policy = BatchPolicy(max_batch=3)
    if runtime == "sync":
        client, acct, counters = _wire_serve(ServeRuntime(policy), specs,
                                             streams, wire_of, 61)
    else:
        with AsyncServeRuntime(policy) as rt:
            client, acct, counters = _wire_serve(rt, specs, streams,
                                                 wire_of, 61)
    assert not acct["errors"]
    assert counters["duplicates"] > 0 and counters["reordered"] > 0
    assert kern.INSTANCE_LAUNCHES["generic"] == 0
    assert kern.INSTANCE_LAUNCHES["rb"] == sum(kern.LAUNCHES.values()) > 0
    for s in specs:
        wave = waves[s.tenant_id]
        if wire_of[s.tenant_id] == net.WireDtype.BF16:
            wave = net.decode_samples(net.encode_samples(
                wave, net.WireDtype.BF16), net.WireDtype.BF16)
        want = s.build_engine(cuda_device)(wave).cpu().numpy()
        np.testing.assert_array_equal(client.symbols(s.tenant_id), want)
    np.testing.assert_array_equal(client.symbols("int8-0"),
                                  client.symbols(twin.tenant_id))


@pytest.mark.cuda
@pytest.mark.parametrize("channel", [DriftingProakis(), DriftingIMDD()],
                         ids=["proakis", "imdd"])
def test_drift_draw_on_card(cuda_device, channel):
    """drift_streams draws on the card: the same seed repeats bitwise, and
    at t = 0 every burst equals the stationary simulator on the same
    generator within the channels' bound (atol 1e-4)."""
    sch = DriftSchedule(2, 2)
    streams, pilots = loadgen.drift_streams(channel, sch, ["a", "b"], 4,
                                            7320, seed=9)
    again, _ = loadgen.drift_streams(channel, sch, ["a", "b"], 4, 7320,
                                     seed=9)
    sim = (proakis.simulate if isinstance(channel, DriftingProakis)
           else imdd.simulate)
    for i, t in enumerate(("a", "b")):
        for burst in range(4):
            rx = streams[t][burst]
            assert rx.shape == (14640,) and np.isfinite(rx).all()
            np.testing.assert_array_equal(rx, again[t][burst])
            if sch.t_at(burst) == 0.0:
                want, syms = sim(loadgen._burst_generator(
                    9, burst, i, cuda_device), channel.cfg, 7320,
                    device=cuda_device)
                np.testing.assert_array_equal(pilots[t][burst],
                                              syms.cpu().numpy())
                np.testing.assert_allclose(rx, want.cpu().numpy(), rtol=0,
                                           atol=1e-4)


@pytest.mark.cuda
def test_tile_too_large_for_shared_memory_raises(cuda_device):
    st = teq.layer_strides(HT.CNN)
    w = _folded(0, cuda_device)
    x = _x(1, 64, seed=4).to(cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        kern._forced("generic", kern.MODE_FP32, x, w, st, tile_m=8192)
    # a tile that fits still runs and equals the plain version, and the
    # wrapper (the register-blocked kernel, which takes no tile) runs at any
    want = ref.cnn_eq(x, w, st)
    assert torch.equal(
        kern._forced("generic", kern.MODE_FP32, x, w, st, tile_m=1024), want)
    assert torch.equal(kern.cnn_eq_fused(x, w, st, tile_m=8192), want)


# the register-blocked kernel's cases: (rows, samples, tile_m, input scale,
# per-channel int8 formats); its run is the plan's w_run positions, a
# position 16 samples, the receptive field 137 samples
RB_CASES = {
    "rows1": (1, 2006, 64, 1.0, False),
    "rows4": (4, 2006, 16, 1.0, False),
    "rows64": (64, 2006, 256, 1.0, False),
    "shorter_than_receptive_field": (4, 100, 64, 1.0, False),
    "one_position": (4, 16, 64, 1.0, False),
    "ragged_run": (4, 16 * 197 + 9, 64, 1.0, False),
    "7320_symbols": (4, 14640, 64, 1.0, False),
    "tile_8192": (4, 2006, 8192, 1.0, False),
    "per_channel_formats": (4, 2006, 64, 1.0, True),
    "saturating": (4, 2006, 64, 40.0, False),
}


def _rb_case(device, dp, stacked, case):
    rows, width, tile_m, scale, per_channel = RB_CASES[case]
    st = teq.layer_strides(HT.CNN)
    rng = np.random.default_rng(7)
    x = torch.from_numpy((scale * rng.standard_normal((rows, width))).astype(
        np.float32)).to(device)
    per = [_folded(s, device) for s in range(rows if stacked else 1)]
    fmts = (qat.per_channel_formats(per[0], FMTS) if per_channel else FMTS)
    if dp == "int8":
        per = [kern.quantize_weights_int8(w, fmts) for w in per]
    w = (tuple((torch.stack([p[l][0] for p in per]),
                torch.stack([p[l][1] for p in per])) for l in range(3))
         if stacked else per[0])
    return x, w, st, fmts, tile_m


MODES = {"fp32": kern.MODE_FP32, "bf16": kern.MODE_BF16,
         "int8": kern.MODE_INT8}


@pytest.mark.cuda
@pytest.mark.parametrize("dp,stacked,case", [
    (dp, stacked, case) for dp in ("fp32", "bf16", "int8")
    for stacked in (False, True)
    for case in RB_CASES if dp == "int8" or not RB_CASES[case][4]])
def test_register_blocked_kernel_equals_plain_and_generic_on_card(
        cuda_device, dp, stacked, case):
    x, w, st, fmts, tile_m = _rb_case(cuda_device, dp, stacked, case)
    mode = MODES[dp]
    assert kern._plan(mode, kern._dims(w, st)) == "rb"
    if dp == "int8":
        want = ref.cnn_eq_int8(x, w, st, fmts)
        call = lambda: kern.cnn_eq_fused_int8(x, w, st, fmts, tile_m)  # noqa
    elif dp == "bf16":
        want = ref.cnn_eq_bf16(x, w, st)
        call = lambda: kern.cnn_eq_fused_bf16(x, w, st, tile_m)  # noqa
    else:
        want = ref.cnn_eq(x, w, st)
        call = lambda: kern.cnn_eq_fused(x, w, st, tile_m)  # noqa
    before = dict(kern.INSTANCE_LAUNCHES)
    got = call()
    torch.cuda.synchronize()
    n_pos = x.shape[1] // 16
    assert kern.INSTANCE_LAUNCHES["rb"] == before["rb"] + (n_pos > 0)
    assert kern.INSTANCE_LAUNCHES["generic"] == before["generic"]
    assert got.is_cuda and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    generic = kern._forced("generic", mode, x, w, st, min(tile_m, 1024),
                           formats=fmts)
    assert torch.equal(got, generic)


@pytest.mark.cuda
@pytest.mark.parametrize("dp", ["fp32", "bf16", "int8"])
def test_register_blocked_plan_is_the_librarys_on_card(cuda_device, dp):
    mode = MODES[dp]
    lib = kern._load()
    other = tuple((7, ci, co, s) for _, ci, co, s in kern._RB_DIMS)
    for m, dims in ((mode, kern._RB_DIMS), (kern.MODE_FP32, kern._RB_DIMS),
                    (mode, other), (mode, kern._RB_DIMS[:2])):
        assert kern._plan(m, dims) == kern._lib_plan(lib, m, dims).instance
    plan = kern._lib_plan(lib, mode, kern._RB_DIMS)
    assert plan.w_run >= 1 and plan.p in (2, 4) and plan.threads == 128
    assert 0 < plan.smem <= kern._MAX_SMEM_BYTES and plan.smem % 16 == 0
    # the runs cover every position, at each run the sweep times and at
    # runs that leave the last block ragged: into an output filled with
    # NaN, a position never stored stays NaN, and one stored by a block
    # whose window does not hold it differs from the plain version
    x, w, st, fmts, _ = _rb_case(cuda_device, dp, True, "ragged_run")
    if dp == "int8":
        want = ref.cnn_eq_int8(x, w, st, fmts)
        ws, scales = w, kern._int8_scales(fmts, w, x.device)
    elif dp == "bf16":
        want = ref.cnn_eq_bf16(x, w, st)
        ws, scales, fmts = kern.cast_weights_bf16(w), None, None
    else:
        want = ref.cnn_eq(x, w, st)
        ws, scales, fmts = w, None, None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for w_run in (1, 3, 16, 32, 60, 64, 100, 124, 128):
        out = torch.full_like(want, float("nan"))
        assert kern._rb_call(lib, mode, x, out, ws, st, True, fmts, scales,
                             stream, w_run) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), w_run


@pytest.mark.cuda
@pytest.mark.parametrize("dp,k", [("fp32", 7), ("bf16", 7), ("int8", 7)])
def test_other_widths_take_the_generic_kernel_on_card(cuda_device, dp, k):
    cfg = teq.CNNEqConfig(kernel=k)
    st = teq.layer_strides(cfg)
    gen = torch.Generator().manual_seed(3)
    w = tuple((a.to(cuda_device), b.to(cuda_device)) for a, b in
              teq.folded_weights(teq.fold_bn(
                  teq.init(gen, cfg, device="cpu"),
                  teq.init_bn_state(cfg, device="cpu"), cfg)))
    x = _x(2, 500, seed=8).to(cuda_device)
    before = dict(kern.INSTANCE_LAUNCHES)
    if dp == "fp32":
        got, want = kern.cnn_eq_fused(x, w, st), ref.cnn_eq(x, w, st)
    elif dp == "bf16":
        got, want = kern.cnn_eq_fused_bf16(x, w, st), ref.cnn_eq_bf16(x, w, st)
    else:
        q = kern.quantize_weights_int8(w, FMTS)
        got = kern.cnn_eq_fused_int8(x, q, st, FMTS)
        want = ref.cnn_eq_int8(x, q, st, FMTS)
    torch.cuda.synchronize()
    assert kern.INSTANCE_LAUNCHES["generic"] == before["generic"] + 1
    assert kern.INSTANCE_LAUNCHES["rb"] == before["rb"]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m1,m2,m3", [(25, 9, 0), (41, 15, 9), (121, 35, 15)])
def test_volterra_kernel_equals_plain_on_card(cuda_device, m1, m2, m3):
    g = torch.Generator().manual_seed(m1)
    w0 = torch.tensor(0.05)
    w1 = 0.3 * torch.randn(m1, generator=g)
    w2 = 0.1 * torch.randn((m2, m2), generator=g)
    w3 = 0.05 * torch.randn((m3, m3, m3), generator=g) if m3 else None
    ws = [None if w is None else w.to(cuda_device) for w in (w0, w1, w2, w3)]
    x = _x(3, 1001, seed=m2).to(cuda_device)
    want = v_ref.volterra(x, *ws, 2)
    for tile in (16, 128, 512):
        before = v_kern.LAUNCHES["volterra"]
        got = v_kern.volterra(x, *ws, stride=2, tile=tile)
        torch.cuda.synchronize()
        assert v_kern.LAUNCHES["volterra"] == before + 1
        assert got.is_cuda and torch.equal(got, want), tile
    # the generic kernel's tile (the register-blocked one, which the
    # deployed baseline takes, has none)
    with pytest.raises(ValueError, match="shared memory"):
        v_kern._forced("generic", x, *ws, stride=2, tile=1 << 16)


# the register-blocked Volterra kernel's cases: (rows, samples, strided
# view); the plan's run is 512 symbols, P = 4
V_CASES = {"long": (3, 2 * 1001, False),
           "shorter_than_a_run": (2, 2 * 100, False),
           "ragged_p": (2, 2 * 257, False),           # n_out not a multiple of P
           "odd_width": (2, 2 * 300 + 1, False),
           "one_row": (1, 2 * 7320, False),
           "one_symbol": (2, 3, False),
           "strided_view": (3, 2 * 513 + 1, True)}
HALF_TYPES = [torch.float32, torch.bfloat16, torch.float16]


def _v_case(device, case, dtype, seed=0):
    rows, width, strided = V_CASES[case]
    g = torch.Generator().manual_seed(seed + width)
    ws = [torch.tensor(0.05), 0.3 * torch.randn(25, generator=g),
          0.1 * torch.randn((9, 9), generator=g), None]
    big = torch.randn((rows, width + 11), generator=g).to(dtype)
    x = big[:, 5:5 + width] if strided else big[:, :width].contiguous()
    return x.to(device), [None if w is None else w.to(device) for w in ws]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_TYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", list(V_CASES))
def test_volterra_register_blocked_equals_plain_and_generic_on_card(
        cuda_device, case, dtype):
    x, ws = _v_case(cuda_device, case, dtype)
    want = v_ref.volterra(x, *ws, 2)
    before = dict(v_kern.INSTANCE_LAUNCHES)
    got = v_kern.volterra(x, *ws, stride=2)
    torch.cuda.synchronize()
    assert v_kern.INSTANCE_LAUNCHES == {"rb": before["rb"] + 1,
                                        "generic": before["generic"]}
    assert got.is_cuda and got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs()
                                         .max())
    for tile in (16, 128):
        generic = v_kern._forced("generic", x, *ws, stride=2, tile=tile)
        assert torch.equal(got, generic), tile
    # the same weights in the 16-bit type: widened exactly, same result
    got16 = v_kern.volterra(x, *[None if w is None else w.to(dtype)
                                 for w in ws], stride=2)
    assert torch.equal(got16, v_ref.volterra(
        x, *[None if w is None else w.to(dtype) for w in ws], 2))


@pytest.mark.cuda
def test_volterra_register_blocked_plan_is_the_librarys_on_card(cuda_device):
    lib = v_kern._load()
    for d in ((25, 9, 0, 2), (25, 9, 0, 1), (25, 9, 3, 2), (41, 15, 9, 2),
              (121, 35, 15, 2), (23, 9, 0, 2), (25, 7, 0, 2)):
        assert v_kern._plan(d) == v_kern._lib_plan(lib, d).instance, d
    plan = v_kern._lib_plan(lib, (25, 9, 0, 2))
    assert plan.instance == "rb" and plan.w_run >= 1
    assert plan.p in (1, 2, 4) and plan.threads == 128
    assert 0 < plan.smem <= v_kern._MAX_SMEM_BYTES and plan.smem % 16 == 0
    # the runs cover every symbol, at each run the sweep times and at runs
    # that leave the last block ragged: into an output filled with NaN, a
    # symbol never stored stays NaN
    for dtype in HALF_TYPES:
        x, ws = _v_case(cuda_device, "strided_view", dtype)
        want = v_ref.volterra(x, *ws, 2)
        w0, w1, w2, _ = v_kern._f32(ws)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for w_run in (1, 3, 64, 100, 128, 256, 512, 1024):
            out = torch.full_like(want, float("nan"))
            assert v_kern._rb_call(lib, x, w0, w1, w2, out, 2, stream,
                                   w_run) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want), (dtype, w_run)


@pytest.mark.cuda
@pytest.mark.parametrize("m1,m2,m3", [(41, 15, 9), (121, 35, 15), (25, 9, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_volterra_generic_kernel_takes_16bit_on_card(cuda_device, m1, m2, m3,
                                                     dtype):
    g = torch.Generator().manual_seed(m1 + m3)
    ws = [torch.tensor(0.05), 0.3 * torch.randn(m1, generator=g),
          0.1 * torch.randn((m2, m2), generator=g),
          0.05 * torch.randn((m3, m3, m3), generator=g)]
    ws = [w.to(cuda_device) for w in ws]
    x = _x(2, 700, seed=m2).to(dtype).to(cuda_device)
    before = dict(v_kern.INSTANCE_LAUNCHES)
    got = v_kern.volterra(x, *ws, stride=2)
    torch.cuda.synchronize()
    assert v_kern.INSTANCE_LAUNCHES == {"rb": before["rb"],
                                        "generic": before["generic"] + 1}
    assert got.dtype == dtype
    assert torch.equal(got, v_ref.volterra(x, *ws, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ib,fb", [((64, 14640), 3.0, 4.0),
                                         ((5, 1, 9), 0.0, 7.0),
                                         ((1001,), 2.6, 5.3)])
def test_quant_kernel_equals_plain_on_card(cuda_device, shape, ib, fb):
    g = torch.Generator().manual_seed(len(shape))
    x = (4 * torch.randn(shape, generator=g)).to(cuda_device)
    bits = torch.tensor([ib, fb], device=cuda_device)
    before = q_kern.LAUNCHES["fixed_point_quantize"]
    got = q_kern.fixed_point_quantize(x, bits[0], bits[1])
    torch.cuda.synchronize()
    assert q_kern.LAUNCHES["fixed_point_quantize"] == before + 1
    assert got.shape == x.shape
    assert torch.equal(got, q_ref.fixed_point_quantize(x, bits[0], bits[1]))
    # integer widths: the card's kernel equals the host's plain version
    if float(ib).is_integer() and float(fb).is_integer():
        assert torch.equal(got.cpu(),
                           q_ref.fixed_point_quantize(x.cpu(), ib, fb))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_TYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 3, 5, 8, 17, 1000, 64 * 14640])
def test_quant_vector_kernel_at_aligned_and_unaligned_views_on_card(
        cuda_device, dtype, n):
    g = torch.Generator().manual_seed(n)
    base = (4 * torch.randn(n + 16, generator=g)).to(dtype).to(cuda_device)
    bits = torch.tensor([2.0, 5.0], device=cuda_device)
    for off in (0, 1, 3, 7):
        x = base[off:off + n]
        for ib, fb in ((bits[0], bits[1]), (3, 4), (2.6, 5.3)):
            before = dict(q_kern.INSTANCE_LAUNCHES)
            got = q_kern.fixed_point_quantize(x, ib, fb)
            torch.cuda.synchronize()
            assert q_kern.INSTANCE_LAUNCHES["tensor"] == before["tensor"] + 1
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got, q_ref.fixed_point_quantize(x, ib, fb)), \
                (off, ib, fb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_TYPES, ids=["f32", "bf16", "f16"])
def test_quantize_params_makes_one_launch_on_card(cuda_device, dtype):
    p = teq.init(torch.Generator().manual_seed(5), HT.CNN, device="cpu")
    p = {"conv": [{k: v.to(dtype).to(cuda_device) for k, v in layer.items()}
                  for layer in p["conv"]]}
    qp = {f"layer{i}": {"w_int": torch.tensor(float(i), device=cuda_device),
                        "w_frac": torch.tensor(5.0 + i, device=cuda_device)}
          for i in range(3)}
    before = dict(q_kern.INSTANCE_LAUNCHES)
    q = q_ops.quantize_params(p, qp, device=cuda_device)
    torch.cuda.synchronize()
    assert q_kern.INSTANCE_LAUNCHES == {"tensor": before["tensor"],
                                        "many": before["many"] + 1}
    for i, (layer, lq) in enumerate(zip(p["conv"], q["conv"])):
        for key in ("w", "b"):
            want = q_ref.fixed_point_quantize(layer[key], qp[f"layer{i}"][
                "w_int"], qp[f"layer{i}"]["w_frac"])
            assert lq[key].dtype == dtype and torch.equal(lq[key], want)
            # each tensor as its own per-tensor launch, too
            assert torch.equal(lq[key], q_kern.fixed_point_quantize(
                layer[key], qp[f"layer{i}"]["w_int"],
                qp[f"layer{i}"]["w_frac"]))
    # more tensors than one launch takes: one launch per MAX_SEGMENTS
    xs = [torch.randn(k + 1, device=cuda_device).to(dtype) for k in range(
        q_kern.MAX_SEGMENTS + 3)]
    ws = [(1, 4)] * len(xs)
    before = q_kern.INSTANCE_LAUNCHES["many"]
    got = q_kern.fixed_point_quantize_many(xs, ws)
    torch.cuda.synchronize()
    assert q_kern.INSTANCE_LAUNCHES["many"] == before + 2
    for a, x in zip(got, xs):
        assert torch.equal(a, q_ref.fixed_point_quantize(x, 1, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,k,stride", [(1, 5, 9, 8), (5, 5, 9, 1),
                                                 (5, 8, 9, 2)])
def test_conv1d_kernel_equals_plain_on_card(cuda_device, c_in, c_out, k,
                                            stride):
    g = torch.Generator().manual_seed(c_out * 10 + stride)
    w = (0.3 * torch.randn((c_out, c_in, k), generator=g)).to(cuda_device)
    b = torch.randn(c_out, generator=g).to(cuda_device)
    x = torch.randn((3, c_in, 2 * 8 * 300 + 5), generator=g).to(cuda_device)
    want = c1_ref.conv1d(x, w, b, stride)
    for tile in (32, 256, 1024):
        before = c1_kern.LAUNCHES["conv1d"]
        got = c1_kern.conv1d(x, w, b, stride, tile_w=tile)
        torch.cuda.synchronize()
        assert c1_kern.LAUNCHES["conv1d"] == before + 1
        assert torch.equal(got, want), tile


# the register-blocked conv1d kernel's cases: (rows, width, strided view);
# a run is the plan's w_run output positions; "one_position" is 9 samples
# (K) for the VALID conv, 1 for SAME_LOWER
C1_CASES = {"long": (3, 2 * 8 * 300 + 5, False),
            "shorter_than_a_run": (2, 8 * 40 + 3, False),
            "one_position": (2, 9, False),
            "strided_view": (2, 8 * 150 + 1, True)}


def _c1_case(device, dims, case, same=False, seed=0):
    k, c_in, c_out, stride = dims
    rows, width, strided = C1_CASES[case]
    if same and case == "one_position":
        width = 1
    g = torch.Generator().manual_seed(seed + stride)
    w = (0.3 * torch.randn((c_out, c_in, k), generator=g)).to(device)
    b = torch.randn(c_out, generator=g).to(device)
    big = torch.randn((rows, c_in, width + 11), generator=g).to(device)
    x = big[:, :, 5:5 + width] if strided else big[:, :, :width].contiguous()
    return x, w, b, stride


@pytest.mark.cuda
@pytest.mark.parametrize("dims", list(c1_kern._RB_DIMS))
@pytest.mark.parametrize("case", list(C1_CASES))
@pytest.mark.parametrize("same", [False, True])
def test_conv1d_register_blocked_equals_plain_and_generic_on_card(
        cuda_device, dims, case, same):
    x, w, b, stride = _c1_case(cuda_device, dims, case, same)
    k = dims[0]
    pad = (k // 2, k - 1 - k // 2) if same else (0, 0)
    want = c1_ref.conv1d(torch.nn.functional.pad(x, pad), w, b, stride)
    if case == "one_position":
        assert want.shape[2] == 1
    before = dict(c1_kern.INSTANCE_LAUNCHES)
    got = (c1_ops.conv1d_same_lower(x, w, b, stride, device=cuda_device)
           if same else c1_kern.conv1d(x, w, b, stride, tile_w=64))
    torch.cuda.synchronize()
    assert c1_kern.INSTANCE_LAUNCHES == {"rb": before["rb"] + 1,
                                         "generic": before["generic"]}
    assert got.is_cuda and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    for tile in (32, 256):
        generic = c1_kern._forced("generic", x, w, b, stride, tile, pad=pad)
        assert torch.equal(got, generic), tile


@pytest.mark.cuda
@pytest.mark.parametrize("dims", list(c1_kern._RB_DIMS))
def test_conv1d_register_blocked_plan_is_the_librarys_on_card(cuda_device,
                                                             dims):
    lib = c1_kern._load()
    k, c_in, c_out, stride = dims
    for d in (dims, (7, c_in, c_out, stride), (k, c_in + 1, c_out, stride),
              (k, c_in, c_out, stride + 1)):
        assert c1_kern._plan(d) == c1_kern._lib_plan(lib, d).instance
    plan = c1_kern._lib_plan(lib, dims)
    assert plan.instance == "rb" and plan.w_run >= 1
    assert plan.p in (1, 2, 4) and plan.threads == 128
    assert 0 < plan.smem <= c1_kern._MAX_SMEM_BYTES and plan.smem % 16 == 0
    # the runs cover every position, at each run the sweep times and at
    # runs that leave the last block ragged: into an output filled with
    # NaN, a position never stored stays NaN
    x, w, b, stride = _c1_case(cuda_device, dims, "strided_view", True)
    pad = (k // 2, k - 1 - k // 2)
    want = c1_ref.conv1d(torch.nn.functional.pad(x, pad), w, b, stride)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for w_run in (1, 3, 64, 100, 128, 256, 512, 1024):
        out = torch.full_like(want, float("nan"))
        assert c1_kern._rb_call(lib, x, w, b, out, stride, pad[0], stream,
                                w_run) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), w_run


@pytest.mark.cuda
@pytest.mark.parametrize("dims", list(c1_kern._RB_DIMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_conv1d_takes_16bit_on_card(cuda_device, dims, dtype):
    x, w, b, stride = _c1_case(cuda_device, dims, "strided_view", True)
    k = dims[0]
    pad = (k // 2, k - 1 - k // 2)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    want = c1_ref.conv1d(torch.nn.functional.pad(x, pad), w, b, stride)
    got = c1_ops.conv1d_same_lower(x, w, b, stride, device=cuda_device)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got, c1_kern._forced("generic", x, w, b, stride, 64,
                                            pad=pad))


@pytest.mark.cuda
def test_conv1d_other_shapes_take_the_generic_kernel_on_card(cuda_device):
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 3, 301), generator=g).to(cuda_device)
    w = torch.randn((7, 3, 15), generator=g).to(cuda_device)
    b = torch.randn(7, generator=g).to(cuda_device)
    before = dict(c1_kern.INSTANCE_LAUNCHES)
    got = c1_ops.conv1d_same_lower(x, w, b, 4, device=cuda_device)
    torch.cuda.synchronize()
    assert c1_kern.INSTANCE_LAUNCHES == {"rb": before["rb"],
                                         "generic": before["generic"] + 1}
    assert torch.equal(got, c1_ref.conv1d(
        torch.nn.functional.pad(x, (7, 7)), w, b, 4))


@pytest.mark.cuda
def test_qat_training_repeats_bitwise_on_card(cuda_device):
    cfg = ttrain.EqTrainConfig(steps=10, batch=4, seq_syms=256,
                               eval_syms=4096)
    qcfg = qat.QATConfig(init_int_bits=8.0, init_frac_bits=8.0)
    fn = tdata.channel_fn("imdd", device=cuda_device)
    runs = [ttrain.train_equalizer(
        torch.Generator(device=cuda_device).manual_seed(4), "cnn", HT.CNN,
        fn, cfg, qat_cfg=qcfg, device=cuda_device) for _ in range(2)]
    (p1, bn1, i1), (p2, bn2, i2) = runs
    assert "qat" in p1
    for a, b in zip(tree_leaves((p1, bn1)), tree_leaves((p2, bn2))):
        assert torch.equal(a, b)
    assert i1["ber"] == i2["ber"]
    assert (i1["bits_params"], i1["bits_acts"]) == (i2["bits_params"],
                                                    i2["bits_acts"])


@pytest.mark.cuda
def test_training_runs_on_card_and_deploys(cuda_device):
    cfg = ttrain.EqTrainConfig(steps=20, batch=4, seq_syms=256,
                               eval_syms=4096)
    fn = tdata.channel_fn("imdd", device=cuda_device)
    params, _, info = ttrain.train_equalizer(
        torch.Generator(device=cuda_device).manual_seed(0), "fir",
        tfir.FIRConfig(), fn, cfg, record_every=1, device=cuda_device)
    assert params["w"].is_cuda and 0.0 <= info["ber"] <= 0.5
    assert all(np.isfinite(h["loss"]) for h in info["history"])
    p = teq.init(torch.Generator().manual_seed(0), HT.CNN,
                 device=cuda_device)
    qp = {f"layer{i}": {k: torch.tensor(v, device=cuda_device)
                        for k, v in QAT.items()} for i in range(3)}
    before = q_kern.LAUNCHES["fixed_point_quantize"]
    q = q_ops.quantize_params(p, qp, device=cuda_device)
    assert q_kern.LAUNCHES["fixed_point_quantize"] == before + 1
    plain = q_ops.quantize_params(p, qp, use_kernel=False,
                                  device=cuda_device)
    for a, b in zip(q["conv"], plain["conv"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


# ---------------------------------------------------------------------------
# the LM serving slice: the flash-attention kernel
# ---------------------------------------------------------------------------

FLASH_GRID = [  # b, sq, sk, h, hkv, d, causal, window, q_offset
    (2, 128, 128, 4, 4, 64, True, 0, 0),
    (1, 256, 256, 4, 2, 64, True, 64, 0),       # GQA + sliding window
    (2, 100, 100, 2, 2, 32, True, 0, 0),        # non-block-aligned
    (1, 1, 320, 4, 4, 64, True, 0, 319),        # decode: 1 query at offset
    (2, 64, 192, 2, 2, 64, False, 0, 0),        # bidirectional
    (1, 96, 96, 8, 1, 16, True, 0, 0),          # MQA
    (1, 40, 40, 4, 2, 48, True, 0, -5),         # rows with no valid key
    # the bf16 tensor-core tiles' edges: 64-row q tiles, 64-key K/V tiles
    (1, 63, 63, 4, 2, 80, True, 0, 0),
    (1, 64, 64, 4, 2, 112, True, 0, 0),
    (1, 65, 65, 2, 1, 128, True, 0, 0),
    (1, 129, 129, 4, 2, 80, True, 0, 0),
    (1, 2049, 2049, 2, 1, 128, True, 0, 0),
    (1, 65, 129, 4, 2, 112, True, 0, 64),       # Sq < Sk at an offset
    (1, 129, 129, 4, 2, 64, True, 37, 0),       # window ends inside a tile
    (1, 63, 2049, 2, 2, 128, False, 0, 0),      # bidirectional, 33 K tiles
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SERVING_SHAPE = (2, 2048, 2048, 16, 8, 128, True, 0, 0)   # qwen3-0.6b


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (c, dt) for c in FLASH_GRID for dt in (torch.float32, torch.bfloat16)]
    + [(SERVING_SHAPE, torch.bfloat16)])
def test_flash_attention_kernel_agrees_with_plain_on_card(cuda_device, case,
                                                          dtype):
    b, sq, sk, h, hkv, d, causal, win, qoff = case
    g = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn(s, generator=g).to(cuda_device, dtype)
               for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=win,
                             q_offset=qoff)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa_ref.flash_attention(q, k, v, causal, win, qoff)
    assert got.is_cuda and got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err
    if qoff < 0:
        assert bool((got[:, :-qoff] == 0).all())
    # strided views: k and v read in place from one (B, S, 2, Hkv, D) tensor
    kv = torch.stack([k, v], dim=2)
    got2 = fa.flash_attention(q, kv[:, :, 0], kv[:, :, 1], causal=causal,
                              window=win, q_offset=qoff)
    assert torch.equal(got2, got)


@pytest.mark.cuda
def test_flash_attention_refuses_on_card(cuda_device):
    q = torch.randn(1, 8, 2, 24, device=cuda_device)
    h = torch.randn(1, 8, 2, 16, device=cuda_device)
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="share one type"):
        fa.flash_attention(h, h.half(), h.half())
    assert fa.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
def test_flash_attention_refuses_unaligned_bf16_rows_on_card(cuda_device):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g).to(cuda_device, torch.bfloat16)
               for s in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))
    flat = torch.zeros(k.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + k.numel()].view(k.shape)      # 2 bytes off 16
    shifted.copy_(k)
    wide = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16,
                       device=cuda_device)[..., :64]   # rows 136 bytes apart
    wide.copy_(v)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="flash_attention: bf16 k rows"):
        fa.flash_attention(q, shifted, v)
    with pytest.raises(ValueError, match="flash_attention_fwd: bf16 v rows"):
        fa.flash_attention_fwd(q, k, wide)
    torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == 0
    # the same values, aligned, launch
    aligned = fa.flash_attention(q, shifted.clone(), wide.contiguous())
    assert torch.equal(aligned, fa.flash_attention(q, k, v))
    assert fa.LAUNCHES["flash_attention"] == 2


# The f32 instances kept their FP32-FMA datapath when the bf16 instances
# moved to the tensor cores: sha256 (first 16 hex digits) of o, of the
# training forward's o and of its lse on fixed numpy inputs, as the kernel
# before the bf16 redesign computed them on an H100.
F32_FINGERPRINTS = {
    (16, (1, 130, 4, 2, 64)): ("057b38ba9e23d90d", "057b38ba9e23d90d",
                               "4f719f5812545970"),
    (17, (2, 100, 8, 4, 128)): ("bc601f7907a035bf", "bc601f7907a035bf",
                                "8dbca4f2301d6cbe"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("seed,shape", list(F32_FINGERPRINTS))
def test_flash_f32_instances_are_bitwise_unchanged_on_card(cuda_device,
                                                           seed, shape):
    b, s, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(cuda_device) for sh in ((b, s, h, d), (b, s, hkv, d),
                                           (b, s, hkv, d)))
    o = fa.flash_attention(q, k, v)
    o2, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    got = tuple(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                for t in (o, o2, lse))
    assert got == F32_FINGERPRINTS[(seed, shape)]


@pytest.mark.cuda
def test_reduced_qwen3_serving_launches_flash_once_per_layer(cuda_device):
    cfg = lm_configs.get_config("qwen3-0.6b", reduced=True, tp=1,
                                fused_attention=True)
    model, params, state, prefill, decode = lm_serve.serve_session(
        cfg, 2, 32, 40, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 32), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    fa.reset_launch_counts()
    logits, state = prefill(params, {"tokens": toks}, state)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    fa.reset_launch_counts()
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    for i in range(4):
        tok, logits, state = decode(params, tok, 32 + i, state)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert bool(torch.isfinite(logits).all())
    # the same prefill through the chunked plain path (f32, TF32 off)
    plain = lm_registry.build(lm_configs.get_config("qwen3-0.6b", True,
                                                    tp=1))
    lg, _ = plain.prefill(params, {"tokens": toks},
                          plain.init_serve_state(2, 40, cuda_device))
    fused_lg, _ = model.prefill(params, {"tokens": toks},
                                model.init_serve_state(2, 40, cuda_device))
    assert float((lg - fused_lg).abs().max()) < 1e-4


TRAIN_GRID = [  # b, s, h, hkv, d, causal, window, q_offset
    (1, 100, 4, 2, 128, True, 0, 0),
    (1, 130, 8, 2, 128, True, 48, 0),
    (2, 2049, 4, 2, 128, True, 0, 0),
    (1, 96, 4, 1, 48, True, 0, -5),        # rows with no valid key
    (1, 64, 2, 2, 64, False, 0, 0),        # bidirectional
]


def _train_inputs(case, dtype, dev):
    b, s, h, hkv, d = case[:5]
    g = torch.Generator().manual_seed(s + h + d)
    return [torch.randn(sh, generator=g).to(dev, dtype)
            for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, s, h, d))]


def _bwd_close(got, want, dtype, what):
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 5e-4, (what, float(diff.max()))
    else:
        w = want.float().abs()
        assert bool((diff <= 1e-2 * w + 1e-3 * float(w.max())).all()), (
            what, float(diff.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_flash_kernels_agree_with_plain_on_card(cuda_device, case,
                                                         dtype):
    _, _, _, _, _, causal, win, qoff = case
    q, k, v, do = _train_inputs(case, dtype, cuda_device)
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, win, qoff)
    wo, wlse = fa_ref.flash_attention_fwd(q, k, v, causal, win, qoff)
    assert float((o.float() - wo.float()).abs().max()) <= FLASH_TOL[dtype]
    assert float((lse - wlse).abs().max()) <= 1e-5
    assert torch.equal(o, fa.flash_attention(q, k, v, causal, win, qoff))
    delta = fa_ref.attention_delta(wo, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, wlse, delta, causal,
                                        win, qoff)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, wlse, delta, causal, win,
                                   qoff)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_fwd": 1,
                           "flash_attention_bwd_dkv": 1,
                           "flash_attention_bwd_dq": 1}
    wdk, wdv = fa_ref.flash_attention_bwd_dkv(q, k, v, do, wlse, delta,
                                              causal, win, qoff)
    wdq = fa_ref.flash_attention_bwd_dq(q, k, v, do, wlse, delta, causal,
                                        win, qoff)
    for name, got, want in (("dq", dq, wdq), ("dk", dk, wdk),
                            ("dv", dv, wdv)):
        assert got.dtype == dtype and got.shape == want.shape, name
        _bwd_close(got, want, dtype, name)
    if qoff < 0:
        assert bool((lse[:, :-qoff] == -1e30).all())
        assert bool((dq[:, :-qoff] == 0).all())
    # k and v read in place as strided views of one tensor
    kv = torch.stack([k, v], dim=2)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, kv[:, :, 0], kv[:, :, 1], do,
                                          wlse, delta, causal, win, qoff)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.cuda
def test_training_flash_kernels_refuse_on_card(cuda_device):
    q = torch.randn(1, 8, 2, 16, device=cuda_device)
    lse = torch.zeros(1, 8, 2, device=cuda_device)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse[:, :4], lse)
    with pytest.raises(ValueError, match="do must match"):
        fa.flash_attention_bwd_dkv(q, q, q, q.double(), lse, lse)
    assert sum(fa.LAUNCHES.values()) == 0


# The f32 backward instances kept their FP32-FMA datapath when the bf16
# instances moved to the tensor cores: sha256 (first 16 hex digits) of dq,
# dk and dv on fixed numpy inputs (o and lse from the f32 training forward,
# whose bits are pinned above; delta summed in float64 on the host), as
# the kernels before the bf16 redesign computed them on an H100.
BWD_F32_FINGERPRINTS = {   # seed, (b, s, h, hkv, d), window
    (16, (1, 130, 4, 2, 64), 0): ("d19dea7dfb8bb406", "e56a631b534f19d3",
                                  "eb46adc320c2ba8d"),
    (17, (2, 100, 8, 4, 128), 48): ("db6260f1577a1d9e", "f12fdba31e0528d6",
                                    "5c8aab7366ae2405"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("seed,shape,win", list(BWD_F32_FINGERPRINTS))
def test_flash_bwd_f32_instances_are_bitwise_unchanged_on_card(
        cuda_device, seed, shape, win):
    b, s, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(cuda_device) for sh in ((b, s, h, d), (b, s, hkv, d),
                                                (b, s, hkv, d), (b, s, h, d)))
    o, lse = fa.flash_attention_fwd(q, k, v, True, win)
    delta = torch.from_numpy((do.cpu().numpy().astype(np.float64)
                              * o.cpu().numpy().astype(np.float64)).sum(-1)
                             .astype(np.float32)).to(cuda_device)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True, win)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, win)
    torch.cuda.synchronize()
    got = tuple(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                for t in (dq, dk, dv))
    assert got == BWD_F32_FINGERPRINTS[(seed, shape, win)]


# the bf16 tensor-core backward's tiles (64 q rows × 64 keys, 16-wide
# passes) at their edges: S = 1 (one query at an offset: a single row
# with a single key has ds = 0 up to rounding, which no elementwise bound
# can compare), 63, 64, 65, 127, 129, 2049; D = 48, 80, 112, 128; GQA 1,
# 2, 4, 8
BWD_TC_EDGES = [  # b, sq, sk, h, hkv, d, causal, window, q_offset
    (1, 1, 65, 8, 8, 128, True, 0, 64),
    (1, 63, 63, 8, 4, 48, True, 0, 0),
    (1, 64, 64, 8, 2, 80, True, 0, 0),
    (1, 65, 65, 8, 1, 112, True, 0, 0),
    (1, 127, 127, 4, 4, 128, True, 0, 0),
    (2, 129, 129, 8, 4, 80, True, 37, 0),     # window ends inside a tile
    (1, 2049, 2049, 8, 1, 128, True, 0, 0),
    (1, 129, 129, 4, 2, 112, False, 0, 0),    # bidirectional
    (1, 65, 129, 8, 2, 48, True, 0, 64),      # Sq < Sk at an offset
    (1, 127, 127, 16, 2, 128, True, 0, -5),   # rows with no valid key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_TC_EDGES)
def test_flash_bwd_bf16_agrees_with_plain_at_tile_edges_on_card(cuda_device,
                                                                case):
    b, sq, sk, h, hkv, d, causal, win, qoff = case
    g = torch.Generator().manual_seed(sq + sk + d)
    q, k, v, do = (torch.randn(s, generator=g).to(cuda_device,
                                                  torch.bfloat16)
                   for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                             (b, sq, h, d)))
    wo, wlse = fa_ref.flash_attention_fwd(q, k, v, causal, win, qoff)
    delta = fa_ref.attention_delta(wo, do)
    fa.reset_launch_counts()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, wlse, delta, causal,
                                        win, qoff)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, wlse, delta, causal, win,
                                   qoff)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["flash_attention_bwd_dkv"],
            fa.LAUNCHES["flash_attention_bwd_dq"]) == (1, 1)
    wdk, wdv = fa_ref.flash_attention_bwd_dkv(q, k, v, do, wlse, delta,
                                              causal, win, qoff)
    wdq = fa_ref.flash_attention_bwd_dq(q, k, v, do, wlse, delta, causal,
                                        win, qoff)
    for name, got, want in (("dq", dq, wdq), ("dk", dk, wdk),
                            ("dv", dv, wdv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _bwd_close(got, want, torch.bfloat16, name)
    if qoff < 0:
        assert bool((dq[:, :-qoff] == 0).all())
    # no atomics: a second call gives the same bits
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, wlse, delta, causal,
                                          win, qoff)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, wlse, delta, causal, win,
                                    qoff)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert torch.equal(dq2, dq)


@pytest.mark.cuda
def test_flash_bwd_refuses_unaligned_bf16_do_on_card(cuda_device):
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(s, generator=g).to(cuda_device,
                                                  torch.bfloat16)
                   for s in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64),
                             (1, 64, 4, 64)))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa_ref.attention_delta(o, do)
    flat = torch.zeros(do.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + do.numel()].view(do.shape)    # 2 bytes off 16
    shifted.copy_(do)
    fa.reset_launch_counts()
    with pytest.raises(ValueError,
                       match="flash_attention_bwd_dkv: bf16 do rows"):
        fa.flash_attention_bwd_dkv(q, k, v, shifted, lse, delta)
    with pytest.raises(ValueError,
                       match="flash_attention_bwd_dq: bf16 do rows"):
        fa.flash_attention_bwd_dq(q, k, v, shifted, lse, delta)
    torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == 0
    # the same values, aligned, launch; the training Function copies an
    # unaligned cotangent before its launches
    dq = fa.flash_attention_bwd_dq(q, k, v, shifted.clone(), lse, delta)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                     delta))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = lm_attn.attend_causal(*leaves, fused=True)
    got = torch.autograd.grad(out, leaves, shifted)
    want = torch.autograd.grad(lm_attn.attend_causal(*leaves, fused=True),
                               leaves, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _grads(model, params, toks):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss_fn(tree_unflatten(params, leaves),
                            {"tokens": toks, "labels": toks})
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
def test_fused_model_has_gradients_through_attention_on_card(cuda_device):
    """The fused branch once returned the kernel's output with no grad_fn,
    so nothing reached wq, wk, wv, q_norm or k_norm on the card. Its
    gradients must now be nonzero and equal the plain path's (f32, TF32
    off), and the step must launch only the training kernels."""
    cfg = lm_configs.get_config("qwen3-0.6b", True, tp=1,
                                fused_attention=True)
    fused = lm_registry.build(cfg)
    plain = lm_registry.build(lm_configs.get_config("qwen3-0.6b", True,
                                                    tp=1))
    params = fused.init(torch.Generator(cuda_device).manual_seed(0),
                        cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 100), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    with fp32_exact():
        fa.reset_launch_counts()
        lf, gf = _grads(fused, params, toks)
        torch.cuda.synchronize()
        counts = dict(fa.LAUNCHES)
        lp, gp = _grads(plain, params, toks)
    n = cfg.n_layers
    assert counts == {"flash_attention": 0, "flash_attention_fwd": 2 * n,
                      "flash_attention_bwd_dkv": n,
                      "flash_attention_bwd_dq": n}
    assert abs(float(lf) - float(lp)) < 1e-5
    leaves = tree_leaves(params)
    attn = params["layers"]["attn"]
    for key in ("wq", "wk", "wv", "q_norm", "k_norm"):
        i = next(j for j, t in enumerate(leaves) if t is attn[key])
        assert float(gf[i].abs().max()) > 0, key
    for a, b in zip(gf, gp):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_serving_prefill_launches_only_the_serving_kernel(cuda_device):
    cfg = lm_configs.get_config("qwen3-0.6b", reduced=True, tp=1,
                                fused_attention=True)
    model, params, state, prefill, _ = lm_serve.serve_session(
        cfg, 2, 32, 40, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 32), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    for ctx in (torch.enable_grad, torch.no_grad):
        fa.reset_launch_counts()
        with ctx():
            logits, _ = prefill(params, {"tokens": toks},
                                model.init_serve_state(2, 40, cuda_device))
        torch.cuda.synchronize()
        assert fa.LAUNCHES == {"flash_attention": cfg.n_layers,
                               "flash_attention_fwd": 0,
                               "flash_attention_bwd_dkv": 0,
                               "flash_attention_bwd_dq": 0}
        assert logits.grad_fn is None


@pytest.mark.cuda
def test_train_step_on_card_launches_training_kernels(cuda_device):
    cfg = lm_configs.get_config("qwen3-0.6b", True, tp=1,
                                fused_attention=True)
    init_state, train_step = lm_train.build(cfg, 3e-4, 2, cuda_device)
    params, opt_state = init_state()
    batches = lm_data.lm_batches(lm_data.PipelineConfig(
        seq_len=128, global_batch=4, accum=2), cfg, cuda_device)
    losses = []
    for _ in range(3):
        fa.reset_launch_counts()
        params, opt_state, m = train_step(params, opt_state, next(batches))
        losses.append(float(m["loss"]))
        n = cfg.n_layers
        assert fa.LAUNCHES == {"flash_attention": 0,
                               "flash_attention_fwd": 2 * n * 2,
                               "flash_attention_bwd_dkv": n * 2,
                               "flash_attention_bwd_dq": n * 2}
    assert all(np.isfinite(losses))
    assert int(opt_state.step) == 3


SLSTM_GRID = [(2, 64, 4, 192), (1, 65, 2, 8), (3, 17, 1, 32),
              (2, 1, 4, 192), (5, 17, 4, 192), (2, 33, 2, 99),
              (1, 9, 1, 1024)]                      # b, s, nh, dh
# the cluster kernel at geometries the plan does not take: (b, s, nh, dh),
# (Q, RB); dh = 8 at Q = 16 leaves eight CTAs with no column
SLSTM_FORCED = [((1, 9, 2, 8), (16, 1)), ((5, 9, 2, 40), (8, 4)),
                ((3, 9, 4, 100), (7, 2)), ((2, 9, 4, 192), (16, 1))]


def _slstm_inputs(case, dtype, dev, seed=0):
    """xg 0.5·N with the model's forget offset (+1 on f), r ~ N(0, 0.09/dh)
    and a nonzero state, drawn on the host from a seed."""
    b, s, nh, dh = case
    d = nh * dh
    g = torch.Generator().manual_seed(seed + s + dh)
    xg = 0.5 * torch.randn((b, s, 4, d), generator=g)
    xg[:, :, 2] += 1.0
    r = 0.3 / np.sqrt(dh) * torch.randn((4, nh, dh, dh), generator=g)
    st = (torch.randn((b, d), generator=g),
          0.5 + 1.5 * torch.rand((b, d), generator=g),
          0.5 * torch.randn((b, d), generator=g),
          torch.randn((b, d), generator=g))
    return (xg.reshape(b, s, 4 * d).to(dev, dtype), r.to(dev, dtype),
            tuple(t.to(dev) for t in st))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLSTM_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_kernel_agrees_with_plain_on_card(cuda_device, case, dtype):
    """atol 1e-4, the reference's bound on its own kernel: at these
    sequence lengths f32 resolves it (the plain version's TF32 is off).
    The kernel that ran is the one the plan names, and the plan is the
    library's own."""
    b, s, nh, dh = case
    xg, r, st = _slstm_inputs(case, dtype, cuda_device)
    plan = sl_kern._plan(b, nh, dh)
    lib = sl_kern._lib()
    assert sl_kern._lib_plan(lib, b, nh, dh) == plan
    assert plan.instance == ("stream" if dh > 256 else "cluster")
    if b == 5:
        assert plan.rb > 1 and b % plan.rb     # a ragged row group
    if dh == 99:                               # Q = 4: 24 and 25 columns
        assert len({n for _, n in sl_kern._columns(dh, plan.q)}) == 2
    before = sl_kern.LAUNCHES["slstm_fused"]
    before_inst = dict(sl_kern.INSTANCE_LAUNCHES)
    with fp32_exact():
        got, gst = sl_kern.slstm_fused(xg, r, st, case[2])
        want, wst = sl_ref.slstm_fused(xg, r, st, case[2])
    torch.cuda.synchronize()
    assert sl_kern.LAUNCHES["slstm_fused"] == before + 1
    before_inst[plan.instance] += 1
    assert sl_kern.INSTANCE_LAUNCHES == before_inst
    assert got.dtype == torch.float32 and got.shape == (
        case[0], case[1], case[2] * case[3])
    for name, a, w in zip(("hs", "c", "n", "h", "m"), (got, *gst),
                          (want, *wst)):
        assert float((a - w).abs().max()) <= 1e-4, (name, float(
            (a - w).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case,geometry", SLSTM_FORCED)
def test_slstm_cluster_kernel_at_forced_geometry_on_card(cuda_device, case,
                                                         geometry):
    """The cluster kernel through `slstm_cluster_launch` at a cluster size
    and row group the plan does not take: every CTA must reach every
    barrier (CTAs with no column, rows past B), within atol 1e-4."""
    b, s, nh, dh = case
    q, rb = geometry
    if dh < q:
        assert any(n == 0 for _, n in sl_kern._columns(dh, q))
    xg, r, st = _slstm_inputs(case, torch.bfloat16, cuda_device)
    hs = torch.empty((b, s, nh * dh), device=cuda_device)
    out = tuple(torch.empty_like(t) for t in st)
    lib = sl_kern._lib()
    with fp32_exact():
        rc = sl_kern._launch_cluster(lib, q, rb, xg, r, st, hs, out,
                                     torch.cuda.current_stream().cuda_stream)
        want, wst = sl_ref.slstm_fused(xg, r, st, nh)
    torch.cuda.synchronize()
    assert rc == 0
    for name, a, w in zip(("hs", "c", "n", "h", "m"), (hs, *out),
                          (want, *wst)):
        assert float((a - w).abs().max()) <= 1e-4, name


@pytest.mark.cuda
def test_slstm_cluster_kernel_repeats_bitwise_on_card(cuda_device):
    """Two launches of the cluster kernel on the same inputs give the same
    bits (a fixed order of sums, no atomics)."""
    xg, r, st = _slstm_inputs((4, 200, 4, 192), torch.bfloat16, cuda_device)
    assert sl_kern._plan(4, 4, 192).instance == "cluster"
    first = sl_kern.slstm_fused(xg, r, st, 4)
    second = sl_kern.slstm_fused(xg, r, st, 4)
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, w) for a, w in zip(first[1], second[1]))


@pytest.mark.cuda
def test_slstm_split_is_bitwise_on_card(cuda_device):
    """A pass over [0, s1) then one over [s1, S) from the returned state
    equals one pass bitwise (a deterministic kernel, state in f32); at
    dh = 192 all three passes run the cluster kernel."""
    xg, r, st = _slstm_inputs((2, 300, 4, 192), torch.bfloat16, cuda_device)
    before = sl_kern.INSTANCE_LAUNCHES["cluster"]
    full, fst = sl_kern.slstm_fused(xg, r, st, 4)
    h1, st1 = sl_kern.slstm_fused(xg[:, :101], r, st, 4)
    h2, st2 = sl_kern.slstm_fused(xg[:, 101:], r, st1, 4)
    assert sl_kern.INSTANCE_LAUNCHES["cluster"] == before + 3
    assert torch.equal(torch.cat([h1, h2], 1), full)
    assert all(torch.equal(a, w) for a, w in zip(st2, fst))


@pytest.mark.cuda
def test_slstm_refuses_on_card(cuda_device):
    xg, r, st = _slstm_inputs((1, 8, 2, 16), torch.float32, cuda_device)
    before = sl_kern.LAUNCHES["slstm_fused"]
    with pytest.raises(ValueError, match="must be one of"):
        sl_kern.slstm_fused(xg.half(), r, st, 2)
    with pytest.raises(ValueError, match="does not fit"):
        sl_kern.slstm_fused(xg, r[:, :1].contiguous(), st, 2)
    with pytest.raises(ValueError, match="state c"):
        sl_kern.slstm_fused(xg, r, (st[0].cpu(),) + st[1:], 2)
    leaf = xg.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="models.xlstm.slstm_scan"):
        sl_kern.slstm_fused(leaf, r, st, 2)
    assert sl_kern.LAUNCHES["slstm_fused"] == before
    with torch.no_grad():                  # no autograd: the kernel runs
        sl_kern.slstm_fused(leaf, r, st, 2)
    assert sl_kern.LAUNCHES["slstm_fused"] == before + 1


@pytest.mark.cuda
def test_reduced_xlstm_serving_launches_slstm_per_block_and_step(
        cuda_device):
    cfg = lm_configs.get_config("xlstm-125m", reduced=True, tp=1)
    model, params, state, prefill, decode = lm_serve.serve_session(
        cfg, 2, 32, 36, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 32), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    n = len(cfg.slstm_at)
    fa.reset_launch_counts()
    sl_kern.reset_launch_counts()
    logits, state = prefill(params, {"tokens": toks}, state)
    torch.cuda.synchronize()
    assert sl_kern.LAUNCHES["slstm_fused"] == n
    assert sl_kern.INSTANCE_LAUNCHES == {"cluster": n, "stream": 0,
                                         "bwd_cluster": 0,
                                         "bwd_stream": 0}
    first = logits
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    for i in range(4):
        tok, logits, state = decode(params, tok, 32 + i, state)
    torch.cuda.synchronize()
    assert sl_kern.LAUNCHES["slstm_fused"] == n * 5
    assert sl_kern.INSTANCE_LAUNCHES == {"cluster": n * 5, "stream": 0,
                                         "bwd_cluster": 0,
                                         "bwd_stream": 0}
    assert all(v == 0 for v in fa.LAUNCHES.values())
    assert bool(torch.isfinite(logits).all())
    # the same prefill on the host (the plain versions), f32, TF32 off
    host = interop.tree_map(lambda t: t.cpu(), params)
    want, _ = model.prefill(host, {"tokens": toks.cpu()},
                            model.init_serve_state(2, 36, "cpu"))
    err = float((first.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


# ---------------------------------------------------------------------------
# the adaptation slice and the fleet on the card
# ---------------------------------------------------------------------------

def _adapt_spec(tid, seed, backend="fused_fp32"):
    params = teq.init(torch.Generator().manual_seed(seed), HT.CNN,
                      device="cpu")
    if backend == "auto":
        params["qat"] = {f"layer{i}": {k: torch.tensor(v)
                                       for k, v in QAT.items()}
                         for i in range(HT.CNN.layers)}
    return TenantSpec(tid, HT.CNN, params=params,
                      bn_state=teq.init_bn_state(HT.CNN, device="cpu"),
                      backend=backend, tile_m=16)


def _adapter(rt, seed=0):
    from repro_torch.adapt import (AdaptPolicy, FineTuneConfig,
                                   OnlineAdapter, PromotionPolicy)
    return OnlineAdapter(
        rt, AdaptPolicy(min_train_syms=1024, adapt_every_syms=512,
                        eval_capacity=4096,
                        promotion=PromotionPolicy(min_eval_syms=512,
                                                  eval_bucket_syms=256)),
        FineTuneConfig(steps=10, batch=4, seq_syms=128, lr=1e-3), seed=seed)


def _per_epoch_offline(sess, spec0, wave, device):
    """The stream each weight epoch's offline engine gives from its
    swap_log boundary (contract #8). `prev_spec` holds the spec before the
    last swap, so a stream with at most one swap is fully determined."""
    vp = HT.CNN.v_parallel
    log = sess.swap_log
    specs = [spec0] + ([sess.spec] if len(log) > 1 else [])
    assert len(log) <= 2
    outs = [s.build_engine(device)(wave).cpu().numpy() for s in specs]
    bounds = [p * vp for _, p in log] + [None]
    return np.concatenate([o[a:b] for o, a, b in
                           zip(outs, bounds[:-1], bounds[1:])])


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["sync", "async"])
@pytest.mark.parametrize("backend", ["fused_fp32", "auto"])
def test_hot_swap_bitwise_per_epoch_on_card(cuda_device, driver, backend):
    """A weight hot-swap mid-stream on the card: each epoch's positions
    equal that epoch's offline engine bitwise, through the rb kernel."""
    cls = AsyncServeRuntime if driver == "async" else ServeRuntime
    rt = cls(BatchPolicy(max_batch=1, max_wait_s=1e9))
    try:
        spec0 = _adapt_spec("hs", 1, backend)
        sess = rt.open(spec0)
        wave = np.random.default_rng(2).standard_normal(
            60 * 16 * 16).astype(np.float32)
        chunks = chop(wave, 300, seed=4)
        kern.reset_launch_counts()
        for c in chunks[:len(chunks) // 2]:
            rt.submit("hs", c)
        new = _adapt_spec("x", 99, backend).params
        assert rt.swap_weights("hs", params=new) == 1
        for c in chunks[len(chunks) // 2:]:
            rt.submit("hs", c)
        got = rt.close("hs")
        assert kern.INSTANCE_LAUNCHES["generic"] == 0
        assert kern.INSTANCE_LAUNCHES["rb"] > 0
        np.testing.assert_array_equal(
            got, _per_epoch_offline(sess, spec0, wave, cuda_device))
    finally:
        if driver == "async":
            rt.shutdown()


@pytest.mark.cuda
def test_fleet_device_loss_migrates_bitwise_on_card(cuda_device):
    """Two workers on cuda:0, worker 0 killed mid-stream: every stream ==
    its offline engine bitwise, 0 poisoned, one migration; each worker
    executed on its own stream."""
    from repro_torch.serve import Fault, FaultPlan, FleetRuntime
    specs, waves, streams = _slice_tenants()
    seen = set()
    fp = FaultPlan([Fault("device_lost", at=0, after=2)])
    kern.reset_launch_counts()
    with FleetRuntime(n_workers=2, policy=BatchPolicy(max_batch=3),
                      fault_plan=fp) as rt:
        for w in rt.workers:
            execute = w.batcher.execute

            def recording(batch, execute=execute):
                seen.add(torch.cuda.current_stream(
                    batch.device).cuda_stream)
                return execute(batch)
            w.batcher.execute = recording
        own = {w.stream.cuda_stream for w in rt.workers}
        got = _serve_streams(rt, specs, streams)
        st = rt.stats()
    assert fp.fired == [("device_lost", 0)]
    assert st["migrations"] == 1
    assert st["recovery"]["sessions_poisoned"] == 0
    assert seen <= own and len(own) == 2
    assert kern.INSTANCE_LAUNCHES["generic"] == 0
    for s in specs:
        want = s.build_engine(cuda_device)(waves[s.tenant_id]).cpu().numpy()
        np.testing.assert_array_equal(got[s.tenant_id], want)


@pytest.mark.cuda
def test_adapter_background_thread_under_async_traffic_on_card(cuda_device):
    """The adapter's thread (on its own CUDA stream) fine-tunes and may
    hot-swap while AsyncServeRuntime serves: no adapter or runtime error,
    nothing lost or duplicated, the swap log monotone."""
    with AsyncServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9)) as rt:
        adapter = _adapter(rt)
        assert adapter.stream is not None
        adapter.attach(_adapt_spec("bg", 21))
        streams, pilots = loadgen.drift_streams(
            DriftingProakis(), DriftSchedule(2, 3), ["bg"], n_bursts=8,
            syms_per_burst=1024, seed=11)
        adapter.start(interval_s=0.02)
        try:
            for chunk, labels in zip(streams["bg"], pilots["bg"]):
                adapter.feed_pilots("bg", labels)
                rt.submit("bg", chunk)
            rt.finish("bg")
            rt.drain()
        finally:
            adapter.stop()
        assert adapter.history and not adapter.errors and not rt.errors
        assert rt.output("bg").shape == (8 * 1024,)
        log = rt.sessions.get("bg").swap_log
        assert [e for e, _ in log] == list(range(len(log)))
        assert all(p1 <= p2 for (_, p1), (_, p2) in zip(log, log[1:]))


@pytest.mark.cuda
def test_adapter_cycle_repeats_bitwise_on_card(cuda_device):
    """One adapter run twice on the card: the same history and the same
    active weights, bitwise (fine-tuning under `fp32_exact`)."""
    def run():
        rt = ServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9))
        adapter = _adapter(rt, seed=5)
        adapter.attach(_adapt_spec("d", 8))
        streams, pilots = loadgen.drift_streams(
            DriftingProakis(), DriftSchedule(1, 2), ["d"], n_bursts=4,
            syms_per_burst=1024, seed=2)
        loadgen.replay_adaptive(rt, streams, pilots=pilots, adapter=adapter)
        hist = [(r.action, r.weight_epoch, repr(r.shadow),
                 None if r.train_info is None
                 else (r.train_info["loss_first"], r.train_info["loss_last"]))
                for r in adapter.history]
        sess = rt.sessions.get("d")
        return hist, sess.engine.weights, rt.output("d")

    h1, w1, o1 = run()
    h2, w2, o2 = run()
    assert h1 == h2
    assert any(h[3] is not None for h in h1)     # a fine-tune ran
    for (a, b), (c, d) in zip(w1, w2):
        assert torch.equal(a, c) and torch.equal(b, d)
    np.testing.assert_array_equal(o1, o2)


def _halo_rank_on_card(rank: int, world: int, weights, x: np.ndarray):
    """One rank of a gloo world on cuda:0: its int8 engine on its shard."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import halo
    torch.cuda.set_device(0)
    mesh = make_mesh((world,), ("data",), "cuda")
    engine = EqualizerEngine(cfg=HT.CNN, weights=weights,
                             backend="fused_int8", formats=FMTS, tile_m=64,
                             device="cuda")
    shard = halo.local_shard(torch.from_numpy(x), HT.CNN, mesh)
    kern.reset_launch_counts()
    y = halo.halo_apply(engine, shard, HT.CNN, mesh)
    torch.cuda.synchronize()
    return y.cpu().numpy(), dict(kern.LAUNCHES)


@pytest.mark.cuda
def test_halo_two_gloo_ranks_on_card_int8_bitwise(cuda_device):
    """Two ranks over gloo on one card (NCCL refuses two ranks on one GPU):
    the int8 halo (edges staged through the host as int8) gives the
    unsplit engine's symbols bitwise, one kernel launch a rank."""
    from repro_torch.launch.mesh import run_ranks
    weights = tuple((w.numpy(), b.numpy()) for w, b in _folded(3))
    x = np.random.default_rng(4).standard_normal(
        2 * 2 * 1024).astype(np.float32)
    outs = run_ranks(_halo_rank_on_card, 2, (weights, x), timeout_s=300)
    whole = EqualizerEngine(cfg=HT.CNN, weights=weights,
                            backend="fused_int8", formats=FMTS, tile_m=64,
                            device=cuda_device)(x).cpu().numpy()
    np.testing.assert_array_equal(np.concatenate([y for y, _ in outs]),
                                  whole)
    assert all(n["cnn_eq_fused_int8"] == 1 for _, n in outs), outs


@pytest.mark.cuda
def test_grad_compress_on_card_equals_host(cuda_device):
    from repro_torch.optim import grad_comp
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, 1000)).astype(np.float32))
    g[0, :4] = torch.tensor([127.0 * 0.03, 0.015, 0.045, -0.015])
    p, s = grad_comp.compress(g)
    pc, sc = grad_comp.compress(g.to(cuda_device))
    assert pc.is_cuda and pc.dtype == torch.int8
    assert torch.equal(pc.cpu(), p) and torch.equal(sc.cpu(), s)
    assert torch.equal(grad_comp.decompress(pc, sc).cpu(),
                       grad_comp.decompress(p, s))


# ---------------------------------------------------------------------------
# the sharded checkpoint over gloo, and xlstm training on the card
# ---------------------------------------------------------------------------

def _ckpt_rank_on_card(rank: int, world: int, tmp: str):
    """One rank of a gloo world on cuda:0: a tree of DTensor leaves (an
    uneven Shard(0) of a (7, 5) f32 tensor, a replicated bf16 one) saved
    through the host-staged gather, the same tree saved as plain tensors,
    and the DTensor checkpoint restored onto the same mesh, replicated."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    mesh = make_mesh((world,), ("data",), "cuda")
    plain = {"w": torch.arange(35, dtype=torch.float32,
                               device="cuda").reshape(7, 5) / 7,
             "b": torch.linspace(-2, 2, 12, device="cuda").to(
                 torch.bfloat16).reshape(3, 4)}
    sharded = {"w": distribute_tensor(plain["w"], mesh, [Shard(0)],
                                      src_data_rank=None),
               "b": distribute_tensor(plain["b"], mesh, [Replicate()],
                                      src_data_rank=None)}
    CheckpointManager(f"{tmp}/dtensor").save(1, sharded)
    CheckpointManager(f"{tmp}/plain").save(1, plain)
    got = CheckpointManager(f"{tmp}/dtensor").restore(plain, mesh=mesh)
    torch.cuda.synchronize()
    return ({k: v.to_local().cpu() for k, v in got.items()},
            {k: v.cpu() for k, v in plain.items()},
            {k: v.to_local().device.type for k, v in got.items()})


@pytest.mark.cuda
def test_dtensor_checkpoint_over_gloo_on_card_saves_and_restores_bitwise(
        cuda_device, tmp_path):
    """Two gloo ranks on one card: `CheckpointManager.save` gathers CUDA
    DTensor leaves through the host (gloo cannot all-gather CUDA
    tensors), writes exactly what a plain-tensor save writes, and the
    restore gives every rank the tensors bitwise, on the card."""
    import pathlib

    from repro_torch.launch.mesh import run_ranks
    outs = run_ranks(_ckpt_rank_on_card, 2, (str(tmp_path),), timeout_s=300)
    for got, plain, devices in outs:
        assert devices == {"w": "cuda", "b": "cuda"}
        for k in plain:
            assert got[k].dtype == plain[k].dtype and torch.equal(
                got[k], plain[k]), k
    dt = pathlib.Path(tmp_path, "dtensor", "step_00000001")
    pl = pathlib.Path(tmp_path, "plain", "step_00000001")
    assert sorted(p.name for p in dt.iterdir()) == sorted(
        p.name for p in pl.iterdir())
    for p in pl.iterdir():
        assert (dt / p.name).read_bytes() == p.read_bytes(), p.name


# (b, s, nh, dh[, "tie"]): the backward's plan takes the cluster kernel for
# dh <= 256 and the stream kernel above; the cluster kernel's edges: dh = 99
# over Q = 4 (24 and 25 columns), B = 5 and 9 at the trained heads (RB = 2
# and 4, a last group of one row), S = 1, dh = 256 (32 registers of R a
# row), and a tie in the stabilizer's max at t = 0
SLSTM_BWD_GRID = [(2, 33, 2, 16), (3, 65, 4, 192), (1, 17, 1, 300),
                  (3, 17, 4, 99), (5, 17, 4, 192), (9, 9, 4, 192),
                  (2, 1, 4, 192), (2, 19, 1, 256), (2, 9, 2, 16, "tie")]
# a kernel named, not planned: the cluster kernel at a (Q, RB) the plan does
# not take (dh = 8 over Q = 16 leaves eight CTAs with no column; dh = 100
# over Q = 8 gives 12 and 13), and the stream kernel at cluster shapes
SLSTM_BWD_FORCED = [((2, 9, 2, 8), (16, 1)), ((3, 9, 4, 100), (8, 2)),
                    ((5, 9, 2, 40), (8, 4)), ((2, 9, 4, 192), (16, 1)),
                    ((3, 33, 4, 192), "stream"), ((2, 17, 2, 16), "stream")]


def _slstm_bwd_case(case, dtype, dev):
    """The forward's inputs with seed 5, cotangents of hs and of the final
    state ~ N, and hs from the forward kernel; with "tie", h0 = 0, m0 = 0.5
    and xg's ĩ = 1.5, f̃ = 1.0 at t = 0, so f̃ + m0 == ĩ exactly (pre = xg
    at t = 0)."""
    b, s, nh, dh = case[:4]
    xg, r, st = _slstm_inputs(case[:4], dtype, dev, seed=5)
    if case[4:] == ("tie",):
        d = nh * dh
        st[2].zero_()
        st[3].fill_(0.5)
        xg[:, 0, d:2 * d] = 1.5
        xg[:, 0, 2 * d:3 * d] = 1.0
    g = torch.Generator().manual_seed(17)
    dhs = torch.randn((b, s, nh * dh), generator=g).to(dev)
    dfin = tuple(torch.randn((b, nh * dh), generator=g).to(dev)
                 for _ in range(4))
    with torch.no_grad():
        hs, _ = sl_kern.slstm_fused(xg, r, st, nh)
    return xg, r, st, hs, dhs, dfin


def _bwd_agrees(got, want, xg, r):
    """dpre's f32 sums in another order than the plain version's: each
    output within 1e-4 · max(1, max|want|); dxg and dr in bf16 also within
    one bf16 rounding (2^-7 · |want|)."""
    assert got[0].dtype == xg.dtype and got[1].dtype == r.dtype
    rel = 2.0 ** -7 if xg.dtype == torch.bfloat16 else 0.0
    for name, a, w in zip(("dxg", "dr", "dc0", "dn0", "dh0", "dm0"),
                          (got[0], got[1], *got[2]),
                          (want[0].to(xg.dtype), want[1].to(r.dtype),
                           *want[2])):
        a, w = a.float(), w.float()
        tol = 1e-4 * max(1.0, float(w.abs().max())) + rel * w.abs()
        assert bool(((a - w).abs() <= tol).all()), (name, float(
            (a - w).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLSTM_BWD_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_bwd_kernel_agrees_with_plain_on_card(cuda_device, case,
                                                    dtype):
    """The backward's planned kernel against `ref.slstm_fused_bwd` on the
    card (TF32 off) on the same inputs and hs, within `_bwd_agrees`'s
    bound. One launch counted, of the kernel the plan names, and the plan
    is the library's own."""
    b, nh, dh = case[0], case[2], case[3]
    xg, r, st, hs, dhs, dfin = _slstm_bwd_case(case, dtype, cuda_device)
    plan = sl_kern._plan_bwd(b, nh, dh)
    assert sl_kern._lib_plan_bwd(sl_kern._lib_bwd(), b, nh, dh) == plan
    assert plan.instance == ("bwd_stream" if dh > 256 else "bwd_cluster")
    if b in (5, 9):
        assert plan.rb == (2 if b == 5 else 4) and b % plan.rb == 1
    before = sl_kern.LAUNCHES["slstm_fused_bwd"]
    before_inst = dict(sl_kern.INSTANCE_LAUNCHES)
    with fp32_exact():
        got = sl_kern.slstm_fused_bwd(xg, r, st, nh, hs, dhs, dfin)
        want = sl_ref.slstm_fused_bwd(xg, r, st, nh, hs, dhs, dfin)
    torch.cuda.synchronize()
    assert sl_kern.LAUNCHES["slstm_fused_bwd"] == before + 1
    before_inst[plan.instance] += 1
    assert sl_kern.INSTANCE_LAUNCHES == before_inst
    _bwd_agrees(got, want, xg, r)


@pytest.mark.cuda
@pytest.mark.parametrize("case,forced", SLSTM_BWD_FORCED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_bwd_forced_kernel_agrees_with_plain_on_card(cuda_device, case,
                                                           forced, dtype):
    """Each design named, not planned (`_forced_bwd`): the cluster kernel
    at a (Q, RB) the plan does not take, where every CTA must reach every
    mbarrier phase (CTAs with no column, rows past B), and the stream
    kernel at cluster shapes; within `_bwd_agrees`'s bound, one launch of
    the named kernel counted."""
    nh, dh = case[2], case[3]
    if forced != "stream" and dh < forced[0]:
        assert any(n == 0 for _, n in sl_kern._columns(dh, forced[0]))
    xg, r, st, hs, dhs, dfin = _slstm_bwd_case(case, dtype, cuda_device)
    name = "bwd_stream" if forced == "stream" else "bwd_cluster"
    before = sl_kern.INSTANCE_LAUNCHES[name]
    with fp32_exact():
        got = sl_kern._forced_bwd(forced, xg, r, st, nh, hs, dhs, dfin)
        want = sl_ref.slstm_fused_bwd(xg, r, st, nh, hs, dhs, dfin)
    torch.cuda.synchronize()
    assert sl_kern.INSTANCE_LAUNCHES[name] == before + 1
    _bwd_agrees(got, want, xg, r)


@pytest.mark.cuda
def test_slstm_bwd_kernel_repeats_bitwise_on_card(cuda_device):
    """Two launches of the cluster backward on the same inputs give the
    same bits (fixed orders of sums, no atomics), as do two of the stream
    backward."""
    case = SLSTM_BWD_GRID[1]
    xg, r, st, hs, dhs, dfin = _slstm_bwd_case(case, torch.bfloat16,
                                               cuda_device)
    assert sl_kern._plan_bwd(case[0], case[2], case[3]).instance == \
        "bwd_cluster"
    for run in (lambda: sl_kern.slstm_fused_bwd(xg, r, st, case[2], hs, dhs,
                                                dfin),
                lambda: sl_kern._forced_bwd("stream", xg, r, st, case[2],
                                            hs, dhs, dfin)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.cuda
def test_reduced_xlstm_gradients_on_card_equal_the_plain_path(cuda_device):
    """The reduced xlstm's loss gradient on the card (the forward kernel
    twice a block under remat, the backward kernel once) against the same
    on the host (the plain versions), f32 and TF32 off: every leaf within
    1e-3 · max|leaf|, slstm_r's and slstm_w's nonzero (the check that
    caught a gradient that never reached a kernel's weights)."""
    cfg = lm_configs.get_config("xlstm-125m", reduced=True, tp=1)
    model = lm_registry.build(cfg)
    host = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))

    def grads(params, dev):
        leaves = [p.to(dev).requires_grad_(True)
                  for p in tree_leaves(params)]
        t = toks.to(dev)
        with fp32_exact():
            loss, _ = model.loss_fn(tree_unflatten(params, leaves),
                                    {"tokens": t, "labels": t})
            return loss.detach().cpu(), [
                g.cpu() for g in torch.autograd.grad(loss, leaves)]

    sl_kern.reset_launch_counts()
    loss, got = grads(host, cuda_device)
    torch.cuda.synchronize()
    n = len(cfg.slstm_at)
    assert sl_kern.LAUNCHES == {"slstm_fused": 2 * n, "slstm_fused_bwd": n}
    assert sl_kern.INSTANCE_LAUNCHES["bwd_cluster"] == n
    want_loss, want = grads(host, "cpu")
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    names = [p for p, _ in interop.tree_named_leaves(host)]
    for name, a, w in zip(names, got, want):
        assert float((a - w).abs().max()) <= 1e-3 * float(
            w.abs().max()), name
    for key in ("slstm_r", "slstm_w"):
        i = names.index(f"blocks/1/slstm/{key}")
        assert float(got[i].abs().max()) > 0, key


@pytest.mark.cuda
def test_train_build_trains_xlstm_on_card(cuda_device):
    cfg = lm_configs.get_config("xlstm-125m", reduced=True, tp=1)
    init_state, train_step = lm_train.build(cfg, 3e-4, 2, cuda_device)
    params, opt = init_state()
    toks = torch.randint(0, cfg.vocab, (2, 2, 32), device=cuda_device)
    sl_kern.reset_launch_counts()
    params, opt, met = train_step(params, opt, {"tokens": toks,
                                                "labels": toks})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(met["loss"]))
    assert sl_kern.LAUNCHES["slstm_fused_bwd"] == 2 * len(cfg.slstm_at)
    assert sl_kern.INSTANCE_LAUNCHES["bwd_cluster"] == 2 * len(cfg.slstm_at)


NEW_FAMILIES = ("llava-next-34b", "zamba2-1.2b", "whisper-large-v3")


def _family_batch(cfg, b, s, device):
    """Tokens and the family's stub input (a 0.1·N image prefix or frame
    embeddings), seeded, on ``device``."""
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g)
    batch = {"tokens": toks, "labels": toks, **lm_registry.stub_inputs(
        cfg, (b,), "cpu", make=lambda shape: 0.1 * torch.randn(
            shape, generator=g))}
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_reduced_family_gradients_through_flash_equal_the_plain_path(
        cuda_device, arch):
    """Each new family at its reduced config, f32 with TF32 off: the
    loss's gradient with ``fused_attention`` (the flash forward-with-lse
    and the two backward kernels; zamba2's shared block at both of its
    application points, whisper's decoder self-attention) against the
    plain attention path on the same card: loss within 1e-5, every leaf
    within 1e-3 · max|leaf| and nonzero where the plain path's is."""
    cfg = lm_configs.get_config(arch, reduced=True, tp=1)
    host = lm_registry.build(cfg).init(torch.Generator().manual_seed(0),
                                       "cpu")
    batch = _family_batch(cfg, 2, 40, cuda_device)

    def grads(fused):
        model = lm_registry.build(dataclasses.replace(
            cfg, fused_attention=fused))
        leaves = [p.to(cuda_device).requires_grad_(True)
                  for p in tree_leaves(host)]
        with fp32_exact():
            loss, _ = model.loss_fn(tree_unflatten(host, leaves), batch)
            return loss.detach().cpu(), [
                g.cpu() for g in torch.autograd.grad(loss, leaves)]

    fa.reset_launch_counts()
    loss, got = grads(True)
    torch.cuda.synchronize()
    apps = {"hybrid": 2, "encdec": cfg.n_layers}.get(cfg.family,
                                                       cfg.n_layers)
    assert fa.LAUNCHES["flash_attention_fwd"] == 2 * apps      # remat
    assert fa.LAUNCHES["flash_attention_bwd_dq"] == apps
    want_loss, want = grads(False)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    names = [p for p, _ in interop.tree_named_leaves(host)]
    for name, a, w in zip(names, got, want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-3 * scale, name
        assert (scale == 0) == (float(a.abs().max()) == 0), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_cli_serves_the_new_families_on_card(cuda_device, arch):
    assert lm_serve.main(["--arch", arch, "--batch", "2", "--prompt-len",
                          "24", "--gen", "4"]) == 0


@pytest.mark.cuda
def test_serve_cli_decodes_llava_at_the_prefix_shifted_positions_on_card(
        cuda_device, monkeypatch):
    """On the card, the CLI's llava decode steps run at img_tokens +
    prompt_len + i in a cache of img_tokens + prompt_len + gen, and its
    prefill launches the flash kernel once a layer."""
    seen = {}
    real = lm_serve.serve_session

    def recording(cfg, batch, prompt_len, max_len, device="cuda", seed=0):
        out = real(cfg, batch, prompt_len, max_len, device=device,
                   seed=seed)
        seen["max_len"], decode = max_len, out[4]

        def dec(params, token, pos, state):
            seen.setdefault("pos", []).append(pos)
            return decode(params, token, pos, state)
        return (*out[:4], dec)
    monkeypatch.setattr(lm_serve, "serve_session", recording)
    assert lm_serve.main(["--arch", "llava-next-34b", "--batch", "2",
                          "--prompt-len", "24", "--gen", "3"]) == 0
    cfg = lm_configs.get_config("llava-next-34b", reduced=True)
    p0 = cfg.img_tokens + 24
    assert seen == {"max_len": p0 + 3, "pos": [p0, p0 + 1, p0 + 2]}
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers

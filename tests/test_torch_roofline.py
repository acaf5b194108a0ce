"""Port vs reference: `repro_torch.launch.roofline`.

  * `Roofline`'s three terms, `bottleneck`, `t_step`, `mfu` and the rest of
    `to_dict` equal the reference's on the same numbers, with the
    reference's TPU constants put in place of the port's H100 ones for the
    comparison (the port's own constants are NVIDIA's H100 figures);
  * the ring model equals the reference's `CollectiveStats`, which it
    reads from HLO text, collective by collective;
  * `model_flops` equals the reference's;
  * `StepCounter` on toys: a product in a Python loop of 10 counts 10
    times its flops per rank; on a fake 16 × 16 world an all-gather gets
    the ring bytes (n − 1)·operand and a shard-to-shard move counts as one
    all-to-all; the custom ops count their own work.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import roofline as rl


def _ref():
    from repro.launch import roofline as jrl
    return jrl


CASES = [  # flops, hbm bytes, {kind: (operand bytes, ring bytes)}, chips, mf
    (3.1e12, 2.2e11, {"all-gather": (1e9, 1.5e10)}, 256, 4e14),
    (1e9, 9e11, {"all-reduce": (2e8, 3.9e8),
                 "reduce-scatter": (5e7, 4.7e7)}, 512, 1e12),
    (5e14, 1e9, {}, 256, 1e17),
    (0.0, 0.0, {}, 1, 0.0),
]


@pytest.mark.parametrize("flops,hbm,coll,chips,mf", CASES)
def test_roofline_terms_equal_reference(monkeypatch, flops, hbm, coll,
                                        chips, mf):
    jrl = _ref()
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(rl, name, getattr(jrl, name))
    op = {k: int(v[0]) for k, v in coll.items()}
    ring = {k: v[1] for k, v in coll.items()}
    count = {k: 1 for k in coll}
    got = rl.Roofline(flops, hbm, rl.CollectiveStats(op, ring, count),
                      chips, mf)
    want = jrl.Roofline(flops, hbm, jrl.CollectiveStats(op, ring, count),
                        chips, mf)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "t_step", "useful_flops_ratio", "mfu"):
        assert getattr(got, prop) == getattr(want, prop), prop
    wd = want.to_dict()
    gd = got.to_dict()
    assert set(wd) - set(gd) == {"xla_flops_per_chip_loops_once",
                                 "xla_bytes_per_chip_loops_once"}
    assert {k: gd[k] for k in gd} == {k: wd[k] for k in gd}


def test_h100_constants():
    assert rl.PEAK_FLOPS == 989e12 == rl.PEAK_OPS_S["bf16"]
    assert rl.HBM_BW == rl.HBM_BYTES_S == 3.35e12
    assert rl.ICI_BW == 450e9 and rl.HBM_PER_CHIP == 80e9
    r = rl.Roofline(989e12, 3.35e12, rl.CollectiveStats(
        {"all-gather": 1}, {"all-gather": 450e9}, {"all-gather": 1}), 1)
    assert r.t_compute == r.t_memory == r.t_collective == 1.0


# each collective on a (4, 8) f32 operand, as the reference reads it from
# HLO, and the group it runs over
HLO = """\
HloModule m

ENTRY %main.1 (p0: f32[4,8]) -> f32[4,8] {
  %p0 = f32[4,8]{1,0} parameter(0)
  %ag = f32[16,8]{1,0} all-gather(f32[4,8]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} %p0), replica_groups=[2,16]<=[32], to_apply=%add
  %rs = f32[1,8]{1,0} reduce-scatter(f32[4,8]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %a2a = f32[4,8]{1,0} all-to-all(f32[4,8]{1,0} %p0), replica_groups=[1,8]<=[8], dimensions={0}
  ROOT %cp = f32[4,8]{1,0} collective-permute(f32[4,8]{1,0} %p0), source_target_pairs={{0,1},{1,0}}
}
"""
GROUPS = {"all-gather": 4, "all-reduce": 16, "reduce-scatter": 4,
          "all-to-all": 8, "collective-permute": 2}


def test_ring_model_equals_reference_collective_stats():
    want = _ref().parse_collectives(HLO)
    operand = 4 * 8 * 4
    assert set(want.ring_bytes) == set(GROUPS)
    for kind, n in GROUPS.items():
        assert want.op_bytes[kind] == operand
        assert rl.ring_bytes(kind, operand, n) == pytest.approx(
            want.ring_bytes[kind], rel=1e-12), kind


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_model_flops_equals_reference(kind):
    for n, tokens in ((596_049_920, 1_048_576), (141_225_296, 128)):
        assert rl.model_flops(n, tokens, kind) == _ref().model_flops(
            n, tokens, kind)


def test_counter_counts_a_python_loop_every_time():
    from torch.utils.flop_counter import FlopCounterMode
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    with FlopCounterMode(display=False) as fc:
        a @ b
    once = fc.get_total_flops()
    counter = rl.StepCounter()
    with counter:
        for _ in range(10):
            c = a @ b
    assert once == 2 * 32 * 64 * 16
    assert counter.flops == 10 * once
    assert counter.flops_by_op == {"aten.mm": 10 * once}
    # each product reads a and b and writes c
    per = (a.numel() + b.numel() + c.numel()) * 4
    assert counter.hbm_bytes == 10 * per
    assert counter.peak_bytes >= c.numel() * 4


def test_counter_counts_the_kernels_own_work():
    from repro_torch.kernels.flash_attn import attention_costs
    from repro_torch.kernels.flash_attn import flash_attn as fa
    q = torch.randn(2, 64, 4, 32)
    kv = torch.randn(2, 64, 2, 32)
    counter = rl.StepCounter()
    with counter:
        fa.flash_attention(q, kv, kv, causal=True)
        fa.flash_attention(q, kv, kv, causal=True, window=16)
    want = (attention_costs(2, 64, 64, 4, 32, True)["flops"]
            + attention_costs(2, 64, 64, 4, 32, True, 16)["flops"])
    assert counter.flops_by_op == {"repro_torch.flash_attention": want}
    # the plain path's dense scores are not counted: the op is opaque
    assert counter.n_ops == 2


def test_counter_ring_bytes_on_a_fake_16x16_world():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    init_fake_world(256)
    try:
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.zeros(64, 32), mesh,
                                  [Shard(0), Replicate()])
            local = (64 // 16) * 32 * 4
            counter = rl.StepCounter()
            with counter:
                x.redistribute(mesh, [Replicate(), Replicate()])
            assert counter.count == {"all-gather": 1}
            assert counter.op_bytes == {"all-gather": local}
            assert counter.ring["all-gather"] == 15 * local
            counter = rl.StepCounter()
            with counter:                 # rows → columns on "data"
                y = x.redistribute(mesh, [Shard(1), Replicate()])
            assert tuple(y.placements) == (Shard(1), Replicate())
            assert counter.count == {"all-to-all": 1}
            assert counter.ring["all-to-all"] == pytest.approx(
                local * 15 / 16)
    finally:
        dist.destroy_process_group()
    roof = counter.roofline(256, 0.0)
    assert roof.t_collective == roof.coll.total_ring_bytes / rl.ICI_BW
    assert np.isfinite(roof.t_step)


@pytest.mark.parametrize("op", ("to_f32", "add", "matmul"))
def test_counter_sees_only_local_ops_of_a_dtensor_op(op):
    """DTensor derives an op's output shape by running the op once on fake
    tensors of the global shape, the first time it meets the op's schema;
    no rank runs that op, so the counter leaves it out: a fresh op's first
    call counts the same flops, bytes and peak as its second, all at the
    local shapes (x: (64, 100) of a global (64, 1600)), and the peak names
    a local tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    init_fake_world(256)
    try:
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(64, 100), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
            w = DTensor.from_local(torch.empty(100, 48), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            fn = {"to_f32": lambda: x.to(torch.float64),
                  "add": lambda: x + 1.5,
                  "matmul": lambda: (x @ w).to_local()}[op]
            counts = []
            for _ in range(2):
                counter = rl.StepCounter()
                with counter:
                    fn()
                counts.append((counter.flops, counter.hbm_bytes,
                               counter.peak_bytes, counter.n_ops))
                assert counter.peak_live[0][2] in ((64, 100), (64, 48)), \
                    counter.peak_live
    finally:
        dist.destroy_process_group()
    assert counts[0] == counts[1]
    assert counts[0][2] <= 64 * 100 * 8


def test_counter_keeps_a_tensor_live_while_a_view_or_a_collective_holds_it():
    """A made tensor's bytes stay in the temporaries while any tensor on
    its storage lives: a view of it after its own tensor is dropped, and
    the result of a Partial → Replicate redistribute (an all-reduce whose
    `wait_tensor` returns the buffer; a new one under FakeTensorMode) with
    its views; none once all are gone."""
    import gc
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    init_fake_world(16)
    try:
        mesh = make_mesh((4, 4), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            f = DTensor.from_local(torch.empty(2, 1024, 256), mesh,
                                   [Shard(0), Partial()], run_check=False)
            a = torch.empty(64, 32)
            counter = rl.StepCounter()
            with counter:
                y = (a @ a.T).view(-1)
                gc.collect()
                assert counter.live_bytes == 64 * 64 * 4
                del y
                gc.collect()
                assert counter.live_bytes == 0
                r = f.redistribute(mesh, [Shard(0), Replicate()])
                gc.collect()
                assert counter.live_bytes == 2 * 1024 * 256 * 4
                v = r.to_local()[0]
                del r
                gc.collect()
                assert counter.live_bytes == 2 * 1024 * 256 * 4
                del v
                gc.collect()
                assert counter.live_bytes == 0
    finally:
        dist.destroy_process_group()


def _int8_decode_reading(arch: str, n_layers: int) -> tuple:
    """One count of the reduced int8 (serve_fsdp) decode_32k cell of
    ``arch`` at ``n_layers`` on a fake 16 x 16 world: (peak bytes, the op
    at the peak, the tensors live there, flops, HBM bytes, ring bytes by
    op)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch.distributed as dist
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding
    mesh = make_production_mesh(fake=True)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            low = steps.make_lowerable(
                arch, SHAPES["decode_32k"], mesh, reduced=True,
                cfg_overrides={"serve_int8_weights": True,
                               "serve_fsdp": True, "n_layers": n_layers})
            _, _, c = rl.count_step(low.fn, *low.args)
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()
    return (c.peak_bytes, c.peak_op, c.peak_live, c.flops, c.hbm_bytes,
            c.ring)


def test_counter_reads_a_step_the_same_whatever_it_counted_before(
        monkeypatch):
    """A step's reading is a function of the step alone: the reduced int8
    decode_32k cell of llava counted three times in one process, the
    second and third time after itself and after another cell (qwen3's),
    reads the same peak, op at the peak, tensors live there, flops, HBM
    bytes and ring bytes each time. A collective's own result dies once
    its `wait_tensor` has returned a new buffer (under FakeTensorMode)
    while that buffer keeps their entry alive; a counter that let go of
    the dead storage saw the next tensor made at its address (the decode's
    (32768,) arange) as a view of the entry and left its bytes out, but
    only when the allocator happened to reuse the address."""
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "_INT8_MIN_SIZE", 1)
    first = _int8_decode_reading("llava-next-34b", 8)
    again = _int8_decode_reading("llava-next-34b", 8)
    other = _int8_decode_reading("qwen3-0.6b", 2)
    last = _int8_decode_reading("llava-next-34b", 8)
    assert other[0] > 0
    assert first == again == last, (first[:2], again[:2], last[:2])

"""Port vs reference: the fused sLSTM recurrence (repro_torch.kernels.slstm).

On the CPU the wrapper `slstm_fused` runs its plain version (`ref.py`); it
is held against the reference's Pallas kernel `slstm_fused` in interpret
mode and its oracle `ref.slstm`, on inputs drawn once with numpy, at the
reference test's three shapes (tests/test_slstm_kernel.py) from the zero
state and from a nonzero one, with f32 and bf16 inputs. The bound is the
reference's own kernel-vs-oracle bound, atol 1e-4; at these short
sequences the two packages agree to ~1e-6 (f32 rounding of the same
operations, the recurrent einsum summed in each backend's order). The
kernels themselves run only on a card (tests/test_torch_cuda.py); here the
plan that picks one of them is checked: the served shape takes the
cluster kernel in every type pair, wide heads the stream kernel, the
cluster kernel's column ranges cover a head once, and its plans fit the
card (threads, shared memory, registers, clusters at once); likewise the
backward's plan (`_plan_bwd`: its cluster kernel at the train shape with
the forward's geometry, the stream kernel past dh = 256).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm import slstm_fused as jslstm_fused
from repro.kernels.slstm import slstm_ref as jslstm_ref
from repro.models import xlstm as jxlstm
from repro_torch.kernels import slstm as tslstm_pkg
from repro_torch.kernels.slstm import ops as tops
from repro_torch.kernels.slstm import ref as tref
from repro_torch.kernels.slstm import slstm as tkern
from repro_torch.models import xlstm as txlstm

ATOL = 1e-4                    # tests/test_slstm_kernel.py's bound
SHAPES = [(2, 40, 4, 16), (1, 65, 2, 8), (3, 17, 1, 32)]


def _inputs(b, s, nh, dh, seed, zero_state=True):
    """xg 0.5·N and r 0.3·N, as the reference test draws them; the state
    zero (m = -1e30) or nonzero (c ~ N, n ~ U(0.5, 2), h ~ 0.5·N,
    m ~ N)."""
    rng = np.random.default_rng(seed)
    d = nh * dh
    xg = (0.5 * rng.standard_normal((b, s, 4 * d))).astype(np.float32)
    r = (0.3 * rng.standard_normal((4, nh, dh, dh))).astype(np.float32)
    if zero_state:
        st = (np.zeros((b, d)), np.zeros((b, d)), np.zeros((b, d)),
              np.full((b, d), -1e30))
    else:
        st = (rng.standard_normal((b, d)), rng.uniform(0.5, 2.0, (b, d)),
              0.5 * rng.standard_normal((b, d)), rng.standard_normal((b, d)))
    return xg, r, tuple(np.asarray(v, np.float32) for v in st)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("b,s,nh,dh", SHAPES)
@pytest.mark.parametrize("zero_state", [True, False])
def test_plain_slstm_fused_matches_pallas_kernel_and_oracle(b, s, nh, dh,
                                                            zero_state):
    xg, r, st = _inputs(b, s, nh, dh, s + dh, zero_state)
    jst = tuple(jnp.asarray(v) for v in st)
    want_k, wst_k = jslstm_fused(jnp.asarray(xg), jnp.asarray(r), jst, nh=nh,
                                 interpret=True)
    want_o, wst_o = jslstm_ref(jnp.asarray(xg).reshape(b, s, 4, nh * dh),
                               jnp.asarray(r), jst)
    got, gst = tkern.slstm_fused(_t(xg), _t(r), tuple(map(_t, st)), nh)
    assert got.shape == (b, s, nh * dh) and got.dtype == torch.float32
    for want, wst in ((want_k, wst_k), (want_o, wst_o)):
        _close(got, want, "hs")
        for name, a, w in zip("cnhm", gst, wst):
            _close(a, w, name)


@pytest.mark.parametrize("b,s,nh,dh", SHAPES)
def test_plain_oracle_layout_matches_reference_oracle(b, s, nh, dh):
    xg, r, st = _inputs(b, s, nh, dh, 3, zero_state=False)
    xg4 = xg.reshape(b, s, 4, nh * dh)
    want, wst = jslstm_ref(jnp.asarray(xg4), jnp.asarray(r),
                           tuple(jnp.asarray(v) for v in st))
    got, gst = tslstm_pkg.slstm_ref(_t(xg4), _t(r), tuple(map(_t, st)))
    _close(got, want, "hs")
    for name, a, w in zip("cnhm", gst, wst):
        _close(a, w, name)
    # and the kernel-layout plain version is the same function
    got2, _ = tref.slstm_fused(_t(xg), _t(r), tuple(map(_t, st)), nh)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("x_bf16,r_bf16", [(True, False), (False, True),
                                           (True, True)])
def test_bf16_inputs_convert_exactly_as_the_reference(x_bf16, r_bf16):
    """bf16 xg and r are cast to f32 inside, in both packages."""
    b, s, nh, dh = 2, 40, 4, 16
    xg, r, st = _inputs(b, s, nh, dh, 9, zero_state=False)
    jx = jnp.asarray(xg, jnp.bfloat16 if x_bf16 else jnp.float32)
    jr = jnp.asarray(r, jnp.bfloat16 if r_bf16 else jnp.float32)
    want, wst = jslstm_fused(jx, jr, tuple(jnp.asarray(v) for v in st),
                             nh=nh, interpret=True)
    tx = _t(np.asarray(jx.astype(jnp.float32)),
            torch.bfloat16 if x_bf16 else torch.float32)
    tr = _t(np.asarray(jr.astype(jnp.float32)),
            torch.bfloat16 if r_bf16 else torch.float32)
    got, gst = tkern.slstm_fused(tx, tr, tuple(map(_t, st)), nh)
    _close(got, want, "hs")
    for name, a, w in zip("cnhm", gst, wst):
        _close(a, w, name)


def test_state_carry_composes():
    """[0:s1] then [s1:S] from the returned state equals one pass: bitwise
    in the port's plain version (the same operations step by step), and
    within the reference test's 1e-4 of the reference's composition."""
    b, s, nh, dh = 2, 48, 4, 8
    xg, r, st = _inputs(b, s, nh, dh, 2)
    tst = tuple(map(_t, st))
    full, fst = tkern.slstm_fused(_t(xg), _t(r), tst, nh)
    h1, st1 = tkern.slstm_fused(_t(xg)[:, :20], _t(r), tst, nh)
    h2, st2 = tkern.slstm_fused(_t(xg)[:, 20:], _t(r), st1, nh)
    assert torch.equal(torch.cat([h1, h2], 1), full)
    assert all(torch.equal(a, w) for a, w in zip(st2, fst))
    jst = tuple(jnp.asarray(v) for v in st)
    j1, jst1 = jslstm_fused(jnp.asarray(xg[:, :20]), jnp.asarray(r), jst,
                            nh=nh, interpret=True)
    j2, _ = jslstm_fused(jnp.asarray(xg[:, 20:]), jnp.asarray(r), jst1,
                         nh=nh, interpret=True)
    _close(torch.cat([h1, h2], 1), jnp.concatenate([j1, j2], 1))


def test_float64_plain_version_runs_the_same_function():
    """`dtype=torch.float64` (the yardstick of f32 rounding on the card)
    computes the same recurrence: at 40 steps it is within 1e-5 of f32."""
    xg, r, st = _inputs(2, 40, 4, 16, 4, zero_state=False)
    f32, s32 = tref.slstm_fused(_t(xg), _t(r), tuple(map(_t, st)), 4)
    f64, s64 = tref.slstm_fused(_t(xg), _t(r), tuple(map(_t, st)), 4,
                                dtype=torch.float64)
    assert f64.dtype == torch.float64 and s64[3].dtype == torch.float64
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), atol=1e-5)


def test_model_slstm_scan_matches_reference_scan():
    """The model's `slstm_scan` (the wrapper) against the reference model's
    own `lax.scan` of the same function, from a nonzero state."""
    b, s, nh, dh = 2, 37, 4, 24
    xg, r, st = _inputs(b, s, nh, dh, 5, zero_state=False)
    want, wst = jxlstm.slstm_scan({"slstm_r": jnp.asarray(r)},
                                  jnp.asarray(xg), nh,
                                  tuple(jnp.asarray(v) for v in st))
    got, gst = txlstm.slstm_scan({"slstm_r": _t(r)}, _t(xg), nh,
                                 tuple(map(_t, st)))
    _close(got, want, "hs")
    for name, a, w in zip("cnhm", gst, wst):
        _close(a, w, name)


def _valid():
    xg, r, st = _inputs(2, 5, 2, 8, 0)
    return _t(xg), _t(r), tuple(map(_t, st))


@pytest.mark.parametrize("case,match", [
    ("xg_f16", "must be one of"),
    ("r_heads", "does not fit"),
    ("r_rank", "need xg"),
    ("empty", "empty input"),
    ("stride", "unit stride"),
    ("state_f64", "state c"),
    ("state_shape", "state n"),
    ("state_count", r"\(c, n, h, m\)"),
    ("nh", "positive python int"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    xg, r, st = _valid()
    nh = 2
    if case == "xg_f16":
        xg = xg.half()
    elif case == "r_heads":
        r = r[:, :1].contiguous()
    elif case == "r_rank":
        r = r[0]
    elif case == "empty":
        xg = xg[:, :0]
    elif case == "stride":
        xg = xg.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "state_f64":
        st = (st[0].double(),) + st[1:]
    elif case == "state_shape":
        st = (st[0], st[1][:1]) + st[2:]
    elif case == "state_count":
        st = st[:3]
    elif case == "nh":
        nh = 2.0
    before = tkern.LAUNCHES["slstm_fused"]
    with pytest.raises(ValueError, match=match):
        tkern.slstm_fused(xg, r, st, nh)
    assert tkern.LAUNCHES["slstm_fused"] == before


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    xg, r, st = _valid()
    tkern.reset_launch_counts()
    got, _ = tkern.slstm_fused(xg, r, st, 2)
    want, _ = tref.slstm_fused(xg, r, st, 2)
    assert torch.equal(got, want)
    assert tkern.LAUNCHES == {"slstm_fused": 0, "slstm_fused_bwd": 0}


def test_exports_do_not_shadow_the_kernel_module():
    """The package exports the oracle as `slstm_ref` (a bare `slstm` would
    shadow the submodule), and `ops` the wrapper and the oracle."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.slstm.slstm")
    assert tslstm_pkg.slstm is mod
    assert tslstm_pkg.slstm_fused is mod.slstm_fused is tops.slstm_fused
    assert tslstm_pkg.slstm_ref is tref.slstm is tops.slstm_ref


def test_costs_at_the_serving_shape():
    """xlstm-125m's sLSTM at 4 × 2048 tokens, bf16 xg and r: 76.8 MB and
    9.66e9 operations (0.0229 ms at 3.35 TB/s, 0.144 ms at 67 TFLOP/s)."""
    c = tkern.slstm_costs(4, 2048, 4, 192)
    assert c["bytes"] == 4 * 2048 * 3072 * 2 + 4 * 2048 * 768 * 4 \
        + 4 * 4 * 192 * 192 * 2 + 8 * 4 * 768 * 4 == 76_775_424
    assert c["flops"] == 2 * 4 * 2048 * 3072 * 192 == 9_663_676_416
    f32 = tkern.slstm_costs(4, 2048, 4, 192, torch.float32, torch.float32)
    assert f32["bytes"] - c["bytes"] == 4 * 2048 * 3072 * 2 \
        + 4 * 4 * 192 * 192 * 2


SERVED = (4, 4, 192)     # b, nh, dh: xlstm-125m's served sLSTM
_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("x_dt,r_dt", _PAIRS)
def test_served_shape_plans_the_cluster_kernel(x_dt, r_dt):
    """The served shape, in every type pair the wrapper takes, runs the
    cluster kernel: Q = 6 (32 columns a CTA), RB = 1 (16 clusters of 6, two
    to a GPC), two 8-byte mbarriers and two h buffers of 8 k-blocks of 36
    floats."""
    b, nh, dh = SERVED
    xg = torch.zeros((b, 1, 4 * nh * dh), dtype=x_dt)
    r = torch.zeros((4, nh, dh, dh), dtype=r_dt)
    tkern._check(xg, r, tuple(torch.zeros((b, nh * dh)) for _ in range(4)),
                 nh)
    assert tkern._plan(b, nh, dh) == tkern.Plan("cluster", 6, 1,
                                                16 + 4 * 2 * 8 * 36)


@pytest.mark.parametrize("dh", [257, 300, 512, 1024])
def test_wide_heads_plan_the_stream_kernel(dh):
    """Past dh = 256 a lane's k-block no longer fits its 32 registers of R:
    the stream kernel takes the shape (up to MAX_DH = 1024)."""
    assert tkern._plan(4, 1, dh) == tkern.Plan("stream", 0, 0, 8 * dh * 4)
    assert tkern._plan(4, 1, 256).instance == "cluster"


@pytest.mark.parametrize("q", range(1, 17))
def test_cluster_columns_cover_the_head_once(q):
    """CTA i of a cluster of q owns [i·dh/q, (i+1)·dh/q): every column of
    the head exactly once, in order, ragged by at most one (CTAs with no
    column where dh < q)."""
    for dh in range(1, 300):
        cols = tkern._columns(dh, q)
        assert [e for e0, n in cols for e in range(e0, e0 + n)] == list(
            range(dh))
        sizes = [n for _, n in cols]
        assert max(sizes) == -(-dh // q) and max(sizes) - min(sizes) <= 1
        assert (min(sizes) == 0) == (dh < q)


def test_ragged_splits_at_the_test_shapes():
    """dh = 100 over 8 CTAs gives 12 and 13 columns; B = 5 at the served
    heads takes RB = 2, a last group with one row; dh = 8 over 16 CTAs
    leaves eight CTAs with none."""
    assert sorted({n for _, n in tkern._columns(100, 8)}) == [12, 13]
    plan = tkern._plan(5, 4, 192)
    assert plan.instance == "cluster" and plan.rb == 2 and 5 % plan.rb == 1
    assert sum(n == 0 for _, n in tkern._columns(8, 16)) == 8


def test_cluster_plans_fit_the_card():
    """Wherever the plan takes the cluster kernel: at most 512 threads and
    32 k a lane, at most 232 448 bytes of shared memory (a block's limit on
    sm_90), Q = ceil(dh / 32), and RB the fewest rows (1, 2, 4) that keep
    every cluster on the card at once (8 GPCs of at least 14 SMs, a CTA an
    SM), or 4 where none does."""
    for b in (1, 2, 3, 4, 5, 8, 17, 33, 64):
        for nh in (1, 2, 3, 4, 8, 16):
            for dh in range(1, 300, 7):
                plan = tkern._plan(b, nh, dh)
                if dh > 256:
                    assert plan.instance == "stream"
                    continue
                threads, smem, kp = tkern._layout(dh, plan.q, plan.rb)
                assert plan.instance == "cluster" and smem == plan.smem
                assert threads <= 512 and kp <= 32
                assert smem <= 232_448
                assert plan.q == -(-dh // 32) and plan.rb in (1, 2, 4)
                fit = 8 * (14 // plan.q)
                assert nh * -(-b // plan.rb) <= fit or plan.rb == 4
                if plan.rb > 1:
                    assert nh * -(-b // (plan.rb // 2)) > fit


TRAINED = (4, 4, 192)     # b, nh, dh: xlstm-125m's trained sLSTM micro-batch


def test_train_shape_plans_the_bwd_cluster_kernel():
    """The backward at the train shape runs the cluster kernel with the
    forward's geometry: Q = 6, RB = 1, two 8-byte mbarriers and two dpre
    buffers of one row, eight e-blocks of 24 columns' four gates at a
    stride of 100 floats (≡ 4 mod 32)."""
    b, nh, dh = TRAINED
    plan = tkern._plan_bwd(b, nh, dh)
    assert plan == tkern.Plan("bwd_cluster", 6, 1, 16 + 4 * 2 * 8 * 100)
    assert (plan.q, plan.rb) == tkern._plan(b, nh, dh)[1:3]
    assert tkern._layout_bwd(dh, 6, 1) == (512, plan.smem, 24)


@pytest.mark.parametrize("dh", [257, 300, 512, 1024])
def test_wide_heads_plan_the_bwd_stream_kernel(dh):
    """Past dh = 256 a lane's e-block no longer fits its 32 registers of
    R: the stream backward takes the shape (12·dh floats of shared
    memory), as the stream forward does."""
    assert tkern._plan_bwd(4, 1, dh) == tkern.Plan("bwd_stream", 0, 0,
                                                   12 * dh * 4)
    assert tkern._plan_bwd(4, 1, 256).instance == "bwd_cluster"


def test_bwd_cluster_plans_fit_the_card():
    """Wherever the backward takes the cluster kernel: the forward's Q and
    RB, at most 512 threads and 32 e a lane, and its dpre buffers within
    the 48 KB of dynamic shared memory a kernel gets without opting in
    (the launcher sets no larger limit); each e-block stride ≡ 4 (mod 32)
    floats and a multiple of 4 (16-byte stores)."""
    for b in (1, 2, 3, 4, 5, 8, 9, 17, 33, 64):
        for nh in (1, 2, 3, 4, 8, 16):
            for dh in range(1, 300, 7):
                plan = tkern._plan_bwd(b, nh, dh)
                if dh > 256:
                    assert plan.instance == "bwd_stream"
                    continue
                fwd = tkern._plan(b, nh, dh)
                threads, smem, kp = tkern._layout_bwd(dh, plan.q, plan.rb)
                assert plan.instance == "bwd_cluster" and smem == plan.smem
                assert (plan.q, plan.rb) == (fwd.q, fwd.rb)
                assert threads <= 512 and kp <= 32 and smem <= 49_152
                eb = (smem - 16) // (4 * 2 * plan.rb * 8)
                assert eb % 32 == 4 and eb >= 4 * kp


@pytest.mark.parametrize("q", range(1, 17))
def test_bwd_cluster_rows_and_columns_cover_the_head_once(q):
    """The backward's CTA i owns the same [i·dh/q, (i+1)·dh/q) as rows k of
    dh_carry and as columns e of the gate backward, so a column finds its
    carried dh in its own CTA: each split covers the head once, and each
    column's e-block (e // kp, eight a head) holds it at one place."""
    for dh in range(1, 257):
        _, _, kp = tkern._layout_bwd(dh, q, 1)
        cols = tkern._columns(dh, q)
        assert sorted(e for e0, n in cols for e in range(e0, e0 + n)) == \
            list(range(dh))
        assert 8 * kp >= dh
        slots = {(e // kp, e % kp) for e in range(dh)}
        assert len(slots) == dh and max(b for b, _ in slots) < 8


def test_ragged_splits_at_the_bwd_test_shapes():
    """The card tests' backward edges: dh = 99 planned over 4 CTAs (24 and
    25 columns), B = 5 and 9 at the trained heads take RB = 2 and 4 with a
    last group of one row, and dh = 8 forced over 16 CTAs leaves eight with
    none."""
    assert sorted({n for _, n in tkern._columns(99, 4)}) == [24, 25]
    assert tkern._plan_bwd(3, 4, 99).q == 4
    for b, rb in ((5, 2), (9, 4)):
        plan = tkern._plan_bwd(b, 4, 192)
        assert plan.instance == "bwd_cluster" and plan.rb == rb
        assert b % rb == 1
    assert sum(n == 0 for _, n in tkern._columns(8, 16)) == 8


def test_forced_backward_needs_a_cuda_tensor():
    """`_forced_bwd` names a kernel: on CPU tensors there is none to run,
    so it raises rather than running the plain loop, and counts nothing."""
    xg, r, st, dhs, dfin = _bwd_inputs(BWD_CASES[0])
    nh = BWD_CASES[0][2]
    hs, _ = tref.slstm_fused(_t(xg), _t(r), tuple(map(_t, st)), nh)
    tkern.reset_launch_counts()
    for forced in ("stream", (6, 1)):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            tkern._forced_bwd(forced, _t(xg), _t(r), tuple(map(_t, st)), nh,
                              hs, _t(dhs), tuple(map(_t, dfin)))
    assert tkern.LAUNCHES["slstm_fused_bwd"] == 0


def test_reset_zeroes_the_instance_counts_and_cpu_counts_none():
    tkern.INSTANCE_LAUNCHES["cluster"] = 3
    tkern.INSTANCE_LAUNCHES["bwd_stream"] = 2
    tkern.INSTANCE_LAUNCHES["bwd_cluster"] = 1
    tkern.reset_launch_counts()
    none = {"cluster": 0, "stream": 0, "bwd_cluster": 0, "bwd_stream": 0}
    assert tkern.INSTANCE_LAUNCHES == none
    xg, r, st = _valid()
    tkern.slstm_fused(xg, r, st, 2)
    assert tkern.INSTANCE_LAUNCHES == none


# ---------------------------------------------------------------------------
# the backward: the plain reverse loop against autograd and jax.grad
# ---------------------------------------------------------------------------

# (b, s, nh, dh, nonzero initial state, nonzero final-state cotangents,
# a tie in the stabilizer's max at t = 0)
BWD_CASES = [(2, 37, 2, 16, False, False, False),
             (2, 37, 1, 100, True, True, False),
             (1, 37, 2, 192, True, False, False),
             (2, 1, 2, 16, False, True, False),
             (2, 1, 1, 100, True, False, False),
             (2, 6, 2, 16, True, False, True)]
BWD_IDS = ["dh16", "dh100_state_dstate", "dh192_state", "s1_dstate",
           "s1_dh100_state", "max_tie"]


def _bwd_inputs(case, seed=3):
    """xg, r, state as `_inputs` draws them (zero or nonzero state), and
    the cotangents of hs (N) and of the final state (N, or zero); for the
    tie case m0 = 0.5, h0 = 0 and xg's f̃ = 1.0, ĩ = 1.5 at t = 0, so f̃ +
    m0 == ĩ exactly."""
    b, s, nh, dh, nz, dst, tie = case
    xg, r, st = _inputs(b, s, nh, dh, seed, zero_state=not nz)
    d = nh * dh
    st = [v.copy() for v in st]
    if tie:
        st[2][:] = 0.0
        st[3][:] = 0.5
        xg[:, 0, d:2 * d] = 1.5
        xg[:, 0, 2 * d:3 * d] = 1.0
    rng = np.random.default_rng(seed + 1)
    dhs = rng.standard_normal((b, s, d)).astype(np.float32)
    dfin = [(rng.standard_normal((b, d)) * (1.0 if dst else 0.0)).astype(
        np.float32) for _ in range(4)]
    return xg, r, tuple(st), dhs, tuple(dfin)


def _autograd(xg, r, st, nh, dhs, dfin, dtype):
    """Gradients of sum(hs·dhs) + Σ sum(final·dfin) through
    `ref.slstm_fused` in ``dtype``: (dxg, dr, dc0, dn0, dh0, dm0), and
    hs."""
    leaves = [_t(a, dtype).requires_grad_(True) for a in (xg, r, *st)]
    hs, fin = tref.slstm_fused(leaves[0], leaves[1], tuple(leaves[2:]),
                               r.shape[1], dtype)
    out = (hs * _t(dhs, dtype)).sum() + sum(
        (f * _t(g, dtype)).sum() for f, g in zip(fin, dfin))
    return torch.autograd.grad(out, leaves), hs.detach()


def _plain_bwd(xg, r, st, nh, dhs, dfin, dtype, hs):
    dxg, dr, dst0 = tref.slstm_fused_bwd(
        _t(xg, dtype), _t(r, dtype), tuple(_t(a, dtype) for a in st), nh,
        hs, _t(dhs, dtype), tuple(_t(a, dtype) for a in dfin), dtype)
    return (dxg, dr, *dst0)


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_plain_backward_equals_autograd_in_float64(case):
    """The reverse loop is the derivative of the forward: in float64 every
    gradient within 1e-10 of autograd through `ref.slstm_fused`."""
    xg, r, st, dhs, dfin = _bwd_inputs(case)
    nh = case[2]
    want, hs = _autograd(xg, r, st, nh, dhs, dfin, torch.float64)
    got = _plain_bwd(xg, r, st, nh, dhs, dfin, torch.float64, hs)
    for name, g, w in zip(("xg", "r", "c0", "n0", "h0", "m0"), got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-10,
                                   err_msg=name)
    if case[-1]:                                  # the tie is hit and split
        pre, _ = tref.recompute(_t(xg, torch.float64), _t(r, torch.float64),
                                tuple(_t(a, torch.float64) for a in st), nh,
                                hs, torch.float64)
        d = case[2] * case[3]
        assert bool((pre[:, 0, 2 * d:3 * d] + 0.5
                     == pre[:, 0, d:2 * d]).all())


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_plain_backward_in_f32_within_the_slstm_bound(case):
    """In f32 the reverse loop and autograd sum in other orders; each
    gradient is within the sLSTM bound of autograd's f32 result: atol
    1e-4 · max(1, max|truth|), or 4× autograd's own distance from the
    float64 truth where that is larger."""
    xg, r, st, dhs, dfin = _bwd_inputs(case)
    nh = case[2]
    truth, _ = _autograd(xg, r, st, nh, dhs, dfin, torch.float64)
    want, hs = _autograd(xg, r, st, nh, dhs, dfin, torch.float32)
    got = _plain_bwd(xg, r, st, nh, dhs, dfin, torch.float32, hs)
    for name, g, w, t in zip(("xg", "r", "c0", "n0", "h0", "m0"), got,
                             want, truth):
        assert g.dtype == torch.float32, name
        scale = max(1.0, float(t.abs().max()))
        own = float((w.double() - t).abs().max())
        err = float((g - w).abs().max())
        assert err <= max(1e-4 * scale, 4 * own), (name, err, own, scale)


def test_wrapper_backward_on_the_cpu_rounds_as_autograd_and_counts_none():
    """`slstm_fused_bwd` on CPU tensors: the plain backward, dxg in xg's
    type and dr in r's, no launch counted; it refuses what the forward
    refuses and cotangents of the wrong shape."""
    xg, r, st, dhs, dfin = _bwd_inputs(BWD_CASES[0])
    nh = BWD_CASES[0][2]
    tkern.reset_launch_counts()
    xb, rb = _t(xg, torch.bfloat16), _t(r, torch.bfloat16)
    state = tuple(map(_t, st))
    hs, _ = tkern.slstm_fused(xb, rb, state, nh)
    dxg, dr, dst0 = tkern.slstm_fused_bwd(xb, rb, state, nh, hs, _t(dhs),
                                          tuple(map(_t, dfin)))
    want = tref.slstm_fused_bwd(xb, rb, state, nh, hs, _t(dhs),
                                tuple(map(_t, dfin)))
    assert (dxg.dtype, dr.dtype) == (torch.bfloat16, torch.bfloat16)
    assert torch.equal(dxg, want[0].to(torch.bfloat16))
    assert torch.equal(dr, want[1].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(dst0, want[2]))
    assert tkern.LAUNCHES == {"slstm_fused": 0, "slstm_fused_bwd": 0}
    with pytest.raises(ValueError, match="dhs must be"):
        tkern.slstm_fused_bwd(xb, rb, state, nh, hs, _t(dhs)[:, 1:],
                              tuple(map(_t, dfin)))
    with pytest.raises(ValueError, match="nh must be"):
        tkern.slstm_fused_bwd(xb, rb, state, 0, hs, _t(dhs),
                              tuple(map(_t, dfin)))


def test_model_slstm_scan_gradient_matches_jax_grad():
    """`models.xlstm.slstm_scan` (the autograd Function) against jax.grad
    of the reference's `slstm_scan` (its `lax.scan`), f32, from a nonzero
    state, with cotangents on hs and on every final-state tensor: rtol
    1e-4, atol 1e-4 · max|want|."""
    import jax
    b, s, nh, dh = 2, 23, 2, 16
    xg, r, st, dhs, _ = _bwd_inputs((b, s, nh, dh, True, True, False))
    rng = np.random.default_rng(9)
    dfin = [rng.standard_normal((b, nh * dh)).astype(np.float32)
            for _ in range(4)]

    def jloss(xg_, r_, *st_):
        hs, fin = jxlstm.slstm_scan({"slstm_r": r_}, xg_, nh, st_)
        return (hs * dhs).sum() + sum((f * g).sum()
                                      for f, g in zip(fin, dfin))
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (xg, r, *st)))
    leaves = [_t(a).requires_grad_(True) for a in (xg, r, *st)]
    hs, fin = txlstm.slstm_scan({"slstm_r": leaves[1]}, leaves[0], nh,
                                tuple(leaves[2:]))
    out = (hs * _t(dhs)).sum() + sum((f * _t(g)).sum()
                                     for f, g in zip(fin, dfin))
    got = torch.autograd.grad(out, leaves)
    for name, g, w in zip(("xg", "r", "c0", "n0", "h0", "m0"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
    assert float(got[1].abs().max()) > 0


def test_bwd_costs_at_the_train_shape():
    """xlstm-125m's sLSTM at a 4 × 2048-token micro-batch: pre, c, n, m,
    hs and dhs (f32) read once, dpre written once, bf16 R once, the
    states: 328.4 MB; the transpose product's 9.66e9 operations."""
    c = tkern.slstm_bwd_costs(4, 2048, 4, 192)
    bsd = 4 * 2048 * 768
    assert c["bytes"] == bsd * 9 * 4 + bsd * 4 * 4 + 4 * 4 * 192 * 192 * 2 \
        + 8 * 4 * 768 * 4 == 328_433_664
    assert c["flops"] == tkern.slstm_costs(4, 2048, 4, 192)["flops"]

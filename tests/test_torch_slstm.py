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
card (threads, shared memory, registers, clusters at once).
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
    assert tkern.LAUNCHES == {"slstm_fused": 0}


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


def test_reset_zeroes_the_instance_counts_and_cpu_counts_none():
    tkern.INSTANCE_LAUNCHES["cluster"] = 3
    tkern.reset_launch_counts()
    assert tkern.INSTANCE_LAUNCHES == {"cluster": 0, "stream": 0}
    xg, r, st = _valid()
    tkern.slstm_fused(xg, r, st, 2)
    assert tkern.INSTANCE_LAUNCHES == {"cluster": 0, "stream": 0}

"""Port vs reference: the Volterra, fixed-point-quantize and conv1d kernels
(repro_torch.kernels.{volterra,quant,conv1d}).

On the CPU each wrapper runs its kernel's plain version (`ref.py`), which
fixes the kernel's order of operations; these tests hold it against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs
and the same weights (carried through `interop`):

  * quant:    bitwise at integer widths (round half to even, saturation);
  * volterra: rtol = atol = 1e-5 (the port sums one product at a time in
              the kernel's order, the reference in einsums / dots);
  * conv1d:   atol = 1e-6 plus rtol = 1e-6. At these inputs (|y| up to
              9) the reference's own Pallas kernel and oracle differ by up
              to 1.9e-6, and the port and the Pallas kernel by up to
              2.4e-6 (measured): a few float32 ulps, from the port's
              tap-major-then-C_in order against XLA's dots and FMAs.

The conv1d plan (`conv1d._plan`) takes the register-blocked kernel at the
deployed CNN's three layer shapes and the generic one elsewhere, and the
plain version both kernels repeat sums tap-major, then C_in ascending
(checked bitwise against a float32 scalar loop). On the card each kernel
must equal its plain version bitwise (tests/test_torch_cuda.py;
chip_smoke.py at full size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import equalizer as jeq
from repro.core import volterra as jvol
from repro.kernels.conv1d import ops as jc1_ops
from repro.kernels.conv1d.conv1d import conv1d as jconv1d_pallas
from repro.kernels.quant import ops as jq_ops
from repro.kernels.quant.quant import fixed_point_quantize as jquant_pallas
from repro.kernels.volterra import ops as jv_ops
from repro_torch import interop
from repro_torch.configs import equalizer_ht as THT
from repro_torch.core import equalizer as teq
from repro_torch.core import qat as tqat
from repro_torch.core import volterra as tvol
from repro_torch.kernels import _build
from repro_torch.kernels.conv1d import conv1d as tc1
from repro_torch.kernels.conv1d import ops as tc1_ops
from repro_torch.kernels.quant import ops as tq_ops
from repro_torch.kernels.quant import quant as tq
from repro_torch.kernels.volterra import ops as tv_ops
from repro_torch.kernels.volterra import ref as tv_ref
from repro_torch.kernels.volterra import volterra as tv

VOL_TOL = 1e-5
CONV_ATOL = CONV_RTOL = 1e-6
KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# volterra
# ---------------------------------------------------------------------------

def _vol_params(m1, m2, m3, seed=0):
    """JAX-initialized Volterra params with non-trivial nonlinear kernels
    (as tests/test_kernels.py makes them), as numpy."""
    cfg = jvol.VolterraConfig(m1=m1, m2=m2, m3=m3)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jvol.init(KEY, cfg))
    params["w0"] = np.float32(0.05)
    params["w1"] = (params["w1"] + 0.1 * rng.standard_normal(m1)).astype(
        np.float32)
    if m2:
        params["w2"] = (0.1 * rng.standard_normal((m2, m2))).astype(
            np.float32)
    if m3:
        params["w3"] = (0.05 * rng.standard_normal((m3, m3, m3))).astype(
            np.float32)
    return cfg, tvol.VolterraConfig(m1=m1, m2=m2, m3=m3), params


@pytest.mark.parametrize("m1,m2,m3", [(25, 9, 0), (9, 3, 3), (15, 0, 0),
                                      (41, 15, 9)])
def test_volterra_equalize_matches_pallas(m1, m2, m3):
    jcfg, tcfg, params = _vol_params(m1, m2, m3)
    x = np.random.default_rng(1).standard_normal((2, 256)).astype(np.float32)
    want = np.asarray(jv_ops.equalize(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x), jcfg, use_pallas=True,
                                      tile=32))
    tp = interop.to_torch(params, device="cpu")
    got = tv_ops.equalize(tp, x, tcfg, device="cpu")
    assert got.shape == (2, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=VOL_TOL, atol=VOL_TOL)
    # the wrapper on a CPU tensor is the plain version, at any tile; the
    # plain path of `equalize` is the same function
    plain = tv_ops.equalize(tp, x, tcfg, use_kernel=False, device="cpu")
    assert torch.equal(got, plain)
    assert torch.equal(got[0], tv_ops.equalize(tp, x[0], tcfg, tile=7,
                                               device="cpu"))


def test_volterra_kernel_semantics_vs_core_at_every_position():
    """ops.equalize pads once by the common halo, core.apply each order on
    its own. Both pad with zeros, so every window holds the same samples and
    the two agree at every position, edges included, up to rounding (the
    reference's own test compares the interior only)."""
    _, tcfg, params = _vol_params(9, 5, 3, seed=2)
    tp = interop.to_torch(params, device="cpu")
    x = _t(np.random.default_rng(3).standard_normal((1, 512)).astype(
        np.float32))
    y_k = tv_ops.equalize(tp, x, tcfg, device="cpu")
    y_c = tvol.apply(tp, x, tcfg)
    np.testing.assert_allclose(y_k.numpy(), y_c.numpy(), rtol=VOL_TOL,
                               atol=VOL_TOL)


def test_volterra_plain_version_sums_in_the_kernel_order():
    """The plain version computes ((w0 + o1) + o2) + o3 with each sum in the
    documented order: checked against a scalar loop in float32."""
    _, _, p = _vol_params(5, 3, 3, seed=4)
    x = np.random.default_rng(5).standard_normal((1, 20)).astype(np.float32)
    f = np.float32
    halo, stride = 2, 2
    xp = np.pad(x[0], (halo, halo))
    want = []
    for n in range(10):
        c = n * stride + halo
        w1 = xp[c - 2:c + 3]
        o1 = f(0)
        for m in range(5):
            o1 = f(o1 + f(w1[m] * p["w1"][m]))
        w2 = xp[c - 1:c + 2]
        o2 = f(0)
        for k in range(3):
            t = f(0)
            for j in range(3):
                t = f(t + f(w2[j] * p["w2"][j, k]))
            o2 = f(o2 + f(t * w2[k]))
        o3 = f(0)
        for i in range(3):
            s = f(0)
            for k in range(3):
                t = f(0)
                for j in range(3):
                    t = f(t + f(w2[j] * p["w3"][i, j, k]))
                s = f(s + f(t * w2[k]))
            o3 = f(o3 + f(w2[i] * s))
        want.append(f(f(f(f(p["w0"]) + o1) + o2) + o3))
    tp = interop.to_torch(p, device="cpu")
    got = tv_ref.volterra(_t(x), tp["w0"], tp["w1"], tp["w2"], tp["w3"], 2)
    np.testing.assert_array_equal(got[0].numpy(), np.array(want, np.float32))


def test_volterra_wrapper_checks_its_inputs():
    _, _, p = _vol_params(5, 3, 0)
    tp = interop.to_torch(p, device="cpu")
    x = torch.zeros(2, 40)
    with pytest.raises(ValueError, match="float32"):
        tv.volterra(x.double(), tp["w0"], tp["w1"], tp["w2"])
    with pytest.raises(ValueError, match="cube"):
        tv.volterra(x, tp["w0"], tp["w1"], tp["w2"][:, :2])
    with pytest.raises(ValueError, match="w0"):
        tv.volterra(x, tp["w1"], tp["w1"], tp["w2"])
    before = dict(tv.LAUNCHES)
    tv.volterra(x, tp["w0"], tp["w1"], tp["w2"])
    assert tv.LAUNCHES == before            # the CPU path launches nothing


# ---------------------------------------------------------------------------
# quant
# ---------------------------------------------------------------------------

def _quant_inputs(ib, fb):
    rng = np.random.default_rng(ib * 31 + fb)
    scale = 2.0 ** fb
    lim = 2.0 ** ib
    halves = (np.arange(-40, 40) + 0.5) / scale          # exactly half-way
    past = np.array([lim, lim + 1, 3 * lim, -lim - 1 / scale, -3 * lim,
                     lim - 0.5 / scale, -lim - 0.5 / scale])
    edge = [0.0, -0.0, 0.5 / scale, 1.5 / scale, 1 / scale]
    x = np.concatenate([rng.standard_normal(300) * lim, halves, past, edge])
    return x.astype(np.float32).reshape(-1, 4)


@pytest.mark.parametrize("ib,fb", [(0, 0), (1, 3), (2, 5), (3, 4), (5, 10),
                                   (8, 8)])
def test_fixed_point_quantize_is_bitwise_jax(ib, fb):
    x = _quant_inputs(ib, fb)
    want = np.asarray(jquant_pallas(jnp.asarray(x), float(ib), float(fb),
                                    block=64, interpret=True))
    got = tq.fixed_point_quantize(_t(x), float(ib), float(fb))
    np.testing.assert_array_equal(got.numpy(), want)
    # widths as 0-d tensors (as learned widths arrive) give the same values
    got_t = tq.fixed_point_quantize(_t(x), torch.tensor(float(ib)),
                                    torch.tensor(float(fb)))
    assert torch.equal(got_t, got)
    # and the QAT fake-quantizer agrees at integer widths
    assert torch.equal(tqat.quantize_fixed(_t(x), ib, fb), got)


def test_quantize_params_is_bitwise_jax():
    cfg = jeq.CNNEqConfig(layers=3, kernel=9, channels=5, v_parallel=8)
    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, jeq.init(KEY, cfg))
    for layer in params["conv"]:
        layer["b"] = (0.3 * rng.standard_normal(layer["b"].shape)).astype(
            np.float32)
    qparams = {f"layer{i}": {"w_int": np.float32(wi), "w_frac": np.float32(wf),
                             "a_int": np.float32(3), "a_frac": np.float32(4)}
               for i, (wi, wf) in enumerate([(1, 6), (0, 7), (2, 5)])}
    want = jax.tree.map(np.asarray, jq_ops.quantize_params(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, qparams),
        use_pallas=True))
    got = tq_ops.quantize_params(interop.to_torch(params, device="cpu"),
                                 interop.to_torch(qparams, device="cpu"),
                                 device="cpu")
    for lw, lg in zip(want["conv"], got["conv"]):
        np.testing.assert_array_equal(lg["w"].numpy(), lw["w"])
        np.testing.assert_array_equal(lg["b"].numpy(), lw["b"])
    plain = tq_ops.quantize_params(params, qparams, use_kernel=False,
                                   device="cpu")
    for lp, lg in zip(plain["conv"], got["conv"]):
        assert torch.equal(lp["w"], lg["w"]) and torch.equal(lp["b"], lg["b"])


# ---------------------------------------------------------------------------
# conv1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,c_in,c_out,width,kernel,stride", [
    (1, 1, 5, 128, 9, 8),          # equalizer layer 1
    (2, 5, 5, 256, 9, 1),          # mid layer
    (2, 5, 8, 254, 9, 2),          # output layer, non-tile-aligned width
    (1, 3, 7, 64, 15, 4),
    (4, 2, 2, 33, 3, 1),           # tiny odd width
    (1, 1, 1, 512, 21, 2),
])
def test_conv1d_matches_pallas(batch, c_in, c_out, width, kernel, stride):
    rng = np.random.default_rng(batch * 100 + width)
    x = rng.standard_normal((batch, c_in, width)).astype(np.float32)
    w = (0.3 * rng.standard_normal((c_out, c_in, kernel))).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(jconv1d_pallas(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), stride, tile_w=64,
                                     interpret=True))
    got = tc1.conv1d(_t(x), _t(w), _t(b), stride, tile_w=64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_RTOL,
                               atol=CONV_ATOL)


@pytest.mark.parametrize("layer", range(3))
def test_conv1d_same_lower_at_equalizer_ht_layers(layer):
    """Each trained-CNN layer shape of equalizer_ht: (1→5, /8), (5→5, /1),
    (5→8, /2), on BN-folded weights."""
    params = jax.tree.map(np.asarray, jeq.init(KEY, jeq.CNNEqConfig()))
    w = params["conv"][layer]["w"]
    c_in = w.shape[1]
    stride = THT.CNN.layer_specs()[layer][2]
    rng = np.random.default_rng(layer)
    b = (0.1 * rng.standard_normal(w.shape[0])).astype(np.float32)
    x = rng.standard_normal((2, c_in, 2 * 8 * 37)).astype(np.float32)
    want = np.asarray(jc1_ops.conv1d_same_lower(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
        use_pallas=True, tile_w=64))
    got = tc1_ops.conv1d_same_lower(x, w, b, stride, tile_w=64, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_RTOL,
                               atol=CONV_ATOL)
    # the layer of the port's own CNN forward (F.conv1d, SAME_LOWER)
    ref = teq._conv1d(_t(x), _t(w), stride) + _t(b)[None, :, None]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=CONV_RTOL,
                               atol=CONV_ATOL)
    plain = tc1_ops.conv1d_same_lower(x, w, b, stride, use_kernel=False,
                                      device="cpu")
    assert torch.equal(got, plain)


def test_conv1d_wrapper_checks_its_inputs():
    x, w, b = torch.zeros(1, 2, 30), torch.zeros(3, 2, 5), torch.zeros(3)
    with pytest.raises(ValueError, match="channel mismatch"):
        tc1.conv1d(x, w[:, :1], b)
    with pytest.raises(ValueError, match="float32"):
        tc1.conv1d(x, w.double(), b)
    with pytest.raises(ValueError, match="W >= K"):
        tc1.conv1d(x[:, :, :3], w, b)
    before = dict(tc1.LAUNCHES), dict(tc1.INSTANCE_LAUNCHES)
    assert tc1.conv1d(x, w, b, 2).shape == (1, 3, 13)
    assert (tc1.LAUNCHES, tc1.INSTANCE_LAUNCHES) == before


# the register-blocked conv1d kernel's plan (conv1d._plan, mirrored by
# csrc/conv1d.cu's conv1d_plan, which the card tests hold it to): the
# deployed CNN's three layer shapes, as (k, c_in, c_out, stride)
RB_LAYERS = [(9, 1, 5, 8), (9, 5, 5, 1), (9, 5, 8, 2)]


@pytest.mark.parametrize("dims", RB_LAYERS)
def test_conv1d_plan_takes_register_blocked_kernel_at_deploy_shapes(dims):
    assert tc1._plan(dims) == "rb"
    k, c_in, c_out, stride = dims
    assert tc1._dims(torch.zeros(c_out, c_in, k), stride) == dims


@pytest.mark.parametrize("dims", [(7, 1, 5, 8), (9, 4, 5, 1), (9, 5, 7, 2),
                                  (9, 5, 8, 1), (9, 1, 5, 4), (15, 3, 7, 4)])
def test_conv1d_plan_takes_generic_kernel_elsewhere(dims):
    assert tc1._plan(dims) == "generic"


@pytest.mark.parametrize("dims", RB_LAYERS)
@pytest.mark.parametrize("width", [1, 9, 17, 301])
def test_conv1d_same_lower_matches_jax_at_rb_shapes(dims, width):
    """The deploy entry point at the register-blocked kernel's shapes, on
    widths down to one sample (one output position), against the JAX
    package's conv1d_same_lower (Pallas, interpret mode)."""
    k, c_in, c_out, stride = dims
    rng = np.random.default_rng(width * 10 + stride)
    x = rng.standard_normal((2, c_in, width)).astype(np.float32)
    w = (0.3 * rng.standard_normal((c_out, c_in, k))).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(jc1_ops.conv1d_same_lower(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
        use_pallas=True, tile_w=64))
    got = tc1_ops.conv1d_same_lower(x, w, b, stride, device="cpu")
    assert got.shape == want.shape == (2, c_out, (width - 1) // stride + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_RTOL,
                               atol=CONV_ATOL)


@pytest.mark.parametrize("dims", RB_LAYERS)
def test_conv_valid_taps_sums_in_the_kernel_order(dims):
    """The conv1d kernels' plain version adds each product in turn, tap-major
    then C_in ascending, from zero, bias last: checked bitwise against a
    float32 scalar loop at the deployed CNN's widths."""
    k, c_in, c_out, stride = dims
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((1, c_in, 4 * stride + k)).astype(np.float32)
    w = (0.3 * rng.standard_normal((c_out, c_in, k))).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    f = np.float32
    n_out = (x.shape[2] - k) // stride + 1
    want = np.zeros((c_out, n_out), np.float32)
    for c in range(c_out):
        for m in range(n_out):
            acc = f(0)
            for kk in range(k):
                for ci in range(c_in):
                    acc = f(acc + f(w[c, ci, kk] * x[0, ci, m * stride + kk]))
            want[c, m] = f(acc + b[c])
    got = tc1.conv1d(_t(x), _t(w), _t(b), stride)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_conv1d_forced_launch_refuses_a_host_tensor():
    x, w, b = torch.zeros(1, 5, 30), torch.zeros(5, 5, 9), torch.zeros(5)
    for instance in ("rb", "generic"):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            tc1._forced(instance, x, w, b, 1)


def test_conv1d_source_is_self_contained():
    """csrc/conv1d.cu includes no header of its own (a header shared with
    another source would tie their build keys together)."""
    assert _build._INCLUDE.findall(tc1.CSRC.read_bytes()) == []


# ---------------------------------------------------------------------------
# build: one path for every kernel, and it never falls back
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [tv, tq, tc1], ids=["volterra", "quant",
                                                        "conv1d"])
def test_missing_compiler_raises_for_every_kernel(monkeypatch, tmp_path,
                                                  module):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        module.build()
    assert module.CSRC.is_file() and module.CSRC.suffix == ".cu"

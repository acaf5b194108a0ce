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

In bfloat16 and float16 (x, and the weights, in the 16-bit type; float32
arithmetic, one rounding to x's type, as the reference): quant bitwise;
volterra and conv1d within one ulp of x's type of the JAX result (the
float32 sums differ by a few float32 ulps, which can move the one
rounding to the next 16-bit value). Each deploy entry point returns x's
type. `fixed_point_quantize_many` (one launch on the card for the deploy
path's six tensors) is bitwise the JAX `quantize_params`.

The conv1d plan (`conv1d._plan`) takes the register-blocked kernel at the
deployed CNN's three layer shapes and the generic one elsewhere, and the
plain version both kernels repeat sums tap-major, then C_in ascending
(checked bitwise against a float32 scalar loop); the Volterra plan
(`volterra._plan`) takes its register-blocked kernel at the deployed
baseline (25, 9, 0) at N_os = 2 and the generic one elsewhere. On the card
each kernel must equal its plain version bitwise (tests/test_torch_cuda.py;
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
from repro_torch.device import as_float
from repro_torch.kernels import _build
from repro_torch.kernels.conv1d import conv1d as tc1
from repro_torch.kernels.conv1d import ops as tc1_ops
from repro_torch.kernels.quant import ops as tq_ops
from repro_torch.kernels.quant import quant as tq
from repro_torch.kernels.quant import ref as tq_ref
from repro_torch.kernels.volterra import ops as tv_ops
from repro_torch.kernels.volterra import ref as tv_ref
from repro_torch.kernels.volterra import volterra as tv

VOL_TOL = 1e-5
CONV_ATOL = CONV_RTOL = 1e-6
KEY = jax.random.PRNGKey(0)
HALF = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]
HALF_IDS = ["bf16", "f16"]
# explicit mantissa bits and least normal exponent of each 16-bit type
_ULP = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _h(a):
    """A JAX array of any float type as a torch tensor of that type."""
    return as_float(np.asarray(a), torch.device("cpu"))


def _assert_within_one_ulp(got: torch.Tensor, want, dtype) -> None:
    """|got − want| ≤ one ulp of ``dtype`` at the larger magnitude."""
    assert got.dtype == dtype
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert g.shape == w.shape
    mant, emin = _ULP[dtype]
    mag = np.maximum(np.abs(g), np.abs(w))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.exp2(np.maximum(exp, emin) - mant)
    bad = np.abs(g - w) > ulp
    assert not bad.any(), (f"{int(bad.sum())} values beyond one ulp; max "
                           f"|diff| {float(np.abs(g - w).max())}")


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


@pytest.mark.parametrize("jdt,tdt", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("m1,m2,m3", [(25, 9, 0), (41, 15, 9), (121, 35, 15)])
def test_volterra_16bit_matches_pallas_within_one_ulp(m1, m2, m3, jdt, tdt):
    """x and the weights in bfloat16 / float16 through `ops.equalize`,
    against the JAX kernel on the same 16-bit arrays: x's type out, within
    one ulp of it (the deployed baseline and the DSE's two largest sets)."""
    jcfg, tcfg, params = _vol_params(m1, m2, m3)
    x = np.random.default_rng(1).standard_normal((2, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    want = jv_ops.equalize(jp, jx, jcfg, use_pallas=True, tile=32)
    assert want.dtype == jdt
    tp = {k: np.asarray(v) for k, v in jp.items()}
    got = tv_ops.equalize(tp, np.asarray(jx), tcfg, device="cpu")
    assert got.shape == (2, 128)
    _assert_within_one_ulp(got, want, tdt)
    plain = tv_ops.equalize(tp, np.asarray(jx), tcfg, use_kernel=False,
                            device="cpu")
    assert torch.equal(got, plain)


def test_volterra_plain_version_rounds_once_to_x_dtype():
    """In bfloat16 the plain version is the float32 computation on the
    widened inputs, rounded once."""
    _, _, p = _vol_params(25, 9, 0, seed=6)
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(np.random.default_rng(7).standard_normal((2, 300)).astype(
        np.float32)).to(torch.bfloat16)
    got = tv_ref.volterra(x, tp["w0"], tp["w1"], tp["w2"], None, 2)
    want = tv_ref.volterra(x.float(), tp["w0"], tp["w1"], tp["w2"], None, 2)
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))


def test_volterra_plan_takes_register_blocked_kernel_at_deployed_shape():
    cfg = tvol.VolterraConfig()
    p = tvol.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    dims = tv._dims(p["w1"], p.get("w2"), p.get("w3"), cfg.n_os)
    assert dims == (25, 9, 0, 2) and tv._plan(dims) == "rb"


@pytest.mark.parametrize("dims", [(25, 9, 0, 1), (25, 9, 3, 2), (41, 15, 9, 2),
                                  (121, 35, 15, 2), (25, 0, 0, 2),
                                  (23, 9, 0, 2), (25, 7, 0, 2)])
def test_volterra_plan_takes_generic_kernel_elsewhere(dims):
    assert tv._plan(dims) == "generic"


def test_volterra_forced_launch_refuses_a_host_tensor():
    _, _, p = _vol_params(25, 9, 0)
    tp = interop.to_torch(p, device="cpu")
    for instance in ("rb", "generic"):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            tv._forced(instance, torch.zeros(1, 40), tp["w0"], tp["w1"],
                       tp["w2"])


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


QUANT_WIDTHS = [(0, 0), (1, 3), (2, 5), (3, 4), (5, 10), (8, 8)]


@pytest.mark.parametrize("ib,fb", QUANT_WIDTHS)
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


@pytest.mark.parametrize("jdt,tdt", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("ib,fb", QUANT_WIDTHS)
def test_fixed_point_quantize_16bit_is_bitwise_jax(ib, fb, jdt, tdt):
    """bfloat16 / float16 in, the same type out, equal to the JAX kernel's
    values on the same 16-bit array (as the float32 test: a zero result's
    sign is not held, since jnp.clip and torch.minimum differ there)."""
    x = jnp.asarray(_quant_inputs(ib, fb)).astype(jdt)
    want = jquant_pallas(x, float(ib), float(fb), block=64, interpret=True)
    assert want.dtype == jdt
    got = tq.fixed_point_quantize(_h(x), float(ib), float(fb))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    assert torch.equal(got, tq_ref.fixed_point_quantize(
        _h(x).float(), ib, fb).to(tdt))


def _cnn_params(seed=7):
    cfg = jeq.CNNEqConfig(layers=3, kernel=9, channels=5, v_parallel=8)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jeq.init(KEY, cfg))
    for layer in params["conv"]:
        layer["b"] = (0.3 * rng.standard_normal(layer["b"].shape)).astype(
            np.float32)
    qparams = {f"layer{i}": {"w_int": np.float32(wi), "w_frac": np.float32(wf),
                             "a_int": np.float32(3), "a_frac": np.float32(4)}
               for i, (wi, wf) in enumerate([(1, 6), (0, 7), (2, 5)])}
    return params, qparams


def test_quantize_params_is_bitwise_jax():
    params, qparams = _cnn_params()
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


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_fixed_point_quantize_many_is_bitwise_jax_quantize_params(dtype):
    """The one-launch entry point on the trained CNN's six tensors, each at
    its layer's widths (0-d tensors, as learned widths arrive), against the
    JAX package's quantize_params (one Pallas call per tensor)."""
    params, qparams = _cnn_params(seed=9)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    want = jq_ops.quantize_params(params, jax.tree.map(jnp.asarray, qparams),
                                  use_pallas=True)
    xs, widths, wants = [], [], []
    for i, (layer, lw) in enumerate(zip(params["conv"], want["conv"])):
        q = qparams[f"layer{i}"]
        for key in ("w", "b"):
            xs.append(_h(layer[key]))
            widths.append((torch.tensor(q["w_int"]),
                           torch.tensor(q["w_frac"])))
            wants.append(_h(lw[key]))
    before = dict(tq.LAUNCHES)
    got = tq.fixed_point_quantize_many(xs, widths)
    assert tq.LAUNCHES == before            # the CPU path launches nothing
    assert len(got) == 6
    for g, w, x in zip(got, wants, xs):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_array_equal(g.float().numpy(), w.float().numpy())


def test_fixed_point_quantize_many_checks_its_inputs():
    x = torch.zeros(4)
    assert tq.fixed_point_quantize_many([], []) == []
    with pytest.raises(ValueError, match="widths"):
        tq.fixed_point_quantize_many([x, x], [(1, 2)])
    with pytest.raises(ValueError, match="float32"):
        tq.fixed_point_quantize_many([x.double()], [(1, 2)])


def test_quant_output_lines_up_with_an_unaligned_input():
    """The per-tensor kernel reads and writes 16 bytes an access: the
    wrapper's output sits at the input's offset within 16 bytes."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for off in range(9):
            x = torch.zeros(40, dtype=dtype)[off:off + 17]
            out = tq._out_like(x)
            assert out.shape == x.shape and out.dtype == dtype
            assert (out.data_ptr() - x.data_ptr()) % 16 == 0


def test_quant_widths_travel_by_value_or_by_device_pointer():
    card = torch.device("cuda", 0)         # a device object; no card needed
    assert tq._width(2, card)[:2] == (0, 2.0)
    assert tq._width(torch.tensor(3.5), card)[:2] == (0, 3.5)
    host = torch.tensor(4.0)
    ptr, _, held = tq._width(host, torch.device("cpu"))
    assert ptr == host.data_ptr() and held is host
    with pytest.raises(ValueError, match="one value"):
        tq._width(torch.zeros(2), card)


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


@pytest.mark.parametrize("jdt,tdt", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("batch,c_in,c_out,width,kernel,stride", [
    (1, 1, 5, 128, 9, 8),
    (2, 5, 5, 256, 9, 1),
    (2, 5, 8, 254, 9, 2),
    (1, 3, 7, 64, 15, 4),
    (4, 2, 2, 33, 3, 1),
    (1, 1, 1, 512, 21, 2),
])
def test_conv1d_16bit_matches_pallas_within_one_ulp(batch, c_in, c_out, width,
                                                    kernel, stride, jdt, tdt):
    """The reference's own bf16 grid (tests/test_kernels.py), and f16: x, w
    and b in the 16-bit type, x's type out, within one ulp of the JAX
    kernel's result on the same arrays."""
    rng = np.random.default_rng(batch * 100 + width)
    x = jnp.asarray(rng.standard_normal((batch, c_in, width)).astype(
        np.float32)).astype(jdt)
    w = (0.3 * jnp.asarray(rng.standard_normal((c_out, c_in, kernel)).astype(
        np.float32))).astype(jdt)
    b = jnp.asarray(rng.standard_normal(c_out).astype(np.float32)).astype(jdt)
    want = jconv1d_pallas(x, w, b, stride, tile_w=64, interpret=True)
    assert want.dtype == jdt
    got = tc1.conv1d(_h(x), _h(w), _h(b), stride, tile_w=64)
    _assert_within_one_ulp(got, want, tdt)


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
# the deploy entry points keep x's type, as the reference's do
# ---------------------------------------------------------------------------

ENTRY_DTYPES = [(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float16, torch.float16),
                (torch.float64, torch.float32)]     # anything else → f32


@pytest.mark.parametrize("dtype,out", ENTRY_DTYPES,
                         ids=["f32", "bf16", "f16", "f64"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_volterra_equalize_returns_x_dtype(dtype, out, use_kernel):
    _, tcfg, p = _vol_params(25, 9, 0)
    x = torch.randn(2, 64, generator=torch.Generator().manual_seed(0))
    for xi in (x.to(dtype), x[0].to(dtype)):
        y = tv_ops.equalize(p, xi, tcfg, use_kernel=use_kernel, device="cpu")
        assert y.dtype == out and y.shape == xi.shape[:-1] + (32,)


@pytest.mark.parametrize("dtype,out", ENTRY_DTYPES,
                         ids=["f32", "bf16", "f16", "f64"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_quantize_params_returns_params_dtype(dtype, out, use_kernel):
    params, qparams = _cnn_params()
    params = {"conv": [{k: _t(v).to(dtype) for k, v in layer.items()}
                       for layer in params["conv"]]}
    got = tq_ops.quantize_params(params, qparams, use_kernel=use_kernel,
                                 device="cpu")
    for layer, lg in zip(params["conv"], got["conv"]):
        for key in ("w", "b"):
            assert lg[key].dtype == out
            assert lg[key].shape == layer[key].shape


@pytest.mark.parametrize("dtype,out", ENTRY_DTYPES,
                         ids=["f32", "bf16", "f16", "f64"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_conv1d_same_lower_returns_x_dtype(dtype, out, use_kernel):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 40, generator=g).to(dtype)
    w, b = torch.randn(8, 5, 9, generator=g), torch.randn(8, generator=g)
    y = tc1_ops.conv1d_same_lower(x, w, b, 2, use_kernel=use_kernel,
                                  device="cpu")
    assert y.dtype == out and y.shape == (2, 8, 20)


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

"""Port vs reference: equalizer training (repro_torch.core.{train_eq, fir,
volterra}) and the train-then-deploy slice as a whole.

Both packages start from the same parameters (drawn by JAX, carried through
`interop`) and see the same batches (drawn once by the JAX channel):

  * the first step's loss and gradients agree within rtol=1e-5;
  * after three fine-tuning steps (CNN with QAT, FIR, Volterra) the
    parameters agree within atol=1e-5 and the QAT widths are bitwise
    unchanged. One exception, in both packages alike: a conv bias that
    feeds a train-mode BN has a gradient of exactly zero in exact
    arithmetic (BN subtracts the batch mean), so its computed gradient is
    rounding noise (~1e-8) and Adam, which normalizes the gradient, moves
    it by ±lr per step in the noise's sign. Those biases (and the BN
    running means they shift) are held to Adam's bound instead;
  * a phase-2 QAT step (sign-SGD on the widths) matches the reference's
    arithmetic;
  * the trained Volterra, deployed through both packages' `ops.equalize`,
    agrees within the Volterra kernel tolerance (1e-5).

Port-only checks follow: the 3-phase schedule of `train_equalizer`, and
every new entry point refuses to run without a card unless asked for the
CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels import proakis as jproakis
from repro.channels.common import bits_to_pam as jbits_to_pam
from repro.core import equalizer as jeq
from repro.core import fir as jfir
from repro.core import qat as jqat
from repro.core import train_eq as jtrain
from repro.core import volterra as jvol
from repro.kernels.volterra import ops as jv_ops
from repro.optim import AdamW as JAdamW
from repro_torch import interop
from repro_torch.channels import imdd as timdd
from repro_torch.channels import proakis as tproakis
from repro_torch.channels.common import pam_constellation
from repro_torch.core import equalizer as teq
from repro_torch.core import fir as tfir
from repro_torch.core import qat as tqat
from repro_torch.core import train_eq as ttrain
from repro_torch.core import volterra as tvol
from repro_torch.data import equalizer_data as tdata
from repro_torch.kernels.conv1d import ops as tc1_ops
from repro_torch.kernels.quant import ops as tq_ops
from repro_torch.kernels.volterra import ops as tv_ops
from repro_torch.optim import AdamW

RTOL = 1e-5
ATOL = 1e-5
VOL_TOL = 1e-5
N_SYMS, BATCH = 64, 4
CNN_J = jeq.CNNEqConfig(layers=3, kernel=5, channels=3, v_parallel=4)
CNN_T = teq.CNNEqConfig(layers=3, kernel=5, channels=3, v_parallel=4)
QAT_W = {"w_int": 2.0, "w_frac": 6.0, "a_int": 3.0, "a_frac": 5.0}


@pytest.fixture(scope="module")
def batches():
    """Three (xs, amps) batches from the JAX Proakis-B channel, as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(11), 3 * BATCH)
    rx, syms = jax.vmap(lambda k: jproakis.simulate(
        k, jproakis.ProakisConfig(), N_SYMS))(keys)
    amps = jbits_to_pam(syms, 2)
    return [(np.asarray(rx[i * BATCH:(i + 1) * BATCH]),
             np.asarray(amps[i * BATCH:(i + 1) * BATCH])) for i in range(3)]


def _family(kind):
    """(jax cfg, port cfg, numpy params, numpy state) for one family."""
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(4)
    if kind == "cnn":
        params = jax.tree.map(np.asarray, jeq.init(key, CNN_J))
        params["qat"] = {f"layer{i}": {k: np.float32(v)
                                       for k, v in QAT_W.items()}
                         for i in range(CNN_J.layers)}
        state = jax.tree.map(np.asarray, jeq.init_bn_state(CNN_J))
        return CNN_J, CNN_T, params, state
    if kind == "fir":
        params = jax.tree.map(np.asarray, jfir.init(key, jfir.FIRConfig()))
        params["w"] = (params["w"] + 0.05 * rng.standard_normal(
            params["w"].shape)).astype(np.float32)
        return jfir.FIRConfig(), tfir.FIRConfig(), params, None
    cfg = jvol.VolterraConfig(m1=15, m2=5, m3=3)
    params = jax.tree.map(np.asarray, jvol.init(key, cfg))
    return cfg, tvol.VolterraConfig(m1=15, m2=5, m3=3), params, None


def _close(got, want, rtol, atol):
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        g, np.asarray(w), rtol=rtol, atol=atol), want, interop.to_numpy(got))


def _split_noise(params, state=None):
    """Pop the conv biases that feed a BN (and the BN running means) out of
    copies of the numpy trees: their updates are Adam-normalized noise."""
    params = dict(params, conv=[dict(l) for l in params["conv"]])
    noise = [params["conv"][i].pop("b") for i in range(len(params["bn"]))]
    if state is not None:
        state = {"bn": [dict(l) for l in state["bn"]]}
        noise += [l.pop("mean") for l in state["bn"]]
    return params, state, noise


@pytest.mark.parametrize("kind", ["cnn", "fir", "volterra"])
def test_first_step_loss_and_grads_match_reference(kind, batches):
    jcfg, tcfg, params, state = _family(kind)
    xs, amps = batches[0]
    quant = "qat" in params
    _, japply = jtrain._build(kind, jcfg)

    def loss_fn(p):
        y, _ = japply(p, jnp.asarray(xs), train=True,
                      state=None if state is None else jax.tree.map(
                          jnp.asarray, state), quant=quant)
        return jnp.mean((y - jnp.asarray(amps)) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    _, tapply = ttrain._build(kind, tcfg)
    tloss, tgrads, _ = ttrain._loss_and_grads(
        tapply, interop.to_torch(params, device="cpu"), torch.tensor(xs),
        torch.tensor(amps), interop.to_torch(state, device="cpu"), quant)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    # gradients: rtol, with an atol at RTOL × the largest gradient, since
    # entries that are zero in exact arithmetic (a bias feeding BN) carry
    # only rounding noise
    jg = jax.tree.map(np.asarray, jgrads)
    tg = interop.to_numpy(tgrads)
    scale = max(float(np.max(np.abs(l))) for l in jax.tree.leaves(jg))
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        g, w, rtol=RTOL, atol=RTOL * scale), jg, tg)


@pytest.mark.parametrize("kind", ["cnn", "fir", "volterra"])
def test_fine_tune_three_steps_matches_reference(kind, batches):
    jcfg, tcfg, params, state = _family(kind)

    def feeder():
        it = iter(batches)
        return lambda _key: next(it)

    jp, jstate, jinfo = jtrain.fine_tune_equalizer(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, params),
        None if state is None else jax.tree.map(jnp.asarray, state), jcfg,
        feeder(), steps=3, lr=1e-3, kind=kind)
    tp, tstate, tinfo = ttrain.fine_tune_equalizer(
        torch.Generator().manual_seed(0), interop.to_torch(params, "cpu"),
        interop.to_torch(state, "cpu"), tcfg, feeder(), steps=3, lr=1e-3,
        kind=kind, device="cpu")
    assert tinfo["steps"] == 3
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(tinfo[k], jinfo[k], rtol=RTOL)
    assert tinfo["loss_last"] < tinfo["loss_first"]
    jp, tp_np = jax.tree.map(np.asarray, jp), interop.to_numpy(tp)
    if kind == "cnn":
        jst = jax.tree.map(np.asarray, jstate)
        tst = interop.to_numpy(tstate)
        jp, jst, jnoise = _split_noise(jp, jst)
        tp_np, tst, tnoise = _split_noise(tp_np, tst)
        _close(tst, jst, 0, ATOL)
        # Adam moves each such bias by at most lr per step (3 steps), so
        # the two packages' biases differ by at most 2·lr per step taken
        # before a batch; a running mean sees (1 − momentum) of that
        n_b = len(params["bn"])
        for a, b, a0 in zip(tnoise[:n_b], jnoise[:n_b],
                            _split_noise(params)[2]):
            assert np.max(np.abs(a - a0)) <= 3e-3 * 1.001
            assert np.max(np.abs(b - a0)) <= 3e-3 * 1.001
        for a, b in zip(tnoise[n_b:], jnoise[n_b:]):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=ATOL + 0.1 * 2e-3 * (0 + 1 + 2))
    _close(tp_np, jp, 0, ATOL)
    if kind == "cnn":                      # widths frozen, bit-identical
        for name, q in interop.to_numpy(tp["qat"]).items():
            for k, v in q.items():
                assert v == np.float32(QAT_W[k]), (name, k)
                assert v == np.asarray(jp["qat"][name][k])
    if kind == "volterra":
        # the trained baseline through both packages' deployment kernels
        x = np.asarray(batches[2][0])
        want = np.asarray(jv_ops.equalize(jp, jnp.asarray(x), jcfg,
                                          use_pallas=True, tile=32))
        got = tv_ops.equalize(tp, x, tcfg, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=VOL_TOL,
                                   atol=VOL_TOL)


def test_phase2_qat_step_matches_reference_arithmetic(batches):
    """One `_train_step` in QAT phase 2 (quantized forward + width loss term,
    Adam on the weights, sign-SGD on the widths, clip) against the same step
    written with the reference's functions."""
    _, _, params, state = _family("cnn")
    params["qat"] = {n: {k: np.float32(v - 0.3) for k, v in q.items()}
                     for n, q in params["qat"].items()}   # non-integer
    qcfg_j = jqat.QATConfig(init_int_bits=8.0, init_frac_bits=8.0)
    qcfg_t = tqat.QATConfig(init_int_bits=8.0, init_frac_bits=8.0)
    xs, amps = batches[1]
    _, japply = jtrain._build("cnn", CNN_J)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax.tree.map(jnp.asarray, state)

    def loss_fn(p):
        y, _ = japply(p, jnp.asarray(xs), train=True, state=jstate,
                      quant=True)
        return (jnp.mean((y - jnp.asarray(amps)) ** 2)
                + jqat.quant_loss_term(p["qat"], qcfg_j))

    jloss, g = jax.value_and_grad(loss_fn)(jparams)
    qat_g = g["qat"]
    g = dict(g)
    g["qat"] = jax.tree.map(jnp.zeros_like, qat_g)
    jopt = JAdamW(lr=3e-3)
    want, _ = jopt.update(g, jopt.init(jparams), jparams)
    want = dict(want)
    want["qat"] = jqat.clip_qparams(jax.tree.map(
        lambda b, gb: b - 0.05 * jnp.sign(gb), jparams["qat"], qat_g), qcfg_j)

    _, tapply = ttrain._build("cnn", CNN_T)
    tparams = interop.to_torch(params, "cpu")
    opt = AdamW(lr=3e-3)
    got, _, _, tloss = ttrain._train_step(
        tparams, opt.init(tparams), interop.to_torch(state, "cpu"),
        torch.tensor(xs), torch.tensor(amps), apply_fn=tapply, opt=opt,
        qat_cfg=qcfg_t, quant=True, train_bits=True, qat_lr_bits=0.05)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    got_w, _, _ = _split_noise({k: v for k, v in interop.to_numpy(
        got).items() if k != "qat"})
    want_w, _, _ = _split_noise(jax.tree.map(np.asarray, {
        k: v for k, v in want.items() if k != "qat"}))
    _close(got_w, want_w, 0, ATOL)
    jax.tree.map(lambda w, t: np.testing.assert_array_equal(t, np.asarray(w)),
                 want["qat"], interop.to_numpy(got["qat"]))
    moved = [float(got["qat"][n][k]) - float(tparams["qat"][n][k])
             for n in got["qat"] for k in got["qat"][n]]
    assert all(abs(abs(d) - 0.05) < 1e-6 for d in moved), moved


def test_train_equalizer_runs_the_three_qat_phases(monkeypatch):
    """Phases 1 and 3 hold the widths bitwise, phase 2 moves them, phase 3
    starts from ceil'd integers; the widths never go through Adam."""
    seen = []
    real = ttrain._train_step

    def spy(params, *args, **kw):
        out = real(params, *args, **kw)
        seen.append((kw["quant"], kw["train_bits"],
                     interop.to_numpy(params["qat"]),
                     interop.to_numpy(out[0]["qat"]), float(out[3])))
        return out
    monkeypatch.setattr(ttrain, "_train_step", spy)
    cfg = ttrain.EqTrainConfig(steps=10, batch=2, seq_syms=64,
                               eval_syms=256)
    fn = tdata.channel_fn("proakis", device="cpu")
    params, _, info = ttrain.train_equalizer(
        torch.Generator().manual_seed(0), "cnn", CNN_T, fn, cfg,
        qat_cfg=tqat.QATConfig(init_int_bits=8.0, init_frac_bits=8.0),
        record_every=1, device="cpu")
    assert [(q, b) for q, b, *_ in seen] == (
        [(False, False)] * 2 + [(True, True)] * 6 + [(True, False)] * 2)
    for step, (_, train_bits, before, after, loss) in enumerate(seen):
        assert np.isfinite(loss)
        pairs = [(before[n][k], after[n][k]) for n in before
                 for k in before[n]]
        if train_bits:
            assert all(abs(abs(a - b) - 0.05) < 1e-6 or a == b
                       for b, a in pairs)
            assert any(a != b for b, a in pairs)
        else:
            assert all(a == b for b, a in pairs)      # held bitwise
        if step >= 8:
            assert all(float(b) == np.ceil(b) for b, _ in pairs)
    assert [h["step"] for h in info["history"]] == list(range(10))
    assert 0.0 <= info["ber"] <= 1.0
    assert info["bits_params"] == float(np.mean(
        [float(q["w_int"] + q["w_frac"]) + 1 for q in params["qat"].values()]))


@pytest.mark.parametrize("kind,cfg", [("fir", tfir.FIRConfig(taps=9)),
                                      ("volterra", tvol.VolterraConfig(
                                          m1=9, m2=3, m3=0))])
def test_train_equalizer_baselines_learn(kind, cfg):
    tcfg = ttrain.EqTrainConfig(steps=40, batch=4, seq_syms=128,
                                eval_syms=2048, lr=1e-2)
    fn = tdata.channel_fn("proakis", device="cpu")
    params, state, info = ttrain.train_equalizer(
        torch.Generator().manual_seed(1), kind, cfg, fn, tcfg,
        record_every=1, device="cpu")
    losses = [h["loss"] for h in info["history"]]
    assert state is None and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert info["ber"] < 0.2


def test_deploy_entry_points_agree_with_training_forwards():
    """The deployment entry points compute what training's forwards do: the
    CNN's layers through conv1d_same_lower (BN folded), and quantize_params
    at frozen widths is the QAT fake-quantizer."""
    gen = torch.Generator().manual_seed(3)
    p = teq.init(gen, CNN_T, tqat.QATConfig(), device="cpu")
    p["qat"] = tqat.freeze_qparams(tqat.clip_qparams(
        {n: {k: torch.tensor(QAT_W[k] - 0.4) for k in q}
         for n, q in p["qat"].items()}, tqat.QATConfig()))
    bn = teq.init_bn_state(CNN_T, device="cpu")
    x = torch.randn((2, 2 * 96), generator=gen)
    folded = teq.fold_bn(p, bn, CNN_T)
    h = x[:, None, :]
    for i, (_, _, s) in enumerate(CNN_T.layer_specs()):
        h = tc1_ops.conv1d_same_lower(h, folded["conv"][i]["w"],
                                      folded["conv"][i]["b"], s,
                                      device="cpu")
        if i < CNN_T.layers - 1:
            h = torch.relu(h)
    y = h.transpose(1, 2).reshape(2, -1)
    np.testing.assert_allclose(y.numpy(),
                               teq.apply_folded(folded, x, CNN_T).numpy(),
                               rtol=1e-6, atol=1e-6)
    qp = tq_ops.quantize_params(p, p["qat"], device="cpu")
    for i, layer in enumerate(qp["conv"]):
        q = p["qat"][f"layer{i}"]
        for k in ("w", "b"):
            assert torch.equal(layer[k], tqat.quantize_fixed(
                p["conv"][i][k], q["w_int"], q["w_frac"]))


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_VCFG = tvol.VolterraConfig(m1=5, m2=3, m3=0)


@pytest.mark.parametrize("entry", [
    lambda: timdd.simulate(torch.Generator(), timdd.IMDDConfig(), 8),
    lambda: tproakis.simulate(torch.Generator(), tproakis.ProakisConfig(), 8),
    lambda: tdata.channel_fn("imdd"),
    lambda: pam_constellation(2),
    lambda: tfir.init(torch.Generator(), tfir.FIRConfig()),
    lambda: tvol.init(torch.Generator(), _VCFG),
    lambda: ttrain.train_equalizer(
        torch.Generator(), "fir", tfir.FIRConfig(),
        tdata.channel_fn("proakis", device="cpu"),
        ttrain.EqTrainConfig(steps=1)),
    lambda: ttrain.fine_tune_equalizer(
        torch.Generator(), {"w": np.zeros(3, np.float32),
                            "b": np.float32(0)}, None, tfir.FIRConfig(taps=3),
        lambda g: (np.zeros((1, 8), np.float32), np.zeros((1, 4),
                                                          np.float32)),
        steps=1, kind="fir"),
    lambda: tv_ops.equalize(tvol.init(torch.Generator(), _VCFG, "cpu"),
                            np.zeros(16, np.float32), _VCFG),
    lambda: tq_ops.quantize_params({"conv": []}, {}),
    lambda: tc1_ops.conv1d_same_lower(np.zeros((1, 1, 16), np.float32),
                                      np.zeros((1, 1, 3), np.float32),
                                      np.zeros(1, np.float32)),
])
def test_new_entry_points_raise_without_card(monkeypatch, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()

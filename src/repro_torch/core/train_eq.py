"""Supervised equalizer training (MSE + Adam, paper §3.4) with optional
3-phase quantization-aware training (paper §4), in PyTorch.

Port of `repro.core.train_eq`, for all three equalizer families (CNN / FIR /
Volterra) through the same small adapter. Data comes from a channel
simulator ``channel_fn(generator, n_syms, batch=None)``
(`repro_torch.data.equalizer_data.channel_fn`), drawn on the device.

Training differentiates the plain PyTorch forwards (`core.equalizer.apply`,
`core.fir.apply`, `core.volterra.apply`) with autograd; the deployed
kernels (`kernels.volterra`, `kernels.quant`, `kernels.conv1d`,
`kernels.cnn_eq`) run what training produced.

The QAT schedule, exactly as the reference's:
  * phase 1 (first `qat_phase1` of the steps): full precision, widths held;
  * phase 2 (next `qat_phase2`): fake-quantized forward; the widths move by
    sign-SGD at `qat_lr_bits` and are clipped to [min_bits, 16];
  * phase 3: starts with `freeze_qparams` (ceil to integers), quantized
    forward, widths held bitwise.
The widths never go through Adam: their gradients are zeroed before the
Adam update, and the update's width values are replaced afterwards.

A step is `_train_step(params, opt_state, bn_state, xs, amps, ...)`: the
batch is an argument (the reference draws it inside its jitted step), so a
test can hand it the batch it wants.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..channels.common import ber_from_soft, bits_to_pam
from ..device import DeviceLike, as_float32, fp32_exact, resolve_device
from ..interop import tree_map
from ..optim import AdamW
from . import equalizer as cnn_eq
from . import fir as fir_eq
from . import qat as qat_lib
from . import volterra as vol_eq


@dataclasses.dataclass(frozen=True)
class EqTrainConfig:
    steps: int = 1500
    batch: int = 8
    seq_syms: int = 512          # symbols per training sequence
    lr: float = 3e-3             # paper: 1e-3 × 10k iters; we use fewer steps
    eval_syms: int = 1 << 15
    # QAT phases (fractions of `steps`); active only when qat_cfg given
    qat_phase1: float = 0.2      # full precision
    qat_phase2: float = 0.6      # bit-width-aware
    qat_lr_bits: float = 0.05    # lr for the width parameters


def _build(kind: str, model_cfg) -> Tuple[Callable, Callable]:
    """(init_fn(generator, qat_cfg, device) → (params, state),
        apply_fn(params, x, *, train, state, quant) → (y, state))."""
    if kind == "cnn":
        def init_fn(generator, qat_cfg=None, device="cuda"):
            return (cnn_eq.init(generator, model_cfg, qat_cfg, device=device),
                    cnn_eq.init_bn_state(model_cfg, device=device))

        def apply_fn(params, x, *, train, state, quant):
            return cnn_eq.apply(params, x, model_cfg, train=train,
                                bn_state=state, qat_enabled=quant)
        return init_fn, apply_fn
    if kind == "fir":
        return (lambda generator, qat_cfg=None, device="cuda":
                    (fir_eq.init(generator, model_cfg, device=device), None),
                lambda p, x, *, train, state, quant:
                    (fir_eq.apply(p, x, model_cfg), state))
    if kind == "volterra":
        return (lambda generator, qat_cfg=None, device="cuda":
                    (vol_eq.init(generator, model_cfg, device=device), None),
                lambda p, x, *, train, state, quant:
                    (vol_eq.apply(p, x, model_cfg), state))
    raise ValueError(f"unknown equalizer kind {kind!r}")


def _detach(tree: Any) -> Any:
    return tree_map(lambda t: t.detach(), tree)


def _loss_and_grads(apply_fn: Callable, params: Dict[str, Any],
                    xs: torch.Tensor, amps: torch.Tensor, state,
                    quant: bool, qat_cfg: Optional[qat_lib.QATConfig] = None):
    """(loss, grads, new_state): MSE (+ the QAT width term when quantizing
    with a QATConfig) and its gradient for every parameter leaf (zeros for
    leaves the forward does not use)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    y, new_state = apply_fn(p, xs, train=True, state=state, quant=quant)
    loss = torch.mean((y - amps) ** 2)
    if quant and qat_cfg is not None and "qat" in p:
        loss = loss + qat_lib.quant_loss_term(p["qat"], qat_cfg)
    with fp32_exact():      # the backward convolutions too: no TF32, and
        loss.backward()     # the same sums on every run
    grads = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), p)
    return loss.detach(), grads, _detach(new_state)


def _train_step(params: Dict[str, Any], opt_state, bn_state,
                xs: torch.Tensor, amps: torch.Tensor, *, apply_fn: Callable,
                opt: AdamW, qat_cfg: Optional[qat_lib.QATConfig],
                quant: bool, train_bits: bool, qat_lr_bits: float):
    """One step on a given batch → (params, opt_state, bn_state, loss)."""
    loss, grads, new_state = _loss_and_grads(apply_fn, params, xs, amps,
                                             bn_state, quant, qat_cfg)
    qat_grads = None
    if "qat" in params:
        # widths never go through Adam: phase 2 uses dedicated sign-SGD at
        # qat_lr_bits, phases 1/3 hold them exactly
        qat_grads = grads["qat"]
        grads = dict(grads)
        grads["qat"] = tree_map(torch.zeros_like, qat_grads)
    new_params, new_opt = opt.update(grads, opt_state, params)
    if "qat" in new_params:
        new_params = dict(new_params)
        if train_bits:
            stepped = tree_map(lambda b, g: b - qat_lr_bits * torch.sign(g),
                               params["qat"], qat_grads)
            new_params["qat"] = qat_lib.clip_qparams(stepped, qat_cfg)
        else:
            new_params["qat"] = params["qat"]
    return new_params, new_opt, new_state, loss


def _split(generator: torch.Generator, dev: torch.device):
    """Three independent generators from one, as the reference splits its
    key into (init, data, eval): init draws on the CPU (weights do not
    depend on the device), data and eval on ``dev``."""
    seeds = torch.randint(0, 2 ** 62, (3,), generator=generator,
                          device=generator.device).tolist()
    return (torch.Generator().manual_seed(seeds[0]),
            torch.Generator(device=dev).manual_seed(seeds[1]),
            torch.Generator(device=dev).manual_seed(seeds[2]))


def train_equalizer(generator: torch.Generator, kind: str, model_cfg,
                    channel_fn: Callable, cfg: EqTrainConfig,
                    qat_cfg: Optional[qat_lib.QATConfig] = None,
                    record_every: int = 0, device: DeviceLike = "cuda"):
    """Returns (params, bn_state, info dict with 'ber', 'history').

    ``channel_fn`` must draw on ``device`` (`channel_fn(kind, device=…)`).
    History values are read from the device once, after the last step.
    """
    dev = resolve_device(device)
    init_fn, apply_fn = _build(kind, model_cfg)
    g_init, g_data, g_eval = _split(generator, dev)
    params, bn_state = init_fn(g_init, qat_cfg, dev)
    levels = model_cfg.levels

    opt = AdamW(lr=cfg.lr)
    opt_state = opt.init(params)

    p1_end = int(cfg.steps * cfg.qat_phase1) if qat_cfg else cfg.steps + 1
    p2_end = int(cfg.steps * (cfg.qat_phase1 + cfg.qat_phase2)) \
        if qat_cfg else cfg.steps + 1

    history = []
    for step in range(cfg.steps):
        quant = qat_cfg is not None and step >= p1_end
        train_bits = qat_cfg is not None and p1_end <= step < p2_end
        if qat_cfg is not None and step == p2_end and "qat" in params:
            params = dict(params)
            params["qat"] = qat_lib.freeze_qparams(params["qat"])
        xs, syms = channel_fn(g_data, cfg.seq_syms, batch=cfg.batch)
        amps = bits_to_pam(syms, levels)
        params, opt_state, bn_state, loss = _train_step(
            params, opt_state, bn_state, xs, amps, apply_fn=apply_fn,
            opt=opt, qat_cfg=qat_cfg, quant=quant, train_bits=train_bits,
            qat_lr_bits=cfg.qat_lr_bits)
        if record_every and step % record_every == 0:
            rec = {"step": step, "loss": loss}
            if "qat" in params:
                rec["bits_params"], rec["bits_acts"] = \
                    qat_lib.average_bits(params["qat"])
            history.append(rec)
    history = [{k: float(v) if isinstance(v, torch.Tensor) else v
                for k, v in rec.items()} for rec in history]

    # ---- evaluation --------------------------------------------------------
    quant = qat_cfg is not None
    rx, syms = channel_fn(g_eval, cfg.eval_syms)
    with torch.no_grad():
        y, _ = apply_fn(params, rx, train=False, state=bn_state, quant=quant)
    info: Dict[str, Any] = {"ber": float(ber_from_soft(y, syms, levels)),
                            "history": history}
    if "qat" in params:
        bp, ba = qat_lib.average_bits(params["qat"])
        info["bits_params"], info["bits_acts"] = float(bp), float(ba)
    return params, bn_state, info


def fine_tune_equalizer(generator: torch.Generator, params: Dict[str, Any],
                        bn_state: Optional[Dict[str, Any]], model_cfg,
                        sample_fn: Callable, *, steps: int = 60,
                        lr: float = 1e-3, kind: str = "cnn",
                        device: DeviceLike = "cuda"):
    """Resume the QAT loop from deployed params — WEIGHT-ONLY fine-tuning.

    The in-the-field retraining step: the learned fixed-point formats must
    not move (they are baked into the deployed kernel and the serving group
    key), so only the weights train — phase 3 of `train_equalizer`
    (quantized forward at the frozen widths, widths held bitwise), on
    batches from served traffic instead of a channel simulator:

    sample_fn(generator) → (xs (batch, S·N_os), amps (batch, S)), numpy or
    tensors. Fake-quantization is on iff the params carry a "qat" subtree.
    Params, state and batches move to ``device`` as float32. Returns (params,
    bn_state, {"steps", "loss_first", "loss_last"}).
    """
    dev = resolve_device(device)
    params = tree_map(lambda t: as_float32(t, dev), params)
    bn_state = tree_map(lambda t: as_float32(t, dev), bn_state)
    quant = "qat" in params
    opt, step_fn = _fine_tune_step(kind, model_cfg, quant, lr)
    opt_state = opt.init(params)
    first = last = None
    for step in range(steps):
        xs, amps = sample_fn(generator)
        params, opt_state, bn_state, loss = step_fn(
            params, opt_state, bn_state, as_float32(xs, dev),
            as_float32(amps, dev))
        if step == 0:
            first = loss
        last = loss
    return params, bn_state, {
        "steps": steps,
        "loss_first": float("nan") if first is None else float(first),
        "loss_last": float("nan") if last is None else float(last)}


def _fine_tune_step(kind: str, model_cfg, quant: bool, lr: float):
    """(optimizer, step) for `fine_tune_equalizer`: `_train_step` in phase 3
    (no width loss term, widths zeroed out of Adam and held bitwise)."""
    _, apply_fn = _build(kind, model_cfg)
    opt = AdamW(lr=lr)
    return opt, functools.partial(_train_step, apply_fn=apply_fn, opt=opt,
                                  qat_cfg=None, quant=quant,
                                  train_bits=False, qat_lr_bits=0.0)

"""Background fine-tuning from buffered traffic.

Wraps `repro_torch.core.train_eq.fine_tune_equalizer` — the weight-only
resume of the QAT loop (frozen formats, quantized forward) — with the
sampling glue that turns a `SampleCollector` buffer into training batches:
random symbol-aligned windows over the buffered stream, labels mapped to
PAM amplitudes. The candidate parameters come back WITHOUT touching the
live stream; promotion is the shadow evaluator's call
(`repro_torch.adapt.shadow`).

Port of `repro.adapt.trainer`. The reference draws each batch's numpy seed
from a `jax.random` key; the port draws it from the `torch.Generator` that
`fine_tune_equalizer` hands the sampler (`draw_seed`). After the seed the
window code is the reference's numpy, so the same seed picks the same
windows in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.train_eq import fine_tune_equalizer
from ..device import DeviceLike
from .collector import pam_amplitudes


@dataclasses.dataclass(frozen=True)
class FineTuneConfig:
    """Knobs for one background fine-tune round.

    steps:     optimizer steps per round (default 60 — rounds are meant to
               be cheap and frequent, not one big retrain).
    batch:     sequences per step.
    seq_syms:  symbols per training sequence; must be a multiple of the
               topology's V_p so the strided forward tiles cleanly
               (checked at sample time).
    lr:        AdamW learning rate — lower than from-scratch training
               (`EqTrainConfig.lr`): this is a warm start, and the labels
               may be decision-directed (label noise argues for small
               steps).
    """
    steps: int = 60
    batch: int = 8
    seq_syms: int = 256
    lr: float = 1e-3


def draw_seed(generator: torch.Generator) -> int:
    """One batch's numpy seed, in [0, 2^31 - 1) as the reference's
    `jax.random.randint(key, (), 0, int32 max)`, drawn from ``generator``
    (on the generator's own device). The draws differ from JAX's by
    construction; a test that wants the reference's windows replaces this
    function with one that returns the reference's seeds."""
    return int(torch.randint(0, np.iinfo(np.int32).max, (),
                             generator=generator, device=generator.device))


def make_sample_fn(rx: np.ndarray, syms: np.ndarray, *, n_os: int,
                   levels: int, cfg: FineTuneConfig):
    """Batch sampler over a buffered stream: random symbol-aligned windows.

    rx:   (n·n_os,) buffered waveform, stream order.
    syms: (n,) label symbol indices aligned with rx.

    Returns sample_fn(generator) → (xs (batch, seq·n_os), amps (batch,
    seq)), host numpy, for `fine_tune_equalizer`. Window starts are
    arbitrary symbol offsets — the equalizer's forward is shift-equivariant
    at symbol granularity, so every offset is a valid training sequence.
    """
    n = int(min(syms.shape[0], rx.shape[0] // n_os))
    seq = cfg.seq_syms
    if n < seq + 1:
        raise ValueError(f"buffer too small: {n} syms < seq_syms={seq}+1")
    amps = pam_amplitudes(levels)[syms[:n]].astype(np.float32)

    def sample_fn(generator: torch.Generator
                  ) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(draw_seed(generator))
        offs = rng.integers(0, n - seq, size=cfg.batch)
        xs = np.stack([rx[o * n_os:(o + seq) * n_os] for o in offs])
        ys = np.stack([amps[o:o + seq] for o in offs])
        return xs, ys

    return sample_fn


def fine_tune_from_buffer(generator: torch.Generator,
                          params: Dict[str, Any],
                          bn_state: Optional[Dict[str, Any]], model_cfg,
                          rx: np.ndarray, syms: np.ndarray,
                          cfg: FineTuneConfig = FineTuneConfig(),
                          device: DeviceLike = "cuda"):
    """One background fine-tune round over buffered traffic, on ``device``.

    Returns (candidate_params, candidate_bn_state, info), as tensors on
    ``device``. The inputs are never mutated — the caller's live params
    stay valid for rollback.
    """
    if cfg.seq_syms % model_cfg.v_parallel != 0:
        raise ValueError(
            f"seq_syms={cfg.seq_syms} must be a multiple of "
            f"V_p={model_cfg.v_parallel}")
    sample_fn = make_sample_fn(rx, syms, n_os=model_cfg.n_os,
                               levels=model_cfg.levels, cfg=cfg)
    return fine_tune_equalizer(generator, params, bn_state, model_cfg,
                               sample_fn, steps=cfg.steps, lr=cfg.lr,
                               device=device)

"""Learning-rate schedules, pure functions of the step tensor (port of
`repro.optim.schedule`)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def linear_decay(peak_lr: float, total_steps: int, final_frac: float = 0.0):
    def fn(step):
        t = torch.clamp(step.float() / total_steps, 0, 1)
        return peak_lr * (1 - (1 - final_frac) * t)
    return fn

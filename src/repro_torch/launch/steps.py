"""Serving step builders: prefill and one greedy decode step.

Port of `repro.launch.steps.build_prefill_step` and `build_decode_step`.
The reference jits them; the port runs them eagerly (the model's ops
launch one by one on the current CUDA stream). The train step and the
per-cell lowering assembly come with later slices.
"""
from __future__ import annotations

import torch

from ..models import registry


def build_prefill_step(model: registry.Model):
    def prefill_step(params, batch, state):
        logits, new_state = model.prefill(params, batch, state)
        return logits, new_state
    return prefill_step


def build_decode_step(model: registry.Model):
    def decode_step(params, token, pos, state):
        logits, new_state = model.decode(params, token, pos, state)
        # greedy next token — serving loops feed it back
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_state
    return decode_step

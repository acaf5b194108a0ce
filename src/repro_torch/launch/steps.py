"""Step builders: the gradient-accumulating train step, prefill and one
greedy decode step.

Port of `repro.launch.steps.build_train_step`, `build_prefill_step` and
`build_decode_step`. The reference jits them; the port runs them eagerly
(the model's ops launch one by one on the current CUDA stream). The
per-cell lowering assembly comes with a later slice.
"""
from __future__ import annotations

import torch

from ..interop import tree_leaves, tree_map, tree_unflatten
from ..models import registry
from ..optim.adam import AdamW


def build_train_step(model: registry.Model, opt: AdamW):
    """Gradient-accumulating train step: every batch leaf has a leading
    accum axis. For each microbatch, the loss's gradient is taken with
    `torch.autograd.grad` and added into f32 sums; the sums are divided by
    accum and `opt.update` applies them (with its gradient clipping).
    Returns (new_params, new_opt_state, {"loss": mean microbatch loss}).
    The sums are updated in place; params and the optimizer state are
    not."""

    def train_step(params, opt_state, batch):
        accum = tree_leaves(batch)[0].shape[0]
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)]
        losses = []
        for a in range(accum):
            mb = tree_map(lambda t: t[a], batch)
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss, _ = model.loss_fn(tree_unflatten(params, leaves), mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, g in zip(gsum, grads):
                if g is not None:
                    acc.add_(g.float())
            losses.append(loss.detach())
            del loss, grads, leaves
        grads = tree_unflatten(params, [g / accum for g in gsum])
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": torch.stack(losses).mean()}

    return train_step


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

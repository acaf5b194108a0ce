"""Token data pipeline for LM training (port of `repro.data.pipeline`).

The source is the reference's deterministic synthetic LM stream: every row
of every step is a function of (seed, step, row) alone, so a restart at
step s rebuilds exactly the batches an uninterrupted run would have seen.
There is no mesh on one card: `lm_batches` yields whole (accum, mb, seq)
token tensors on the trainer's device, where the reference materializes
each device's shard with `jax.make_array_from_callback`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import registry
from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seq_len: int
    global_batch: int
    accum: int = 1               # leading grad-accumulation axis
    seed: int = 0


class TokenSource:
    """Deterministic synthetic token stream: shard-addressable, stateless.

    `block(step, row)` returns the row's tokens, a function of (seed, step,
    row) only. The reference draws ``changes`` and ``fresh`` from one
    generator and walks the row token by token (a token repeats until a
    change); here the walk is vectorized — each token is ``fresh`` at the
    last change at or before it, position 0 counting as one — which gives
    the same int32 row bitwise.
    """

    def __init__(self, cfg: PipelineConfig, vocab: int):
        self.cfg = cfg
        self.vocab = vocab

    def block(self, step: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))
        n = self.cfg.seq_len
        changes = rng.random(n) < 0.3
        fresh = rng.integers(0, self.vocab, size=n)
        pos = np.arange(n)
        last = np.maximum.accumulate(np.where(changes | (pos == 0), pos, 0))
        return fresh[last].astype(np.int32)


def lm_batches(cfg: PipelineConfig, model_cfg: ModelConfig,
               device: DeviceLike = "cuda", start_step: int = 0
               ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields {tokens, labels[, enc_embed | embed_prefix]}: tokens and
    labels the same (accum, global_batch / accum, seq_len) int64 tensor on
    ``device``, row a·mb + r of step s being `TokenSource.block(s, a·mb +
    r)`, as in the reference; an encdec model gets zero frame embeddings
    ``enc_embed`` (accum, mb, enc_len, d_model) and a vlm model a zero
    image prefix ``embed_prefix`` (accum, mb, img_tokens, d_model), both
    in the model's param dtype, as the reference's stubs
    (`registry.stub_inputs`). The device is resolved here, so an absent
    card raises at the call."""
    dev = resolve_device(device)
    source = TokenSource(cfg, model_cfg.vocab)
    mb = cfg.global_batch // cfg.accum

    def gen(step: int):
        while True:
            rows = np.stack([source.block(step, i)
                             for i in range(cfg.accum * mb)])
            toks = torch.from_numpy(rows.reshape(
                cfg.accum, mb, cfg.seq_len).astype(np.int64)).to(dev)
            batch = {"tokens": toks, "labels": toks}
            batch.update(registry.stub_inputs(model_cfg, (cfg.accum, mb),
                                              dev))
            yield batch
            step += 1

    return gen(start_step)

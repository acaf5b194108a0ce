"""Assigned input shapes (the 4 columns of the 10×4 cell grid).

  train_4k     seq 4 096 × global batch 256   → lowers train_step
  prefill_32k  seq 32 768 × global batch 32   → lowers prefill
  decode_32k   seq 32 768 × global batch 128  → lowers serve_step (1 token,
                                                KV/SSM state of seq_len)
  long_500k    seq 524 288 × global batch 1   → serve_step; requires
                                                sub-quadratic attention

long_500k runnability: full-attention archs are SKIPPED
(receptive field = whole sequence ⇒ the paper's overlap partitioning
degenerates); mixtral (SWA), zamba2 (hybrid, windowed shared attn at decode),
xlstm (recurrent) RUN.

Port of `repro.configs.shapes` (the same values).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs whose attention is sub-quadratic (or state-bounded) at decode —
# the only ones that run long_500k
LONG_CONTEXT_ARCHS = ("mixtral-8x22b", "zamba2-1.2b", "xlstm-125m")


def long_500k_runnable(arch: str) -> bool:
    return arch in LONG_CONTEXT_ARCHS

"""llava-next-34b — VLM backbone [hf:llava-hf/llava-v1.6; unverified].

60L · d_model 7168 · 56 heads (GQA kv=8) · d_ff 20480 · vocab 64000.
The anyres vision tower is a stub, as in the reference: the caller
provides precomputed patch embeddings (batch, img_tokens, d_model)
standing in for 4+1 anyres tiles × 576 patches = 2880 image tokens; they
are prepended to the token embeddings (prefix-LM, loss on text only).
TP note: 56 Q heads pad to 64 (8 GQA groups of 7→8), KV replicates 8→16.

Port of `repro.configs.llava_next_34b` (the same values).
"""
from ..models.common import ModelConfig

IMG_TOKENS = 2880        # (4 anyres tiles + 1 base) × 576 patches

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, img_tokens=IMG_TOKENS,
    tp=16, train_accum=16,
)

REDUCED = ModelConfig(
    name="llava-reduced", family="vlm",
    n_layers=3, d_model=112, n_heads=7, n_kv_heads=1,
    d_ff=256, vocab=512, img_tokens=16, dtype="float32",
)

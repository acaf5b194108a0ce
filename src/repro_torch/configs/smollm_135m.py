"""smollm-135m — small llama-arch [hf:HuggingFaceTB/SmolLM-135M; hf].

30L · d_model 576 · 9 heads (GQA kv=3) · d_ff 1536 · vocab 49152.
TP note: 9 Q heads pad to 16, KV expands to 16 (full expansion — 3 divides
neither 16 nor the padded head count).

Port of `repro.configs.smollm_135m` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152,
    tp=16, train_accum=2,
)

REDUCED = ModelConfig(
    name="smollm-reduced", family="dense",
    n_layers=3, d_model=96, n_heads=3, n_kv_heads=1,
    d_ff=256, vocab=512, dtype="float32",
)

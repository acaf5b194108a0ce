"""internlm2-1.8b — dense GQA transformer [arXiv:2403.17297; hf].

24L · d_model 2048 · 16 heads (GQA kv=8) · d_ff 8192 · vocab 92544.

Port of `repro.configs.internlm2_1_8b` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544,
    tp=16, train_accum=4,
)

REDUCED = ModelConfig(
    name="internlm2-reduced", family="dense",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, dtype="float32",
)

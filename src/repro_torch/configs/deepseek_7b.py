"""deepseek-7b — dense llama-arch transformer [arXiv:2401.02954; hf].

30L · d_model 4096 · 32 heads (GQA kv=32, i.e. MHA) · d_ff 11008 ·
vocab 102400.

Port of `repro.configs.deepseek_7b` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    tp=16, train_accum=8,
)

REDUCED = ModelConfig(
    name="deepseek-reduced", family="dense",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=344, vocab=512, dtype="float32",
)

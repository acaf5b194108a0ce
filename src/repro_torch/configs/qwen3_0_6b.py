"""qwen3-0.6b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family; hf].

28L · d_model 1024 · 16 heads (GQA kv=8) · head_dim 128 (decoupled from
d_model, as in Qwen3) · d_ff 3072 · vocab 151936 · qk_norm.

Port of `repro.configs.qwen3_0_6b` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936, qk_norm=True,
    tp=16, train_accum=2,
)

REDUCED = ModelConfig(
    name="qwen3-reduced", family="dense",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_head=48,
    d_ff=256, vocab=512, qk_norm=True, dtype="float32",
)

"""moonshot-v1-16b-a3b — fine-grained MoE (Moonlight-16B-A3B style)
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L · d_model 2048 · 16 heads (GQA kv=16) · expert d_ff 1408 ·
vocab 163840 · 64 experts top-6.

Port of `repro.configs.moonshot_v1_16b_a3b` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6,
    tp=16, train_accum=8, moe_group=2048,
)

REDUCED = ModelConfig(
    name="moonshot-reduced", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, n_experts=8, top_k=2,
    moe_group=64, dtype="float32",
)

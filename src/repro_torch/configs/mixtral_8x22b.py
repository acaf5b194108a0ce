"""mixtral-8x22b — sparse MoE with sliding-window attention
[arXiv:2401.04088; hf].

56L · d_model 6144 · 48 heads (GQA kv=8) · d_ff 16384 · vocab 32768 ·
8 experts top-2 · SWA window 4096. Its 280 GB of bf16 params need 2-D
sharding at serve time (``serve_fsdp``): no single card holds them, so
the port runs it at its reduced config.

Port of `repro.configs.mixtral_8x22b` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, window=4096,
    tp=16, train_accum=16, moe_group=2048,
    serve_fsdp=True,
)

REDUCED = ModelConfig(
    name="mixtral-reduced", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, n_experts=4, top_k=2, window=32,
    moe_group=64, dtype="float32",
)

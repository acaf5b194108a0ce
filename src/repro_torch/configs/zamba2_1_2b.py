"""zamba2-1.2b — hybrid Mamba2 + shared attention block [arXiv:2411.15242].

38 Mamba2 layers · d_model 2048 · ssm_state 64 · expand 2 (d_inner 4096,
64 SSD heads of 64) · shared attention block (32 heads, MHA) applied every
6 layers · d_ff 8192 (shared block MLP) · vocab 32000.

long_500k policy: the Mamba2 state is O(1); the shared attention block
decodes with a sliding-window ring cache when the caller sets
`decode_window`.

Port of `repro.configs.zamba2_1_2b` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, d_conv=4, expand=2, ssm_head=64, attn_every=6,
    tp=16, train_accum=8, ssd_chunk=64,
)

REDUCED = ModelConfig(
    name="zamba2-reduced", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    ssm_state=16, d_conv=4, expand=2, ssm_head=16, attn_every=2,
    ssd_chunk=16, dtype="float32",
)

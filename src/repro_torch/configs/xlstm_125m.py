"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12 blocks · d_model 768 · 4 heads · vocab 50304 · d_ff 0 (xLSTM blocks
carry their own projections: mLSTM pre-up ×2, sLSTM post-up ×4/3).
sLSTM at blocks {3, 9} (paper-style mix), mLSTM elsewhere in
chunkwise-parallel form. Recurrent state ⇒ long_500k runs at O(1) memory.

Port of `repro.configs.xlstm_125m` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_at=(3, 9), expand=2, d_conv=4,
    tp=16, train_accum=2, ssd_chunk=64,
)

REDUCED = ModelConfig(
    name="xlstm-reduced", family="ssm",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512, slstm_at=(1,), expand=2,
    ssd_chunk=16, dtype="float32",
)

"""whisper-large-v3 — encoder–decoder audio backbone [arXiv:2212.04356].

32+32L · d_model 1280 · 20 heads (MHA) · d_ff 5120 · vocab 51866 (padded to
51968 for the 128-lane boundary) · enc_len 1500. The mel/conv frontend is a
stub, as in the reference: the caller provides precomputed frame
embeddings. GELU MLP, sinusoidal positions (rope_theta = 0 disables RoPE).
TP note: 20 heads pad to 32 with full KV expansion.

Port of `repro.configs.whisper_large_v3` (the same values).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, enc_len=1500,
    rope_theta=0.0, mlp_act="gelu",
    tp=16, train_accum=4,
)

REDUCED = ModelConfig(
    name="whisper-reduced", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=500, enc_len=30,
    rope_theta=0.0, mlp_act="gelu", dtype="float32",
)

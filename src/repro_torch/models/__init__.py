"""LM model families of the port (`repro.models` counterparts).

So far the dense decoder-only transformer's serving path: `common`
(ModelConfig, RMSNorm, RoPE, init helpers), `attention`, `mlp` (dense),
`transformer` (init, prefill, decode_step) and `registry` (`build`).
"""

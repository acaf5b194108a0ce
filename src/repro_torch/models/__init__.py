"""LM model families of the port (`repro.models` counterparts).

So far: `common` (ModelConfig, RMSNorm, RoPE, init helpers), `attention`,
`mlp` (dense), `transformer` (the dense decoder: init, forward, loss_fn,
prefill, decode_step), `xlstm` (mLSTM + sLSTM blocks: init, forward,
loss_fn, prefill, decode_step) and `registry` (`build`).
"""

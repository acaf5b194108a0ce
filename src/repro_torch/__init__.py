"""repro_torch — the PyTorch/CUDA port of the CNN-equalizer system.

The package mirrors `repro` (the JAX reference) module for module, so each
port module sits at the same relative path as its counterpart:

  core/      equalizer topology, QAT formats, autotune, EqualizerEngine;
             the FIR and Volterra baselines and their training (train_eq);
             stream partitioning over N_i instances, the paper's
             timing model and l_inst framework, and design-space
             exploration (dse)
  channels/  simulated IM/DD and Proakis-B links, stationary and drifting
  data/      channel frames drawn on the device for training
  optim/     AdamW and learning-rate schedules on tensor trees
  configs/   the paper's operating points (equalizer_ht, equalizer_lp)
             and the dense LM architectures (`get_config(arch)`)
  kernels/   hand-written Hopper kernels, each beside its plain PyTorch
             version (cnn_eq: the fused fp32/bf16/int8 stack; volterra;
             quant; conv1d; flash_attn: the attention forward)
  models/    the dense LM transformer's serving path: config, attention,
             MLP, prefill and decode over ring-buffer KV caches
  parallel/  head-count resolution for tensor parallelism
  launch/    serving steps and the batched prefill + decode driver
  obs/       metrics registry, chunk tracer, Observability hub; link
             quality, SLO rules and the console report
  runtime/   straggler monitor
  serve/     chunker, engine pool, sessions, micro-batcher, ServeRuntime
             and the threaded AsyncServeRuntime; load generation
  net/       the packetized wire: frame codec, transports, gateway
             (ingress/egress over a runtime), control plane, client
  examples/  quickstart and stream_equalizer (`python -m
             repro_torch.examples.<name> [--device cpu]`)

It imports torch, numpy and the standard library only — never jax and
nothing of `repro`. `interop` carries parameter trees across as numpy.
Entry points take ``device=`` (default ``"cuda"``) and raise when a card is
asked for and absent (`device.resolve_device`).
"""
from .device import fp32_exact, resolve_device

__all__ = ["fp32_exact", "resolve_device"]

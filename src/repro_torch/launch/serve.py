"""Batched serving driver: prefill + greedy decode loop.

Port of `repro.launch.serve`. Requests are grouped into a fixed batch,
prefilled once, then decoded step by step: a transformer (dense, MoE,
VLM) writes its KV ring caches in place, xlstm carries its recurrent
states, zamba2 both, whisper its decoder caches and the encoder's
cross-attention K/V. On one card (tp = 1), with prefill attention in the
hand-written flash kernel (``fused_attention=True``) and every sLSTM
block's recurrence in the hand-written sLSTM kernel:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --full --batch 4 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper-large-v3 --full --prompt-len 416 --gen 32

The batch carries the families' stub inputs (`registry.stub_inputs`) as
the reference's CLI builds them: zero frame embeddings ``enc_embed`` (B,
enc_len, d_model) for whisper and a zero image prefix ``embed_prefix``
(B, img_tokens, d_model) for llava, in the param dtype. A VLM's prefill writes img_tokens +
prompt_len cache positions, so its cache holds img_tokens + prompt_len +
gen entries and decode step i runs at position img_tokens + prompt_len +
i. The reference's CLI sizes the cache prompt_len + gen and decodes at
prompt_len + i (`repro/launch/serve.py`), which leaves a llava decode
attending to the wrong cache slots; its models, and the port's, take the
global position, as its own tests do.

Without ``--full`` it serves the REDUCED config; ``--device cpu`` runs the
plain PyTorch versions on the host (the default, ``cuda``, raises without a
card). Weights are random, from a seed; prompts come from a seeded
generator. The log says how often each kernel was launched (0 on the host,
where the wrappers run their plain versions).
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from .. import configs
from ..device import DeviceLike, resolve_device
from ..kernels.flash_attn import flash_attn
from ..kernels.slstm import slstm
from ..models import registry
from . import steps as steps_lib

log = logging.getLogger("repro_torch.serve")


def serve_session(cfg, batch: int, prompt_len: int, max_len: int,
                  device: DeviceLike = "cuda", seed: int = 0):
    """(model, params, state, prefill, decode) for ``batch`` requests of up
    to ``max_len`` tokens: seeded random weights and zero caches on
    ``device``."""
    dev = resolve_device(device)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    state = model.init_serve_state(batch, max_len, dev)
    prefill = steps_lib.build_prefill_step(model)
    decode = steps_lib.build_decode_step(model)
    return model, params, state, prefill, decode


def prefix_len(cfg) -> int:
    """Cache positions a prefill writes ahead of the text: the image
    tokens of a VLM, else 0."""
    return cfg.img_tokens if cfg.family == "vlm" else 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=configs.ARCHS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, reduced=not args.full, tp=1,
                             fused_attention=True)
    start = prefix_len(cfg) + args.prompt_len      # first decode position
    max_len = start + args.gen
    model, params, state, prefill, decode = serve_session(
        cfg, args.batch, args.prompt_len, max_len, device=dev)

    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev),
             **registry.stub_inputs(cfg, (args.batch,), dev)}
    flash_attn.reset_launch_counts()
    slstm.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(params, batch, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen):
        tok, logits, state = decode(params, tok, start + i, state)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks_out = torch.cat(generated, dim=1)
    tput = args.batch * args.gen / t_decode
    log.info("%s on %s: prefill %.3fs; decode %d steps at positions "
             "%d.. in %.3fs (%.1f tok/s, %.2f ms/tok)", cfg.name, dev,
             t_prefill, args.gen, start, t_decode, tput,
             1e3 * t_decode / max(args.gen, 1))
    log.info("kernel launches: %s",
             {**flash_attn.LAUNCHES, **slstm.LAUNCHES})
    log.info("sample row 0: %s", toks_out[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Batched serving driver: prefill + greedy decode loop.

Port of `repro.launch.serve`. Requests are grouped into a fixed batch,
prefilled once, then decoded step by step: a dense transformer writes its
KV ring caches in place, xlstm carries its recurrent states from step to
step. On one card (tp = 1), with prefill attention in the hand-written
flash kernel (``fused_attention=True``) and every sLSTM block's recurrence
in the hand-written sLSTM kernel:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --full --batch 4 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --full

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
    max_len = args.prompt_len + args.gen
    model, params, state, prefill, decode = serve_session(
        cfg, args.batch, args.prompt_len, max_len, device=dev)

    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
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
        tok, logits, state = decode(params, tok, args.prompt_len + i, state)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks_out = torch.cat(generated, dim=1)
    tput = args.batch * args.gen / t_decode
    log.info("%s on %s: prefill %.3fs; decode %d steps in %.3fs "
             "(%.1f tok/s, %.2f ms/tok)", cfg.name, dev, t_prefill, args.gen,
             t_decode, tput, 1e3 * t_decode / max(args.gen, 1))
    log.info("kernel launches: %s",
             {**flash_attn.LAUNCHES, **slstm.LAUNCHES})
    log.info("sample row 0: %s", toks_out[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

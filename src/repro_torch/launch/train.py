"""LM training driver: model → train step (grad accumulation) → token
pipeline → checkpoints (atomic, keep-k) → fault-tolerant restart loop →
straggler monitor.

Port of `repro.launch.train` for the dense family (`build` refuses xlstm:
its training is ROADMAP Queue 1 item 10), on one card: there is
no mesh, so where the reference takes ``--mesh`` this takes ``--device``
(default ``cuda``, which raises without a card; ``cpu`` runs the kernels'
plain PyTorch versions), and it trains with ``tp=1, fused_attention=True``
(attention and its gradient in the flash kernels), as the serving CLI
serves. ``--layers`` cuts the depth (for a quick run at full width).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --full --batch 8 --seq 2048 --accum 2 --steps 20

Without ``--full`` it trains the REDUCED config. Weights are random from a
seed, tokens come from the reference's synthetic stream. A run resumes
from the latest checkpoint in ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import logging
import pathlib
import time

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..data import PipelineConfig, lm_batches
from ..device import DeviceLike, resolve_device
from ..models import registry
from ..models.common import ModelConfig
from ..optim import AdamW
from ..runtime import (FailureInjector, StragglerMonitor, TrainLoopConfig,
                       run_with_restarts)
from . import steps as steps_lib

log = logging.getLogger("repro_torch.train")

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "ckpt"


def build(cfg: ModelConfig, lr: float, accum: int,
          device: DeviceLike = "cuda"):
    """(init_state, train_step): init_state() → (params, opt_state), the
    model's seeded weights (generator seed 0) and AdamW(lr,
    grad_clip_norm=1.0) state on ``device``; train_step(params, opt_state,
    batch) → (params, opt_state, {"loss"}) over a batch with a leading
    accum axis (``accum`` is the batch's, as in the reference). Raises
    NotImplementedError for the ssm family (xlstm), on every device: its
    sLSTM kernel has no backward (ROADMAP Queue 1 item 10)."""
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: xlstm training is not ported yet (ROADMAP Queue 1 "
            f"item 10): the sLSTM kernel has no backward")
    dev = resolve_device(device)
    model = registry.build(cfg)
    opt = AdamW(lr=lr, grad_clip_norm=1.0)

    def init_state():
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        return params, opt.init(params)

    return init_state, steps_lib.build_train_step(model, opt)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=configs.ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full config; default: reduced")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject worker failures at these steps (demo)")
    return ap


def run(argv=None) -> dict:
    """The CLI's training run; returns `run_with_restarts`' summary plus
    "losses" (every step's loss, in step order, from the surviving run)
    and "straggler" (the monitor's summary)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    overrides = {"tp": 1, "fused_attention": True}
    if args.layers:
        overrides["n_layers"] = args.layers
    cfg = configs.get_config(args.arch, reduced=not args.full, **overrides)

    init_state, train_step = build(cfg, args.lr, args.accum, dev)
    pipe = PipelineConfig(seq_len=args.seq, global_batch=args.batch,
                          accum=args.accum)
    ckpt = CheckpointManager(args.ckpt_dir, keep_k=3)
    monitor = StragglerMonitor()
    injector = FailureInjector(fail_at=tuple(args.fail_at))
    losses = {}

    def batches(start_step):
        return lm_batches(pipe, cfg, dev, start_step=start_step)

    def on_step(step, metrics):
        # reading the loss waits for the step, so the monitor sees its
        # device time too
        losses[step] = float(metrics["loss"])
        now = time.perf_counter()
        monitor.observe(step, now - on_step.t0)
        on_step.t0 = now
    on_step.t0 = time.perf_counter()

    out = run_with_restarts(
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_every=args.ckpt_every),
        ckpt, init_state, train_step, batches, injector=injector,
        on_step=on_step)
    out["losses"] = [losses[s] for s in sorted(losses)]
    out["straggler"] = monitor.summary()
    log.info("%s on %s: %d steps, %d restarts, straggler summary %s",
             cfg.name, dev, out["steps"], out["restarts"], out["straggler"])
    if len(out["losses"]) >= 2:
        log.info("loss %0.4f → %0.4f", out["losses"][0], out["losses"][-1])
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end training driver for the equalizer: on-device channel
simulation as the data pipeline, 3-phase quantization-aware training,
checkpointing, and the DSE complexity ceilings deciding the operating
point — the paper's cross-layer flow in one script.

Port of the reference's `examples/train_equalizer_imdd.py`:

    PYTHONPATH=src python -m repro_torch.examples.train_equalizer_imdd \
        [--steps 1200] [--ckpt-dir build/eq_ckpt] [--device cpu]

The two ceilings are the reference's DSE models (`core.dse`): the FPGA's
DSP budget and the reference's TPU roofline constants, not a measurement
of the card this runs on.
"""
from __future__ import annotations

import argparse
import pathlib

import torch

from ..channels import imdd
from ..checkpoint import CheckpointManager
from ..core import dse, qat as qat_lib
from ..core.equalizer import CNNEqConfig
from ..core.train_eq import EqTrainConfig, train_equalizer
from ..data.equalizer_data import channel_fn
from ..device import resolve_device

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "eq_ckpt"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_equalizer_imdd")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--qlf", type=float, default=5e-4)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    generator = torch.Generator().manual_seed(1)
    fn = channel_fn("imdd", imdd.IMDDConfig(), device=dev)

    # --- cross-layer operating-point choice (paper §3.5 / DESIGN.md §2) ---
    fpga_ceiling = dse.mac_sym_max_fpga()
    tpu_ceiling = dse.mac_sym_max_tpu(chips=1)
    candidates = [CNNEqConfig(channels=c) for c in (5, 10, 16)]
    feasible_fpga = [c for c in candidates
                     if c.mac_per_symbol() <= fpga_ceiling]
    feasible_tpu = [c for c in candidates
                    if c.mac_per_symbol() <= tpu_ceiling]
    cfg = max(feasible_tpu, key=lambda c: c.mac_per_symbol())
    print(f"ceilings: FPGA {fpga_ceiling:.1f} MAC/sym "
          f"(admits C={max(c.channels for c in feasible_fpga)}), "
          f"TPU model {tpu_ceiling:.0f} (admits C={cfg.channels}) → "
          f"training C={cfg.channels} on {dev}")

    # --- 3-phase QAT training ---------------------------------------------
    qcfg = qat_lib.QATConfig(qlf=args.qlf, init_int_bits=8.0,
                             init_frac_bits=8.0)
    tcfg = EqTrainConfig(steps=args.steps, batch=8, seq_syms=256, lr=3e-3,
                         eval_syms=1 << 15)
    params, bn, info = train_equalizer(generator, "cnn", cfg, fn, tcfg,
                                       qat_cfg=qcfg, record_every=100,
                                       device=dev)
    print(f"BER {info['ber']:.3e} at {info['bits_params']:.1f}b weights / "
          f"{info['bits_acts']:.1f}b activations")
    for name, q in params["qat"].items():
        print(f"  {name}: deploys as {qat_lib.deployment_dtype(q)}")

    ckpt = CheckpointManager(args.ckpt_dir, keep_k=2)
    path = ckpt.save(args.steps, (params, bn), extra=dict(info, history=[]))
    print(f"checkpoint at {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

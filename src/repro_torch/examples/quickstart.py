"""Quickstart: train the paper's CNN equalizer on the simulated 40 GBd
IM/DD optical channel and compare it with a linear FIR at the SAME
complexity (paper Fig. 2's headline comparison), then run the deployment
path (BN folded, the fused CUDA kernel through `kernels.cnn_eq.ops`).

Port of the reference's `examples/quickstart.py`:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the CPU the deployment path runs the kernel's plain version.
"""
from __future__ import annotations

import argparse

import torch

from ..channels import imdd
from ..channels.common import ber_from_soft
from ..core.equalizer import CNNEqConfig
from ..core.fir import FIRConfig
from ..core.train_eq import EqTrainConfig, train_equalizer
from ..data.equalizer_data import channel_fn
from ..device import resolve_device
from ..kernels.cnn_eq import ops as cnn_ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fn = channel_fn("imdd", imdd.IMDDConfig(), device=dev)
    tcfg = EqTrainConfig(steps=600, batch=8, seq_syms=256, lr=3e-3,
                         eval_syms=1 << 14)

    print("training the paper's CNN (V_p=8, L=3, K=9, C=5) …")
    cnn_cfg = CNNEqConfig()
    params, bn, cnn = train_equalizer(torch.Generator().manual_seed(0),
                                      "cnn", cnn_cfg, fn, tcfg, device=dev)
    print(f"  CNN  ({cnn_cfg.mac_per_symbol():.1f} MAC/sym): "
          f"BER {cnn['ber']:.3e}")

    print("training a same-complexity linear FIR …")
    _, _, fir = train_equalizer(torch.Generator().manual_seed(0), "fir",
                                FIRConfig(taps=57), fn, tcfg, device=dev)
    print(f"  FIR  (57.0 MAC/sym): BER {fir['ber']:.3e}")

    # deployment path: fold BN and run the fused kernel
    rx, syms = imdd.simulate(torch.Generator(device=dev).manual_seed(1),
                             imdd.IMDDConfig(), 4096, device=dev)
    y = cnn_ops.equalize(params, bn, rx, cnn_cfg, use_kernel=True,
                         device=dev)
    print(f"fused-kernel deployment BER on a fresh frame ({dev}): "
          f"{float(ber_from_soft(y, syms, 2)):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

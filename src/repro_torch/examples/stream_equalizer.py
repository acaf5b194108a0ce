"""Multi-instance stream equalization — the paper's §5.3 hardware path:

    OGM (overlap) → SSM tree (split) → N_i × CNN → MSM (merge) → ORM

Port of the partitioned part of the reference's
`examples/stream_equalizer.py`: one `EqualizerEngine` runs all N_i
overlapped instances as one batch (`core.stream_partition.
partitioned_apply`), and the merged interior is held against the engine
on the unsplit stream. The paper's timing model then names ℓ_inst for its
80 GSa/s target where N_i instances can reach it.

    PYTHONPATH=src python -m repro_torch.examples.stream_equalizer \
        [--instances 8] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..channels import imdd
from ..core import equalizer as eq
from ..core import seqlen_opt, stream_partition as sp
from ..core import timing_model as tm
from ..core.engine import EqualizerEngine
from ..device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.stream_equalizer")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_inst = args.instances

    cfg = eq.CNNEqConfig()
    params = eq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    # the production inference path: BN-folded, fused kernel ("auto"
    # upgrades to int8 or bf16 when QAT formats are present in params)
    engine = EqualizerEngine.from_params(params, eq.init_bn_state(cfg, "cpu"),
                                         cfg, backend="auto", tile_m="auto",
                                         device=dev)

    n_syms = 1024 * n_inst
    rx, _ = imdd.simulate(torch.Generator(device=dev).manual_seed(0),
                          imdd.IMDDConfig(), n_syms, device=dev)

    y_single = engine(rx)
    y_split = sp.partitioned_apply(engine, rx, n_inst, cfg)
    o = sp.overlap_symbols(cfg)
    inner = y_split[o:-o] - y_single[o:-o]
    print(f"{n_inst} instances on {dev} (engine: {engine.describe()}):")
    print(f"  split-tree vs single instance (interior): max err "
          f"{float(inner.abs().max()):.2e}, bitwise "
          f"{bool(torch.equal(y_split[o:-o], y_single[o:-o]))}")

    hw = tm.fpga_profile(cfg)
    if tm.max_throughput(hw, n_inst) > 80e9:
        l_inst = seqlen_opt.optimal_l_inst(cfg, hw, n_inst, 80e9)
        print(f"  ℓ_inst for 80 GSa/s: {l_inst} "
              f"(λ = {tm.symbol_latency(cfg, hw, n_inst, l_inst)*1e6:.1f} µs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-instance stream equalization — the paper's §5.3 hardware path:

    OGM (overlap) → SSM tree (split) → N_i × CNN → MSM (merge) → ORM

Port of the reference's `examples/stream_equalizer.py`, run two ways:
(1) one `EqualizerEngine` runs all N_i overlapped instances as one batch
(`core.stream_partition.partitioned_apply`); (2) the halo exchange
(`parallel.halo.halo_apply`): the same stream sharded over ``--ranks``
spawned processes (default N_i), one CNN instance a rank, each with its own
engine on its device, exchanging only the boundary samples with its
neighbours (over NCCL where each rank has its own card, else gloo). Both
are held against the engine on the unsplit stream, on the interior. The
paper's timing model then names ℓ_inst for its 80 GSa/s target where N_i
instances can reach it.

    PYTHONPATH=src python -m repro_torch.examples.stream_equalizer \
        [--instances 8] [--ranks 4] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..channels import imdd
from ..core import equalizer as eq
from ..core import seqlen_opt, stream_partition as sp
from ..core import timing_model as tm
from ..core.engine import EqualizerEngine
from ..device import resolve_device
from ..launch.mesh import make_mesh, run_ranks
from ..parallel import halo


def _engine(cfg: eq.CNNEqConfig, dev: torch.device) -> EqualizerEngine:
    params = eq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    # the production inference path: BN-folded, fused kernel ("auto"
    # upgrades to int8 or bf16 when QAT formats are present in params)
    return EqualizerEngine.from_params(params, eq.init_bn_state(cfg, "cpu"),
                                       cfg, backend="auto", tile_m="auto",
                                       device=dev)


def _halo_rank(rank: int, world: int, device: str,
               rx: np.ndarray) -> np.ndarray:
    """One CNN instance: this rank's shard of ``rx`` through its engine."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = eq.CNNEqConfig()
    mesh = make_mesh((world,), ("data",), dev.type)
    x = halo.local_shard(torch.from_numpy(rx), cfg, mesh)
    return halo.halo_apply(_engine(cfg, dev), x, cfg, mesh).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.stream_equalizer")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the halo exchange (default: "
                         "--instances)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_inst = args.instances
    n_ranks = args.ranks or n_inst

    cfg = eq.CNNEqConfig()
    engine = _engine(cfg, dev)

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
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n_ranks else "gloo")
    y_halo = torch.from_numpy(np.concatenate(run_ranks(
        _halo_rank, n_ranks, (dev.type, rx.cpu().numpy()), backend)))
    inner = y_halo[o:-o] - y_single[o:-o].cpu()
    print(f"  halo exchange over {n_ranks} ranks ({backend}) vs single "
          f"instance (interior): max err {float(inner.abs().max()):.2e}, "
          f"bitwise {bool(torch.equal(y_halo, y_single.cpu()))} "
          f"(whole stream)")

    hw = tm.fpga_profile(cfg)
    if tm.max_throughput(hw, n_inst) > 80e9:
        l_inst = seqlen_opt.optimal_l_inst(cfg, hw, n_inst, 80e9)
        print(f"  ℓ_inst for 80 GSa/s: {l_inst} "
              f"(λ = {tm.symbol_latency(cfg, hw, n_inst, l_inst)*1e6:.1f} µs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

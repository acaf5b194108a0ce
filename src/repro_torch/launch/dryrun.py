"""Multi-pod dry run: prove the distribution config is coherent without the
hardware.

Port of `repro.launch.dryrun`. For every (architecture × input shape ×
mesh) cell, on the 16×16 single-pod mesh AND the 2×16×16 multi-pod mesh:

    a fake world of 256 (512) ranks in this process   (launch.mesh)
    under FakeTensorMode:
        low = steps.make_lowerable(arch, shape, mesh)   # DTensor inputs
        one step of low under roofline.StepCounter      # flops, bytes,
                                                        # collectives, peak

The reference lowers and compiles each cell with XLA and reads its HLO;
the port has no compiler, so it runs the step itself on fake tensors:
rank 0's local shards, every op at its local shape, the collectives
DTensor issues over the fake group (which moves nothing). The flash and
sLSTM kernels are opaque ops whose fake kernels give their outputs and
whose flop formulas give their own work (causal where causal): the
counterpart of the reference's `REPRO_STUB_FLASH` stub plus its
`_kernel_flops`, which here stays as the analytical expectation
(`kernel_flops`). Failures (a sharding the model cannot run, an op
without a sharding rule) are bugs.

Memory per rank: the arguments' local shards (params, optimizer state,
batch, serve state) plus the step's temporaries (the peak of the live
bytes the step's ops made, `StepCounter.peak_bytes`), against the H100's
80 GB, with the op that made the peak and the largest tensors live there
(`peak_op`, `peak_live`); every local matrix product a rank runs, by
operand shapes with its count, the largest operand first (`products`),
and the flops by op (`flops_by_op`).

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
        [--reduced] [--override fused_attention=true] [--out build/dryrun]

Results land as JSON per cell (roofline terms, bytes per rank, collective
counts) in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from .. import configs
from ..configs.shapes import SHAPES
from ..interop import tree_leaves
from ..parallel import sharding
from . import roofline as rl
from . import steps
from .mesh import make_production_mesh

HBM_PER_CHIP = rl.HBM_PER_CHIP           # NVIDIA H100 SXM5: 80 GB
# the counted ops that are the hand-written kernels
KERNEL_OPS = ("repro_torch.flash_attention", "repro_torch.flash_attention_fwd",
              "repro_torch.flash_attention_bwd_dkv",
              "repro_torch.flash_attention_bwd_dq", "repro_torch.slstm_fused",
              "repro_torch.slstm_fused_bwd")


def _tokens_for(shape) -> int:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch        # decode: 1 token per sequence


def _kernel_flops(cfg, shape, n_chips: int) -> float:
    """Per-chip flops of the flash-attention calls, as the reference adds
    them analytically: train = 5.5·L (forward, its recompute under remat,
    the dK/dV and dQ kernels' 3.5×) per microbatch, prefill = L, decode 0;
    each `attention_costs` of the whole batch (causal, the config's
    window) over ``n_chips``."""
    if not cfg.fused_attention or shape.kind == "decode":
        return 0.0
    from ..kernels.flash_attn import attention_costs
    hq, _ = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    if cfg.family == "hybrid":
        from ..models.zamba2 import attn_points
        layers = len(attn_points(cfg))
    else:
        layers = cfg.n_layers
    b = shape.global_batch
    s = shape.seq_len                       # VLM: prefix+text = backbone seq
    factor = (5.5 if shape.kind == "train" else 1.0) * layers
    per = attention_costs(b, s, s, hq, cfg.head_dim, causal=True,
                          window=cfg.window)
    return factor * per["flops"] / n_chips


def _local_bytes(tree) -> int:
    """Bytes of each tensor leaf's local shard (a plain tensor whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             reduced: bool = False, cfg_overrides: Optional[dict] = None,
             verbose: bool = True) -> dict:
    """One cell's result: status "ok" (with n_params, n_active_params,
    the roofline, memory per rank and the kernels' counted flops),
    "skipped" (with the reference's reason) or "failed" (with the
    error). The fake world is torn down after the cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = SHAPES[shape_name]
    ok, reason = steps.cell_supported(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason}
    if dist.is_initialized():
        raise RuntimeError("run_cell stands up its own fake world; a "
                           "torch.distributed world is already initialized")
    mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            low = steps.make_lowerable(arch, shape, mesh, reduced=reduced,
                                       cfg_overrides=cfg_overrides)
            t_build = time.time() - t0
            cfg = low.cfg
            n_chips = mesh.size()
            n_active = cfg.n_active_params()
            mfl = rl.model_flops(n_active, _tokens_for(shape), shape.kind)
            counter = rl.StepCounter()
            out, roof, _ = rl.count_step(low.fn, *low.args, n_chips=n_chips,
                                         model_fl=mfl, counter=counter)
            t_count = time.time() - t0 - t_build
            arg_bytes = _local_bytes(low.args)
            out_bytes = _local_bytes(out)
            n_params = sum(t.numel() for t in tree_leaves(low.args[0]))
        kernel_flops = {k: v for k, v in counter.flops_by_op.items()
                        if k in KERNEL_OPS}
        result = {
            "arch": arch, "shape": shape_name,
            "mesh": str(sharding.mesh_axes(mesh)), "chips": n_chips,
            "status": "ok",
            "kind": shape.kind,
            "t_build_s": round(t_build, 1), "t_count_s": round(t_count, 1),
            "n_params": int(n_params), "n_active_params": int(n_active),
            "ops_per_chip": counter.n_ops,
            "roofline": roof.to_dict(),
            "kernel_flops": kernel_flops,
            "kernel_flops_expected": _kernel_flops(cfg, shape, n_chips),
            "flops_by_op": dict(counter.flops_by_op),
            "products": [
                {"op": op, "shapes": [list(s) for s in shapes], "count": c}
                for op, shapes, c in counter.products_by_size()],
        }
        live = arg_bytes + counter.peak_bytes
        result["memory"] = {
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": counter.peak_bytes,
            "live_bytes_per_chip": live,
            "fits_hbm": bool(live <= HBM_PER_CHIP),
            "peak_op": counter.peak_op,
            "peak_live": [{"bytes": n, "op": op, "shape": list(shape),
                           "dtype": dt}
                          for n, op, shape, dt in counter.peak_live]}
        if verbose:
            r = result["roofline"]
            print(f"[{arch} × {shape_name} × {n_chips}ch] OK  "
                  f"build {t_build:.1f}s count {t_count:.1f}s  "
                  f"compute {r['t_compute_s'] * 1e3:.2f}ms  "
                  f"memory {r['t_memory_s'] * 1e3:.2f}ms  "
                  f"collective {r['t_collective_s'] * 1e3:.2f}ms  "
                  f"→ {r['bottleneck']}-bound, "
                  f"MFU@roofline {r['mfu_at_roofline'] * 100:.1f}%")
            m = result["memory"]
            print(f"    mem/chip: args {m['argument_bytes'] / 2 ** 30:.2f} "
                  f"GiB + temps {m['temp_bytes'] / 2 ** 30:.2f} GiB (fits "
                  f"{HBM_PER_CHIP / 1e9:.0f} GB: {m['fits_hbm']})")
        return result
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "status": "failed",
                "error": f"{type(e).__name__}: {e}",
                "multi_pod": multi_pod}
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="a config field for every cell, the value as JSON "
                         "(e.g. fused_attention=true, tp=16)")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    overrides = {}
    for item in args.override:
        key, _, val = item.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    t0 = time.time()
    for arch, shape in cells:
        for mp in meshes:
            res = run_cell(arch, shape, multi_pod=mp, reduced=args.reduced,
                           cfg_overrides=overrides or None)
            tag = "mp" if mp else "sp"
            fname = out / f"{arch}_{shape}_{tag}.json"
            fname.write_text(json.dumps(res, indent=2))
            if res["status"] == "failed":
                failures += 1
                print(f"[{arch} × {shape} × {tag}] FAILED: {res['error']}")
            elif res["status"] == "skipped":
                print(f"[{arch} × {shape}] SKIPPED: {res['reason'][:60]}…")
    print(f"{len(cells) * len(meshes)} cells in {time.time() - t0:.1f} s, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

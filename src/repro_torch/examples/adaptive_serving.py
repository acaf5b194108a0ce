"""Online adaptation under channel drift — the repro_torch.adapt runtime.

Two tenants stream the SAME drifting Proakis-B magnetic-recording channel
(tap rotation + SNR ramp, `repro_torch.channels.drift`) through one
serving runtime, both starting from one equalizer trained on the
pre-drift channel:

  * "frozen"   — served as-is; its BER degrades as the channel drifts
                 away from what it was trained for;
  * "adaptive" — attached to an `OnlineAdapter`: served traffic is tapped
                 into a sample buffer (pilot labels here — the load
                 generator knows the tx symbols), a background fine-tune
                 resumes training from the live weights, a shadow
                 evaluator scores each candidate on held-out traffic, and
                 winning candidates hot-swap into the live stream at a
                 chunk boundary (bitwise-per-epoch — docs/ADAPTATION.md).

The printed per-burst BER trajectories show the story: both tenants track
each other until the ramp, the frozen tenant falls off a cliff, the
adaptive one recovers within a few bursts of the first promotion.

Port of the reference's `examples/adaptive_serving.py`:

    PYTHONPATH=src python -m repro_torch.examples.adaptive_serving \
        [--bursts 26] [--train-steps 600] [--driver sync|async] \
        [--device cpu]

On the CPU the engines run the kernel's plain version.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..adapt import (AdaptPolicy, FineTuneConfig, OnlineAdapter,
                     PromotionPolicy, engine_ber, hard_decide)
from ..channels.drift import DriftingProakis, DriftSchedule
from ..core import equalizer as eq
from ..core.train_eq import EqTrainConfig, train_equalizer
from ..device import resolve_device
from ..serve import (AsyncServeRuntime, BatchPolicy, ServeRuntime,
                     TenantSpec, drift_streams, replay_adaptive)

CFG = eq.CNNEqConfig()


def burst_ber(soft, pilots):
    """Per-burst BER of a served stream against its true symbols."""
    decided = hard_decide(np.asarray(soft), CFG.levels)
    out, pos = [], 0
    for true in pilots:
        n = min(int(true.shape[0]), decided.shape[0] - pos)
        if n <= 0:
            break
        out.append(float(np.mean(decided[pos:pos + n] != true[:n])))
        pos += n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.adaptive_serving")
    ap.add_argument("--bursts", type=int, default=26)
    ap.add_argument("--syms-per-burst", type=int, default=2048)
    ap.add_argument("--train-steps", type=int, default=600)
    ap.add_argument("--driver", choices=("sync", "async"), default="sync")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    channel = DriftingProakis()
    print(f"training the shared base equalizer on the pre-drift channel "
          f"({args.train_steps} steps, {dev})…")
    params, bn, info = train_equalizer(
        torch.Generator().manual_seed(0), "cnn", CFG,
        channel.at(0.0, device=dev),
        EqTrainConfig(steps=args.train_steps, eval_syms=1 << 14),
        device=dev)
    print(f"  pre-drift BER: {info['ber']:.3e}")

    rt = (AsyncServeRuntime if args.driver == "async" else ServeRuntime)(
        BatchPolicy(max_batch=2, max_wait_s=1e9), device=dev)
    adapter = OnlineAdapter(
        rt,
        AdaptPolicy(min_train_syms=3072, adapt_every_syms=3072,
                    eval_capacity=8192,
                    promotion=PromotionPolicy(min_eval_syms=1024,
                                              eval_bucket_syms=512)),
        FineTuneConfig(steps=200, batch=8, seq_syms=256, lr=3e-3))

    def spec(tid):
        return TenantSpec(tid, CFG, params=params, bn_state=bn,
                          backend="fused_fp32", tile_m=16)

    rt.open(spec("frozen"))
    sess = adapter.attach(spec("adaptive"))

    sched = DriftSchedule(hold_bursts=4, ramp_bursts=6)
    streams, pilots = drift_streams(
        channel, sched, ["frozen", "adaptive"], n_bursts=args.bursts,
        syms_per_burst=args.syms_per_burst, seed=3, device=dev)
    print(f"replaying {args.bursts} bursts × {args.syms_per_burst} syms "
          f"(drift settles at burst {sched.total_to_settle}) "
          f"on {type(rt).__name__}…")
    replay_adaptive(rt, streams, pilots=pilots, adapter=adapter,
                    step_every=2)

    traj_f = burst_ber(rt.output("frozen"), pilots["frozen"])
    traj_a = burst_ber(rt.output("adaptive"), pilots["adaptive"])
    # swap_log positions are engine passes (V_p symbols each)
    swaps = {pos * CFG.v_parallel // args.syms_per_burst
             for _, pos in sess.swap_log[1:]}
    print(f"\n  burst    t    frozen BER   adaptive BER")
    for b, (bf, ba) in enumerate(zip(traj_f, traj_a)):
        mark = "  ← weights hot-swapped" if b in swaps else ""
        print(f"  {b:5d}  {sched.t_at(b):4.2f}   {bf:10.4f}   "
              f"{ba:10.4f}{mark}")

    rx1, sy1 = channel.at(1.0, device=dev)(
        torch.Generator(device=dev).manual_seed(77), 1 << 14)
    rx1, sy1 = rx1.cpu().numpy(), sy1.cpu().numpy()
    bf = engine_ber(rt.sessions.get("frozen").engine, rx1, sy1)
    ba = engine_ber(sess.engine, rx1, sy1)
    actions = [r.action for r in adapter.history if r.action != "idle"]
    print(f"\npost-drift (fresh t=1 data): frozen {bf:.3e} vs adaptive "
          f"{ba:.3e} ({bf / max(ba, 1e-4):,.0f}x better)")
    print(f"adaptation actions: {actions}")
    print(f"weight epochs (epoch, start position): {sess.swap_log}")
    if args.driver == "async":
        rt.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

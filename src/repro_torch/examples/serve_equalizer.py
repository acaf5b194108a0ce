"""Multi-tenant streaming equalizer serving — the repro_torch.serve runtime.

Opens a mixed tenant population on ONE runtime:

  * three "ht" tenants — the 40 GBd IM/DD optical operating point with
    8-bit QAT formats → the auto ladder deploys fused_int8;
  * three "lp" tenants — the Proakis-B magnetic-recording operating point
    with 12-bit QAT formats → deploys fused_bf16;

then streams each tenant's channel-simulated waveform in bursty chunks
(round-robin arrivals). Chunks from tenants sharing a backend coalesce into
ONE stacked fused-kernel launch with per-row tenant weights; the two
backends form separate batch groups. At the end each tenant's streamed
output is checked against the offline engine on its full waveform —
bitwise-identical for every fused backend.

`--driver async` (the default) runs the same workload through
`AsyncServeRuntime`: submits return per-chunk futures, the max_wait timer
fires from the runtime's own thread, and stacked-input assembly overlaps
device launches (double buffering). `--driver sync` uses the synchronous
`ServeRuntime`. The parity check is identical either way — only the
driving loop changes.

Port of the reference's `examples/serve_equalizer.py`:

    PYTHONPATH=src python -m repro_torch.examples.serve_equalizer \
        [--tenants-per-op 3] [--driver async|sync] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..channels import imdd, proakis
from ..configs import equalizer_ht as HT
from ..configs import equalizer_lp as LP
from ..core import equalizer as eq
from ..device import resolve_device
from ..serve import (AsyncServeRuntime, BatchPolicy, ServeRuntime,
                     TenantSpec, chop, replay)

FORMATS = {
    "ht": {"w_int": 2, "w_frac": 5, "a_int": 3, "a_frac": 4},   # → int8
    "lp": {"w_int": 3, "w_frac": 8, "a_int": 3, "a_frac": 8},   # → bf16
}


def make_tenant(op: str, idx: int, n_syms: int, dev: torch.device):
    cfg = HT.CNN if op == "ht" else LP.CNN
    seed = 100 * idx + (0 if op == "ht" else 1)
    params = eq.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    params["qat"] = {
        f"layer{i}": {k: torch.tensor(float(v))
                      for k, v in FORMATS[op].items()}
        for i in range(cfg.layers)}
    spec = TenantSpec(f"{op}-{idx}", cfg, params=params,
                      bn_state=eq.init_bn_state(cfg, device="cpu"),
                      backend="auto", tile_m=16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if op == "ht":
        rx, _ = imdd.simulate(gen, HT.CHANNEL, n_syms, device=dev)
    else:
        rx, _ = proakis.simulate(gen, LP.CHANNEL, n_syms, device=dev)
    return spec, rx.cpu().numpy().astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_equalizer")
    ap.add_argument("--tenants-per-op", type=int, default=3)
    ap.add_argument("--n-syms", type=int, default=2048)
    ap.add_argument("--chunk-syms", type=int, default=256)
    ap.add_argument("--driver", choices=("async", "sync"), default="async")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    policy = BatchPolicy(max_batch=args.tenants_per_op, max_wait_s=1e9)
    rt = (AsyncServeRuntime(policy, device=dev) if args.driver == "async"
          else ServeRuntime(policy, device=dev))
    print(f"driver: {args.driver} ({type(rt).__name__}) on {dev}")
    tenants = [make_tenant(op, i, args.n_syms, dev)
               for op in ("ht", "lp") for i in range(args.tenants_per_op)]
    for spec, _ in tenants:
        s = rt.open(spec)
        print(f"  open {spec.tenant_id}: backend={s.engine.backend}")

    streams = {spec.tenant_id: chop(w, args.chunk_syms * spec.cfg.n_os,
                                    seed=i, jitter=0.5)
               for i, (spec, w) in enumerate(tenants)}
    rep = replay(rt, streams)       # async: drain() waits for all landings

    worst = 0.0
    for spec, w in tenants:
        got = rt.output(spec.tenant_id)
        want = spec.build_engine(dev)(w).cpu().numpy()
        assert got.shape == want.shape, \
            f"{spec.tenant_id}: streamed {got.shape} != offline {want.shape}"
        worst = max(worst, float(np.max(np.abs(got - want))))
        assert bool(np.all(got == want)), \
            f"{spec.tenant_id}: streamed != offline (max |Δ| {worst:.2e})"
    st = rt.stats()
    print(f"\n{len(tenants)} tenants, {rep['total_syms']} symbols streamed "
          f"in {rep['elapsed_s']:.2f}s "
          f"({rep['agg_syms_per_s']:,.0f} sym/s aggregate)")
    print(f"  launches={st['launches']} mean_batch={st['mean_batch']:.1f} "
          f"(int8 and bf16 tenants batch separately)")
    print(f"  latency p50={st['p50_latency_ms']:.1f} ms "
          f"p99={st['p99_latency_ms']:.1f} ms")
    print(f"  engine pool: {st['pool']}")
    print(f"  streamed output == offline engine: bitwise "
          f"(max |Δ| = {worst:.1e}) for all tenants")
    if args.driver == "async":
        rt.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time the sLSTM cluster kernel's alternatives on the card.

    PYTHONPATH=src python -m repro_torch.kernels.slstm.sweep \\
        [--parent PATH/slstm.cu] [--out chiprun_out/slstm_sweep.json]

At xlstm-125m's served sLSTM shape (xg (4, 2048, 3072), r (4, 4, 192, 192),
both bf16; random inputs from a seed, as chip_smoke.py's [10b] draws them)
it times, with CUDA events:
- the shape's own plan (`slstm._plan`), through `slstm_fused`;
- the cluster kernel at every other cluster size Q and rows a CTA RB that
  fit (`slstm_cluster_launch`), with the number of such clusters the card
  holds at once;
- the plan's kernel built from copies of the source with one piece
  rewritten (`VARIANTS`, built under build/kernels): R's slice kept in
  shared memory as f32 and read every step instead of in registers; h
  handed over through plain distributed-shared-memory stores and a
  cluster barrier a step instead of st.async counted on the receiver's
  mbarrier; the recurrent product as separate IEEE-rounded multiplies and
  adds instead of `__fmaf_rn`; two partial sums a lane instead of one; x
  loaded four steps ahead, or at the top of the step, or through `__ldg`;
  hs stored at the top of the next step; the wait's acquire at CTA
  scope; and ablations that give wrong results — no x load (x frozen at
  step 0), no hs store, no gate math, no recurrent product. An ablation
  also changes the values the gates see, and with them the branches that
  tanhf, expf and the divisions take, so it bounds a part's cost rather
  than measuring it;
- with --parent, the `slstm_launch` of another copy of the source (an
  earlier commit's), on the same inputs in the same process.
Before timing it holds the plan's kernel and every alternative against the
plain version at short sequences (atol 1e-4), and prints the -Xptxas -v
lines of the cluster instances. The result is one JSON object, printed and
written to --out. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from . import ref
from . import slstm as S

SERVED = (4, 2048, 4, 192)                      # b, s, nh, dh
ITERS = 10                                      # timed calls a figure
CANDIDATES = [(q, rb) for q in (6, 7, 8, 12, 16) for rb in (1, 2, 4)]
CHECK_SHAPES = ((4, 33, 4, 192), (5, 17, 4, 192), (2, 9, 2, 100),
                (1, 5, 2, 6), (2, 1, 4, 192), (2, 7, 1, 1024))
_GATES = """    const float z = tanhf(pz);
    const float o = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-po)));
    const float fm = __fadd_rn(f_pre, m_st);
    const float m_new = fmaxf(fm, i_pre);
    const float i_s = expf(__fsub_rn(i_pre, m_new));
    const float f_s = expf(__fsub_rn(fm, m_new));
    c_st = __fadd_rn(__fmul_rn(f_s, c_st), __fmul_rn(i_s, z));
    n_st = __fadd_rn(__fmul_rn(f_s, n_st), i_s);
    h_st = __fdiv_rn(__fmul_rn(o, c_st), fmaxf(n_st, 1e-6f));
    m_st = m_new;
"""
# R's slice in shared memory as f32 (after the h buffers; k-blocks at a
# stride ≡ 4 and gates at ≡ 2 (mod 32) words, so that a warp's 8-byte reads
# hit distinct banks), read every step, instead of in registers
_R_REGS = """  float rr[CL_MAX_KP][2];
  const RT* r_g = r + (static_cast<long long>(g) * nh + hd) * dh * dh;
#pragma unroll
  for (int i = 0; i < CL_MAX_KP; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = kq * p.kp + i, col = 2 * w + c;
      rr[i][c] = i < p.kp && k < dh && col < ne
                     ? to_f32(r_g[static_cast<long long>(k) * dh + e0 + col])
                     : 0.0f;
    }
"""
_R_STRIDES = """  const int row_ = 2 * p.nw;
  const int ps_ = p.kp * row_ + ((4 - (p.kp * row_) % 32) + 32) % 32;
  const int gs_ = 8 * ps_ + ((2 - (8 * ps_) % 32) + 32) % 32;
"""
_R_SMEM = _R_STRIDES + """  float* r_s = h_s + 2 * hbuf;
  for (int i = threadIdx.x; i < 4 * gs_; i += blockDim.x) {
    const int gg = i / gs_, in_g = i - gg * gs_;
    const int kb = in_g / ps_, in_b = in_g - kb * ps_;
    const int kk = in_b / row_, c = in_b - kk * row_;
    const int k = kb * p.kp + kk;
    r_s[i] = kb < 8 && kk < p.kp && k < dh && c < ne
                 ? to_f32(r[((static_cast<long long>(gg) * nh + hd) * dh
                             + k) * dh + e0 + c])
                 : 0.0f;
  }
  const float* r_lane = r_s + g * gs_ + kq * ps_ + 2 * w;
"""
_MAC_REGS = """            acc[rb][0] = mac(acc[rb][0], lane_of(hv, j), rr[i + j][0]);
            acc[rb][1] = mac(acc[rb][1], lane_of(hv, j), rr[i + j][1]);
"""
_MAC_SMEM = """            const float2 rv = *reinterpret_cast<const float2*>(
                r_lane + (i + j) * 2 * p.nw);
            acc[rb][0] = mac(acc[rb][0], lane_of(hv, j), rv.x);
            acc[rb][1] = mac(acc[rb][1], lane_of(hv, j), rv.y);
"""
_ATTR = """    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
"""
_MBAR_WAIT = """    if (t > 0) mbar_wait(&bars[t & 1], ((t - 1) >> 1) & 1);
    if (threadIdx.x == 0 && t + 1 < S)
      mbar_expect_tx(&bars[(t + 1) & 1], step_bytes);
"""
_ST_ASYNC = """    if (valid && t + 1 < S) {
      const unsigned dst = smem_addr(h_s + ((t + 1) & 1) * hbuf + h_at);
      const unsigned bar = smem_addr(&bars[(t + 1) & 1]);
      for (int peer = slot; peer < p.q; peer += per_pair)
        st_async_f32(map_rank(dst, peer), h_st, map_rank(bar, peer));
    }
"""
_X_NEXT = """      x_nxt = to_f32(x_p[static_cast<long long>(t + 2) * xg_ss]);
  }
"""
_X_SHIFT = """    x_cur = x_nxt;
    if (valid && t + 2 < S)
      x_nxt = to_f32(x_p[static_cast<long long>(t + 2) * xg_ss]);
"""
_ARMED = """      mbar_expect_tx(&bars[(t + 1) & 1], step_bytes);
"""
_X_TOP = """    if (t > 0) x_cur = x_nxt;
    if (valid && t + 1 < S)
      x_nxt = to_f32(x_p[static_cast<long long>(t + 1) * xg_ss]);
"""
_HS_STORE = """    if (valid && slot == 0) hs_p[static_cast<long long>(t) * d] = h_st;
"""
_HS_TOP = """    if (valid && slot == 0 && t > 0)
      hs_p[static_cast<long long>(t - 1) * d] = h_st;
"""
_EPILOGUE = """  if (valid && slot == 0) {
"""
_HS_LAST = """    hs_p[static_cast<long long>(S - 1) * d] = h_st;
"""
_WAIT_CALL = """    if (t > 0) mbar_wait(&bars[t & 1], ((t - 1) >> 1) & 1);
"""
_WAIT_CTA = """__device__ __forceinline__ void mbar_wait_cta(unsigned long long* bar,
                                              unsigned parity) {
  asm volatile(
      "{\\n.reg .pred done;\\nWAIT_%=:\\n"
      "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 done, [%0], %1;\\n"
      "@!done bra WAIT_%=;\\n}\\n" :: "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
"""
# name: ((text in the source, its replacement), ...), results stay right
VARIANTS = {
    "r_in_smem": (((_R_REGS, _R_SMEM), (_MAC_REGS, _MAC_SMEM),
                   (_ATTR, _ATTR.replace("const cudaError_t err", "cudaError_t "
                                         "err") + """    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
"""),
                   ("  cfg.dynamicSmemBytes = p.smem;\n",
                    _R_STRIDES + "  cfg.dynamicSmemBytes = p.smem + 16 * gs_;"
                    "\n")), True),
    # h through plain distributed-shared-memory stores and a cluster
    # barrier a step (arrive after the stores, wait after hs and x)
    "cluster_barrier": ((('#include "cluster_sync.cuh"\n',
                          '#include "cluster_sync.cuh"\n'
                          "#include <cooperative_groups.h>\n"),
                         (_MBAR_WAIT, ""),
                         (_ST_ASYNC, """    if (valid) {
      float* dst = h_s + ((t + 1) & 1) * hbuf + h_at;
      for (int peer = slot; peer < p.q; peer += per_pair)
        *cooperative_groups::this_cluster().map_shared_rank(dst, peer) =
            h_st;
    }
    cluster_arrive();
"""),
                         (_X_NEXT, _X_NEXT.replace("  }\n",
                                                   "    cluster_wait();\n  }\n"))
                         ), True),
    "unfused_mac": ((("  return __fmaf_rn(h, r, acc);",
                      "  return __fadd_rn(acc, __fmul_rn(h, r));"),), True),
    # x loaded four steps ahead (a ring of four registers) instead of two
    "x_ahead4": ((("  float x_cur = 0.0f, x_nxt = 0.0f;",
                   "  float x_cur = 0.0f, x_nxt = 0.0f, x_2 = 0.0f, "
                   "x_3 = 0.0f;"),
                  ("    if (S > 1) x_nxt = to_f32(x_p[xg_ss]);\n",
                   "    if (S > 1) x_nxt = to_f32(x_p[xg_ss]);\n"
                   "    if (S > 2) x_2 = to_f32(x_p[2 * xg_ss]);\n"
                   "    if (S > 3) x_3 = to_f32(x_p[3 * xg_ss]);\n"),
                  ("    x_cur = x_nxt;\n    if (valid && t + 2 < S)\n"
                   "      x_nxt = to_f32(x_p[static_cast<long long>(t + 2) "
                   "* xg_ss]);\n",
                   "    x_cur = x_nxt;\n    x_nxt = x_2;\n    x_2 = x_3;\n"
                   "    if (valid && t + 4 < S)\n      x_3 = to_f32(x_p["
                   "static_cast<long long>(t + 4) * xg_ss]);\n")), True),
    # two partial sums a lane (k-blocks of 4 alternating), added at the end
    "two_chains": ((("    float acc[RB][2];\n",
                     "    float acc[RB][2], acc2[RB][2];\n"),
                    ("    for (int rb = 0; rb < RB; ++rb) acc[rb][0] = acc[rb]"
                     "[1] = 0.0f;\n",
                     "    for (int rb = 0; rb < RB; ++rb)\n      acc[rb][0] = "
                     "acc[rb][1] = acc2[rb][0] = acc2[rb][1] = 0.0f;\n"),
                    (_MAC_REGS,
                     "            float* a = (i & 4) ? acc2[rb] : acc[rb];\n"
                     "            a[0] = mac(a[0], lane_of(hv, j), rr[i + j][0]"
                     ");\n            a[1] = mac(a[1], lane_of(hv, j), "
                     "rr[i + j][1]);\n"),
                    ("    // the eight k-blocks of this gate, in a fixed tree\n",
                     "    for (int rb = 0; rb < RB; ++rb)\n      for (int c = "
                     "0; c < 2; ++c)\n        acc[rb][c] = __fadd_rn(acc[rb]"
                     "[c], acc2[rb][c]);\n")), True),
    # x for step t + 1 loaded at the top of step t, after the wait
    "x_at_top": (((_X_SHIFT, ""), (_ARMED, _ARMED + _X_TOP)), True),
    # and hs for step t - 1 stored there too
    "mem_at_top": (((_X_SHIFT, ""), (_HS_STORE, ""),
                    (_ARMED, _ARMED + _X_TOP + _HS_TOP),
                    (_EPILOGUE, _EPILOGUE + _HS_LAST)), True),
    # x through the non-coherent read-only path
    "x_ldg": ((("      x_nxt = to_f32(x_p[static_cast<long long>(t + 2) * "
                "xg_ss]);", "      x_nxt = to_f32(__ldg(&x_p[static_cast<long"
                " long>(t + 2) * xg_ss]));"),), True),
    # the wait's acquire at CTA scope instead of cluster scope
    "wait_cta": (((_WAIT_CALL, _WAIT_CALL.replace("mbar_wait(", "mbar_wait_cta(")),
                  ("__device__ __forceinline__ float mac(",
                   _WAIT_CTA + "__device__ __forceinline__ float mac(")),
                 True),
    # ablations (wrong results): what a step's time is made of
    "no_x_load": ((("      x_nxt = to_f32(x_p[static_cast<long long>(t + 2)"
                    " * xg_ss]);", "      x_nxt = x_cur;"),), False),
    "no_hs_store": ((("    if (valid && slot == 0) hs_p[static_cast<long "
                      "long>(t) * d] = h_st;", "    ;"),), False),
    "no_gates": (((_GATES, "    h_st = __fadd_rn(__fadd_rn(pz, i_pre), "
                   "__fadd_rn(f_pre, po));\n"),), False),
    "no_macs": ((("      if (has_cols && i < p.kp) {",
                  "      if (i < 0) {"),), False),
}


def inputs(gen, b, s, nh, dh, x_dt, r_dt):
    """xg 0.5·N with the model's forget offset (+1 on f), r ~ N(0, 0.09/dh)
    and a nonzero state, on the card."""
    dev = gen.device
    d = nh * dh
    xg = 0.5 * torch.randn((b, s, 4, d), generator=gen, device=dev)
    xg[:, :, 2] += 1.0
    r = 0.3 / np.sqrt(dh) * torch.randn((4, nh, dh, dh), generator=gen,
                                        device=dev)
    st = (torch.randn((b, d), generator=gen, device=dev),
          0.5 + 1.5 * torch.rand((b, d), generator=gen, device=dev),
          0.5 * torch.randn((b, d), generator=gen, device=dev),
          torch.randn((b, d), generator=gen, device=dev))
    return xg.reshape(b, s, 4 * d).to(x_dt), r.to(r_dt), st


def outputs(xg, st):
    b, s, d4 = xg.shape
    return (torch.empty((b, s, d4 // 4), device=xg.device),
            tuple(torch.empty_like(t) for t in st))


def call(lib, xg, r, st, forced=None):
    """One launch through `slstm_launch` (the plan) or, with forced =
    (q, rb), through `slstm_cluster_launch`; raises on a code."""
    hs, out = outputs(xg, st)
    stream = torch.cuda.current_stream().cuda_stream
    rc = (S._launch(lib, xg, r, st, hs, out, stream) if forced is None else
          S._launch_cluster(lib, *forced, xg, r, st, hs, out, stream))
    if rc != 0:
        raise RuntimeError(f"launch {forced or 'plan'} failed with {rc}")
    return hs, out


def max_err(got, want) -> float:
    return max(float((a - w).abs().max())
               for a, w in zip((got[0], *got[1]), (want[0], *want[1])))


def ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/slstm_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slstm sweep: no CUDA card available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    _, log = _build.build(S.CSRC)
    lib = S._lib()
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(k in ln for k in ("registers", "spill", "Compiling"))]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    text = S.CSRC.read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for header in S.CSRC.parent.glob("*.cuh"):     # beside the copies
        shutil.copy(header, _build.BUILD_DIR / header.name)
    sources = {}
    for name, (edits, _) in VARIANTS.items():
        variant = text
        for old, new in edits:
            if variant.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   f"source once")
            variant = variant.replace(old, new)
        sources[name] = _build.BUILD_DIR / f"slstm_{name}.cu"
        sources[name].write_text(variant)
    if args.parent is not None:
        sources["parent"] = _build.BUILD_DIR / "slstm_parent.cu"
        sources["parent"].write_text(args.parent.read_text())
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda src: ctypes.CDLL(str(_build.build(src)[0])),
            sources.values())))
    for name in VARIANTS:
        S._bind(built[name])
    ulib = built["unfused_mac"]

    gen = torch.Generator(device=dev).manual_seed(3)
    checked = []
    for case in CHECK_SHAPES:
        b, s, nh, dh = case
        for x_dt in (torch.float32, torch.bfloat16):
            for r_dt in (torch.float32, torch.bfloat16):
                xg, r, st = inputs(gen, *case, x_dt, r_dt)
                plan = S._plan(b, nh, dh)
                if S._lib_plan(lib, b, nh, dh) != plan:
                    raise RuntimeError(f"{case}: the library's plan differs")
                want = ref.slstm_fused(xg, r, st, nh)
                errs = [max_err(call(lib, xg, r, st), want),
                        max_err(call(ulib, xg, r, st), want)]
                if plan.instance == "cluster" and dh == 192:
                    errs += [max_err(call(lib, xg, r, st, c), want)
                             for c in CANDIDATES if S._fits(dh, *c)]
                if max(errs) > 1e-4:
                    raise RuntimeError(f"{case} {x_dt} {r_dt}: {errs}")
                checked.append([list(case), str(x_dt), str(r_dt),
                                plan.instance, max(errs)])
    print(f"checked vs plain (atol 1e-4): {len(checked)} cases", flush=True)

    b, s, nh, dh = SERVED
    xg, r, st = inputs(gen, b, s, nh, dh, torch.bfloat16, torch.bfloat16)
    plan = S._plan(b, nh, dh)
    want = ref.slstm_fused(xg, r, st, nh)
    res = {"card": card, "shape": list(SERVED), "plan": plan._asdict(),
           "checked": checked, "ptxas": ptxas, "candidates": []}
    res["plan_ms"] = ms(lambda: S.slstm_fused(xg, r, st, nh), ITERS)
    res["plan_err_vs_plain"] = max_err(S.slstm_fused(xg, r, st, nh), want)
    res["variants_ms"] = {}
    for name, (_, right) in VARIANTS.items():
        lib_v = built[name]
        res["variants_ms"][name] = ms(lambda: call(lib_v, xg, r, st),
                                      ITERS)
        print(f"  variant {name}: {res['variants_ms'][name]} ms", flush=True)
        if right:
            res[f"{name}_err_vs_plain"] = max_err(call(lib_v, xg, r, st),
                                                  want)
    for cand in CANDIDATES:
        if not S._fits(dh, *cand):
            continue
        hs, out = outputs(xg, st)
        n = ctypes.c_int(-1)
        rc = S._launch_cluster(lib, *cand, xg, r, st, hs, out, 0, n)
        row = {"q": cand[0], "rb": cand[1],
               "smem": S._layout(dh, *cand)[1],
               "threads": S._layout(dh, *cand)[0],
               "ctas": cand[0] * nh * -(-b // cand[1]),
               "max_active_clusters": n.value if rc == 0 else rc}
        row["ms"] = ms(lambda: call(lib, xg, r, st, cand), ITERS)
        row["us_per_step"] = row["ms"] * 1e3 / s
        row["err_vs_plain"] = max_err(call(lib, xg, r, st, cand), want)
        res["candidates"].append(row)
        print(f"  {row}", flush=True)
    if args.parent is not None:
        plib = built["parent"]        # exports slstm_launch alone
        plib.slstm_launch.restype = ctypes.c_int
        plib.slstm_launch.argtypes = S.LAUNCH_ARGTYPES
        res["parent_ms"] = ms(lambda: call(plib, xg, r, st), ITERS // 3,
                              warmup=1)
        res["plan_ms_after_parent"] = ms(
            lambda: S.slstm_fused(xg, r, st, nh), ITERS)
    line = json.dumps(res)
    print(line)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

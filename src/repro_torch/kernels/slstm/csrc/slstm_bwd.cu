// The sLSTM recurrence's backward for Hopper (sm_90a): the whole reverse
// sequence in one launch, r in f32 or bf16, everything else f32.
//
// Replaces no TPU kernel: the reference differentiates its `lax.scan`
// (src/repro/models/xlstm.py:257) and its Pallas kernel
// (src/repro/kernels/slstm/slstm.py:104) has no backward. This kernel is
// the backward of the port's forward kernels (csrc/slstm.cu), bound from
// Python with ctypes (src/repro_torch/kernels/slstm/slstm.py,
// `slstm_fused_bwd`), and held against the plain reverse-time loop
// `ref.slstm_fused_bwd`.
//
// What it computes. The wrapper recomputes, after the forward, the gate
// pre-activations pre (B, S, 4·d) f32 from hs by one batched product
// (gates [z, i, f, o] along the last axis, d = nh·dh) and hands the
// kernel R transposed, rT[g, hd, e, k] = r[g, hd, k, e]. Given hs (B, S, d),
// its cotangent dhs, the initial (c, n, m) and the cotangents of the final
// (c, n, h, m), the kernel
//   phase 0: runs the gates' elementwise recurrence forward from pre and
//            the initial state, storing c, n, m (B, S, d) each into the
//            scratch cnm (the same operations as the forward kernels);
//   then for t = S-1 .. 0, per column, with N = max(n_t, 1e-6):
//     g = dhs_t + dh_carry; d(oc) = g / N; do = d(oc)·c_t;
//     dc += d(oc)·o; dn -= g·(h_t / N) where n_t >= 1e-6 (the clamp's
//     gradient passes a tie);
//     dz = dc·i_s; di_s = dc·z + dn; df_s = dc·c_{t-1} + dn·n_{t-1};
//     dĩ = di_s·i_s; dfm = df_s·f_s; dm_t = dm_carry - dĩ - dfm, which
//     m_t = max(fm, ĩ) hands to the larger (halves on a tie);
//     dpre_t = [dc·i_s·(1 - z²), dĩ, dfm, do·(1 - o)·o];
//     dh_carry[k] = Σ_g Σ_e r[g, hd, k, e]·dpre_t[g, e];
//     dc_carry = dc·f_s, dn_carry = dn·f_s, dm_carry = dfm;
//   and writes dpre (B, S, 4·d) f32 and (dc0, dn0, dh0, dm0). The wrapper
//   then forms dxg (dpre in xg's type) and dr = Σ_{b,t} h_{t-1} ⊗ dpre_t
//   (one einsum: a plain large product outside the chain).
//
// What bounds it on the card. At the train shape (B = 4, S = 2048, d =
// 768, nh = 4, dh = 192) it must read pre, c, n, m, hs and dhs once and
// write dpre once: 328 MB, 0.098 ms at 3.35 TB/s; the transpose product
// is 2·B·S·4d·dh = 9.66e9 FP32 operations, 0.144 ms at 67 TFLOP/s. As in
// the forward, the S dependent steps are what a launch costs: each step's
// dh_carry needs the whole of step t's dpre.
//
// Two kernels; the shape alone chooses (`bwd_plan`, mirrored by slstm.py's
// `_plan_bwd`): the cluster kernel for dh <= 256 with the forward's Q and
// RB (Q = ceil(dh / 32), RB the fewest rows a CTA that keep all clusters
// on the card at once), the stream kernel for the rest. At the train shape
// the plan is Q = 6, RB = 1: 16 clusters of 6 CTAs of 512 threads on 96
// SMs, 2.13 ms a launch on an H100 (the stream kernel 35.3; PERF.md).
// slstm/sweep.py (--arms bwd) times the alternatives: every Q and RB that
// fit (Q = 12 next at 1.15 µs a step; Q = 7 and 8 at RB = 1, whose 16
// clusters do not all fit at once, 1.9–2.4), and ablations.
//
// slstm_bwd_kernel_cluster: the forward's cluster layout
// (`slstm_kernel_cluster`, csrc/slstm.cu) transposed. Grid (Q, nh,
// ceil(B/RB)), a cluster of Q CTAs per (head, group of RB batch rows). CTA
// q owns E_q = [q·dh/Q, (q+1)·dh/Q) of its head in both roles: as the
// columns e whose gate backward it runs and as the rows k of dh_carry[k] =
// Σ_g Σ_e r[g, hd, k, e]·dpre_t[g, e], so a column finds its carried dh in
// its own CTA. A warp owns two rows (= columns); lane g·8 + b holds r[g,
// hd, the warp's two rows, e-block b = [b·kp, (b+1)·kp)] in registers for
// the whole launch (KB = 24 or 32 a row: 48 values at dh = 192), each
// serving the RB rows. The RB·2 (row, column) pairs of a warp each take
// 16/RB lanes, which run the pair's chain alike. A step u (t = S-1-u):
//   1. the carry-free part of step t's gate backward (tanh, the sigmoid,
//      the exponentials, h/N, which side of the max is larger) arrives by
//      shuffles from the pair's lane that computed it (below), before the
//      wait;
//   2. (u > 0) the wait on the CTA's own mbarrier u & 1, then dh_carry from
//      dpre buffer u & 1: each lane sums its gate's e-block for its warp's
//      rows in ascending e (`__fmaf_rn`), and a butterfly of shuffles adds
//      the eight e-blocks (xor 4, 2, 1) and the four gates (xor 8, 16), so
//      every lane holds the same sums;
//   3. the rest of the gate backward (the stream kernel's operations);
//      dpre_t to dpre, and the column's four gates as one 16-byte
//      st.async into buffer (u + 1) & 1 of every CTA of the cluster,
//      counted on that CTA's mbarrier (u + 1) & 1; thread 0 arms its own
//      mbarrier for those 16·dh·rows bytes once a step.
//   A buffer holds RB rows of eight e-blocks, each kp columns' four gates
//   side by side, at a stride ≡ 4 (mod 32) floats, so a warp's 4-byte
//   reads in step 2 hit 32 banks. The protocol is the forward's with u for
//   t (csrc/slstm.cu: why one pair of buffers serves, which phase a store
//   completes): a warp reads a buffer, and every CTA that reads it stores
//   into each peer only after its reads (through the butterfly), so a peer
//   that has received step u - 1 from all columns may overwrite it. Step
//   S - 1 stores too: after the loop each CTA waits for step 0's dpre,
//   which gives dh0, and no store into it is then outstanding. A cluster
//   barrier after the prologue lets no CTA store into a peer that has not
//   set up its buffers and mbarriers.
//   Off the chain: the steps go in blocks of 16/RB; lane j of a pair loads
//   step T - j's saved values (pre ×4, hs, dhs; c, n, m at that step and
//   the one before) a block ahead and computes its carry-free part once
//   at the block's start, so each lane does one step's transcendentals and
//   divisions a block instead of every step's (on an H100 at the train
//   shape, 1.62 µs a step with each lane computing every step's, 1.04
//   with this; PERF.md). Phase 0 (c, n, m after every step, the forward's gate
//   recurrence from pre) runs first in the same launch on 4·RB warps, four
//   lanes a (row, column) pair sharing its loads (16 steps in flight) and
//   running its recurrence alike; it writes the scratch cnm (3, B, S, d),
//   which the loop reads back.
//
// slstm_bwd_kernel, the stream kernel: any other shape (dh up to 1024),
// the first design (the forward's `slstm_kernel_stream`): one block per
// (head, batch row), its carries in shared memory, rT read from device
// memory (L2) every step. Phase 0 runs column by column; then a step has
// three phases, each closed by a barrier:
//   1. thread e (stride blockDim) runs the gate backward of column e;
//      dpre_t goes to shared memory and to dpre;
//   2. thread j = g·dh + k (stride blockDim) sums a_g[k] = Σ_e rT[g, hd, e,
//      k]·dpre_t[g, e] as four partial chains over e ≡ q (mod 4), each in
//      ascending e (a remainder e >= 4·floor(dh/4) goes into the first),
//      then (c0 + c1) + (c2 + c3); consecutive threads read consecutive
//      k, so each rT row is read coalesced; dpre_t is a broadcast;
//   3. thread k (stride blockDim) adds the gates, (a_0 + a_1) + (a_2 +
//      a_3), into dh_carry[k].
// One dpre_t buffer serves: phase 1 of step t - 1 writes it only after
// every thread has passed phase 3's barrier of step t. At the train shape
// it took 34.9 ms, 17.0 µs a step, on B·nh = 16 SMs (PERF.md).
//
// Numerics: r converts exactly to f32; products and sums are IEEE-rounded
// in a fixed order (__fmul_rn / __fadd_rn / __fmaf_rn chains, --fmad=false
// so nothing else is contracted); expf and tanhf (never __expf), IEEE
// division (__fdiv_rn). Both kernels run the same gate operations and
// differ only in the order of dh_carry's sums. Each is deterministic: two
// runs agree bitwise. The plain version sums in einsum's order, so the
// kernels agree with it to a tolerance (chip_smoke.py [9x] states it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "cluster_sync.cuh"

#define BWD_MAX_THREADS 1024
#define BWD_MAX_DH 1024        // 12·dh floats of shared memory: 48 KB at most
#define BWD_MAX_ROWS 65535     // gridDim.y = B
#define BWD_EPS 1e-6f

__device__ __forceinline__ float bwd_f32(float v) { return v; }
__device__ __forceinline__ float bwd_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename RT>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
slstm_bwd_kernel(const float* __restrict__ pre, const RT* __restrict__ rT,
                 const float* __restrict__ hs, const float* __restrict__ dhs,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0,
                 const float* __restrict__ dc_in,
                 const float* __restrict__ dn_in,
                 const float* __restrict__ dh_in,
                 const float* __restrict__ dm_in, float* __restrict__ cnm,
                 float* __restrict__ dpre, float* __restrict__ dc0,
                 float* __restrict__ dn0, float* __restrict__ dh0,
                 float* __restrict__ dm0, int B, int S, int nh, int dh) {
  extern __shared__ float smem[];
  float* dp_s = smem;                // 4·dh: dpre_t of this head
  float* part_s = dp_s + 4 * dh;     // 4·dh: a_g[k]
  float* dhc_s = part_s + 4 * dh;    // dh: dh carried into step t
  float* dc_s = dhc_s + dh;          // dh
  float* dn_s = dc_s + dh;           // dh
  float* dm_s = dn_s + dh;           // dh
  const int hd = blockIdx.x;
  const int b = blockIdx.y;
  const int d = nh * dh;
  const int dh4 = 4 * dh;
  const long long bsd = static_cast<long long>(B) * S * d;
  const long long vbase = static_cast<long long>(b) * d
                          + static_cast<long long>(hd) * dh;
  // row b, head hd: step t's column e of a (B, S, d) tensor is
  // row_d[t·d + e]; gate g's column e of a (B, S, 4d) tensor is
  // row_4d[t·4d + g·d + e]
  const long long row_d = static_cast<long long>(b) * S * d
                          + static_cast<long long>(hd) * dh;
  const long long row_4d = static_cast<long long>(b) * S * 4 * d
                           + static_cast<long long>(hd) * dh;
  float* c_sv = cnm + row_d;
  float* n_sv = cnm + bsd + row_d;
  float* m_sv = cnm + 2 * bsd + row_d;
  const float* pre_b = pre + row_4d;
  float* dpre_b = dpre + row_4d;
  const float* hs_b = hs + row_d;
  const float* dhs_b = dhs + row_d;

  // phase 0: c, n, m after every step, column by column (no barrier: a
  // column's recurrence is its own)
  for (int e = threadIdx.x; e < dh; e += blockDim.x) {
    float c = c0[vbase + e], n = n0[vbase + e], m = m0[vbase + e];
    for (int t = 0; t < S; ++t) {
      const float* p = pre_b + static_cast<long long>(t) * 4 * d + e;
      const float z = tanhf(p[0]);
      const float i_pre = p[d];
      const float fm = __fadd_rn(p[2 * d], m);
      const float m_new = fmaxf(fm, i_pre);
      const float i_s = expf(__fsub_rn(i_pre, m_new));
      const float f_s = expf(__fsub_rn(fm, m_new));
      c = __fadd_rn(__fmul_rn(f_s, c), __fmul_rn(i_s, z));
      n = __fadd_rn(__fmul_rn(f_s, n), i_s);
      m = m_new;
      const long long at = static_cast<long long>(t) * d + e;
      c_sv[at] = c;
      n_sv[at] = n;
      m_sv[at] = m;
    }
    dc_s[e] = dc_in[vbase + e];
    dn_s[e] = dn_in[vbase + e];
    dm_s[e] = dm_in[vbase + e];
    dhc_s[e] = dh_in[vbase + e];
  }
  __syncthreads();

  const RT* r_h = rT + static_cast<long long>(hd) * dh * dh;
  const long long r_g = static_cast<long long>(nh) * dh * dh;  // gate stride
  for (int t = S - 1; t >= 0; --t) {
    // phase 1: the gate backward of step t, column by column
    for (int e = threadIdx.x; e < dh; e += blockDim.x) {
      const float* p = pre_b + static_cast<long long>(t) * 4 * d + e;
      const long long at = static_cast<long long>(t) * d + e;
      const float c_t = c_sv[at], n_t = n_sv[at], m_t = m_sv[at];
      float c_p, n_p, m_p;
      if (t > 0) {
        c_p = c_sv[at - d];
        n_p = n_sv[at - d];
        m_p = m_sv[at - d];
      } else {
        c_p = c0[vbase + e];
        n_p = n0[vbase + e];
        m_p = m0[vbase + e];
      }
      const float z = tanhf(p[0]);
      const float i_pre = p[d];
      const float o = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-p[3 * d])));
      const float fm = __fadd_rn(p[2 * d], m_p);
      const float i_s = expf(__fsub_rn(i_pre, m_t));
      const float f_s = expf(__fsub_rn(fm, m_t));
      const float big = fmaxf(n_t, BWD_EPS);
      const float g = __fadd_rn(dhs_b[at], dhc_s[e]);
      const float doc = __fdiv_rn(g, big);
      const float d_o = __fmul_rn(doc, c_t);
      const float dc = __fadd_rn(dc_s[e], __fmul_rn(doc, o));
      float dn = dn_s[e];
      if (n_t >= BWD_EPS)
        dn = __fsub_rn(dn, __fmul_rn(g, __fdiv_rn(hs_b[at], big)));
      const float dz = __fmul_rn(dc, i_s);
      const float di_s = __fadd_rn(__fmul_rn(dc, z), dn);
      const float df_s = __fadd_rn(__fmul_rn(dc, c_p), __fmul_rn(dn, n_p));
      float dpi = __fmul_rn(di_s, i_s);
      float dfm = __fmul_rn(df_s, f_s);
      const float dmt = __fsub_rn(__fsub_rn(dm_s[e], dpi), dfm);
      if (fm > i_pre) {
        dfm = __fadd_rn(dfm, dmt);
      } else if (i_pre > fm) {
        dpi = __fadd_rn(dpi, dmt);
      } else {
        const float half = __fdiv_rn(dmt, 2.0f);
        dfm = __fadd_rn(dfm, half);
        dpi = __fadd_rn(dpi, half);
      }
      const float dpz = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(z, z)));
      const float dpo = __fmul_rn(__fmul_rn(d_o, __fsub_rn(1.0f, o)), o);
      dp_s[e] = dpz;
      dp_s[dh + e] = dpi;
      dp_s[2 * dh + e] = dfm;
      dp_s[3 * dh + e] = dpo;
      float* q = dpre_b + static_cast<long long>(t) * 4 * d + e;
      q[0] = dpz;
      q[d] = dpi;
      q[2 * d] = dfm;
      q[3 * d] = dpo;
      dc_s[e] = __fmul_rn(dc, f_s);
      dn_s[e] = __fmul_rn(dn, f_s);
      dm_s[e] = dfm;
    }
    __syncthreads();
    // phase 2: a_g[k] = Σ_e rT[g, hd, e, k]·dpre_t[g, e]
    for (int j = threadIdx.x; j < dh4; j += blockDim.x) {
      const int g = j / dh;
      const int k = j - g * dh;
      const RT* rc = r_h + g * r_g + k;
      const float* dp = dp_s + g * dh;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int e = 0;
      for (; e + 4 <= dh; e += 4) {
        const RT* re = rc + static_cast<long long>(e) * dh;
        a0 = __fmaf_rn(dp[e], bwd_f32(re[0]), a0);
        a1 = __fmaf_rn(dp[e + 1], bwd_f32(re[dh]), a1);
        a2 = __fmaf_rn(dp[e + 2], bwd_f32(re[2 * dh]), a2);
        a3 = __fmaf_rn(dp[e + 3], bwd_f32(re[3 * dh]), a3);
      }
      for (; e < dh; ++e)
        a0 = __fmaf_rn(dp[e], bwd_f32(rc[static_cast<long long>(e) * dh]),
                       a0);
      part_s[j] = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
    }
    __syncthreads();
    // phase 3: dh carried into step t - 1
    for (int k = threadIdx.x; k < dh; k += blockDim.x)
      dhc_s[k] = __fadd_rn(__fadd_rn(part_s[k], part_s[dh + k]),
                           __fadd_rn(part_s[2 * dh + k],
                                     part_s[3 * dh + k]));
    __syncthreads();
  }
  for (int e = threadIdx.x; e < dh; e += blockDim.x) {
    dc0[vbase + e] = dc_s[e];
    dn0[vbase + e] = dn_s[e];
    dh0[vbase + e] = dhc_s[e];
    dm0[vbase + e] = dm_s[e];
  }
}

template <typename RT>
static int launch_stream(const float* pre, const void* rT, const float* hs,
                         const float* dhs, const float* c0, const float* n0,
                         const float* m0, const float* dc_in,
                         const float* dn_in, const float* dh_in,
                         const float* dm_in, float* cnm, float* dpre,
                         float* dc0, float* dn0, float* dh0, float* dm0, int B,
                         int S, int nh, int dh, cudaStream_t stream) {
  int threads = ((4 * dh + 31) / 32) * 32;
  if (threads > BWD_MAX_THREADS) threads = BWD_MAX_THREADS;
  const size_t smem = 12 * static_cast<size_t>(dh) * sizeof(float);
  slstm_bwd_kernel<RT><<<dim3(nh, B), threads, smem, stream>>>(
      pre, static_cast<const RT*>(rT), hs, dhs, c0, n0, m0, dc_in, dn_in,
      dh_in, dm_in, cnm, dpre, dc0, dn0, dh0, dm0, B, S, nh, dh);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// slstm_bwd_kernel_cluster
// ---------------------------------------------------------------------------

#define BC_MAX_THREADS 512     // 16 warps: 32 columns a CTA at most
#define BC_MAX_Q 16            // above 8 needs the non-portable cluster size
#define BC_GPCS 8              // H100 SXM: GPCs, and the fewest SMs of one
#define BC_GPC_SMS 14
#define BC_FULL 0xffffffffu

// The cluster kernel's geometry, computed on the host by `bwd_layout` (and
// by slstm.py's `_layout_bwd`).
struct BwdPlan {
  int q, rb;               // CTAs a cluster, batch rows a CTA
  int nw, kp, eb;          // warps a CTA, e a lane (its e-block), the
                           // e-block stride of a dpre buffer in floats
  int smem;                // dynamic shared memory (2 mbarriers, the dpre
                           // buffers), bytes
};

// Fills *p for a cluster of q CTAs and rb rows a CTA; false if the shape
// does not fit (more than BC_MAX_THREADS threads, or more than 32 e a
// lane).
static bool bwd_layout(int dh, int q, int rb, BwdPlan* p) {
  const int ne = (dh + q - 1) / q;
  p->q = q;
  p->rb = rb;
  p->nw = (ne + 1) / 2;
  p->kp = ((dh + 7) / 8 + 3) / 4 * 4;
  p->eb = 4 * p->kp + ((4 - (4 * p->kp) % 32) + 32) % 32;   // ≡ 4 (mod 32)
  p->smem = 16 + 4 * 2 * rb * 8 * p->eb;
  return 32 * p->nw <= BC_MAX_THREADS && p->kp <= 32;
}

// The shape's plan: the cluster kernel for dh <= 256, Q = ceil(dh / 32) and
// RB the fewest rows a CTA (1, 2, 4) that keep all clusters on the card at
// once (the forward's rule: a CTA takes an SM, a cluster sits within one
// of 8 GPCs of at least BC_GPC_SMS SMs). Returns 1 (cluster, *p filled) or
// 0 (stream).
static int bwd_plan(int B, int nh, int dh, BwdPlan* p) {
  if (nh > 65535) return 0;                      // gridDim.y
  const int q = (dh + 31) / 32;
  const int fit = BC_GPCS * (BC_GPC_SMS / q);
  int rb = 1;
  while (rb < 4 && static_cast<long long>(nh) * ((B + rb - 1) / rb) > fit)
    rb *= 2;
  return bwd_layout(dh, q, rb, p) ? 1 : 0;
}

// one lane's loads of a step s: the four pre-activations, h, its
// cotangent, and c, n, m after steps s and s - 1
struct StepIn {
  float pz, pi, pf, po, h, dh, c, n, m, cp, np, mp;
};
// the part of step s's gate backward that the carried dh does not change;
// flags: 1 n_s >= 1e-6, 2 f̃ + m_{s-1} > ĩ, 4 ĩ > f̃ + m_{s-1}
struct StepPrep {
  float z, o, i_s, f_s, big, h_big, zz, om, c, cp, np, dh;
  int flags;
};

// RB rows a CTA; KB registers of R a lane and row (kp <= KB).
template <typename RT, int RB, int KB>
__global__ void __launch_bounds__(BC_MAX_THREADS)
slstm_bwd_kernel_cluster(const float* __restrict__ pre,
                         const RT* __restrict__ rT,
                         const float* __restrict__ hs,
                         const float* __restrict__ dhs,
                         const float* __restrict__ c0,
                         const float* __restrict__ n0,
                         const float* __restrict__ m0,
                         const float* __restrict__ dc_in,
                         const float* __restrict__ dn_in,
                         const float* __restrict__ dh_in,
                         const float* __restrict__ dm_in,
                         float* __restrict__ cnm, float* __restrict__ dpre,
                         float* __restrict__ dc0, float* __restrict__ dn0,
                         float* __restrict__ dh0, float* __restrict__ dm0,
                         int B, int S, int nh, int dh, BwdPlan p) {
  extern __shared__ __align__(16) unsigned long long smem_raw[];
  unsigned long long* bars = smem_raw;             // one a buffer
  float* dp_s = reinterpret_cast<float*>(smem_raw + 2);  // 2 x RB x 8 x eb
  constexpr int PER = 16 / RB;                     // lanes a (row, column)
  const int rbuf = 8 * p.eb;                       // one row of a buffer
  const int hbuf = RB * rbuf;                      // one buffer
  const int q = blockIdx.x, hd = blockIdx.y, b0 = blockIdx.z * RB;
  const int e0 = q * dh / p.q;
  const int ne = (q + 1) * dh / p.q - e0;
  const int d = nh * dh;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 3, ebk = lane & 7;
  // this lane's (row, column) pair and its place among the pair's lanes
  const int pr = lane % (2 * RB), slot = lane / (2 * RB);
  const int rb_l = pr >> 1, c_l = 2 * w + (pr & 1);
  const int e = e0 + c_l, b = b0 + rb_l;
  const bool valid = c_l < ne && b < B;
  const bool has_cols = 2 * w < ne;
  const long long bsd = static_cast<long long>(B) * S * d;
  const long long col = static_cast<long long>(hd) * dh + e;
  const long long v_at = static_cast<long long>(b) * d + col;
  const long long row_d = static_cast<long long>(b) * S * d + col;
  const long long row_4d = static_cast<long long>(b) * S * 4 * d + col;
  const float* pre_p = pre + row_4d;               // + t·4d + g·d
  float* dpre_p = dpre + row_4d;
  const float* hs_p = hs + row_d;                  // + t·d
  const float* dhs_p = dhs + row_d;
  float* c_sv = cnm + row_d;
  float* n_sv = c_sv + bsd;
  float* m_sv = n_sv + bsd;

  for (int i = threadIdx.x; i < 2 * hbuf; i += blockDim.x) dp_s[i] = 0.0f;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }

  // phase 0: c, n, m after every step, the gates' recurrence forward, on
  // the first ceil(RB·ne / 8) warps (4 at the train shape, one a
  // scheduler; the others wait at the barrier below): pair p = 8·w + (lane
  // & 7) of the CTA's RB·ne (row p / ne, column p % ne) takes the four
  // lanes s = lane >> 3, which run its recurrence alike. The steps go in
  // blocks of 16: lane s loads steps s + 4k (k < 4) of a block, the next
  // block's while this one runs, so 16 steps of pre are in flight a pair;
  // a shuffle hands each step to the pair's lanes; lane s = 0 stores it.
  if (w < (RB * ne + 7) / 8) {
    const int pp = 8 * w + (lane & 7), s4 = lane >> 3;
    const int r0 = pp / ne, cl = pp - r0 * ne;
    const bool ok = pp < RB * ne && b0 + r0 < B;
    const long long col0 = static_cast<long long>(hd) * dh + e0 + cl;
    const long long at0 = static_cast<long long>(b0 + r0) * d + col0;
    const float* xs = pre + static_cast<long long>(b0 + r0) * S * 4 * d + col0;
    float* cs = cnm + static_cast<long long>(b0 + r0) * S * d + col0;
    float c = 0.0f, n = 0.0f, m = 0.0f;
    if (ok) {
      c = c0[at0];
      n = n0[at0];
      m = m0[at0];
    }
    float xa[3][4], xb[3][4];          // z, i, f of this lane's steps
    auto load = [&](float (&x)[3][4], int t0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + 4 * k + s4;
        const bool in = ok && t < S;
        const float* q = xs + static_cast<long long>(t) * 4 * d;
        x[0][k] = in ? q[0] : 0.0f;
        x[1][k] = in ? q[d] : 0.0f;
        x[2][k] = in ? q[2 * d] : 0.0f;
      }
    };
    load(xa, 0);
    load(xb, 16);
    for (int t0 = 0; t0 < S; t0 += 16) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (t0 + j < S) {                          // the same for the warp
          const int src = (j & 3) * 8 + (lane & 7);
          const float pz = __shfl_sync(BC_FULL, xa[0][j >> 2], src);
          const float i_pre = __shfl_sync(BC_FULL, xa[1][j >> 2], src);
          const float f_pre = __shfl_sync(BC_FULL, xa[2][j >> 2], src);
          const float z = tanhf(pz);
          const float fm = __fadd_rn(f_pre, m);
          const float m_new = fmaxf(fm, i_pre);
          const float i_s = expf(__fsub_rn(i_pre, m_new));
          const float f_s = expf(__fsub_rn(fm, m_new));
          c = __fadd_rn(__fmul_rn(f_s, c), __fmul_rn(i_s, z));
          n = __fadd_rn(__fmul_rn(f_s, n), i_s);
          m = m_new;
          if (ok && s4 == 0) {
            const long long at = static_cast<long long>(t0 + j) * d;
            cs[at] = c;
            cs[bsd + at] = n;
            cs[2 * bsd + at] = m;
          }
        }
      }
#pragma unroll
      for (int g3 = 0; g3 < 3; ++g3)
#pragma unroll
        for (int k = 0; k < 4; ++k) xa[g3][k] = xb[g3][k];
      load(xb, t0 + 32);
    }
  }

  // this lane's R: rr[i][c] = r[g, hd, k = e0 + 2w + c, e = ebk·kp + i], in
  // registers for the whole launch (zero where e >= dh or the row is not
  // this CTA's); rT[g, hd, e, k] = r[g, hd, k, e]
  float rr[KB][2];
  {
    const RT* r_g = rT + (static_cast<long long>(g) * nh + hd) * dh * dh;
#pragma unroll
    for (int i = 0; i < KB; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ee = ebk * p.kp + i, k = 2 * w + c;
        rr[i][c] = i < p.kp && ee < dh && k < ne
                       ? bwd_f32(r_g[static_cast<long long>(ee) * dh + e0 + k])
                       : 0.0f;
      }
  }

  // dh_carry for this lane's pair from a dpre buffer: the lane's e-block
  // of its gate for each row in ascending e (`__fmaf_rn`, a fixed chain),
  // then a butterfly of shuffles over the eight e-blocks (xor 4, 2, 1)
  // and the four gates (xor 8, 16), after which every lane holds the
  // sums of all the warp's pairs, bitwise alike
  auto carry = [&](const float* buf) -> float {
    float acc[RB][2];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = 0.0f;
    const float* base = buf + ebk * p.eb + g;
    auto mac = [&](int i) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float v = base[r * rbuf + 4 * i];
        acc[r][0] = __fmaf_rn(v, rr[i][0], acc[r][0]);
        acc[r][1] = __fmaf_rn(v, rr[i][1], acc[r][1]);
      }
    };
    if (has_cols && p.kp == KB) {  // no test between the reads: all in flight
#pragma unroll
      for (int i = 0; i < KB; ++i) mac(i);
    } else if (has_cols) {
#pragma unroll
      for (int i = 0; i < KB; ++i)
        if (i < p.kp) mac(i);
    }
#pragma unroll
    for (int m = 4; m > 0; m >>= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[r][c] = __fadd_rn(acc[r][c],
                                __shfl_xor_sync(BC_FULL, acc[r][c], m));
#pragma unroll
    for (int m = 8; m < 32; m <<= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[r][c] = __fadd_rn(acc[r][c],
                                __shfl_xor_sync(BC_FULL, acc[r][c], m));
    float mine = acc[0][0];
#pragma unroll
    for (int j = 1; j < 2 * RB; ++j)
      if (pr == j) mine = acc[j >> 1][j & 1];
    return mine;
  };

  // What step s's gate backward needs that the carried dh does not change
  // (the stream kernel's operations), computed by one lane of the pair.
  // The steps go in blocks of PER from the top; lane `slot` loads step T -
  // slot of the block whose top step is T (a block ahead), computes its
  // part at the block's start, and hands it to the pair's lanes at that
  // step by shuffles. Step -1's c, n, m are the initial state.
  auto load_step = [&](int s) -> StepIn {
    StepIn v = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid && s >= 0) {
      const float* x = pre_p + static_cast<long long>(s) * 4 * d;
      const long long at = static_cast<long long>(s) * d;
      v.pz = x[0];
      v.pi = x[d];
      v.pf = x[2 * d];
      v.po = x[3 * d];
      v.h = hs_p[at];
      v.dh = dhs_p[at];
      v.c = c_sv[at];
      v.n = n_sv[at];
      v.m = m_sv[at];
      if (s > 0) {
        v.cp = c_sv[at - d];
        v.np = n_sv[at - d];
        v.mp = m_sv[at - d];
      } else {
        v.cp = c0[v_at];
        v.np = n0[v_at];
        v.mp = m0[v_at];
      }
    }
    return v;
  };
  auto prep = [&](const StepIn& v) -> StepPrep {
    StepPrep out;
    out.z = tanhf(v.pz);
    out.o = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v.po)));
    const float fm = __fadd_rn(v.pf, v.mp);
    out.i_s = expf(__fsub_rn(v.pi, v.m));
    out.f_s = expf(__fsub_rn(fm, v.m));
    out.big = fmaxf(v.n, BWD_EPS);
    out.h_big = __fdiv_rn(v.h, out.big);
    out.zz = __fsub_rn(1.0f, __fmul_rn(out.z, out.z));
    out.om = __fsub_rn(1.0f, out.o);
    out.c = v.c;
    out.cp = v.cp;
    out.np = v.np;
    out.dh = v.dh;
    out.flags = (v.n >= BWD_EPS ? 1 : 0) | (fm > v.pi ? 2 : 0) |
                (v.pi > fm ? 4 : 0);
    return out;
  };

  __syncthreads();               // phase 0's c, n, m before they are read
  float dc = 0.0f, dn = 0.0f, dm = 0.0f, dhc = 0.0f;
  if (valid) {
    dc = dc_in[v_at];
    dn = dn_in[v_at];
    dm = dm_in[v_at];
    dhc = dh_in[v_at];
  }
  // where column e's four gates sit in a dpre buffer (16 bytes), and the
  // first buffer and mbarrier as shared addresses
  const unsigned dst0 = smem_addr(dp_s + rb_l * rbuf + (e / p.kp) * p.eb +
                                  4 * (e % p.kp));
  const unsigned bar0 = smem_addr(&bars[0]);
  const int rows = B - b0 < RB ? B - b0 : RB;
  const unsigned step_bytes = 16u * dh * rows;     // dpre a step, all peers
  // this lane's gate of dpre (slot < 4), step S - 1
  float* dq = dpre_p + static_cast<long long>(S - 1) * 4 * d + (slot & 3) * d;
  StepIn in_next = load_step(S - 1 - slot);
  cluster_arrive();        // every peer has started and set up its buffers
  cluster_wait();

  for (int u0 = 0; u0 < S; u0 += PER) {
    const StepPrep mine = prep(in_next);
    in_next = load_step(S - 1 - u0 - PER - slot);
#pragma unroll 1
    for (int j = 0; j < PER && u0 + j < S; ++j) {
      const int u = u0 + j;
      // step t = S - 1 - u's carry-free part, from the lane that made it
      const int src = j * 2 * RB + pr;
      const float z = __shfl_sync(BC_FULL, mine.z, src);
      const float o = __shfl_sync(BC_FULL, mine.o, src);
      const float i_s = __shfl_sync(BC_FULL, mine.i_s, src);
      const float f_s = __shfl_sync(BC_FULL, mine.f_s, src);
      const float big = __shfl_sync(BC_FULL, mine.big, src);
      const float h_big = __shfl_sync(BC_FULL, mine.h_big, src);
      const float zz = __shfl_sync(BC_FULL, mine.zz, src);
      const float om = __shfl_sync(BC_FULL, mine.om, src);
      const float c_t = __shfl_sync(BC_FULL, mine.c, src);
      const float c_p = __shfl_sync(BC_FULL, mine.cp, src);
      const float n_p = __shfl_sync(BC_FULL, mine.np, src);
      const float dh_t = __shfl_sync(BC_FULL, mine.dh, src);
      const int flags = __shfl_sync(BC_FULL, mine.flags, src);
      if (u > 0) {
        mbar_wait(&bars[u & 1], ((u - 1) >> 1) & 1);
        dhc = carry(dp_s + (u & 1) * hbuf);
      }
      if (threadIdx.x == 0) mbar_expect_tx(&bars[(u + 1) & 1], step_bytes);
      // the gate backward of step t
      const float gv = __fadd_rn(dh_t, dhc);
      const float doc = __fdiv_rn(gv, big);
      const float d_o = __fmul_rn(doc, c_t);
      const float dcv = __fadd_rn(dc, __fmul_rn(doc, o));
      float dnv = dn;
      if (flags & 1) dnv = __fsub_rn(dnv, __fmul_rn(gv, h_big));
      const float dz = __fmul_rn(dcv, i_s);
      const float di_s = __fadd_rn(__fmul_rn(dcv, z), dnv);
      const float df_s = __fadd_rn(__fmul_rn(dcv, c_p), __fmul_rn(dnv, n_p));
      float dpi = __fmul_rn(di_s, i_s);
      float dfm = __fmul_rn(df_s, f_s);
      const float dmt = __fsub_rn(__fsub_rn(dm, dpi), dfm);
      if (flags & 2) {                             // f̃ + m_{t-1} > ĩ
        dfm = __fadd_rn(dfm, dmt);
      } else if (flags & 4) {                      // ĩ > f̃ + m_{t-1}
        dpi = __fadd_rn(dpi, dmt);
      } else {
        const float half = __fdiv_rn(dmt, 2.0f);
        dfm = __fadd_rn(dfm, half);
        dpi = __fadd_rn(dpi, half);
      }
      const float4 dp = make_float4(__fmul_rn(dz, zz), dpi, dfm,
                                    __fmul_rn(__fmul_rn(d_o, om), o));
      if (valid) {
        const unsigned dst = dst0 + ((u + 1) & 1) * 4u * hbuf;
        const unsigned bar = bar0 + ((u + 1) & 1) * 8u;
        if (slot < p.q)
          st_async_v4(map_rank(dst, slot), dp, map_rank(bar, slot));
        if (PER < BC_MAX_Q)                        // RB > 1: more peers
          for (int peer = slot + PER; peer < p.q; peer += PER)
            st_async_v4(map_rank(dst, peer), dp, map_rank(bar, peer));
        if (slot < 4)
          *dq = slot == 0 ? dp.x : slot == 1 ? dp.y : slot == 2 ? dp.z : dp.w;
      }
      dq -= 4 * d;
      dc = __fmul_rn(dcv, f_s);
      dn = __fmul_rn(dnv, f_s);
      dm = dfm;
    }
  }
  // dh0 from step 0's dpre; every store into this CTA has landed
  mbar_wait(&bars[S & 1], ((S - 1) >> 1) & 1);
  dhc = carry(dp_s + (S & 1) * hbuf);
  if (valid && slot == 0) {
    dc0[v_at] = dc;
    dn0[v_at] = dn;
    dh0[v_at] = dhc;
    dm0[v_at] = dm;
  }
}

// the cluster kernel's arguments, as slstm_bwd_launch takes them
struct BwdArgs {
  const float *pre;
  const void* rT;
  const float *hs, *dhs, *c0, *n0, *m0, *dc_in, *dn_in, *dh_in, *dm_in;
  float *cnm, *dpre, *dc0, *dn0, *dh0, *dm0;
  int B, S, nh, dh;
};

template <typename RT, int RB, int KB>
static int launch_cluster_k(const BwdArgs& a, const BwdPlan& p,
                            cudaStream_t stream, int* max_clusters) {
  void (*kern)(const float*, const RT*, const float*, const float*,
               const float*, const float*, const float*, const float*,
               const float*, const float*, const float*, float*, float*,
               float*, float*, float*, float*, int, int, int, int, BwdPlan) =
      slstm_bwd_kernel_cluster<RT, RB, KB>;
  static bool attributes_set = false;     // once per instance
  if (!attributes_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    attributes_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.q, a.nh, (a.B + RB - 1) / RB);
  cfg.blockDim = dim3(32 * p.nw);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&n_clusters, kern, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_clusters) {                 // a query: report, launch nothing
    *max_clusters = n_clusters;
    return 0;
  }
  if (n_clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kern, a.pre, static_cast<const RT*>(a.rT),
                           a.hs, a.dhs, a.c0, a.n0, a.m0, a.dc_in, a.dn_in,
                           a.dh_in, a.dm_in, a.cnm, a.dpre, a.dc0, a.dn0,
                           a.dh0, a.dm0, a.B, a.S, a.nh, a.dh, p);
  return static_cast<int>(err);
}

template <typename RT, int KB>
static int launch_cluster_kb(const BwdArgs& a, const BwdPlan& p,
                             cudaStream_t s, int* max_clusters) {
  switch (p.rb) {
    case 1: return launch_cluster_k<RT, 1, KB>(a, p, s, max_clusters);
    case 2: return launch_cluster_k<RT, 2, KB>(a, p, s, max_clusters);
    case 4: return launch_cluster_k<RT, 4, KB>(a, p, s, max_clusters);
  }
  return -1;
}

// The cluster kernel with plan p; R's registers a lane and row are 24
// (kp <= 24, dh <= 192) or 32. With max_clusters set it launches nothing
// and writes how many clusters of this plan the card can hold at once.
static int launch_cluster(int r_bf16, const BwdArgs& a, const BwdPlan& p,
                          cudaStream_t s, int* max_clusters) {
  typedef __nv_bfloat16 bf;
  int rc;
  if (p.kp <= 24)
    rc = r_bf16 ? launch_cluster_kb<bf, 24>(a, p, s, max_clusters)
                : launch_cluster_kb<float, 24>(a, p, s, max_clusters);
  else
    rc = r_bf16 ? launch_cluster_kb<bf, 32>(a, p, s, max_clusters)
                : launch_cluster_kb<float, 32>(a, p, s, max_clusters);
  const int last = static_cast<int>(cudaGetLastError());
  return rc ? rc : last;
}

static int launch_stream_t(int r_bf16, const BwdArgs& a, cudaStream_t s) {
  if (r_bf16)
    return launch_stream<__nv_bfloat16>(a.pre, a.rT, a.hs, a.dhs, a.c0, a.n0,
                                        a.m0, a.dc_in, a.dn_in, a.dh_in,
                                        a.dm_in, a.cnm, a.dpre, a.dc0, a.dn0,
                                        a.dh0, a.dm0, a.B, a.S, a.nh, a.dh,
                                        s);
  return launch_stream<float>(a.pre, a.rT, a.hs, a.dhs, a.c0, a.n0, a.m0,
                              a.dc_in, a.dn_in, a.dh_in, a.dm_in, a.cnm,
                              a.dpre, a.dc0, a.dn0, a.dh0, a.dm0, a.B, a.S,
                              a.nh, a.dh, s);
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

#define BWD_ARGS                                                             \
  const float *pre, const void *rT, const float *hs, const float *dhs,       \
      const float *c0, const float *n0, const float *m0, const float *dc_in, \
      const float *dn_in, const float *dh_in, const float *dm_in,            \
      float *cnm, float *dpre, float *dc0, float *dn0, float *dh0,           \
      float *dm0, int B, int S, int nh, int dh, void *stream

static bool bwd_args_ok(const BwdArgs& a) {
  return a.B >= 1 && a.B <= BWD_MAX_ROWS && a.S >= 1 && a.nh >= 1 &&
         a.nh <= 65535 && a.dh >= 1 && a.dh <= BWD_MAX_DH && a.pre && a.rT &&
         a.hs && a.dhs && a.c0 && a.n0 && a.m0 && a.dc_in && a.dn_in &&
         a.dh_in && a.dm_in && a.cnm && a.dpre && a.dc0 && a.dn0 && a.dh0 &&
         a.dm0;
}

// r_bf16: 1 for a bf16 rT, 0 for f32. Every pointer is a contiguous
// tensor: pre (B, S, 4·d), hs and dhs (B, S, d), the states and their
// cotangents (B, d), cnm (3, B, S, d) scratch, dpre (B, S, 4·d), all f32;
// rT (4, nh, dh, dh). Runs the shape's plan (`bwd_plan`). Returns 0, a
// cudaError_t code, or -1 (bad arguments).
extern "C" int slstm_bwd_launch(int r_bf16, BWD_ARGS) {
  const BwdArgs a = {pre, rT, hs, dhs, c0, n0, m0, dc_in, dn_in, dh_in,
                     dm_in, cnm, dpre, dc0, dn0, dh0, dm0, B, S, nh, dh};
  if (!bwd_args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdPlan p;
  if (bwd_plan(B, nh, dh, &p)) return launch_cluster(r_bf16, a, p, s, nullptr);
  return launch_stream_t(r_bf16, a, s);
}

// The stream kernel whatever the shape's plan (the card tests, chip_smoke.py
// and the sweep hold the two designs against each other with it).
extern "C" int slstm_bwd_stream_launch(int r_bf16, BWD_ARGS) {
  const BwdArgs a = {pre, rT, hs, dhs, c0, n0, m0, dc_in, dn_in, dh_in,
                     dm_in, cnm, dpre, dc0, dn0, dh0, dm0, B, S, nh, dh};
  if (!bwd_args_ok(a)) return -1;
  return launch_stream_t(r_bf16, a, static_cast<cudaStream_t>(stream));
}

// The cluster kernel with an explicit Q and RB, whatever the shape's own
// plan. With max_clusters non-null it launches nothing and writes
// cudaOccupancyMaxActiveClusters's count for that plan. Returns what
// slstm_bwd_launch returns; -1 also for a plan that does not fit or is not
// one (q in 1..16, rb in {1, 2, 4}).
extern "C" int slstm_bwd_cluster_launch(int q, int rb, int* max_clusters,
                                        int r_bf16, BWD_ARGS) {
  const BwdArgs a = {pre, rT, hs, dhs, c0, n0, m0, dc_in, dn_in, dh_in,
                     dm_in, cnm, dpre, dc0, dn0, dh0, dm0, B, S, nh, dh};
  BwdPlan p;
  if (!bwd_args_ok(a) || q < 1 || q > BC_MAX_Q ||
      (rb != 1 && rb != 2 && rb != 4) || !bwd_layout(dh, q, rb, &p))
    return -1;
  return launch_cluster(r_bf16, a, p, static_cast<cudaStream_t>(stream),
                        max_clusters);
}

// The plan slstm_bwd_launch takes for this shape: returns 1 (cluster) or 0
// (stream) and writes out[0..2] = Q, RB and the dynamic shared memory
// bytes (0, 0 and the stream kernel's 12·dh floats for stream).
extern "C" int slstm_bwd_plan(int B, int nh, int dh, int* out) {
  BwdPlan p;
  const int cluster = bwd_plan(B, nh, dh, &p);
  out[0] = cluster ? p.q : 0;
  out[1] = cluster ? p.rb : 0;
  out[2] = cluster ? p.smem : 12 * dh * static_cast<int>(sizeof(float));
  return cluster;
}

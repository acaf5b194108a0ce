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
// Design (the forward's stream layout, `slstm_kernel_stream`): one block
// per (head, batch row), its carries in shared memory, rT read from device
// memory (L2) every step. A step has three phases, each closed by a
// barrier:
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
// every thread has passed phase 3's barrier of step t.
//
// Numerics: r converts exactly to f32; products and sums are IEEE-rounded
// in a fixed order (__fmul_rn / __fadd_rn / __fmaf_rn chains, --fmad=false
// so nothing else is contracted); expf and tanhf (never __expf), IEEE
// division (__fdiv_rn). The result is deterministic: two runs agree
// bitwise. The plain version sums in einsum's order, so the two agree to a
// tolerance (chip_smoke.py [9x] states it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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
static void launch_bwd(const float* pre, const void* rT, const float* hs,
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
}

// r_bf16: 1 for a bf16 rT, 0 for f32. Every pointer is a contiguous
// tensor: pre (B, S, 4·d), hs and dhs (B, S, d), the states and their
// cotangents (B, d), cnm (3, B, S, d) scratch, dpre (B, S, 4·d), all f32;
// rT (4, nh, dh, dh). Returns 0, a cudaError_t code, or -1 (bad
// arguments).
extern "C" int slstm_bwd_launch(int r_bf16, const float* pre, const void* rT,
                                const float* hs, const float* dhs,
                                const float* c0, const float* n0,
                                const float* m0, const float* dc_in,
                                const float* dn_in, const float* dh_in,
                                const float* dm_in, float* cnm, float* dpre,
                                float* dc0, float* dn0, float* dh0,
                                float* dm0, int B, int S, int nh, int dh,
                                void* stream) {
  if (B < 1 || B > BWD_MAX_ROWS || S < 1 || nh < 1 || nh > 65535 ||
      dh < 1 || dh > BWD_MAX_DH || !pre || !rT || !hs || !dhs || !c0 ||
      !n0 || !m0 || !dc_in || !dn_in || !dh_in || !dm_in || !cnm || !dpre ||
      !dc0 || !dn0 || !dh0 || !dm0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_bf16)
    launch_bwd<__nv_bfloat16>(pre, rT, hs, dhs, c0, n0, m0, dc_in, dn_in,
                              dh_in, dm_in, cnm, dpre, dc0, dn0, dh0, dm0, B,
                              S, nh, dh, s);
  else
    launch_bwd<float>(pre, rT, hs, dhs, c0, n0, m0, dc_in, dn_in, dh_in,
                      dm_in, cnm, dpre, dc0, dn0, dh0, dm0, B, S, nh, dh, s);
  return static_cast<int>(cudaGetLastError());
}

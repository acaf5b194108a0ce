// Fused sLSTM recurrence for Hopper (sm_90a): the whole sequence in one
// launch, xg and r in f32 or bf16, state and outputs in f32.
//
// Replaces the TPU kernel src/repro/kernels/slstm/slstm.py::slstm_fused
// (_slstm_kernel, pallas_call at :104). Bound from Python with ctypes
// (src/repro_torch/kernels/slstm/slstm.py).
//
// What it computes. xg (B, S, 4·d) holds the input pre-activations with
// the gates [z, i, f, o] along the last axis (d = nh·dh); r (4, nh, dh, dh)
// the block-diagonal recurrent weights (gate g, head hd maps h[hd·dh + k] to
// column g·d + hd·dh + e through r[g, hd, k, e]); the state (c, n, h, m)
// each (B, d) f32. For t = 0 .. S-1 and every column:
//   pre = x_t + h·R_blockdiag
//   z = tanh(pre_z),  o = 1 / (1 + exp(-pre_o))
//   m' = max(pre_f + m, pre_i),  i_s = exp(pre_i - m'),
//   f_s = exp(pre_f + m - m')
//   c' = f_s·c + i_s·z,  n' = f_s·n + i_s,  h = o·c' / max(n', 1e-6)
// and hs[b, t] = h. It returns hs (B, S, d) f32 and the final (c, n, h, m).
//
// Grid: one block per (head, batch row); heads are independent because R
// is block-diagonal. The block loops over t. Its state (c, n, m and h of
// its dh columns) lives in shared memory for the whole sequence; R is read
// from device memory each step (one head's R is 4·dh·dh values: 295 KB in
// bf16 at dh = 192, more than the 227 KB a block can hold, so it stays in
// the 50 MB L2 after the first step). A step has two phases, each closed
// by a barrier:
//   1. thread j (stride blockDim) computes pre[j], j = g·dh + e: the dot
//      h·r[g, hd, :, e] as four partial sums s_q over k ≡ q (mod 4), each
//      in ascending k from 0 (a remainder k ≥ 4·floor(dh/4) goes into
//      s_0), then x + ((s_0 + s_1) + (s_2 + s_3)). Consecutive threads read
//      consecutive e, so each r row is read coalesced; h is a
//      shared-memory broadcast.
//   2. thread e (stride blockDim) applies the gates to column e and writes
//      h, c, n, m back to shared memory and h to hs.
// Phase 1 of step t+1 reads the h that phase 2 of step t wrote, and phase
// 2 overwrites h only after every thread has passed phase 1's barrier, so
// one h buffer serves (the two barriers do what a double buffer would).
//
// What bounds it on the card. Per launch it moves xg (B·S·4d), hs
// (B·S·d f32), R and the states: 76.8 MB at the serving shape (B = 4,
// S = 2048, d = 768, nh = 4, dh = 192, bf16), 22.9 µs at 3.35 TB/s; and
// does 2·B·S·4d·dh = 9.66e9 FP32 operations, 0.144 ms at 67 TFLOP/s. So
// operations bound it, and more: the recurrence makes S dependent steps,
// which no design avoids. This first kernel keeps B·nh = 16 SMs busy, each
// reading its head's R (295 KB) from L2 every step as 147 K two-byte
// loads, far above both bounds: 16.4 ms at the serving shape, 8.0 µs a
// step (PERF.md). Unrolling the k loop 4× did not change that time, so
// what sets a step's pace (L2 latency, or the load instructions) is not
// measured yet.
//
// What a later design does about it: R partly resident in shared memory
// (three of the four gates' slices of one head fit in 227 KB in bf16); or
// a cluster of 4 CTAs per (batch row, head), each holding one gate's
// dh × dh slice (74 KB bf16 at dh = 192) in shared memory or registers and
// exchanging h through distributed shared memory, with one cluster barrier
// a step; batch rows sharing a head could share each R load.
//
// Numerics: xg and r convert exactly to f32 (as the reference casts them);
// products and sums are __fmul_rn / __fadd_rn in a fixed order (never
// contracted, and --fmad=false); expf and tanhf (never __expf), IEEE
// division (__fdiv_rn) for the sigmoid and for h. The plain version
// (ref.py) sums each dot in einsum's order, so the two agree to rounding,
// not bitwise: within atol 1e-4 (the reference's bound on its own kernel)
// where f32 resolves 1e-4 over the sequence. Over thousands of steps it
// may not: under the model's forget offset m grows by ~1 a step (one f32
// ulp at 2048 is 2.4e-4) and c, n carry their rounding along, so there
// chip_smoke.py holds the two to a few times the plain version's own
// distance from a float64 run. The kernel is deterministic and carries its
// state in f32, so a pass over [0, s1) then one over [s1, S) from the
// returned state equals one pass bitwise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define MAX_THREADS 1024
#define MAX_DH 1024            // 8·dh floats of shared memory: 32 KB at most
#define MAX_ROWS 65535         // gridDim.y = B

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT, typename RT>
__global__ void __launch_bounds__(MAX_THREADS)
slstm_kernel(const XT* __restrict__ xg, long long xg_sb, long long xg_ss,
             const RT* __restrict__ r,
             const float* __restrict__ c0, const float* __restrict__ n0,
             const float* __restrict__ h0, const float* __restrict__ m0,
             float* __restrict__ hs, float* __restrict__ c_out,
             float* __restrict__ n_out, float* __restrict__ h_out,
             float* __restrict__ m_out, int S, int nh, int dh) {
  extern __shared__ float smem[];
  float* h_s = smem;                 // dh
  float* pre_s = h_s + dh;           // 4·dh
  float* c_s = pre_s + 4 * dh;       // dh
  float* n_s = c_s + dh;             // dh
  float* m_s = n_s + dh;             // dh
  const int hd = blockIdx.x;
  const int b = blockIdx.y;
  const int d = nh * dh;
  const int dh4 = 4 * dh;
  const long long vbase = static_cast<long long>(b) * d
                          + static_cast<long long>(hd) * dh;
  for (int e = threadIdx.x; e < dh; e += blockDim.x) {
    c_s[e] = c0[vbase + e];
    n_s[e] = n0[vbase + e];
    h_s[e] = h0[vbase + e];
    m_s[e] = m0[vbase + e];
  }
  __syncthreads();

  const XT* x_b = xg + static_cast<long long>(b) * xg_sb
                  + static_cast<long long>(hd) * dh;
  float* hs_b = hs + static_cast<long long>(b) * S * d
                + static_cast<long long>(hd) * dh;
  for (int t = 0; t < S; ++t) {
    const XT* x_t = x_b + static_cast<long long>(t) * xg_ss;
    // phase 1: pre = x_t + h·R for this head's 4·dh columns
    for (int j = threadIdx.x; j < dh4; j += blockDim.x) {
      const int g = j / dh;
      const int e = j - g * dh;
      const float xv = to_f32(x_t[static_cast<long long>(g) * d + e]);
      const RT* rc = r + (static_cast<long long>(g) * nh + hd)
                         * static_cast<long long>(dh) * dh + e;
      // four partial sums (k mod 4), each in ascending k: four
      // independent chains in flight, and a shorter rounding path
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int k = 0;
      for (; k + 4 <= dh; k += 4) {
        const RT* rk = rc + static_cast<long long>(k) * dh;
        a0 = __fadd_rn(a0, __fmul_rn(h_s[k], to_f32(rk[0])));
        a1 = __fadd_rn(a1, __fmul_rn(h_s[k + 1], to_f32(rk[dh])));
        a2 = __fadd_rn(a2, __fmul_rn(h_s[k + 2], to_f32(rk[2 * dh])));
        a3 = __fadd_rn(a3, __fmul_rn(h_s[k + 3], to_f32(rk[3 * dh])));
      }
      for (; k < dh; ++k)
        a0 = __fadd_rn(a0, __fmul_rn(h_s[k],
                                     to_f32(rc[static_cast<long long>(k)
                                               * dh])));
      pre_s[j] = __fadd_rn(xv, __fadd_rn(__fadd_rn(a0, a1),
                                         __fadd_rn(a2, a3)));
    }
    __syncthreads();
    // phase 2: the gates, column by column
    for (int e = threadIdx.x; e < dh; e += blockDim.x) {
      const float z = tanhf(pre_s[e]);
      const float i_pre = pre_s[dh + e];
      const float f_pre = pre_s[2 * dh + e];
      const float o = __fdiv_rn(1.0f, __fadd_rn(1.0f,
                                                expf(-pre_s[3 * dh + e])));
      const float fm = __fadd_rn(f_pre, m_s[e]);
      const float m_new = fmaxf(fm, i_pre);
      const float i_s = expf(__fsub_rn(i_pre, m_new));
      const float f_s = expf(__fsub_rn(fm, m_new));
      const float c_new = __fadd_rn(__fmul_rn(f_s, c_s[e]),
                                    __fmul_rn(i_s, z));
      const float n_new = __fadd_rn(__fmul_rn(f_s, n_s[e]), i_s);
      const float h_new = __fdiv_rn(__fmul_rn(o, c_new),
                                    fmaxf(n_new, 1e-6f));
      c_s[e] = c_new;
      n_s[e] = n_new;
      m_s[e] = m_new;
      h_s[e] = h_new;
      hs_b[static_cast<long long>(t) * d + e] = h_new;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < dh; e += blockDim.x) {
    c_out[vbase + e] = c_s[e];
    n_out[vbase + e] = n_s[e];
    h_out[vbase + e] = h_s[e];
    m_out[vbase + e] = m_s[e];
  }
}

template <typename XT, typename RT>
static void launch(const void* xg, long long xg_sb, long long xg_ss,
                   const void* r, const void* const* st_in,
                   void* hs, void* const* st_out, int B, int S, int nh,
                   int dh, cudaStream_t stream) {
  int threads = ((4 * dh + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = 8 * static_cast<size_t>(dh) * sizeof(float);
  slstm_kernel<XT, RT><<<dim3(nh, B), threads, smem, stream>>>(
      static_cast<const XT*>(xg), xg_sb, xg_ss, static_cast<const RT*>(r),
      static_cast<const float*>(st_in[0]),
      static_cast<const float*>(st_in[1]),
      static_cast<const float*>(st_in[2]),
      static_cast<const float*>(st_in[3]), static_cast<float*>(hs),
      static_cast<float*>(st_out[0]), static_cast<float*>(st_out[1]),
      static_cast<float*>(st_out[2]), static_cast<float*>(st_out[3]), S, nh,
      dh);
}

// x_bf16 / r_bf16: 1 for bf16, 0 for f32. xg is read through its batch and
// sequence strides (elements; unit stride along 4·d); r, the states and the
// outputs are contiguous. Returns 0, a cudaError_t code, or -1 (bad
// arguments).
extern "C" int slstm_launch(int x_bf16, int r_bf16, const void* xg,
                            long long xg_sb, long long xg_ss, const void* r,
                            const void* c0, const void* n0, const void* h0,
                            const void* m0, void* hs, void* c, void* n,
                            void* h, void* m, int B, int S, int nh, int dh,
                            void* stream) {
  if (B < 1 || B > MAX_ROWS || S < 1 || nh < 1 || dh < 1 || dh > MAX_DH ||
      !xg || !r || !c0 || !n0 || !h0 || !m0 || !hs || !c || !n || !h || !m)
    return -1;
  const void* st_in[4] = {c0, n0, h0, m0};
  void* st_out[4] = {c, n, h, m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && r_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(xg, xg_sb, xg_ss, r, st_in, hs,
                                         st_out, B, S, nh, dh, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(xg, xg_sb, xg_ss, r, st_in, hs, st_out, B,
                                 S, nh, dh, s);
  else if (r_bf16)
    launch<float, __nv_bfloat16>(xg, xg_sb, xg_ss, r, st_in, hs, st_out, B,
                                 S, nh, dh, s);
  else
    launch<float, float>(xg, xg_sb, xg_ss, r, st_in, hs, st_out, B, S, nh,
                         dh, s);
  return static_cast<int>(cudaGetLastError());
}

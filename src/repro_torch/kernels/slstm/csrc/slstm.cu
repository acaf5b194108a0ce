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
// What bounds it on the card. Per launch it moves xg (B·S·4d), hs
// (B·S·d f32), R and the states: 76.8 MB at the serving shape (B = 4,
// S = 2048, d = 768, nh = 4, dh = 192, bf16), 22.9 µs at 3.35 TB/s; and
// does 2·B·S·4d·dh = 9.66e9 FP32 operations, 0.144 ms at 67 TFLOP/s. So
// operations bound it, and more: the recurrence makes S dependent steps,
// which no design avoids. What a step costs is its chain: read h, the
// recurrent product, the gates, and handing h to every block that needs it.
//
// Two kernels; the shape alone chooses (`plan`, mirrored by slstm.py's
// `_plan`).
//
// slstm_kernel_cluster: R resident on chip, for dh <= 256 (the served
// xlstm shapes among them).
//   Grid (Q, nh, ceil(B/RB)), a cluster of Q CTAs per (head, group of RB
//   batch rows). CTA q owns the columns E_q = [q·dh/Q, (q+1)·dh/Q) of its
//   head in all four gates (a ragged split: dh = 100, Q = 8 gives 12 and
//   13; dh < Q leaves some CTAs none). Because a CTA owns all four gates of
//   its columns, the gate math stays local: only h crosses CTAs.
//   A warp owns two columns. Lane g·8 + kq (g the gate, kq in 0..7) holds
//   r[g, hd, k, E_q's two columns] for its k-block [kq·kp, (kq+1)·kp) in
//   registers for the whole launch (2·kp values, f32: bf16 converts
//   exactly), so every step's recurrent product reads only h from shared
//   memory (float4, a broadcast), and each R value serves the RB rows. The
//   lane sums its block in ascending k (`__fmaf_rn`: fixed, not a
//   contraction); a butterfly of shuffles (xor 4, 2, 1) adds the eight
//   blocks, so every lane of the gate holds the same sums; x is added, and
//   four shuffles give each lane the four gates of one (row, column) pair,
//   which 16/RB lanes compute alike.
//   The h exchange. Each CTA keeps two h buffers (RB rows of the head's dh
//   values, f32; the k-blocks at a stride ≡ 4 (mod 32) floats, so a warp's
//   eight float4 reads hit distinct banks, and zero past dh), selected by
//   step parity, and one mbarrier for each. Step t reads buffer t & 1; the
//   lanes of each (row, column) pair then store the new h into buffer
//   (t + 1) & 1 of every CTA of the cluster, one peer each, with
//   st.async, which counts its 4 bytes on that peer's mbarrier (t + 1) & 1
//   (complete_tx). Thread 0 of each CTA arms that mbarrier once a step
//   (arrive.expect_tx of 4·dh·rows bytes), and every thread waits on it
//   (try_wait.parity, acquire at cluster scope) before step t + 1 reads
//   the buffer: a CTA goes on as soon as its own h has arrived, with no
//   barrier across the cluster. Why one pair of buffers serves: a CTA
//   that writes buffer (t + 1) & 1 of a peer at step t has received step
//   t - 1's h from every column of that peer, and each of that peer's
//   warps stores its h only after its step t - 1 reads of that buffer;
//   warps with no column read nothing. The mbarrier phase that a store of
//   step t completes is the one its owner arms at step t: the owner armed
//   it after waiting out the phase before (step t - 2's), and no peer can
//   store step t + 2's h before the owner's step t + 1 h has reached it,
//   which follows the owner's wait. The phase of step t - 1's stores is
//   number (t - 1) >> 1 of its mbarrier, so its parity is ((t - 1) >> 1)
//   & 1.
//   Every CTA stays until the end: a CTA or warp with no column and a row
//   past B skip only their reads and stores. A cluster barrier after the
//   prologue lets no CTA store into a peer before the peer has set up its
//   buffers and mbarriers; the last step stores nothing, and each CTA has
//   waited for every store into it before it leaves.
//   Off the chain: hs for step t is stored and x for step t + 2 loaded
//   into a register after the step's h exchange.
//   Plan (`plan`): Q = ceil(dh / 32), the fewest CTAs that 512 threads
//   allow; a CTA takes an SM (~110 registers a thread), and RB grows only
//   until all clusters fit on the card at once. At the serving shape: Q =
//   6, RB = 1, 16 clusters of 6 CTAs of 512 threads on 96 SMs, 1.4 µs a
//   step, 2.9 ms a launch (PERF.md; slstm/sweep.py times the alternatives:
//   R in shared memory instead of registers, each step then reading 72 KB
//   of it a CTA; a cluster barrier a step instead of the mbarriers; Q = 8,
//   whose 16 clusters of 8 did not all fit on the card at once).
//
// slstm_kernel_stream: any other shape (dh up to MAX_DH), the first
//   design. One block per (head, batch row), its state in shared memory,
//   R read from device memory each step (at dh = 192 one head's R is
//   295 KB in bf16, more than the 227 KB a block can hold). A step has two
//   phases, each closed by a barrier:
//   1. thread j (stride blockDim) computes pre[j], j = g·dh + e: the dot
//      h·r[g, hd, :, e] as four partial sums s_q over k ≡ q (mod 4), each
//      in ascending k from 0 (a remainder k ≥ 4·floor(dh/4) goes into
//      s_0), then x + ((s_0 + s_1) + (s_2 + s_3)). Consecutive threads read
//      consecutive e, so each r row is read coalesced; h is a
//      shared-memory broadcast.
//   2. thread e (stride blockDim) applies the gates to column e and writes
//      h, c, n, m back to shared memory and h to hs.
//   Phase 1 of step t+1 reads the h that phase 2 of step t wrote, and phase
//   2 overwrites h only after every thread has passed phase 1's barrier, so
//   one h buffer serves (the two barriers do what a double buffer would).
//   At the serving shape it took 16.4 ms, 8.0 µs a step, on B·nh = 16 SMs
//   (PERF.md).
//
// Numerics: xg and r convert exactly to f32 (as the reference casts them);
// products and sums are IEEE-rounded in a fixed order (the stream kernel's
// __fmul_rn / __fadd_rn, the cluster kernel's __fmaf_rn chains and
// __fadd_rn tree; --fmad=false, so nothing else is contracted); expf and
// tanhf (never __expf), IEEE division (__fdiv_rn) for the sigmoid and for
// h. The plain version (ref.py) sums each dot in einsum's order, so the
// kernels agree with it to rounding, not bitwise: within atol 1e-4 (the
// reference's bound on its own kernel) where f32 resolves 1e-4 over the
// sequence. Over thousands of steps it may not: under the model's forget
// offset m grows by ~1 a step (one f32 ulp at 2048 is 2.4e-4) and c, n
// carry their rounding along, so there chip_smoke.py holds the two to a
// few times the plain version's own distance from a float64 run. Both
// kernels are deterministic and carry their state in f32, so a pass over
// [0, s1) then one over [s1, S) from the returned state equals one pass
// bitwise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "cluster_sync.cuh"

#define MAX_THREADS 1024
#define MAX_DH 1024            // 8·dh floats of shared memory: 32 KB at most
#define MAX_ROWS 65535         // gridDim.y = B

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT, typename RT>
__global__ void __launch_bounds__(MAX_THREADS)
slstm_kernel_stream(const XT* __restrict__ xg, long long xg_sb, long long xg_ss,
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
static void launch_stream(const void* xg, long long xg_sb, long long xg_ss,
                          const void* r, const void* const* st_in, void* hs,
                          void* const* st_out, int B, int S, int nh, int dh,
                          cudaStream_t stream) {
  int threads = ((4 * dh + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = 8 * static_cast<size_t>(dh) * sizeof(float);
  slstm_kernel_stream<XT, RT><<<dim3(nh, B), threads, smem, stream>>>(
      static_cast<const XT*>(xg), xg_sb, xg_ss, static_cast<const RT*>(r),
      static_cast<const float*>(st_in[0]),
      static_cast<const float*>(st_in[1]),
      static_cast<const float*>(st_in[2]),
      static_cast<const float*>(st_in[3]), static_cast<float*>(hs),
      static_cast<float*>(st_out[0]), static_cast<float*>(st_out[1]),
      static_cast<float*>(st_out[2]), static_cast<float*>(st_out[3]), S, nh,
      dh);
}


// ---------------------------------------------------------------------------
// slstm_kernel_cluster
// ---------------------------------------------------------------------------

#define CL_MAX_THREADS 512     // 16 warps: 32 columns a CTA at most
#define CL_MAX_KP 32           // k a lane: R in registers, dh <= 256
#define CL_MAX_Q 16            // above 8 needs the non-portable cluster size
#define CL_GPCS 8              // H100 SXM: GPCs, and the fewest SMs of one
#define CL_GPC_SMS 14
#define FULL_MASK 0xffffffffu

// The cluster kernel's geometry, computed on the host by `cluster_layout`
// (and by slstm.py's `_layout`).
struct ClusterPlan {
  int q, rb;               // CTAs a cluster, batch rows a CTA
  int nw, kp, hp;          // warps a CTA, k a lane, h's k-block stride
  int smem;                // dynamic shared memory (2 mbarriers, the h
                           // buffers), bytes
};

// Fills *p for a cluster of q CTAs and rb rows a CTA; false if the shape
// does not fit (more than CL_MAX_THREADS threads, or more than CL_MAX_KP
// k a lane).
static bool cluster_layout(int dh, int q, int rb, ClusterPlan* p) {
  const int ne = (dh + q - 1) / q;
  p->q = q;
  p->rb = rb;
  p->nw = (ne + 1) / 2;
  p->kp = ((dh + 7) / 8 + 3) / 4 * 4;
  p->hp = p->kp + ((4 - p->kp % 32) + 32) % 32;   // ≡ 4 (mod 32)
  p->smem = 16 + 4 * 2 * rb * 8 * p->hp;
  return 32 * p->nw <= CL_MAX_THREADS && p->kp <= CL_MAX_KP;
}

// The shape's plan: the cluster kernel where it fits (dh <= 256), with the
// fewest CTAs a head that the thread limit allows (Q = ceil(dh / 32), 32
// columns a CTA), and RB the fewest rows a CTA (1, 2, 4) that keep all
// clusters on the card at once. A CTA takes an SM (its registers), and a
// cluster must sit within one GPC: an H100 SXM has 8 GPCs of at least
// CL_GPC_SMS SMs, so at least 8·floor(CL_GPC_SMS / Q) clusters fit (the
// card's own count can be larger: slstm_cluster_launch reports it).
// Returns 1 (cluster, *p filled) or 0 (stream).
static int plan(int B, int nh, int dh, ClusterPlan* p) {
  if (nh > 65535) return 0;                      // gridDim.y
  const int q = (dh + 31) / 32;
  const int fit = CL_GPCS * (CL_GPC_SMS / q);
  int rb = 1;
  while (rb < 4 && static_cast<long long>(nh) * ((B + rb - 1) / rb) > fit)
    rb *= 2;
  return cluster_layout(dh, q, rb, p) ? 1 : 0;
}

__device__ __forceinline__ float mac(float acc, float h, float r) {
  return __fmaf_rn(h, r, acc);
}
__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <typename XT, typename RT, int RB>
__global__ void __launch_bounds__(CL_MAX_THREADS)
slstm_kernel_cluster(const XT* __restrict__ xg, long long xg_sb,
                     long long xg_ss, const RT* __restrict__ r,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ h0,
                     const float* __restrict__ m0, float* __restrict__ hs,
                     float* __restrict__ c_out, float* __restrict__ n_out,
                     float* __restrict__ h_out, float* __restrict__ m_out,
                     int B, int S, int nh, int dh, ClusterPlan p) {
  extern __shared__ __align__(16) unsigned long long smem_raw[];
  unsigned long long* bars = smem_raw;             // one a buffer
  float* h_s = reinterpret_cast<float*>(smem_raw + 2);  // 2 x RB x 8 x hp
  const int hbuf = RB * 8 * p.hp;
  const int q = blockIdx.x, hd = blockIdx.y, b0 = blockIdx.z * RB;
  const int e0 = q * dh / p.q;
  const int ne = (q + 1) * dh / p.q - e0;
  const int d = nh * dh;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 3, kq = lane & 7;

  // prologue: this lane's R, r[g, hd, kq·kp + i, e0 + 2w + c], in
  // registers for the whole launch (zero where k >= dh or the column is
  // not this CTA's)
  float rr[CL_MAX_KP][2];
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
  // both h buffers: buffer 0 from h0, buffer 1 and all padding zero
  for (int i = threadIdx.x; i < 2 * hbuf; i += blockDim.x) {
    const int buf = i / hbuf, in_buf = i - buf * hbuf;
    const int rb = in_buf / (8 * p.hp), in_row = in_buf - rb * 8 * p.hp;
    const int kb = in_row / p.hp, kk = in_row - kb * p.hp;
    const int k = kb * p.kp + kk;
    float v = 0.0f;
    if (buf == 0 && kk < p.kp && k < dh && b0 + rb < B)
      v = h0[static_cast<long long>(b0 + rb) * d + hd * dh + k];
    h_s[i] = v;
  }

  // this lane's (row, column) pair and its place among the pair's lanes
  const int cmb = kq % (2 * RB);
  const int rb_l = cmb >> 1, c_l = 2 * w + (cmb & 1);
  const int per_pair = 16 / RB;
  const int slot = g * (8 / (2 * RB)) + kq / (2 * RB);
  const int e = e0 + c_l, b = b0 + rb_l;
  const bool valid = c_l < ne && b < B;
  const long long v_at = static_cast<long long>(b) * d + hd * dh + e;
  const XT* x_p = xg + static_cast<long long>(b) * xg_sb
                  + static_cast<long long>(g) * d + hd * dh + e;
  float* hs_p = hs + static_cast<long long>(b) * S * d + hd * dh + e;
  float c_st = 0.0f, n_st = 0.0f, m_st = 0.0f, h_st = 0.0f;
  float x_cur = 0.0f, x_nxt = 0.0f;        // x of steps t and t + 1
  if (valid) {
    c_st = c0[v_at];
    n_st = n0[v_at];
    m_st = m0[v_at];
    h_st = h0[v_at];
    x_cur = to_f32(x_p[0]);
    if (S > 1) x_nxt = to_f32(x_p[xg_ss]);
  }
  // where column e sits in an h buffer
  const int h_at = rb_l * 8 * p.hp + (e / p.kp) * p.hp + e % p.kp;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  const int rows = B - b0 < RB ? B - b0 : RB;
  const unsigned step_bytes = 4u * dh * rows;      // h a step, from all peers
  const bool has_cols = 2 * w < ne;
  cluster_arrive();        // every peer has started and set up its buffers
  cluster_wait();

  for (int t = 0; t < S; ++t) {
    if (t > 0) mbar_wait(&bars[t & 1], ((t - 1) >> 1) & 1);
    if (threadIdx.x == 0 && t + 1 < S)
      mbar_expect_tx(&bars[(t + 1) & 1], step_bytes);
    const float* h_t = h_s + (t & 1) * hbuf + kq * p.hp;
    float acc[RB][2];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) acc[rb][0] = acc[rb][1] = 0.0f;
#pragma unroll
    for (int i = 0; i < CL_MAX_KP; i += 4) {
      if (has_cols && i < p.kp) {
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float4 hv =
              *reinterpret_cast<const float4*>(h_t + rb * 8 * p.hp + i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[rb][0] = mac(acc[rb][0], lane_of(hv, j), rr[i + j][0]);
            acc[rb][1] = mac(acc[rb][1], lane_of(hv, j), rr[i + j][1]);
          }
        }
      }
    }
    // the eight k-blocks of this gate, in a fixed tree
#pragma unroll
    for (int m = 4; m > 0; m >>= 1)
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[rb][c] = __fadd_rn(acc[rb][c],
                                 __shfl_xor_sync(FULL_MASK, acc[rb][c], m));
    float mine = acc[0][0];
#pragma unroll
    for (int j = 1; j < 2 * RB; ++j)
      if (cmb == j) mine = acc[j >> 1][j & 1];
    mine = __fadd_rn(x_cur, mine);
    const float pz = __shfl_sync(FULL_MASK, mine, kq);
    const float i_pre = __shfl_sync(FULL_MASK, mine, 8 + kq);
    const float f_pre = __shfl_sync(FULL_MASK, mine, 16 + kq);
    const float po = __shfl_sync(FULL_MASK, mine, 24 + kq);

    const float z = tanhf(pz);
    const float o = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-po)));
    const float fm = __fadd_rn(f_pre, m_st);
    const float m_new = fmaxf(fm, i_pre);
    const float i_s = expf(__fsub_rn(i_pre, m_new));
    const float f_s = expf(__fsub_rn(fm, m_new));
    c_st = __fadd_rn(__fmul_rn(f_s, c_st), __fmul_rn(i_s, z));
    n_st = __fadd_rn(__fmul_rn(f_s, n_st), i_s);
    h_st = __fdiv_rn(__fmul_rn(o, c_st), fmaxf(n_st, 1e-6f));
    m_st = m_new;
    if (valid && t + 1 < S) {
      const unsigned dst = smem_addr(h_s + ((t + 1) & 1) * hbuf + h_at);
      const unsigned bar = smem_addr(&bars[(t + 1) & 1]);
      for (int peer = slot; peer < p.q; peer += per_pair)
        st_async_f32(map_rank(dst, peer), h_st, map_rank(bar, peer));
    }
    if (valid && slot == 0) hs_p[static_cast<long long>(t) * d] = h_st;
    x_cur = x_nxt;
    if (valid && t + 2 < S)
      x_nxt = to_f32(x_p[static_cast<long long>(t + 2) * xg_ss]);
  }
  if (valid && slot == 0) {
    c_out[v_at] = c_st;
    n_out[v_at] = n_st;
    h_out[v_at] = h_st;
    m_out[v_at] = m_st;
  }
}

template <typename XT, typename RT, int RB>
static int launch_cluster_rb(const void* xg, long long xg_sb,
                             long long xg_ss, const void* r,
                             const void* const* st_in, void* hs,
                             void* const* st_out, int B, int S, int nh,
                             int dh, const ClusterPlan& p,
                             cudaStream_t stream, int* max_clusters) {
  void (*kern)(const XT*, long long, long long, const RT*, const float*,
               const float*, const float*, const float*, float*, float*,
               float*, float*, float*, int, int, int, int, ClusterPlan) =
      slstm_kernel_cluster<XT, RT, RB>;
  static bool attributes_set = false;     // once per instance
  if (!attributes_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    attributes_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.q, nh, (B + RB - 1) / RB);
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
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const XT*>(xg), xg_sb, xg_ss,
      static_cast<const RT*>(r), static_cast<const float*>(st_in[0]),
      static_cast<const float*>(st_in[1]),
      static_cast<const float*>(st_in[2]),
      static_cast<const float*>(st_in[3]), static_cast<float*>(hs),
      static_cast<float*>(st_out[0]), static_cast<float*>(st_out[1]),
      static_cast<float*>(st_out[2]), static_cast<float*>(st_out[3]), B, S,
      nh, dh, p);
  return static_cast<int>(err);
}

template <typename XT, typename RT>
static int launch_cluster_t(const void* xg, long long xg_sb, long long xg_ss,
                            const void* r, const void* const* st_in,
                            void* hs, void* const* st_out, int B, int S,
                            int nh, int dh, const ClusterPlan& p,
                            cudaStream_t stream, int* max_clusters) {
  switch (p.rb) {
    case 1:
      return launch_cluster_rb<XT, RT, 1>(xg, xg_sb, xg_ss, r, st_in, hs,
                                          st_out, B, S, nh, dh, p, stream,
                                          max_clusters);
    case 2:
      return launch_cluster_rb<XT, RT, 2>(xg, xg_sb, xg_ss, r, st_in, hs,
                                          st_out, B, S, nh, dh, p, stream,
                                          max_clusters);
    case 4:
      return launch_cluster_rb<XT, RT, 4>(xg, xg_sb, xg_ss, r, st_in, hs,
                                          st_out, B, S, nh, dh, p, stream,
                                          max_clusters);
  }
  return -1;
}

// The cluster kernel with plan p for the given input types. With
// max_clusters set it launches nothing and writes how many clusters of
// this plan the card can hold at once.
static int launch_cluster(int x_bf16, int r_bf16, const void* xg,
                          long long xg_sb, long long xg_ss, const void* r,
                          const void* const* st_in, void* hs,
                          void* const* st_out, int B, int S, int nh, int dh,
                          const ClusterPlan& p, cudaStream_t s,
                          int* max_clusters) {
  typedef __nv_bfloat16 bf;
  if (x_bf16 && r_bf16)
    return launch_cluster_t<bf, bf>(xg, xg_sb, xg_ss, r, st_in, hs, st_out,
                                    B, S, nh, dh, p, s, max_clusters);
  if (x_bf16)
    return launch_cluster_t<bf, float>(xg, xg_sb, xg_ss, r, st_in, hs,
                                       st_out, B, S, nh, dh, p, s,
                                       max_clusters);
  if (r_bf16)
    return launch_cluster_t<float, bf>(xg, xg_sb, xg_ss, r, st_in, hs,
                                       st_out, B, S, nh, dh, p, s,
                                       max_clusters);
  return launch_cluster_t<float, float>(xg, xg_sb, xg_ss, r, st_in, hs,
                                        st_out, B, S, nh, dh, p, s,
                                        max_clusters);
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

static bool args_ok(int B, int S, int nh, int dh, const void* xg,
                    const void* r, const void* c0, const void* n0,
                    const void* h0, const void* m0, const void* hs,
                    const void* c, const void* n, const void* h,
                    const void* m) {
  return B >= 1 && B <= MAX_ROWS && S >= 1 && nh >= 1 && dh >= 1 &&
         dh <= MAX_DH && xg && r && c0 && n0 && h0 && m0 && hs && c && n &&
         h && m;
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
  if (!args_ok(B, S, nh, dh, xg, r, c0, n0, h0, m0, hs, c, n, h, m))
    return -1;
  const void* st_in[4] = {c0, n0, h0, m0};
  void* st_out[4] = {c, n, h, m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ClusterPlan p;
  if (plan(B, nh, dh, &p)) {
    const int rc = launch_cluster(x_bf16, r_bf16, xg, xg_sb, xg_ss, r, st_in,
                                  hs, st_out, B, S, nh, dh, p, s, nullptr);
    const int last = static_cast<int>(cudaGetLastError());
    return rc ? rc : last;
  }
  if (x_bf16 && r_bf16)
    launch_stream<__nv_bfloat16, __nv_bfloat16>(xg, xg_sb, xg_ss, r, st_in,
                                                hs, st_out, B, S, nh, dh, s);
  else if (x_bf16)
    launch_stream<__nv_bfloat16, float>(xg, xg_sb, xg_ss, r, st_in, hs,
                                        st_out, B, S, nh, dh, s);
  else if (r_bf16)
    launch_stream<float, __nv_bfloat16>(xg, xg_sb, xg_ss, r, st_in, hs,
                                        st_out, B, S, nh, dh, s);
  else
    launch_stream<float, float>(xg, xg_sb, xg_ss, r, st_in, hs, st_out, B, S,
                                nh, dh, s);
  return static_cast<int>(cudaGetLastError());
}

// The plan slstm_launch takes for this shape: returns 1 (cluster) or 0
// (stream) and writes out[0..2] = Q, RB and the dynamic shared memory bytes
// (0, 0 and the stream kernel's 8·dh floats for stream).
extern "C" int slstm_plan(int B, int nh, int dh, int* out) {
  ClusterPlan p;
  const int cluster = plan(B, nh, dh, &p);
  out[0] = cluster ? p.q : 0;
  out[1] = cluster ? p.rb : 0;
  out[2] = cluster ? p.smem : 8 * dh * static_cast<int>(sizeof(float));
  return cluster;
}

// The cluster kernel with an explicit Q and RB, whatever the shape's own
// plan (tools of the sweep in slstm/sweep.py and the card tests time and
// check the alternatives with it). With max_clusters non-null it launches
// nothing and writes cudaOccupancyMaxActiveClusters's count for that plan.
// Returns what slstm_launch returns; -1 also for a plan that does not fit
// or is not one (q in 1..16, rb in {1, 2, 4}).
extern "C" int slstm_cluster_launch(int q, int rb, int* max_clusters,
                                    int x_bf16, int r_bf16, const void* xg,
                                    long long xg_sb, long long xg_ss,
                                    const void* r, const void* c0,
                                    const void* n0, const void* h0,
                                    const void* m0, void* hs, void* c,
                                    void* n, void* h, void* m, int B, int S,
                                    int nh, int dh, void* stream) {
  ClusterPlan p;
  if (!args_ok(B, S, nh, dh, xg, r, c0, n0, h0, m0, hs, c, n, h, m) ||
      q < 1 || q > CL_MAX_Q || (rb != 1 && rb != 2 && rb != 4) ||
      nh > 65535 || !cluster_layout(dh, q, rb, &p))
    return -1;
  const void* st_in[4] = {c0, n0, h0, m0};
  void* st_out[4] = {c, n, h, m};
  const int rc = launch_cluster(x_bf16, r_bf16, xg, xg_sb, xg_ss, r, st_in,
                                hs, st_out, B, S, nh, dh, p,
                                static_cast<cudaStream_t>(stream),
                                max_clusters);
  const int last = static_cast<int>(cudaGetLastError());
  return rc ? rc : last;
}

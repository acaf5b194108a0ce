// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the dQ
// kernel. Causal or bidirectional, sliding window, GQA, a query offset; f32
// or bf16 inputs.
//
// Replaces the TPU kernels src/repro/kernels/flash_attn/flash_attn.py::
// flash_attention_bwd: _flash_dkv_kernel (its first pallas_call) and
// _flash_dq_kernel (its second). Bound from Python with ctypes
// (src/repro_torch/kernels/flash_attn/flash_attn.py).
//
// What they compute. q, do (B, Sq, H, D), k, v (B, Sk, Hkv, D) in one type,
// lse and delta (B, Sq, H) f32 (lse from the forward, delta = rowsum(do ⊙ o)
// computed by the wrapper). Query head h reads kv head h / (H / Hkv); row i
// sits at position q_offset + i, key j at j, and the mask is the forward's.
// Under the mask, with s = scale · q·kᵀ:
//   p  = exp(s − lse)            (0 where masked; the exponent is taken
//                                 only under the mask: a masked entry of a
//                                 row whose lse is NEG_INF would overflow)
//   dp = do·vᵀ,  ds = p·(dp − delta)·scale
//   dv = pᵀ·do,  dk = dsᵀ·q,  dq = ds·k
// dk and dv come out at Hkv heads: the dK/dV kernels sum the GQA group in
// their f32 registers and round once to the input type (the TPU kernel
// writes them at H heads in the input type and its caller sums them, so in
// bf16 it rounds twice). No atomics: every output element is written once
// by one thread, so two calls give the same bits.
//
// What bounds them on the card. Per (b, h), a causal backward over S
// tokens recomputes s and dp and forms two more products: dK/dV does four
// D·S²/2 products (s, dp, dv, dk), dQ three (s, dp, dq). At the training
// shape (4 × 2048 tokens, 16/8 heads, D = 128, bf16) that is 1.37e11 and
// 1.03e11 flops against ~100 MB of traffic each: far above the H100's
// ridge, so the bound is the operations, 0.139 ms and 0.104 ms at the bf16
// tensor-core peak.
//
// bf16 instances (flash_bwd_dkv_kernel_tc, flash_bwd_dq_kernel_tc): the
// forward's tensor-core machinery (mma_tiles.cuh), turned around. Four
// warps of 16 rows each; every product is mma.sync.m16n8k16 bf16 × bf16 →
// f32, and every intermediate stays in registers.
//   * dK/dV: one block per (64-key tile, b·Hkv + kv head); each warp owns
//     16 keys. The K and V tiles are staged once; the block walks the GQA
//     group × the q tiles that can see its keys through a two-stage
//     cp.async ring of (Q, dO, lse, delta). For each q tile it forms the
//     transposed scores Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K and V as A operands by
//     ldmatrix, Q and dO as B operands by plain ldmatrix), then Pᵀ and dSᵀ
//     in registers (lse and delta are per column: each lane reads those of
//     its columns from shared memory), and feeds them back as A operands
//     from the accumulator layout: dV += Pᵀ·dO, dK += dSᵀ·Q, with dO and Q
//     as B operands by ldmatrix.trans. dK and dV stay in f32 registers
//     across the whole walk.
//   * dQ: one block per (64-row q tile, b·H + h); each warp owns 16 rows.
//     The Q and dO fragments are loaded once and stay in registers, as do
//     each row's lse and delta; a two-stage cp.async K/V ring feeds
//     S = Q·Kᵀ and dP = dO·Vᵀ, and dS, in registers, is the A operand of
//     dQ += dS·K (K by ldmatrix.trans). The forward without its online
//     softmax.
//   * Registers are the hazard: dK and dV take 128 f32 a thread at
//     D = 128 (dQ with the Q and dO fragments as much). So each 64-row (or
//     64-key) tile is taken in four 16-wide passes, which cuts the score
//     fragments (Sᵀ and dPᵀ, or S and dP) to 8 f32 each. With two 32-wide
//     passes ptxas spilled at D = 128 in both kernels, at 255 registers,
//     and both ran slower on the card; with 16-wide passes no instance
//     spills (PERF.md records the registers).
//   * Precision: P and dS enter their products as bf16 hi + lo pairs
//     (split_bf16: hi rounded to nearest even, lo what hi missed), two
//     products each, so dV, dK and dQ are as good as products with f32 P
//     and dS. dK/dV then runs six products a tile for its nominal four, dQ
//     four for three. One bf16 rounding of P broke the forward's layer-0
//     bound on the card; the backward's bound (1e-2·|want| +
//     1e-3·max|want|, elementwise) is as tight.
//   * Scores in log2 units (scale · log2 e, lse · log2 e, then exp2f), as
//     in the forward. Only tiles that cross Sq, Sk, the causal diagonal or
//     the window edge evaluate the mask; a masked score is −inf, and
//     exp2f(−inf − lse) = 0 for any finite lse, NEG_INF included.
//   * Schedule: the tile index on the slow grid axis, heaviest first
//     across all heads. A causal key tile kt is seen by the q tiles ≥ kt,
//     so dK/dV starts at key tile 0; dQ starts at the last q tile.
//   * Shared memory at D = 128: dK/dV the K and V tiles (34.8 KB) and two
//     ring stages of Q and dO (69.6 KB) with lse and delta (1 KB); dQ the Q
//     and dO tiles and two stages of K and V, 104 KB. Two blocks an SM.
//     Rows are padded by 16 bytes, as in the forward, so every ldmatrix
//     phase is conflict-free at every D = 16·n. The results go back
//     through each warp's own rows of a staged tile, so each row is
//     written with 16-byte stores.
//   The caller guarantees 16-byte alignment of every row of q, k, v and do
//   (the wrapper checks each pointer and each (b, s, h) stride and raises
//   otherwise).
//
// f32 instances (flash_bwd_dkv_kernel<float, NC>, flash_bwd_dq_kernel<
// float, NC>): every product as FP32 FMAs on the CUDA cores (67 TFLOP/s
// peak), kept because their bound against the plain version is 5e-4,
// which no bf16 product can meet. Each of the 256 threads owns a 4 × 4
// micro-tile of the BQ × BK score tile for the two recomputed products
// (rows tr + 16·i, keys tc + 16·j), rows padded by one word so the strided
// reads hit distinct banks. P and dS go through shared memory once; for
// dK/dV each thread then owns 4 key rows × D/16 columns of both
// accumulators, for dQ 4 query rows × D/16 columns. At D = 128 the staged
// tiles take 162 KB (dK/dV) and 146 KB (dQ) of shared memory. Grids: dK/dV
// one block per (K tile, b·Hkv + kv head), dQ one per (q tile, b·H + h),
// the heaviest causal q tiles first within each head. All arithmetic in
// f32 (fmaf, expf).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "mma_tiles.cuh"   // cp.async, ldmatrix, mma.sync, bf16 packing

#define BQ 64                  // query rows per tile
#define BK 64                  // keys per tile
#define NTHREADS 256           // f32: 16 row groups × 16 key/column lanes
#define TC_THREADS 128         // bf16: 4 warps × 16 rows (keys for dK/dV)
#define TC_STAGES 2            // bf16: ring depth
#define TC_PASS 16             // bf16: q rows (dK/dV) or keys (dQ) a pass
#define MAX_SMEM_BYTES 232448  // 227 KB, the opt-in limit of one block

enum { DT_F32 = 0, DT_BF16 = 1 };

struct BParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;              // (B, Sq, H), contiguous
  const float* delta;            // (B, Sq, H), contiguous
  void* dq;                      // (B, Sq, H, D), contiguous, q's type
  void* dk;                      // (B, Sk, Hkv, D), contiguous, q's type
  void* dv;                      // (B, Sk, Hkv, D), contiguous, q's type
  long long q_sb, q_ss, q_sh;    // element strides of b, s, h (d is 1)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;    // of do
  int heads, kv_heads, kv_group, seq_q, seq_k, causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ void store_out(float* p, long long i, float v) {
  p[i] = v;
}

// Stage rows [row0, row0 + tile_rows) of one head into shared memory as f32
// (row stride ld words); rows at or past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_stride, int row0,
                                      int n_rows, int tile_rows) {
  for (int idx = threadIdx.x; idx < tile_rows * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    dst[r * ld + d] = (row0 + r < n_rows)
                          ? load_f32(src, (row0 + r) * s_stride + d)
                          : 0.0f;
  }
}

// Stage lse and delta of rows [row0, row0 + BQ) of head h; rows at or past
// seq_q are zero (their scores are masked).
__device__ __forceinline__ void stage_rows(float* lse_s, float* dl_s,
                                           const BParams& p, int b, int h,
                                           int row0) {
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const int row = row0 + r;
    const long long i =
        (static_cast<long long>(b) * p.seq_q + row) * p.heads + h;
    lse_s[r] = row < p.seq_q ? p.lse[i] : 0.0f;
    dl_s[r] = row < p.seq_q ? p.delta[i] : 0.0f;
  }
}

// acc[i][j] = Σ_d a[(tr + 16 i)·ld + d] · b[(tc + 16 j)·ld + d]
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ld, int tr, int tc,
                                         float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(tr + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tc + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool valid_pair(const BParams& p, int row,
                                           int kpos) {
  const long long qpos = static_cast<long long>(p.q_offset) + row;
  bool ok = kpos < p.seq_k && row < p.seq_q;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// P and dS of one (q tile, K tile) pair into shared memory (row stride
// BK + 1): recompute s = scale·q·kᵀ and dp = do·vᵀ, then
// p = exp(s − lse), ds = p·(dp − delta)·scale under the mask, 0 elsewhere.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const BParams& p, const float* q_s, const float* do_s, const float* k_s,
    const float* v_s, const float* lse_s, const float* dl_s, float* p_s,
    float* ds_s, int q0, int k0, int tr, int tc) {
  constexpr int LD = D + 1, LDP = BK + 1;
  float s[4][4], dp[4][4];
  tile_dot<D>(q_s, k_s, LD, tr, tc, s);
  tile_dot<D>(do_s, v_s, LD, tr, tc, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      float pv = 0.0f, dsv = 0.0f;
      if (valid_pair(p, q0 + r, k0 + c)) {
        pv = expf(s[i][j] * p.scale - lse_s[r]);
        dsv = pv * (dp[i][j] - dl_s[r]) * p.scale;
      }
      if (p_s != nullptr) p_s[r * LDP + c] = pv;
      ds_s[r * LDP + c] = dsv;
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const BParams p) {
  constexpr int D = 16 * NC;
  constexpr int LD = D + 1;     // padded rows: conflict-free strided reads
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);   // BK × LD
  float* v_s = k_s + BK * LD;                         // BK × LD
  float* q_s = v_s + BK * LD;                         // BQ × LD
  float* do_s = q_s + BQ * LD;                        // BQ × LD
  float* p_s = do_s + BQ * LD;                        // BQ × LDP
  float* ds_s = p_s + BQ * LDP;                       // BQ × LDP
  float* lse_s = ds_s + BQ * LDP;                     // BQ
  float* dl_s = lse_s + BQ;                           // BQ

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.kv_heads, hk = blockIdx.y % p.kv_heads;

  stage<T, D>(k_s, LD, static_cast<const T*>(p.k) + b * p.k_sb +
                           hk * p.k_sh, p.k_ss, k0, p.seq_k, BK);
  stage<T, D>(v_s, LD, static_cast<const T*>(p.v) + b * p.v_sb +
                           hk * p.v_sh, p.v_ss, k0, p.seq_k, BK);

  // the query rows that may see a key of this tile: [q_lo, q_end)
  const long long k_hi = min(k0 + BK, p.seq_k) - 1;
  long long q_lo = 0, q_end = p.seq_q;
  if (p.causal && k0 - static_cast<long long>(p.q_offset) > q_lo)
    q_lo = k0 - static_cast<long long>(p.q_offset);
  if (p.window > 0 && k_hi + p.window - p.q_offset < q_end)
    q_end = k_hi + p.window - p.q_offset;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  if (q_end > q_lo) {
    const int qt_lo = static_cast<int>(q_lo / BQ);
    const int qt_hi = static_cast<int>((q_end - 1) / BQ);
    for (int g = 0; g < p.kv_group; ++g) {
      const int h = hk * p.kv_group + g;
      const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
      const T* dout =
          static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();        // the previous tile's q_s .. dl_s are read
        stage<T, D>(q_s, LD, q, p.q_ss, q0, p.seq_q, BQ);
        stage<T, D>(do_s, LD, dout, p.o_ss, q0, p.seq_q, BQ);
        stage_rows(lse_s, dl_s, p, b, h, q0);
        __syncthreads();
        probs_and_dscores<D>(p, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s,
                             q0, k0, tr, tc);
        __syncthreads();        // p_s, ds_s complete
        // dV += Pᵀ·dO and dK += dSᵀ·Q over the tile's BQ rows
#pragma unroll 4
        for (int j = 0; j < BQ; ++j) {
          float dov[NC], qv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dov[c] = do_s[j * LD + tc + 16 * c];
            qv[c] = q_s[j * LD + tc + 16 * c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = p_s[j * LDP + tr + 16 * i];
            const float dsv = ds_s[j * LDP + tr + 16 * i];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              dv[i][c] = fmaf(pv, dov[c], dv[i][c]);
              dk[i][c] = fmaf(dsv, qv[c], dk[i][c]);
            }
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr + 16 * i;
    if (row >= p.seq_k) continue;
    const long long base =
        ((static_cast<long long>(b) * p.seq_k + row) * p.kv_heads + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store_out(dk_out, base + tc + 16 * c, dk[i][c]);
      store_out(dv_out, base + tc + 16 * c, dv[i][c]);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const BParams p) {
  constexpr int D = 16 * NC;
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // BQ × LD
  float* do_s = q_s + BQ * LD;                        // BQ × LD
  float* k_s = do_s + BQ * LD;                        // BK × LD
  float* v_s = k_s + BK * LD;                         // BK × LD
  float* ds_s = v_s + BK * LD;                        // BQ × LDP
  float* lse_s = ds_s + BQ * LDP;                     // BQ
  float* dl_s = lse_s + BQ;                           // BQ

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  // the heaviest causal tiles (the last q tiles) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int hk = h / p.kv_group;

  stage<T, D>(q_s, LD, static_cast<const T*>(p.q) + b * p.q_sb +
                           h * p.q_sh, p.q_ss, q0, p.seq_q, BQ);
  stage<T, D>(do_s, LD, static_cast<const T*>(p.dout) + b * p.o_sb +
                            h * p.o_sh, p.o_ss, q0, p.seq_q, BQ);
  stage_rows(lse_s, dl_s, p, b, h, q0);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + BQ, p.seq_q) - 1;
  const long long pos_lo = static_cast<long long>(p.q_offset) + q0;
  const long long pos_hi = static_cast<long long>(p.q_offset) + q_last;
  long long k_end = p.seq_k, k_begin = 0;
  if (p.causal && pos_hi + 1 < k_end) k_end = pos_hi + 1;
  if (p.window > 0 && pos_lo - p.window + 1 > 0)
    k_begin = pos_lo - p.window + 1;

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.0f;

  if (k_end > k_begin) {
    const int kt_lo = static_cast<int>(k_begin / BK);
    const int kt_hi = static_cast<int>((k_end - 1) / BK);
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();          // the previous tile's k_s, v_s, ds_s are read
      stage<T, D>(k_s, LD, k, p.k_ss, k0, p.seq_k, BK);
      stage<T, D>(v_s, LD, v, p.v_ss, k0, p.seq_k, BK);
      __syncthreads();
      probs_and_dscores<D>(p, q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr,
                           ds_s, q0, k0, tr, tc);
      __syncthreads();          // ds_s complete
      // dQ += dS·K over the tile's BK keys
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float kv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) kv[c] = k_s[j * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dsv = ds_s[(tr + 16 * i) * LDP + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) dq[i][c] = fmaf(dsv, kv[c], dq[i][c]);
        }
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= p.seq_q) continue;
    const long long base =
        ((static_cast<long long>(b) * p.seq_q + row) * p.heads + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store_out(dq_out, base + tc + 16 * c,
                                           dq[i][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles (fragment layouts: mma_tiles.cuh)
// ---------------------------------------------------------------------------

#define LOG2E_F 1.44269504088896341f

// May the tile pair (q rows from q0, keys from k0) hold a masked (row,
// key) pair? Rows past Sq and keys past Sk count as masked.
__device__ __forceinline__ bool edge_tile(const BParams& p, int q0, int k0) {
  const long long pos_lo = static_cast<long long>(p.q_offset) + q0;
  const long long pos_hi =
      static_cast<long long>(p.q_offset) + min(q0 + BQ, p.seq_q) - 1;
  return q0 + BQ > p.seq_q || k0 + BK > p.seq_k ||
         (p.causal && k0 + BK - 1 > pos_lo) ||
         (p.window > 0 && k0 <= pos_hi - p.window);
}

// Stage rows [row0, row0 + 64) of one head (row stride s_stride elements)
// into shared memory (row stride LDS) by 16-byte cp.async; rows at or past
// n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tc(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         long long s_stride, int row0,
                                         int n_rows) {
  constexpr int LDS = D + 8, CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += TC_THREADS) {
    const int r = idx / CH, ch = idx % CH;
    const bool ok = row0 + r < n_rows;
    cp_async_16(dst + r * LDS + ch * 8,
                src + (ok ? (row0 + r) * s_stride : 0) + ch * 8, ok);
  }
}

// This warp's 16 rows of f32 accumulator fragments (2·NC n-blocks over D)
// → bf16 rows of `rows` (row stride LDS, this warp's own rows), then
// 16-byte stores to out rows row0 + r (contiguous, n_rows of them; row r
// at out + (row0 + r) · row_stride).
template <int NC>
__device__ __forceinline__ void store_rows_tc(
    __nv_bfloat16* rows, const float (&acc)[2 * NC][4],
    __nv_bfloat16* out, long long row_stride, int row0, int n_rows) {
  constexpr int D = 16 * NC, LDS = D + 8, CH = D / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<unsigned*>(rows + (g + 8 * r) * LDS + n * 8 +
                                   2 * c) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, ch = idx % CH;
    if (row0 + r >= n_rows) continue;
    *reinterpret_cast<uint4*>(out + (row0 + r) * row_stride + ch * 8) =
        *reinterpret_cast<const uint4*>(rows + r * LDS + ch * 8);
  }
}

template <int NC>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkv_kernel_tc(const BParams p) {
  typedef __nv_bfloat16 bf16;
  constexpr int D = 16 * NC;
  constexpr int LDS = D + 8;          // row stride in elements: + 16 bytes
  constexpr int NBP = TC_PASS / 8;    // Sᵀ n-blocks (8 q rows) a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);        // BK × LDS
  bf16* v_s = k_s + BK * LDS;                            // BK × LDS
  bf16* q_s = v_s + BK * LDS;                            // STAGES × BQ × LDS
  bf16* do_s = q_s + TC_STAGES * BQ * LDS;               // STAGES × BQ × LDS
  float* lse_s = reinterpret_cast<float*>(do_s + TC_STAGES * BQ * LDS);
  float* dl_s = lse_s + TC_STAGES * BQ;                  // STAGES × BQ each

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  // key tiles on the slow grid axis, the first (heaviest causal) first
  const int k0 = blockIdx.y * BK;
  const int b = blockIdx.x / p.kv_heads, hk = blockIdx.x % p.kv_heads;

  stage_tc<D>(k_s, static_cast<const bf16*>(p.k) + b * p.k_sb +
                       hk * p.k_sh, p.k_ss, k0, p.seq_k);
  stage_tc<D>(v_s, static_cast<const bf16*>(p.v) + b * p.v_sb +
                       hk * p.v_sh, p.v_ss, k0, p.seq_k);
  cp_async_commit();

  // the query rows that may see a key of this tile: [q_lo, q_end); the
  // walk is the GQA group × those q tiles
  const long long k_hi = min(k0 + BK, p.seq_k) - 1;
  long long q_lo = 0, q_end = p.seq_q;
  if (p.causal && k0 - static_cast<long long>(p.q_offset) > q_lo)
    q_lo = k0 - static_cast<long long>(p.q_offset);
  if (p.window > 0 && k_hi + p.window - p.q_offset < q_end)
    q_end = k_hi + p.window - p.q_offset;
  const int qt_lo = q_end > q_lo ? static_cast<int>(q_lo / BQ) : 0;
  const int n_qt =
      q_end > q_lo ? static_cast<int>((q_end - 1) / BQ) - qt_lo + 1 : 0;
  const int n_items = n_qt * p.kv_group;

  auto stage_item = [&](int st, int it) {
    const int h = hk * p.kv_group + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    stage_tc<D>(q_s + st * BQ * LDS, static_cast<const bf16*>(p.q) +
                    b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.seq_q);
    stage_tc<D>(do_s + st * BQ * LDS, static_cast<const bf16*>(p.dout) +
                    b * p.o_sb + h * p.o_sh, p.o_ss, q0, p.seq_q);
    // 128 threads: lse of row tid, then delta of row tid − 64
    const int r = tid % BQ;
    const bool ok = q0 + r < p.seq_q;
    const long long i =
        ok ? (static_cast<long long>(b) * p.seq_q + q0 + r) * p.heads + h
           : 0;
    if (tid < BQ) cp_async_4(lse_s + st * BQ + r, p.lse + i, ok);
    else cp_async_4(dl_s + st * BQ + r, p.delta + i, ok);
  };
  if (n_items > 0) stage_item(0, 0);
  cp_async_commit();

  const int w0 = warp * 16;           // this warp's keys within the tile
  float dk[2 * NC][4], dv[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const float scale_log2 = p.scale * LOG2E_F;

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    if (it + 1 < n_items) stage_item(st ^ 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();         // item it (and K, V) landed; it + 1 in flight
    __syncthreads();

    const bf16* qb = q_s + st * BQ * LDS;
    const bf16* dob = do_s + st * BQ * LDS;
    const float* lse_b = lse_s + st * BQ;
    const float* dl_b = dl_s + st * BQ;
    const bool edge = edge_tile(p, q0, k0);
#pragma unroll
    for (int r0 = 0; r0 < BQ; r0 += TC_PASS) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys × TC_PASS q rows per warp
      float sT[NBP][4], dpT[NBP][4];
#pragma unroll
      for (int n = 0; n < NBP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
        unsigned ka[4], va[4];
        const int a_off = (w0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ka, k_s + a_off);
        ldmatrix_x4(va, v_s + a_off);
#pragma unroll
        for (int n2 = 0; n2 < NBP / 2; ++n2) {
          unsigned qf[4], df[4];
          const int b_off =
              (r0 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
              kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(qf, qb + b_off);
          ldmatrix_x4(df, dob + b_off);
          mma_bf16_16816(sT[2 * n2], ka, qf[0], qf[1]);
          mma_bf16_16816(sT[2 * n2 + 1], ka, qf[2], qf[3]);
          mma_bf16_16816(dpT[2 * n2], va, df[0], df[1]);
          mma_bf16_16816(dpT[2 * n2 + 1], va, df[2], df[3]);
        }
      }
      // Pᵀ and dSᵀ in place: element e of n-block n is key w0 + g + 8·(e/2),
      // q row r0 + 8n + 2c + e%2, whose lse and delta this lane reads
#pragma unroll
      for (int n = 0; n < NBP; ++n) {
        const int j = r0 + n * 8 + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_b + j);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_b + j);
        const float lse2[2] = {l2.x * LOG2E_F, l2.y * LOG2E_F};
        const float dlt[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sT[n][e] * scale_log2;
          if (edge && !valid_pair(p, q0 + j + (e & 1),
                                  k0 + w0 + g + 8 * (e >> 1)))
            x = -INFINITY;
          const float pv = exp2f(x - lse2[e & 1]);
          sT[n][e] = pv;
          dpT[n][e] = pv * (dpT[n][e] - dlt[e & 1]) * p.scale;
        }
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over 16 q rows at a time: Pᵀ and dSᵀ
      // as bf16 hi + lo A fragments, dO and Q by ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < NBP / 2; ++kq) {
        unsigned ph[4], pl[4], sh[4], sl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* x = sT[2 * kq + (j >> 1)] + 2 * (j & 1);
          const float* y = dpT[2 * kq + (j >> 1)] + 2 * (j & 1);
          split_bf16(x[0], x[1], ph[j], pl[j]);
          split_bf16(y[0], y[1], sh[j], sl[j]);
        }
#pragma unroll
        for (int n2 = 0; n2 < NC; ++n2) {
          unsigned bd[4], bq[4];
          const int t_off =
              (r0 + kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
              n2 * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bd, dob + t_off);
          ldmatrix_x4_trans(bq, qb + t_off);
          mma_bf16_16816(dv[2 * n2], ph, bd[0], bd[1]);
          mma_bf16_16816(dv[2 * n2 + 1], ph, bd[2], bd[3]);
          mma_bf16_16816(dv[2 * n2], pl, bd[0], bd[1]);
          mma_bf16_16816(dv[2 * n2 + 1], pl, bd[2], bd[3]);
          mma_bf16_16816(dk[2 * n2], sh, bq[0], bq[1]);
          mma_bf16_16816(dk[2 * n2 + 1], sh, bq[2], bq[3]);
          mma_bf16_16816(dk[2 * n2], sl, bq[0], bq[1]);
          mma_bf16_16816(dk[2 * n2 + 1], sl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();            // stage st is read: the next copy may land
  }

  // dk and dv through this warp's own rows of the K and V tiles (only this
  // warp reads them), rounded once to bf16
  cp_async_wait<0>();
  __syncthreads();
  const long long row_stride = static_cast<long long>(p.kv_heads) * D;
  const long long base =
      (static_cast<long long>(b) * p.seq_k * p.kv_heads + hk) * D;
  store_rows_tc<NC>(k_s + w0 * LDS, dk, static_cast<bf16*>(p.dk) + base,
                    row_stride, k0 + w0, p.seq_k);
  store_rows_tc<NC>(v_s + w0 * LDS, dv, static_cast<bf16*>(p.dv) + base,
                    row_stride, k0 + w0, p.seq_k);
}

template <int NC>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dq_kernel_tc(const BParams p) {
  typedef __nv_bfloat16 bf16;
  constexpr int D = 16 * NC;
  constexpr int LDS = D + 8;
  constexpr int NBP = TC_PASS / 8;    // S n-blocks (8 keys) a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);        // BQ × LDS
  bf16* do_s = q_s + BQ * LDS;                           // BQ × LDS
  bf16* k_s = do_s + BQ * LDS;                           // STAGES × BK × LDS
  bf16* v_s = k_s + TC_STAGES * BK * LDS;                // STAGES × BK × LDS

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  // q tiles on the slow grid axis, the last (heaviest causal) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int hk = h / p.kv_group;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + BQ, p.seq_q) - 1;
  const long long pos_lo = static_cast<long long>(p.q_offset) + q0;
  const long long pos_hi = static_cast<long long>(p.q_offset) + q_last;
  long long k_end = p.seq_k, k_begin = 0;
  if (p.causal && pos_hi + 1 < k_end) k_end = pos_hi + 1;
  if (p.window > 0 && pos_lo - p.window + 1 > 0)
    k_begin = pos_lo - p.window + 1;
  const int kt_lo = static_cast<int>(k_begin / BK);
  const int n_tiles =
      k_end > k_begin ? static_cast<int>((k_end - 1) / BK) - kt_lo + 1 : 0;

  stage_tc<D>(q_s, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
              p.q_ss, q0, p.seq_q);
  stage_tc<D>(do_s, static_cast<const bf16*>(p.dout) + b * p.o_sb +
                        h * p.o_sh, p.o_ss, q0, p.seq_q);
  cp_async_commit();
  auto stage_kv = [&](int st, int k0) {
    stage_tc<D>(k_s + st * BK * LDS, k, p.k_ss, k0, p.seq_k);
    stage_tc<D>(v_s + st * BK * LDS, v, p.v_ss, k0, p.seq_k);
  };
  if (n_tiles > 0) stage_kv(0, kt_lo * BK);
  cp_async_commit();            // one group even when empty: uniform waits
  cp_async_wait<1>();           // Q and dO have landed
  __syncthreads();

  // this warp's 16 rows of Q and dO as A fragments, with their lse (in
  // log2 units) and delta; rows past Sq get 0 and are never stored
  const int w0 = warp * 16;
  unsigned qf[NC][4], df[NC][4];
#pragma unroll
  for (int kk = 0; kk < NC; ++kk) {
    const int a_off = (w0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kk], q_s + a_off);
    ldmatrix_x4(df[kk], do_s + a_off);
  }
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w0 + g + 8 * r;
    const long long i =
        (static_cast<long long>(b) * p.seq_q + row) * p.heads + h;
    lse2[r] = row < p.seq_q ? p.lse[i] * LOG2E_F : 0.0f;
    dlt[r] = row < p.seq_q ? p.delta[i] : 0.0f;
  }

  float dq[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  const float scale_log2 = p.scale * LOG2E_F;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    const int k0 = (kt_lo + i) * BK;
    if (i + 1 < n_tiles) stage_kv(st ^ 1, k0 + BK);
    cp_async_commit();
    cp_async_wait<1>();         // tile i has landed; tile i + 1 in flight
    __syncthreads();

    const bf16* kb = k_s + st * BK * LDS;
    const bf16* vb = v_s + st * BK * LDS;
    const bool edge = edge_tile(p, q0, k0);
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += TC_PASS) {
      // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × TC_PASS keys per warp
      float s[NBP][4], dp[NBP][4];
#pragma unroll
      for (int n = 0; n < NBP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NBP / 2; ++n2) {
          unsigned kf[4], vf[4];
          const int b_off =
              (c0 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
              kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(kf, kb + b_off);
          ldmatrix_x4(vf, vb + b_off);
          mma_bf16_16816(s[2 * n2], qf[kk], kf[0], kf[1]);
          mma_bf16_16816(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
          mma_bf16_16816(dp[2 * n2], df[kk], vf[0], vf[1]);
          mma_bf16_16816(dp[2 * n2 + 1], df[kk], vf[2], vf[3]);
        }
      }
      // dS in place: element e of n-block n is row w0 + g + 8·(e/2), key
      // c0 + 8n + 2c + e%2
#pragma unroll
      for (int n = 0; n < NBP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge && !valid_pair(p, q0 + w0 + g + 8 * (e >> 1),
                                  k0 + c0 + n * 8 + 2 * c + (e & 1)))
            x = -INFINITY;
          const float pv = exp2f(x - lse2[e >> 1]);
          s[n][e] = pv * (dp[n][e] - dlt[e >> 1]) * p.scale;
        }
      // dQ += dS·K over 16 keys at a time: dS as a bf16 hi + lo A
      // fragment, K by ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < NBP / 2; ++kq) {
        unsigned hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* x = s[2 * kq + (j >> 1)] + 2 * (j & 1);
          split_bf16(x[0], x[1], hi[j], lo[j]);
        }
#pragma unroll
        for (int n2 = 0; n2 < NC; ++n2) {
          unsigned bk[4];
          ldmatrix_x4_trans(bk, kb + (c0 + kq * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LDS +
                                    n2 * 16 + (lane >> 4) * 8);
          mma_bf16_16816(dq[2 * n2], hi, bk[0], bk[1]);
          mma_bf16_16816(dq[2 * n2 + 1], hi, bk[2], bk[3]);
          mma_bf16_16816(dq[2 * n2], lo, bk[0], bk[1]);
          mma_bf16_16816(dq[2 * n2 + 1], lo, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();            // stage st is read: the next copy may land
  }

  // dq through this warp's own rows of the Q tile (only this warp read
  // them), rounded once to bf16
  __syncwarp();
  const long long row_stride = static_cast<long long>(p.heads) * D;
  store_rows_tc<NC>(q_s + w0 * LDS, dq, static_cast<bf16*>(p.dq) +
                        (static_cast<long long>(b) * p.seq_q * p.heads + h) *
                            D,
                    row_stride, q0 + w0, p.seq_q);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
static size_t dkv_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BK + 2 * BQ) * (D + 1) +
                          2 * BQ * (BK + 1) + 2 * BQ);
}
template <int D>
static size_t dq_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BK + 2 * BQ) * (D + 1) +
                          BQ * (BK + 1) + 2 * BQ);
}
// bf16: two tiles and two ring stages of two tiles (dK/dV adds lse and
// delta to each stage)
template <int D>
static size_t tc_smem(bool dq) {
  return sizeof(__nv_bfloat16) *
             static_cast<size_t>(2 * 64 + 2 * TC_STAGES * 64) * (D + 8) +
         (dq ? 0 : sizeof(float) * 2 * TC_STAGES * BQ);
}

template <typename Kern>
static int launch_kernel(Kern kern, size_t smem, int threads, dim3 grid,
                         const BParams& p, cudaStream_t stream) {
  if (smem > MAX_SMEM_BYTES) return -2;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// grids (tiles, b·H) and (tiles, b·Hkv), as the f32 instances always had
// them
template <int NC>
static int launch_f32(const BParams& p, bool dq, int batch,
                      cudaStream_t stream) {
  constexpr int D = 16 * NC;
  if (dq) {
    dim3 grid((p.seq_q + BQ - 1) / BQ, batch * p.heads);
    return launch_kernel(flash_bwd_dq_kernel<float, NC>, dq_smem<D>(),
                         NTHREADS, grid, p, stream);
  }
  dim3 grid((p.seq_k + BK - 1) / BK, batch * p.kv_heads);
  return launch_kernel(flash_bwd_dkv_kernel<float, NC>, dkv_smem<D>(),
                       NTHREADS, grid, p, stream);
}

// grids (b·H, q tiles) and (b·Hkv, key tiles): the tile on the slow axis
template <int NC>
static int launch_bf16(const BParams& p, bool dq, int batch,
                       cudaStream_t stream) {
  constexpr int D = 16 * NC;
  const int n_tiles = dq ? (p.seq_q + BQ - 1) / BQ : (p.seq_k + BK - 1) / BK;
  if (n_tiles > 65535) return -1;     // gridDim.y
  if (dq)
    return launch_kernel(flash_bwd_dq_kernel_tc<NC>, tc_smem<D>(true),
                         TC_THREADS, dim3(batch * p.heads, n_tiles), p,
                         stream);
  return launch_kernel(flash_bwd_dkv_kernel_tc<NC>, tc_smem<D>(false),
                       TC_THREADS, dim3(batch * p.kv_heads, n_tiles), p,
                       stream);
}

template <int NC>
static int launch(int dtype, const BParams& p, bool dq, int batch,
                  cudaStream_t stream) {
  return dtype == DT_F32 ? launch_f32<NC>(p, dq, batch, stream)
                         : launch_bf16<NC>(p, dq, batch, stream);
}

static int launch_d(int dtype, const BParams& p, int d, bool dq, int batch,
                    cudaStream_t stream) {
  switch (d) {
    case 16:  return launch<1>(dtype, p, dq, batch, stream);
    case 32:  return launch<2>(dtype, p, dq, batch, stream);
    case 48:  return launch<3>(dtype, p, dq, batch, stream);
    case 64:  return launch<4>(dtype, p, dq, batch, stream);
    case 80:  return launch<5>(dtype, p, dq, batch, stream);
    case 96:  return launch<6>(dtype, p, dq, batch, stream);
    case 112: return launch<7>(dtype, p, dq, batch, stream);
    case 128: return launch<8>(dtype, p, dq, batch, stream);
    default:  return -3;
  }
}

static int bwd_launch(bool dq, int dtype, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, void* out_a, void* out_b,
                      int batch, int seq_q, int seq_k, int heads,
                      int kv_heads, int head_dim, const long long* strides,
                      int causal, int window, int q_offset, float scale,
                      void* stream) {
  if (batch < 1 || seq_q < 1 || seq_k < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 ||
      static_cast<long long>(batch) * (dq ? heads : kv_heads) > 65535 ||
      window < 0 || (dtype != DT_F32 && dtype != DT_BF16))
    return -1;
  BParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq ? out_a : nullptr;
  p.dk = dq ? nullptr : out_a;
  p.dv = dq ? nullptr : out_b;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.kv_group = heads / kv_heads;
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  return launch_d(dtype, p, head_dim, dq, batch,
                  static_cast<cudaStream_t>(stream));
}

// Each returns 0, a cudaError_t code, or -1 (bad arguments) / -2 (the tiles
// need more shared memory than one block can have) / -3 (unsupported head
// dim).
//   strides: 12 element strides, (b, s, h) of q, k, v, then of do.
//   dk, dv: (B, Sk, Hkv, D) contiguous; dq: (B, Sq, H, D) contiguous.
extern "C" int flash_attn_bwd_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int batch,
    int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
    const long long* strides, int causal, int window, int q_offset,
    float scale, void* stream) {
  return bwd_launch(false, dtype, q, k, v, dout, lse, delta, dk, dv, batch,
                    seq_q, seq_k, heads, kv_heads, head_dim, strides, causal,
                    window, q_offset, scale, stream);
}

extern "C" int flash_attn_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int batch, int seq_q,
    int seq_k, int heads, int kv_heads, int head_dim,
    const long long* strides, int causal, int window, int q_offset,
    float scale, void* stream) {
  return bwd_launch(true, dtype, q, k, v, dout, lse, delta, dq, nullptr,
                    batch, seq_q, seq_k, heads, kv_heads, head_dim, strides,
                    causal, window, q_offset, scale, stream);
}

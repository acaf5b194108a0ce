// Flash-attention forward for Hopper (sm_90a): causal or bidirectional,
// sliding window, GQA, a query offset; f32 or bf16 inputs.
//
// Replaces the TPU kernels src/repro/kernels/flash_attn/flash_attn.py::
// flash_attention (_flash_kernel, pallas_call at :224) and
// flash_attention_fwd (_flash_fwd_lse_kernel, pallas_call at :282): one
// template per input type, whose LSE flag adds the row logsumexp the
// backward needs; the serving instances (LSE = false) do not compute or
// write it, and both give the same o bitwise. Bound from Python with
// ctypes (src/repro_torch/kernels/flash_attn/flash_attn.py).
//
// What it computes. q (B, Sq, H, D), k/v (B, Sk, Hkv, D) → o (B, Sq, H, D):
// query row i of head h sits at absolute position q_offset + i, key j at j,
// and reads kv head h / (H / Hkv). Key j is valid for row i when
//   j < Sk  and  (!causal or j <= q_offset + i)
//           and  (window <= 0 or j > q_offset + i - window);
// o = softmax(scale · q·kᵀ over the valid keys) · v, with the softmax in
// f32 and o cast to q's type. A row with no valid key is 0, as in the TPU
// kernel (its l = 0 guard), not the mean of v. With LSE, lse (B, Sq, H) f32
// gets m + log(l) of the scaled scores, or NEG_INF (-1e30) for a row with
// no valid key.
//
// Grid: one block per (q tile of 64 rows, b·H + h); there is no k-block
// grid axis. Each block walks the K/V tiles its rows can see, keeps the
// online-softmax state (row max m, row sum l) and the f32 output
// accumulator in registers, and skips the K/V tiles that causality or the
// window mask out entirely (a masked tile leaves m, l and the accumulator
// unchanged, so this is the same function with less work). The heaviest
// causal q tiles (the last) are scheduled first: the f32 instances order
// them within each head (grid (q tiles, b·H)), the bf16 ones across all
// heads (grid (b·H, q tiles), the q tile on the slow axis), so no heavy
// tile starts in the last wave. q, k and v are read in place through
// their (B, S, H) strides: no transposed copy and no repeat of the kv
// heads.
//
// What bounds it on the card. Causal prefill of S tokens does 4·D·S²/2
// flops per (b, h) against 2·(Sq + Sk)·D·bytes of traffic: at the serving
// shape (4 × 2048 tokens, 16/8 heads, D = 128, bf16) 6.9e10 flops against
// 134 MB, about 510 flop per byte, far above the H100's ridge (989 TFLOP/s
// bf16 / 3.35 TB/s ≈ 295), so the bound is the operations: ≈ 0.07 ms on
// the bf16 tensor cores.
//
// bf16 instances (flash_attn_kernel_tc): the tensor cores, so the bound is
// reachable in kind. Four warps, each owning 16 query rows of the tile.
//   * Both products are mma.sync.m16n8k16 bf16 × bf16 → f32. A bf16
//     product is exact in f32, so S = Q·Kᵀ differs from an f32 dot only in
//     summation order. Q's fragments are loaded once per block (ldmatrix)
//     and stay in registers; K fragments come by ldmatrix, V's by
//     ldmatrix.trans (V is staged key-major, as it lies in memory).
//   * P stays in registers: the f32 accumulator fragment of S has the
//     layout of the A operand of the P·V product, so P is fed back without
//     a trip through shared memory, as a bf16 pair: hi = p rounded to
//     nearest even, lo = (p − hi) rounded, and two products. One bf16
//     rounding (2^-9 relative) moves o by up to 2^-9 · Σ p|v| / l, which
//     broke the layer-0 bound of the served qwen3 on the card (|v| up to
//     60, max |diff| 0.125 against 2e-2 + 1e-2·|want|); hi + lo carries p
//     to 2^-17, so P·V is as good as an f32 product, for half again as
//     many tensor-core products (P·V twice). The row max and row sum are reduced over the four
//     lanes of a quad with warp shuffles; l and lse are summed from the
//     f32 p, as the reference sums them.
//   * Scores are kept in log2 units (the scale times log2 e, then exp2f,
//     a few instructions fewer than IEEE expf on the softmax's critical
//     path), with lse within 2e-6 of the plain version on the card (its
//     bound is 1e-5). A row with no valid key yet subtracts 0 instead of its -inf
//     max, so a masked score's exp2f(-inf) = 0 needs no select.
//   * K and V tiles are staged as bf16 by cp.async 16-byte copies into a
//     two-stage ring: the next tile's copy is in flight while the current
//     tile's products run. Rows past Sk are zero-filled, so a masked key
//     never meets a stale value. Each shared-memory row is padded by 16
//     bytes: its stride is an odd multiple of 16 bytes modulo 128 at every
//     D = 16·n, so the eight row addresses of each ldmatrix phase hit eight
//     distinct bank groups (a power-of-two XOR swizzle would break at
//     D = 48, 80 and 112).
//   * Only tiles that cross Sk, the causal diagonal or the window edge
//     evaluate the mask; interior tiles skip it.
//   * Shared memory: the Q tile and two K and two V stages, 87 KB at
//     D = 128, so two blocks share an SM; 128 threads a block, so each
//     thread may hold up to 255 registers (the D = 128 fragments: 64 f32
//     accumulators, 32 f32 scores, 32 words of Q). Tried on the card and
//     left out, each slower at D = 128: two 16-row m-tiles a warp (K/V
//     fragments shared, 255 registers), and S of the next tile issued
//     before this tile's softmax (K one stage ahead of V, 255 registers).
//     The latency of each warp's chain S → softmax → P·V, with two warps
//     a scheduler to hide it, is what the design loses to its bound;
//     wgmma's asynchronous warpgroup products are the next step.
//   * The output goes back through the warp's own rows of the Q tile, so
//     each row is written with 16-byte stores.
//   The caller guarantees 16-byte alignment of every row (the wrapper
//   checks each pointer and each (b, s, h) stride and raises otherwise).
//
// f32 instances (flash_attn_kernel): both products as FP32 FMAs on the
// CUDA cores (67 TFLOP/s peak, so never within 15× of the bound), kept
// because their bound against the plain version is 2e-5, which neither a
// bf16 nor a TF32 product can meet. Each of the 256 threads owns a 4 × 4
// micro-tile of the 64 × 64 score tile (rows tr + 16·i, keys tc + 16·j),
// so each shared-memory load feeds four FMAs; rows are padded by one word
// so the strided row reads hit distinct banks. The row statistics are
// reduced over the 16 threads of a row group with warp shuffles. P goes
// through shared memory once for the P·V product.
//
// Numerics: scores, softmax and accumulators in f32; the scale multiplies
// after the dot as in the TPU kernel, and o is divided by l at the end.
// The f32 instances take IEEE expf (never __expf), the bf16 ones exp2f
// (see above). Against the plain version (ref.py, dense f32 softmax) the
// difference is summation order and rounding: f32 atol 2e-5, bf16 atol
// 2e-2 on random-normal inputs, the bounds the reference holds its own
// kernel to; lse within 1e-5 in both.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "mma_tiles.cuh"   // cp.async, ldmatrix, mma.sync, bf16 packing

#define BQ 64                  // query rows per block
#define BK 64                  // keys per staged tile
#define NTHREADS 256           // f32: 16 row groups × 16 key/column lanes
#define TC_THREADS 128         // bf16: 4 warps × 16 query rows
#define TC_STAGES 2            // bf16: K/V ring depth
#define MAX_SMEM_BYTES 232448  // 227 KB, the opt-in limit of one block
#define NEG_INF_F (-1e30f)     // lse of a row with no valid key

enum { DT_F32 = 0, DT_BF16 = 1 };

struct FParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;                       // (B, Sq, H, D), contiguous, q's type
  float* lse;                    // (B, Sq, H), contiguous; LSE instances
  long long q_sb, q_ss, q_sh;    // element strides of b, s, h (d is 1)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int heads, kv_group, seq_q, seq_k, causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ void store_out(float* p, long long i, float v) {
  p[i] = v;
}

// Stage rows [row0, row0 + BQ|BK) of one head into shared memory as f32
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

template <typename T, int NC, bool LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_kernel(const FParams p) {
  constexpr int D = 16 * NC;
  constexpr int LDQ = D + 1;    // padded rows: conflict-free strided reads
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // BQ × LDQ
  float* k_s = q_s + BQ * LDQ;                        // BK × LDQ
  float* v_s = k_s + BK * LDQ;                        // BK × D
  float* p_s = v_s + BK * D;                          // BQ × LDP

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  // the heaviest causal tiles (the last q tiles) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.kv_group;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
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

  stage<T, D>(q_s, LDQ, q, p.q_ss, q0, p.seq_q, BQ);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  if (k_end > k_begin) {
    const int kt_lo = static_cast<int>(k_begin / BK);
    const int kt_hi = static_cast<int>((k_end - 1) / BK);
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();          // the previous tile's k_s, v_s, p_s are read
      stage<T, D>(k_s, LDQ, k, p.k_ss, k0, p.seq_k, BK);
      stage<T, D>(v_s, D, v, p.v_ss, k0, p.seq_k, BK);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_s[(tr + 16 * i) * LDQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = k_s[(tc + 16 * j) * LDQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long qpos = static_cast<long long>(p.q_offset) + q0 +
                               tr + 16 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tc + 16 * j;
          bool valid = kpos < p.seq_k;
          if (p.causal) valid = valid && kpos <= qpos;
          if (p.window > 0) valid = valid && kpos > qpos - p.window;
          s[i][j] = valid ? s[i][j] * p.scale : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        // the 16 lanes of a row group are 16 consecutive lanes of a warp
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pv = (s[i][j] == -INFINITY) ? 0.0f
                                                  : expf(s[i][j] - m_new);
          p_s[(tr + 16 * i) * LDP + tc + 16 * j] = pv;
          rs += pv;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        const float alpha = (m[i] == -INFINITY) ? 0.0f : expf(m[i] - m_new);
        l[i] = alpha * l[i] + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();          // p_s complete

#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = v_s[j * D + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = p_s[(tr + 16 * i) * LDP + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= p.seq_q) continue;
    const long long base =
        ((static_cast<long long>(b) * p.seq_q + row) * p.heads + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_out(o, base + tc + 16 * c, l[i] > 0.0f ? acc[i][c] / l[i] : 0.0f);
    if constexpr (LSE) {
      if (tc == 0)
        p.lse[(static_cast<long long>(b) * p.seq_q + row) * p.heads + h] =
            l[i] > 0.0f ? m[i] + logf(l[i]) : NEG_INF_F;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------

// Fragment layouts: mma_tiles.cuh. Each warp owns 16 query rows; its score
// tile is 8 n-blocks (64 keys), its output tile 2·NC of them (D columns).
template <int NC, bool LSE>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attn_kernel_tc(const FParams p) {
  typedef __nv_bfloat16 bf16;
  constexpr int D = 16 * NC;
  constexpr int LDS = D + 8;        // row stride in elements: + 16 bytes
  constexpr int CH = D / 8;         // 16-byte chunks per row
  constexpr int NB = BK / 8;        // score n-blocks per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);        // BQ × LDS
  bf16* k_s = q_s + BQ * LDS;                            // STAGES × BK × LDS
  bf16* v_s = k_s + TC_STAGES * BK * LDS;                // STAGES × BK × LDS

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  // q tiles on the slow grid axis, the last (heaviest causal) first: every
  // head's heaviest tiles are dispatched before any head's lighter ones
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.kv_group;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
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

  for (int idx = tid; idx < BQ * CH; idx += TC_THREADS) {
    const int r = idx / CH, ch = idx % CH;
    const bool ok = q0 + r < p.seq_q;
    cp_async_16(q_s + r * LDS + ch * 8,
                q + (ok ? (q0 + r) * p.q_ss : 0) + ch * 8, ok);
  }
  cp_async_commit();
  auto stage_kv = [&](int st, int k0) {
    bf16* kd = k_s + st * BK * LDS;
    bf16* vd = v_s + st * BK * LDS;
    for (int idx = tid; idx < BK * CH; idx += TC_THREADS) {
      const int r = idx / CH, ch = idx % CH;
      const bool ok = k0 + r < p.seq_k;
      const long long row = ok ? k0 + r : 0;
      cp_async_16(kd + r * LDS + ch * 8, k + row * p.k_ss + ch * 8, ok);
      cp_async_16(vd + r * LDS + ch * 8, v + row * p.v_ss + ch * 8, ok);
    }
  };
  if (n_tiles > 0) stage_kv(0, kt_lo * BK);
  cp_async_commit();            // one group even when empty: uniform waits
  cp_async_wait<1>();           // Q has landed
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of D
  const int w0 = warp * 16;
  unsigned qf[NC][4];
#pragma unroll
  for (int kk = 0; kk < NC; ++kk)
    ldmatrix_x4(qf[kk], q_s + (w0 + (lane & 15)) * LDS + kk * 16 +
                            (lane >> 4) * 8);

  float acc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const long long row_pos[2] = {pos_lo + w0 + g, pos_lo + w0 + g + 8};
  // scores in log2 units: exp2f(x·scale·log2 e − m) = expf(x·scale − m')
  const float scale_log2 = p.scale * 1.44269504088896341f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    const int k0 = (kt_lo + i) * BK;
    if (i + 1 < n_tiles) stage_kv(st ^ 1, k0 + BK);
    cp_async_commit();
    cp_async_wait<1>();         // tile i has landed; tile i + 1 in flight
    __syncthreads();

    // S = Q·Kᵀ, 16 rows × 64 keys per warp
    const bf16* kb = k_s + st * BK * LDS;
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, kb + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  LDS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * n2], qf[kk], bfr[0], bfr[1]);
        mma_bf16_16816(s[2 * n2 + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale; the mask only on tiles that cross Sk, the diagonal or the
    // window edge
    const bool edge = k0 + BK > p.seq_k ||
                      (p.causal && k0 + BK - 1 > pos_lo) ||
                      (p.window > 0 && k0 <= pos_hi - p.window);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * c + (e & 1);
          const long long qpos = row_pos[e >> 1];
          bool valid = kpos < p.seq_k;
          if (p.causal) valid = valid && kpos <= qpos;
          if (p.window > 0) valid = valid && kpos > qpos - p.window;
          if (!valid) x = -INFINITY;
        }
        s[n][e] = x;
      }

    // online softmax for rows g and g + 8 (the four lanes of a quad share
    // them); a masked score is -inf and exp2f(-inf) = 0, and a row with
    // no valid key yet subtracts 0 instead of its -inf max
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_sub = (m_new == -INFINITY) ? 0.0f : m_new;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - m_sub);
          rs += s[n][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      alpha[r] = exp2f(m[r] - m_sub);
      l[r] = alpha[r] * l[r] + rs;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P·V: P from the score registers as a bf16 hi + lo pair (two
    // products), V by ldmatrix.trans
    const bf16* vb = v_s + st * BK * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {     // the A fragment's four registers
        const float* x = s[2 * kk + (j >> 1)] + 2 * (j & 1);
        split_bf16(x[0], x[1], hi[j], lo[j]);
      }
#pragma unroll
      for (int n2 = 0; n2 < NC; ++n2) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, vb + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LDS +
                                   n2 * 16 + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * n2], hi, bfr[0], bfr[1]);
        mma_bf16_16816(acc[2 * n2 + 1], hi, bfr[2], bfr[3]);
        mma_bf16_16816(acc[2 * n2], lo, bfr[0], bfr[1]);
        mma_bf16_16816(acc[2 * n2 + 1], lo, bfr[2], bfr[3]);
      }
    }
    __syncthreads();            // stage st is read: the next copy may land
  }

  // o through this warp's own rows of the Q tile, then 16-byte stores
  __syncwarp();
  bf16* o_s = q_s + w0 * LDS;
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = l[r] > 0.0f ? acc[n][2 * r] / l[r] : 0.0f;
      const float x1 = l[r] > 0.0f ? acc[n][2 * r + 1] / l[r] : 0.0f;
      *reinterpret_cast<unsigned*>(o_s + (g + 8 * r) * LDS + n * 8 + 2 * c) =
          pack_bf16(x0, x1);
    }
  __syncwarp();
  bf16* o = static_cast<bf16*>(p.o);
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, ch = idx % CH;
    const int row = q0 + w0 + r;
    if (row >= p.seq_q) continue;
    const long long base =
        ((static_cast<long long>(b) * p.seq_q + row) * p.heads + h) * D;
    *reinterpret_cast<uint4*>(o + base + ch * 8) =
        *reinterpret_cast<const uint4*>(o_s + r * LDS + ch * 8);
  }
  if constexpr (LSE) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + w0 + g + 8 * r;
      if (c == 0 && row < p.seq_q)
        p.lse[(static_cast<long long>(b) * p.seq_q + row) * p.heads + h] =
            l[r] > 0.0f ? m[r] * 0.693147180559945309f + logf(l[r])
                        : NEG_INF_F;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
static int launch_kernel(Kern kern, size_t smem, int threads, dim3 grid,
                         const FParams& p, cudaStream_t stream) {
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

// grid (q tiles, b·H), as the f32 instances always had it
template <int NC, bool LSE>
static int launch_f32(const FParams& p, int n_bh, cudaStream_t stream) {
  constexpr int D = 16 * NC;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BQ + BK) * (D + 1) + BK * D +
                       BQ * (BK + 1));
  return launch_kernel(flash_attn_kernel<float, NC, LSE>, smem, NTHREADS,
                       dim3((p.seq_q + BQ - 1) / BQ, n_bh), p, stream);
}

// grid (b·H, q tiles): see flash_attn_kernel_tc
template <int NC, bool LSE>
static int launch_bf16(const FParams& p, int n_bh, cudaStream_t stream) {
  constexpr int D = 16 * NC;
  const size_t smem = sizeof(__nv_bfloat16) *
                      static_cast<size_t>(BQ + 2 * TC_STAGES * BK) * (D + 8);
  const int n_qtiles = (p.seq_q + BQ - 1) / BQ;
  if (n_qtiles > 65535) return -1;    // gridDim.y
  return launch_kernel(flash_attn_kernel_tc<NC, LSE>, smem, TC_THREADS,
                       dim3(n_bh, n_qtiles), p, stream);
}

template <int NC, bool LSE>
static int launch(int dtype, const FParams& p, int n_bh,
                  cudaStream_t stream) {
  return dtype == DT_F32 ? launch_f32<NC, LSE>(p, n_bh, stream)
                         : launch_bf16<NC, LSE>(p, n_bh, stream);
}

template <bool LSE>
static int launch_d(int dtype, const FParams& p, int d, int n_bh,
                    cudaStream_t stream) {
  switch (d) {
    case 16:  return launch<1, LSE>(dtype, p, n_bh, stream);
    case 32:  return launch<2, LSE>(dtype, p, n_bh, stream);
    case 48:  return launch<3, LSE>(dtype, p, n_bh, stream);
    case 64:  return launch<4, LSE>(dtype, p, n_bh, stream);
    case 80:  return launch<5, LSE>(dtype, p, n_bh, stream);
    case 96:  return launch<6, LSE>(dtype, p, n_bh, stream);
    case 112: return launch<7, LSE>(dtype, p, n_bh, stream);
    case 128: return launch<8, LSE>(dtype, p, n_bh, stream);
    default:  return -3;
  }
}

template <bool LSE>
static int fwd_launch(int dtype, const void* q, const void* k, const void* v,
                      void* o, float* lse, int batch, int seq_q, int seq_k,
                      int heads, int kv_heads, int head_dim,
                      const long long* strides, int causal, int window,
                      int q_offset, float scale, void* stream) {
  if (batch < 1 || seq_q < 1 || seq_k < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || static_cast<long long>(batch) * heads > 65535 ||
      window < 0 || (dtype != DT_F32 && dtype != DT_BF16) ||
      (LSE && lse == nullptr))
    return -1;
  FParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.heads = heads;
  p.kv_group = heads / kv_heads;
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  return launch_d<LSE>(dtype, p, head_dim, batch * heads,
                       static_cast<cudaStream_t>(stream));
}

// Returns 0, a cudaError_t code, or -1 (bad arguments) / -2 (the tile needs
// more shared memory than one block can have) / -3 (unsupported head dim).
//   strides: 9 element strides, (b, s, h) of q, then of k, then of v.
extern "C" int flash_attn_launch(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int batch,
                                 int seq_q, int seq_k, int heads,
                                 int kv_heads, int head_dim,
                                 const long long* strides, int causal,
                                 int window, int q_offset, float scale,
                                 void* stream) {
  return fwd_launch<false>(dtype, q, k, v, o, nullptr, batch, seq_q, seq_k,
                           heads, kv_heads, head_dim, strides, causal,
                           window, q_offset, scale, stream);
}

// The training forward: as flash_attn_launch, and lse (B, Sq, H) f32.
extern "C" int flash_attn_fwd_lse_launch(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, float* lse, int batch,
                                         int seq_q, int seq_k, int heads,
                                         int kv_heads, int head_dim,
                                         const long long* strides,
                                         int causal, int window,
                                         int q_offset, float scale,
                                         void* stream) {
  return fwd_launch<true>(dtype, q, k, v, o, lse, batch, seq_q, seq_k,
                          heads, kv_heads, head_dim, strides, causal, window,
                          q_offset, scale, stream);
}

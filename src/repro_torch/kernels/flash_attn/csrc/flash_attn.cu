// Flash-attention forward for Hopper (sm_90a): causal or bidirectional,
// sliding window, GQA, a query offset; f32 or bf16 inputs.
//
// Replaces the TPU kernels src/repro/kernels/flash_attn/flash_attn.py::
// flash_attention (_flash_kernel) and flash_attention_fwd
// (_flash_fwd_lse_kernel): one template, whose LSE flag adds the row
// logsumexp the backward needs; the serving instances (LSE = false) do
// not compute or write it. Bound from Python with ctypes
// (src/repro_torch/kernels/flash_attn/flash_attn.py).
//
// What it computes. q (B, Sq, H, D), k/v (B, Sk, Hkv, D) → o (B, Sq, H, D):
// query row i of head h sits at absolute position q_offset + i, key j at j,
// and reads kv head h / (H / Hkv). Key j is valid for row i when
//   j < Sk  and  (!causal or j <= q_offset + i)
//           and  (window <= 0 or j > q_offset + i - window);
// o = softmax(scale · q·kᵀ over the valid keys) · v, with the softmax and
// both products in f32 and o cast to q's type. A row with no valid key is
// 0, as in the TPU kernel (its l = 0 guard), not the mean of v. With LSE,
// lse (B, Sq, H) f32 gets m + log(l) of the scaled scores, or NEG_INF
// (-1e30) for a row with no valid key.
//
// Grid: one block per (q tile of BQ rows, b·H + h); there is no k-block
// grid axis. Each block walks the K/V tiles its rows can see, staging each
// in shared memory, and keeps the online-softmax state (row max m, row sum
// l) and the f32 output accumulator in registers. q, k and v are read in
// place through their (B, S, H) strides: no transposed copy and no repeat
// of the kv heads. K/V tiles that causality or the window mask out entirely
// are skipped (a masked tile leaves m, l and the accumulator unchanged, so
// this is the same function with less work).
//
// What bounds it on the card. Per (b, h) causal prefill of S tokens does
// 4·D·S²/2 flops against 2·(Sq + Sk)·D·bytes of traffic: at the serving
// shape (4 × 2048 tokens, 16/8 heads, D = 128, bf16) 6.9e10 flops against
// 134 MB, about 510 flop per byte, far above the H100's ridge (989 TFLOP/s
// bf16 / 3.35 TB/s ≈ 295), so the bound is the operations: ≈ 0.07 ms on the
// bf16 tensor cores. This first kernel runs both products as FP32 FMAs on
// the CUDA cores (67 TFLOP/s peak), so it cannot come within 15× of that
// bound; wgmma/mma.sync tensor-core tiles and TMA staging are later work.
//
// What the design does about it. Each of the 256 threads owns a 4 × 4
// micro-tile of the BQ × BK score tile (rows tr + 16·i, keys tc + 16·j),
// so each shared-memory load feeds four FMAs; rows are padded by one word
// so the strided row reads hit distinct banks. The row statistics are
// reduced over the 16 threads of a row group with warp shuffles. P goes
// through shared memory once for the P·V product, where each thread owns
// the same 4 rows × D/16 output columns.
//
// Numerics: dots and exponentials in f32 (fmaf, expf — never __expf),
// scale multiplied after the dot as in the TPU kernel, division by l at
// the end. Against the plain version (ref.py, dense f32 softmax) the
// difference is rounding: f32 atol 2e-5, bf16 atol 2e-2 on random-normal
// inputs, the bounds the reference holds its own kernel to.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define BQ 64                  // query rows per block
#define BK 64                  // keys per staged tile
#define NTHREADS 256           // 16 row groups × 16 key/column lanes
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
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_out(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, long long i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
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

template <typename T, int NC, bool LSE>
static int launch(const FParams& p, int n_qtiles, int n_bh,
                  cudaStream_t stream) {
  constexpr int D = 16 * NC;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BQ + BK) * (D + 1) + BK * D +
                       BQ * (BK + 1));
  if (smem > MAX_SMEM_BYTES) return -2;
  auto kern = flash_attn_kernel<T, NC, LSE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n_qtiles, n_bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LSE>
static int launch_d(const FParams& p, int d, int n_qtiles, int n_bh,
                    cudaStream_t stream) {
  switch (d) {
    case 16:  return launch<T, 1, LSE>(p, n_qtiles, n_bh, stream);
    case 32:  return launch<T, 2, LSE>(p, n_qtiles, n_bh, stream);
    case 48:  return launch<T, 3, LSE>(p, n_qtiles, n_bh, stream);
    case 64:  return launch<T, 4, LSE>(p, n_qtiles, n_bh, stream);
    case 80:  return launch<T, 5, LSE>(p, n_qtiles, n_bh, stream);
    case 96:  return launch<T, 6, LSE>(p, n_qtiles, n_bh, stream);
    case 112: return launch<T, 7, LSE>(p, n_qtiles, n_bh, stream);
    case 128: return launch<T, 8, LSE>(p, n_qtiles, n_bh, stream);
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
  const int n_qtiles = (seq_q + BQ - 1) / BQ;
  const int n_bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_d<float, LSE>(p, head_dim, n_qtiles, n_bh, s);
  return launch_d<__nv_bfloat16, LSE>(p, head_dim, n_qtiles, n_bh, s);
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

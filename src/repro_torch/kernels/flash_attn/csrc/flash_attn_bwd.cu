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
// dk and dv come out at Hkv heads: the dK/dV kernel sums the GQA group in
// its f32 registers and rounds once to the input type (the TPU kernel
// writes them at H heads in the input type and its caller sums them, so in
// bf16 it rounds twice). All arithmetic in f32 (fmaf, expf).
//
// Grids. dK/dV: one block per (K tile of BK keys, b·Hkv + kv head). The K
// and V tiles stay in shared memory; the block walks the q heads of its
// GQA group and, for each, the q tiles that causality and the window let
// see the K tile, staging each Q/dO tile with its lse and delta, and
// accumulates dK and dV in registers: no atomics, deterministic. dQ: one
// block per (q tile of BQ rows, b·H + h); Q, dO, lse and delta stay in
// shared memory and the block walks the visible K/V tiles, accumulating dQ
// in registers. Both read q, k, v and do in place through their (B, S, H)
// strides. The TPU grid's innermost sequential axis (with dk/dv or dq in
// VMEM scratch) is the loop inside the block here.
//
// What bounds them on the card. Per (b, h), a causal backward over S
// tokens recomputes s and dp and forms two more products: dK/dV does four
// D·S²/2 products (s, dp, dv, dk), dQ three (s, dp, dq). At the training
// shape (4 × 2048 tokens, 16/8 heads, D = 128, bf16) that is 1.37e11 and
// 1.03e11 flops against ~100 MB of traffic each: far above the H100's
// ridge, so the bound is the operations, 0.139 ms and 0.104 ms at the bf16
// tensor-core peak. These first kernels run every product as FP32 FMAs on
// the CUDA cores (67 TFLOP/s peak), like the forward; tensor-core tiles and
// TMA staging are later work.
//
// What the design does about it. As in the forward, each of the 256
// threads owns a 4 × 4 micro-tile of the BQ × BK score tile for the two
// recomputed products (rows tr + 16·i, keys tc + 16·j), rows padded by one
// word so the strided reads hit distinct banks. P and dS go through shared
// memory once; for dK/dV each thread then owns 4 key rows × D/16 columns
// of both accumulators, for dQ 4 query rows × D/16 columns. At D = 128 the
// staged tiles take 162 KB (dK/dV) and 146 KB (dQ) of shared memory, past
// the 48 KB default, so each launch opts in with cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define BQ 64                  // query rows per tile
#define BK 64                  // keys per tile
#define NTHREADS 256           // 16 row groups × 16 key/column lanes
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

template <typename Kern>
static int launch_kernel(Kern kern, size_t smem, dim3 grid,
                         const BParams& p, cudaStream_t stream) {
  if (smem > MAX_SMEM_BYTES) return -2;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
static int launch(const BParams& p, bool dq, int batch,
                  cudaStream_t stream) {
  constexpr int D = 16 * NC;
  if (dq) {
    dim3 grid((p.seq_q + BQ - 1) / BQ, batch * p.heads);
    return launch_kernel(flash_bwd_dq_kernel<T, NC>, dq_smem<D>(), grid, p,
                         stream);
  }
  dim3 grid((p.seq_k + BK - 1) / BK, batch * p.kv_heads);
  return launch_kernel(flash_bwd_dkv_kernel<T, NC>, dkv_smem<D>(), grid, p,
                       stream);
}

template <typename T>
static int launch_d(const BParams& p, int d, bool dq, int batch,
                    cudaStream_t stream) {
  switch (d) {
    case 16:  return launch<T, 1>(p, dq, batch, stream);
    case 32:  return launch<T, 2>(p, dq, batch, stream);
    case 48:  return launch<T, 3>(p, dq, batch, stream);
    case 64:  return launch<T, 4>(p, dq, batch, stream);
    case 80:  return launch<T, 5>(p, dq, batch, stream);
    case 96:  return launch<T, 6>(p, dq, batch, stream);
    case 112: return launch<T, 7>(p, dq, batch, stream);
    case 128: return launch<T, 8>(p, dq, batch, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_d<float>(p, head_dim, dq, batch, s);
  return launch_d<__nv_bfloat16>(p, head_dim, dq, batch, s);
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

// Fused L-layer CNN equalizer for Hopper (sm_90a): fp32, bf16 and int8.
//
// Replaces the TPU kernels of src/repro/kernels/cnn_eq/cnn_eq.py:
//   MODE_FP32  ::_cnn_eq_kernel with conv_valid_taps       (cnn_eq_fused)
//   MODE_BF16  ::_cnn_eq_kernel with conv_valid_taps_bf16  (cnn_eq_fused_bf16)
//   MODE_INT8  ::_cnn_eq_kernel_int8                       (cnn_eq_fused_int8)
// One template, three instantiations, one plain extern "C" launcher bound
// from Python with ctypes (src/repro_torch/kernels/cnn_eq/cnn_eq.py).
//
// What it computes. Block (tile, row) produces tile_m final positions
// (tile_m·V_p symbols) of one row from its overlapping window of in_tile
// samples of the halo-padded input (the padding is done in Python, as in
// the reference's _fused_call). Per layer: VALID strided conv, ReLU between
// layers, last layer linear; output interleaved as symbol m·V_p + c.
//
// What bounds it on the card. At the paper's widths (L=3, K=9, C=5, V_p=8,
// N_os=2) the stack costs 56.25 MAC = 112.5 FLOP per symbol and moves 8 B
// of fp32 input and 4 B of output per symbol: about 9.4 FLOP/B, below the
// H100's fp32 ridge (67 TFLOP/s / 3.35 TB/s ≈ 20 FLOP/B). So the bound is
// the bytes. At the deployment shape (64 rows × 7320 symbols, 5.6 MB) that
// bound is under 2 µs, below one launch's overhead.
//
// What the design does about it. The whole stack is fused: each input
// sample is read from device memory once per tile window (plus the halo
// overlap), the inter-layer activations never leave shared memory
// (ping-pong buffers, __syncthreads between layers), and each output is
// written once, coalesced. The per-tap products are far below MMA sizes
// (C=5, K=9), so there are no tensor cores: plain FP32/INT32 lanes.
// Making it fast (more positions per thread, fewer bank conflicts, CUDA
// graphs against the launch overhead) is later work.
//
// Numerics. Every output accumulates tap-major, then C_in ascending, one
// product at a time from zero, bias last — the order of the plain versions
// in ref.py. fp32 uses __fmul_rn/__fadd_rn, which nvcc never contracts
// into FMAs (the file is also built with --fmad=false), so each kernel is
// bitwise equal to its plain version. bf16: inputs rounded with
// __float2bfloat16_rn, products exact in fp32, fp32 sums. int8: requant
// with rintf (half to even), clamp in float, then convert; int32
// accumulation; (float)acc · 2^-(wf+af) + b.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#define MAX_LAYERS 8
#define BLOCK_THREADS 256
#define MAX_SMEM_BYTES 232448   // 227 KB, the opt-in limit of one block

enum { MODE_FP32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };

struct Layer {
  const void* w;       // (rows|1, C_out, C_in, K): float, bf16 or int8
  const float* b;      // (rows|1, C_out)
  const float* scale;  // (C_out,) int8 rescale, shared by all rows
  int k, c_in, c_out, stride, n_out;   // n_out: positions out per tile
  float a_scale, a_lo, a_hi;           // int8 requant of this layer's input
};

struct Params {
  const float* xp;     // (rows, xp_width) halo-padded input
  float* out;          // (rows, out_width), out_width = n_tiles·tile_m·V_p
  int xp_width, out_width, tile_step, in_tile, tile_m;
  int n_layers, stacked, act_words, w_words, b_words;
  Layer layer[MAX_LAYERS];
};

__device__ __forceinline__ int requant(float v, float scale, float lo,
                                       float hi) {
  float q = rintf(__fmul_rn(v, scale));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int>(q);
}

// a layer-input value as the datapath consumes it
template <int MODE>
__device__ __forceinline__ typename std::conditional<MODE == MODE_INT8, int,
                                                     float>::type
to_act(float v, const Layer& ly) {
  if constexpr (MODE == MODE_INT8) {
    return requant(v, ly.a_scale, ly.a_lo, ly.a_hi);
  } else if constexpr (MODE == MODE_BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <int MODE>
__device__ __forceinline__ typename std::conditional<MODE == MODE_INT8, int,
                                                     float>::type
load_w(const void* w, int i) {
  if constexpr (MODE == MODE_INT8) {
    return static_cast<int>(static_cast<const int8_t*>(w)[i]);
  } else if constexpr (MODE == MODE_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  } else {
    return static_cast<const float*>(w)[i];
  }
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK_THREADS)
cnn_eq_kernel(const Params p) {
  using act_t = typename std::conditional<MODE == MODE_INT8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  act_t* buf0 = reinterpret_cast<act_t*>(smem_raw);
  act_t* buf1 = buf0 + p.act_words;
  act_t* wsm = buf1 + p.act_words;                    // all layers' weights
  float* bsm = reinterpret_cast<float*>(wsm + p.w_words);   // biases
  float* ssm = bsm + p.b_words;                       // int8 rescales

  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // stage every layer's weights, biases (and rescales) in shared memory;
  // stacked launches read this row's set, shared ones row 0
  int w_off = 0, b_off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& ly = p.layer[l];
    const int nw = ly.c_out * ly.c_in * ly.k;
    const long w_row = p.stacked ? static_cast<long>(row) * nw : 0;
    const long b_row = p.stacked ? static_cast<long>(row) * ly.c_out : 0;
    for (int i = tid; i < nw; i += nt)
      wsm[w_off + i] = load_w<MODE>(ly.w, static_cast<int>(w_row + i));
    for (int i = tid; i < ly.c_out; i += nt) {
      bsm[b_off + i] = ly.b[b_row + i];
      if (MODE == MODE_INT8) ssm[b_off + i] = ly.scale[i];
    }
    w_off += nw;
    b_off += ly.c_out;
  }

  // stage this tile's input window, converted for layer 0
  const float* x = p.xp + static_cast<long>(row) * p.xp_width +
                   static_cast<long>(tile) * p.tile_step;
  for (int i = tid; i < p.in_tile; i += nt)
    buf0[i] = to_act<MODE>(x[i], p.layer[0]);
  __syncthreads();

  act_t* in = buf0;
  act_t* nxt = buf1;
  int n_in = p.in_tile;
  w_off = 0;
  b_off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& ly = p.layer[l];
    const bool last = (l == p.n_layers - 1);
    const int k = ly.k, c_in = ly.c_in, c_out = ly.c_out;
    const int stride = ly.stride, n_out = ly.n_out;
    const int total = c_out * n_out;
    for (int idx = tid; idx < total; idx += nt) {
      // the last layer walks symbol-major so the global store coalesces
      const int c = last ? idx % c_out : idx / n_out;
      const int m = last ? idx / c_out : idx % n_out;
      const act_t* wc = wsm + w_off + c * c_in * k;
      const act_t* xm = in + m * stride;
      float h;
      if constexpr (MODE == MODE_INT8) {
        int acc = 0;
        for (int kk = 0; kk < k; ++kk)
          for (int ci = 0; ci < c_in; ++ci)
            acc += wc[ci * k + kk] * xm[ci * n_in + kk];
        h = __fadd_rn(__fmul_rn(static_cast<float>(acc), ssm[b_off + c]),
                      bsm[b_off + c]);
      } else {
        float acc = 0.0f;
        for (int kk = 0; kk < k; ++kk)
          for (int ci = 0; ci < c_in; ++ci)
            acc = __fadd_rn(acc, __fmul_rn(wc[ci * k + kk],
                                           xm[ci * n_in + kk]));
        h = __fadd_rn(acc, bsm[b_off + c]);
      }
      if (last) {
        p.out[static_cast<long>(row) * p.out_width +
              static_cast<long>(tile) * p.tile_m * c_out + idx] = h;
      } else {
        h = h > 0.0f ? h : 0.0f;                       // ReLU
        nxt[c * n_out + m] = to_act<MODE>(h, p.layer[l + 1]);
      }
    }
    __syncthreads();
    act_t* t = in;
    in = nxt;
    nxt = t;
    n_in = n_out;
    w_off += c_out * c_in * k;
    b_off += c_out;
  }
}

template <int MODE>
static int launch(const Params& p, int n_tiles, int rows, size_t smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cnn_eq_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n_tiles, rows);
  cnn_eq_kernel<MODE><<<grid, BLOCK_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Returns 0, a cudaError_t code, or -1 (bad arguments) / -2 (the tile
// needs more shared memory than one block can have).
//   dims: n_layers × (k, c_in, c_out, stride, n_out)
//   aq:   n_layers × (a_scale, a_lo, a_hi)       (int8; else ignored)
//   ptrs: n_layers × (w, b, scale)               (scale: int8 only)
extern "C" int cnn_eq_launch(int mode, const void* xp, void* out, int rows,
                             int n_tiles, int xp_width, int out_width,
                             int tile_step, int in_tile, int tile_m,
                             int n_layers, int stacked, const void* dims_v,
                             const void* aq_v, const void* ptrs_v,
                             void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || rows < 1 || n_tiles < 1 ||
      rows > 65535 || mode < MODE_FP32 || mode > MODE_INT8)
    return -1;
  const int* dims = static_cast<const int*>(dims_v);
  const float* aq = static_cast<const float*>(aq_v);
  const void* const* ptrs = static_cast<const void* const*>(ptrs_v);
  Params p;
  p.xp = static_cast<const float*>(xp);
  p.out = static_cast<float*>(out);
  p.xp_width = xp_width;
  p.out_width = out_width;
  p.tile_step = tile_step;
  p.in_tile = in_tile;
  p.tile_m = tile_m;
  p.n_layers = n_layers;
  p.stacked = stacked;
  long act_words = in_tile, w_words = 0, b_words = 0;
  for (int l = 0; l < n_layers; ++l) {
    Layer& ly = p.layer[l];
    ly.k = dims[5 * l + 0];
    ly.c_in = dims[5 * l + 1];
    ly.c_out = dims[5 * l + 2];
    ly.stride = dims[5 * l + 3];
    ly.n_out = dims[5 * l + 4];
    ly.a_scale = aq[3 * l + 0];
    ly.a_lo = aq[3 * l + 1];
    ly.a_hi = aq[3 * l + 2];
    ly.w = ptrs[3 * l + 0];
    ly.b = static_cast<const float*>(ptrs[3 * l + 1]);
    ly.scale = static_cast<const float*>(ptrs[3 * l + 2]);
    if (ly.k < 1 || ly.c_in < 1 || ly.c_out < 1 || ly.stride < 1 ||
        ly.n_out < 1 || (l == 0 && ly.c_in != 1))
      return -1;
    if (l < n_layers - 1 && static_cast<long>(ly.c_out) * ly.n_out > act_words)
      act_words = static_cast<long>(ly.c_out) * ly.n_out;
    w_words += static_cast<long>(ly.c_out) * ly.c_in * ly.k;
    b_words += ly.c_out;
  }
  p.act_words = static_cast<int>(act_words);
  p.w_words = static_cast<int>(w_words);
  p.b_words = static_cast<int>(b_words);
  const size_t smem = 4 * static_cast<size_t>(2 * act_words + w_words +
                                              2 * b_words);
  if (smem > MAX_SMEM_BYTES) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FP32: return launch<MODE_FP32>(p, n_tiles, rows, smem, s);
    case MODE_BF16: return launch<MODE_BF16>(p, n_tiles, rows, smem, s);
    default:        return launch<MODE_INT8>(p, n_tiles, rows, smem, s);
  }
}

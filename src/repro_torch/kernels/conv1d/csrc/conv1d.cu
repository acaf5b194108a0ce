// Strided VALID 1-D convolution (NCW) plus bias, for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/conv1d/conv1d.py::conv1d
// (_conv1d_kernel). Bound from Python with ctypes
// (src/repro_torch/kernels/conv1d/conv1d.py).
//
// What it computes. Block (tile, row) produces tile_w output positions of
// every output channel of one row, from its overlapping input window of
// in_tile = (tile_w-1)*stride + K samples per input channel (the wrapper
// pads the right edge so every window is in bounds, as the reference's
// wrapper does):
//   y[c, m] = (sum_kk sum_ci w[c, ci, kk] * x[ci, m*stride + kk]) + b[c]
// summed tap-major, then C_in ascending, one product at a time from zero,
// bias last — the order of the fused cnn_eq kernel and of the plain
// version (kernels/cnn_eq/ref.py::conv_valid_taps).
//
// What bounds it on the card. Per output position (all C_out channels) a
// layer does C_out*C_in*K MACs and moves C_in*stride input and C_out output
// floats: layer 1 of the equalizer (1->5, stride 8) 90 FLOP per 52 B,
// layer 2 (5->5) 450 FLOP per 40 B, layer 3 (5->8, stride 2) 720 FLOP per
// 72 B. All sit below the H100's fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20
// FLOP/B), so each layer is bound by its bytes.
//
// What the design does about it. The input window (C_in x in_tile), the
// weights and the bias live in shared memory; one thread per (c_out,
// position), position-fastest so the global stores coalesce; scalar FP32
// lanes (C and K are far below MMA sizes). Fusing the layers (what
// cnn_eq does) is what removes the intermediate traffic.
//
// Numerics: __fmul_rn/__fadd_rn (never contracted; built with
// --fmad=false), so kernel == plain bitwise at any tile width.
#include <cuda_runtime.h>

#define BLOCK_THREADS 256
#define MAX_SMEM_BYTES 232448   // 227 KB, the opt-in limit of one block

struct CParams {
  const float* x;      // (rows, c_in, x_width), right-padded
  const float* w;      // (c_out, c_in, k)
  const float* b;      // (c_out,)
  float* out;          // (rows, c_out, out_width), out_width = n_tiles*tile_w
  int x_width, out_width, c_in, c_out, k, stride, tile_w, in_tile;
};

__global__ void __launch_bounds__(BLOCK_THREADS)
conv1d_kernel(const CParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);    // c_in * in_tile
  float* ws = xs + p.c_in * p.in_tile;               // c_out * c_in * k
  float* bs = ws + p.c_out * p.c_in * p.k;           // c_out

  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const long start = static_cast<long>(tile) * p.tile_w * p.stride;
  const float* x = p.x + static_cast<long>(row) * p.c_in * p.x_width + start;
  for (int i = tid; i < p.c_in * p.in_tile; i += nt) {
    const int ci = i / p.in_tile, j = i % p.in_tile;
    xs[i] = x[static_cast<long>(ci) * p.x_width + j];
  }
  for (int i = tid; i < p.c_out * p.c_in * p.k; i += nt) ws[i] = p.w[i];
  for (int i = tid; i < p.c_out; i += nt) bs[i] = p.b[i];
  __syncthreads();

  const int k = p.k, c_in = p.c_in, stride = p.stride;
  float* out = p.out + static_cast<long>(row) * p.c_out * p.out_width +
               static_cast<long>(tile) * p.tile_w;
  for (int idx = tid; idx < p.c_out * p.tile_w; idx += nt) {
    const int c = idx / p.tile_w, m = idx % p.tile_w;
    const float* wc = ws + c * c_in * k;
    const float* xm = xs + m * stride;
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk)
      for (int ci = 0; ci < c_in; ++ci)
        acc = __fadd_rn(acc, __fmul_rn(wc[ci * k + kk],
                                       xm[ci * p.in_tile + kk]));
    out[static_cast<long>(c) * p.out_width + m] = __fadd_rn(acc, bs[c]);
  }
}

// Returns 0, a cudaError_t code, or -1 (bad arguments) / -2 (the tile
// needs more shared memory than one block can have).
extern "C" int conv1d_launch(const void* x, const void* w, const void* b,
                             void* out, int rows, int n_tiles, int x_width,
                             int out_width, int c_in, int c_out, int k,
                             int stride, int tile_w, void* stream) {
  const long in_tile = static_cast<long>(tile_w - 1) * stride + k;
  if (rows < 1 || rows > 65535 || n_tiles < 1 || c_in < 1 || c_out < 1 ||
      k < 1 || stride < 1 || tile_w < 1 || out_width != n_tiles * tile_w ||
      static_cast<long>(n_tiles - 1) * tile_w * stride + in_tile > x_width)
    return -1;
  CParams p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<float*>(out);
  p.x_width = x_width;
  p.out_width = out_width;
  p.c_in = c_in;
  p.c_out = c_out;
  p.k = k;
  p.stride = stride;
  p.tile_w = tile_w;
  p.in_tile = static_cast<int>(in_tile);
  const size_t smem = 4 * (static_cast<size_t>(c_in) * in_tile +
                           static_cast<size_t>(c_out) * c_in * k + c_out);
  if (smem > MAX_SMEM_BYTES) return -2;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n_tiles, rows);
  conv1d_kernel<<<grid, BLOCK_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Volterra-series equalizer, orders 0-3, for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/volterra/volterra.py::volterra
// (_volterra_kernel). Bound from Python with ctypes
// (src/repro_torch/kernels/volterra/volterra.py).
//
// What it computes. Block (tile, row) produces `tile` output symbols of one
// row from its overlapping window of in_tile = (tile-1)*stride + 2*halo + 1
// samples of the input, which Python has padded once by the common halo
// max(m1/2, m2/2, m3/2) (as the reference's wrapper does). Symbol n reads
// window r of order r at xp[n*stride + halo - m_r/2 + j], j < m_r, and
//   o1 = sum_m win1[m] w1[m]
//   o2 = sum_k (sum_j win2[j] W2[j,k]) win2[k]
//   o3 = sum_i win3[i] sum_k (sum_j win3[j] W3[i,j,k]) win3[k]
//   y  = ((w0 + o1) + o2) + o3
// Orders 2 and 3 are off when their memory length is 0.
//
// What bounds it on the card. Per symbol it reads N_os = 2 fp32 samples
// (8 B) and writes one (4 B); it does m1 + m2^2 + m2 + m3^3 + m3^2 + m3
// MACs. At the trained baseline (25, 9, 0) that is 115 MAC = 230 FLOP per
// 12 B, about 19 FLOP/B, just under the H100's fp32 ridge (67 TFLOP/s /
// 3.35 TB/s = 20 FLOP/B), so bytes and operations bound it about equally
// (~1.7 us at 64 x 7320 symbols). At (121, 35, 15) the third order makes it
// operation-bound (~5000 MAC = 10 kFLOP per symbol).
//
// What the design does about it. The input window and all weights live in
// shared memory (W3 at m3 = 15 is 13.5 KB, W2 at m2 = 35 is 4.9 KB); each
// thread computes whole symbols with scalar FP32 lanes (the contractions
// are far below MMA sizes, and the order of every sum is fixed). The
// weight reads are broadcasts (every thread reads the same W element), the
// window reads are stride-N_os. Making it fast (register-blocked windows,
// symmetric-kernel folding, tensor cores for large m3) is later work.
//
// Numerics. Every sum runs in the order above, one product at a time from
// zero, with __fmul_rn/__fadd_rn (never contracted into FMAs; the file is
// also built with --fmad=false), which is the order of the plain version
// (ref.py). So kernel == plain bitwise at any tile width.
#include <cuda_runtime.h>

#define BLOCK_THREADS 256
#define MAX_SMEM_BYTES 232448   // 227 KB, the opt-in limit of one block

struct VParams {
  const float* xp;     // (rows, xp_width) halo-padded input
  float* out;          // (rows, out_width), out_width = n_tiles * tile
  const float* w0;     // (1,)
  const float* w1;     // (m1,)
  const float* w2;     // (m2, m2) or null
  const float* w3;     // (m3, m3, m3) or null
  int xp_width, out_width, tile, stride, m1, m2, m3, halo, in_tile;
};

__global__ void __launch_bounds__(BLOCK_THREADS)
volterra_kernel(const VParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);   // in_tile samples
  float* w1s = xs + p.in_tile;                      // m1
  float* w2s = w1s + p.m1;                          // m2 * m2
  float* w3s = w2s + p.m2 * p.m2;                   // m3 * m3 * m3

  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const float* x = p.xp + static_cast<long>(row) * p.xp_width +
                   static_cast<long>(tile) * p.tile * p.stride;
  for (int i = tid; i < p.in_tile; i += nt) xs[i] = x[i];
  for (int i = tid; i < p.m1; i += nt) w1s[i] = p.w1[i];
  for (int i = tid; i < p.m2 * p.m2; i += nt) w2s[i] = p.w2[i];
  for (int i = tid; i < p.m3 * p.m3 * p.m3; i += nt) w3s[i] = p.w3[i];
  __syncthreads();

  const float w0 = p.w0[0];
  const int m1 = p.m1, m2 = p.m2, m3 = p.m3;
  float* out = p.out + static_cast<long>(row) * p.out_width +
               static_cast<long>(tile) * p.tile;
  for (int t = tid; t < p.tile; t += nt) {
    const float* xw = xs + t * p.stride + p.halo;   // centre of symbol t
    const float* x1 = xw - m1 / 2;
    float o1 = 0.0f;
    for (int m = 0; m < m1; ++m)
      o1 = __fadd_rn(o1, __fmul_rn(x1[m], w1s[m]));
    float y = __fadd_rn(w0, o1);

    if (m2 > 0) {
      const float* x2 = xw - m2 / 2;
      float o2 = 0.0f;
      for (int k = 0; k < m2; ++k) {
        float tk = 0.0f;
        for (int j = 0; j < m2; ++j)
          tk = __fadd_rn(tk, __fmul_rn(x2[j], w2s[j * m2 + k]));
        o2 = __fadd_rn(o2, __fmul_rn(tk, x2[k]));
      }
      y = __fadd_rn(y, o2);
    }

    if (m3 > 0) {
      const float* x3 = xw - m3 / 2;
      float o3 = 0.0f;
      for (int i = 0; i < m3; ++i) {
        const float* wi = w3s + i * m3 * m3;
        float si = 0.0f;
        for (int k = 0; k < m3; ++k) {
          float tk = 0.0f;
          for (int j = 0; j < m3; ++j)
            tk = __fadd_rn(tk, __fmul_rn(x3[j], wi[j * m3 + k]));
          si = __fadd_rn(si, __fmul_rn(tk, x3[k]));
        }
        o3 = __fadd_rn(o3, __fmul_rn(x3[i], si));
      }
      y = __fadd_rn(y, o3);
    }
    out[t] = y;
  }
}

// Returns 0, a cudaError_t code, or -1 (bad arguments) / -2 (the tile
// needs more shared memory than one block can have).
extern "C" int volterra_launch(const void* xp, void* out, const void* w0,
                               const void* w1, const void* w2,
                               const void* w3, int rows, int n_tiles,
                               int xp_width, int out_width, int tile,
                               int stride, int m1, int m2, int m3, int halo,
                               int in_tile, void* stream) {
  if (rows < 1 || rows > 65535 || n_tiles < 1 || tile < 1 || stride < 1 ||
      m1 < 1 || m2 < 0 || m3 < 0 || (m2 > 0 && !w2) || (m3 > 0 && !w3) ||
      in_tile != (tile - 1) * stride + 2 * halo + 1 ||
      static_cast<long>(n_tiles - 1) * tile * stride + in_tile > xp_width)
    return -1;
  VParams p;
  p.xp = static_cast<const float*>(xp);
  p.out = static_cast<float*>(out);
  p.w0 = static_cast<const float*>(w0);
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
  p.w3 = static_cast<const float*>(w3);
  p.xp_width = xp_width;
  p.out_width = out_width;
  p.tile = tile;
  p.stride = stride;
  p.m1 = m1;
  p.m2 = m2;
  p.m3 = m3;
  p.halo = halo;
  p.in_tile = in_tile;
  const size_t smem = 4 * (static_cast<size_t>(in_tile) + m1 +
                           static_cast<size_t>(m2) * m2 +
                           static_cast<size_t>(m3) * m3 * m3);
  if (smem > MAX_SMEM_BYTES) return -2;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        volterra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = tile < BLOCK_THREADS ? tile : BLOCK_THREADS;
  dim3 grid(n_tiles, rows);
  volterra_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Fixed-point fake quantization to signed Q(i).(f), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quant/quant.py::
// fixed_point_quantize (_quant_kernel). Bound from Python with ctypes
// (src/repro_torch/kernels/quant/quant.py).
//
// What it computes, per element:
//   scale = 2^f,  hi = 2^i - 1/scale,  lo = -2^i
//   y = clamp(rint(x * scale) / scale, lo, hi)
// rint rounds half to even (jnp.round's rule; never roundf), the division
// is a true division (never a multiply by the reciprocal), and the clamp is
// min(max(., lo), hi). The widths (i, f) are runtime values read from a
// 2-float DEVICE buffer, the analogue of the TPU kernel's SMEM scalars: a
// host scalar would cost a device-to-host sync per call when the learned
// widths live on the card, a compile-time constant a rebuild per width.
//
// What bounds it on the card: bytes. One 4 B read and one 4 B write per
// element against a handful of FP32 operations, far below the H100's ridge
// (20 FLOP/B), so the floor is 8 B per element at 3.35 TB/s; a call on
// the ~1.1 K weights of a trained equalizer is pure launch latency.
//
// What the design does about it. One thread per element, consecutive
// threads on consecutive addresses (coalesced), a grid-stride loop, the
// two widths loaded once per thread. Vectorised 16 B accesses are later
// work.
//
// Numerics: __fmul_rn and __fdiv_rn (IEEE, never contracted), exp2f, and
// the plain version (ref.py) runs the same operations in the same order,
// so kernel == plain bitwise; at integer widths every step but the
// rounding is exact.
#include <cuda_runtime.h>

#define BLOCK_THREADS 256

__global__ void __launch_bounds__(BLOCK_THREADS)
quant_kernel(const float* __restrict__ x, float* __restrict__ y,
             const float* __restrict__ bits, long n) {
  const float scale = exp2f(bits[1]);
  const float hi = exp2f(bits[0]) - __fdiv_rn(1.0f, scale);
  const float lo = -exp2f(bits[0]);
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<long>(gridDim.x) * blockDim.x) {
    const float q = __fdiv_rn(rintf(__fmul_rn(x[i], scale)), scale);
    y[i] = fminf(fmaxf(q, lo), hi);
  }
}

// Returns 0, a cudaError_t code, or -1 (bad arguments).
extern "C" int quant_launch(const void* x, void* y, const void* bits, long n,
                            void* stream) {
  if (n < 1 || !x || !y || !bits) return -1;
  long blocks = (n + BLOCK_THREADS - 1) / BLOCK_THREADS;
  if (blocks > 65535L * 32) blocks = 65535L * 32;   // grid-stride beyond
  quant_kernel<<<static_cast<unsigned>(blocks), BLOCK_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(bits), n);
  return static_cast<int>(cudaGetLastError());
}

// Volterra-series equalizer, orders 0-3, for Hopper (sm_90a): float32,
// bfloat16 and float16 inputs, float32 arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/volterra/volterra.py::volterra
// (_volterra_kernel). Bound from Python with ctypes
// (src/repro_torch/kernels/volterra/volterra.py). Two templates: the
// generic volterra_kernel below (any memory lengths), and, after it,
// volterra_kernel_rb, register-blocked and specialized to the deployed
// baseline VolterraConfig() = (M1, M2, M3) = (25, 9, 0) at N_os = 2
// (volterra_plan); every other shape, the DSE's (41, 15, 9) and
// (121, 35, 15) among them, runs the generic one.
//
// Element types. x and y are float32, bfloat16 or float16 (T; the dtype
// codes of the launchers: 0, 1, 2). Each sample is widened to float32 as
// it is staged, every sum runs in float32, and each output is rounded once
// to T as it is stored (__float2bfloat16_rn / __float2half_rn), as the
// reference computes in f32 and writes x's type. The weights arrive in
// float32 (the wrapper widens 16-bit weights, which is exact).
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
// What the generic design does about it. The input window and all weights
// live in shared memory (W3 at m3 = 15 is 13.5 KB, W2 at m2 = 35 is
// 4.9 KB); each thread computes whole symbols with scalar FP32 lanes (the
// contractions are far below MMA sizes, and the order of every sum is
// fixed). Every MAC reads both operands from shared memory: the weight as
// a broadcast, the window sample at a stride of N_os words (a 2-way bank
// conflict at N_os = 2). volterra_kernel_rb below is the fast design for
// the shape it is specialized to.
//
// Numerics. Every sum runs in the order above, one product at a time from
// zero, with __fmul_rn/__fadd_rn (never contracted into FMAs; the file is
// also built with --fmad=false), which is the order of the plain version
// (ref.py). So kernel == plain bitwise at any tile width, in every type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#define BLOCK_THREADS 256
#define MAX_SMEM_BYTES 232448   // 227 KB, the opt-in limit of one block

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// a sample widened to float32, and a float32 result rounded once to T
__device__ __forceinline__ float v_load(float v) { return v; }
__device__ __forceinline__ float v_load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float v_load(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T v_store(float v);
template <>
__device__ __forceinline__ float v_store<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 v_store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half v_store<__half>(float v) {
  return __float2half_rn(v);
}

struct VParams {
  const void* xp;      // (rows, xp_width) halo-padded input, T
  void* out;           // (rows, out_width), out_width = n_tiles * tile, T
  const float* w0;     // (1,)
  const float* w1;     // (m1,)
  const float* w2;     // (m2, m2) or null
  const float* w3;     // (m3, m3, m3) or null
  int xp_width, out_width, tile, stride, m1, m2, m3, halo, in_tile;
};

template <typename T>
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

  const T* x = static_cast<const T*>(p.xp) +
               static_cast<long>(row) * p.xp_width +
               static_cast<long>(tile) * p.tile * p.stride;
  for (int i = tid; i < p.in_tile; i += nt) xs[i] = v_load(x[i]);
  for (int i = tid; i < p.m1; i += nt) w1s[i] = p.w1[i];
  for (int i = tid; i < p.m2 * p.m2; i += nt) w2s[i] = p.w2[i];
  for (int i = tid; i < p.m3 * p.m3 * p.m3; i += nt) w3s[i] = p.w3[i];
  __syncthreads();

  const float w0 = p.w0[0];
  const int m1 = p.m1, m2 = p.m2, m3 = p.m3;
  T* out = static_cast<T*>(p.out) + static_cast<long>(row) * p.out_width +
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
    out[t] = v_store<T>(y);
  }
}

template <typename T>
static int v_launch_generic(const VParams& p, dim3 grid, int threads,
                            size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        volterra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  volterra_kernel<T><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The generic kernel on a halo-padded input of type dtype (0 float32, 1
// bfloat16, 2 float16). Returns 0, a cudaError_t code, or -1 (bad
// arguments) / -2 (the tile needs more shared memory than one block can
// have).
extern "C" int volterra_launch(int dtype, const void* xp, void* out,
                               const void* w0, const void* w1,
                               const void* w2, const void* w3, int rows,
                               int n_tiles, int xp_width, int out_width,
                               int tile, int stride, int m1, int m2, int m3,
                               int halo, int in_tile, void* stream) {
  if (dtype < DT_F32 || dtype > DT_F16 || rows < 1 || rows > 65535 ||
      n_tiles < 1 || tile < 1 || stride < 1 || m1 < 1 || m2 < 0 || m3 < 0 ||
      (m2 > 0 && !w2) || (m3 > 0 && !w3) ||
      in_tile != (tile - 1) * stride + 2 * halo + 1 ||
      static_cast<long>(n_tiles - 1) * tile * stride + in_tile > xp_width)
    return -1;
  VParams p;
  p.xp = xp;
  p.out = out;
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
  const int threads = tile < BLOCK_THREADS ? tile : BLOCK_THREADS;
  const dim3 grid(n_tiles, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return v_launch_generic<float>(p, grid, threads, smem, s);
    case DT_BF16:
      return v_launch_generic<__nv_bfloat16>(p, grid, threads, smem, s);
    default: return v_launch_generic<__half>(p, grid, threads, smem, s);
  }
}

// ===========================================================================
// The register-blocked instances: volterra_kernel_rb<T, M1, M2, S, P>
// ===========================================================================
//
// What they replace. volterra_kernel above at the deployed baseline,
// VolterraConfig() = (M1, M2, M3) = (25, 9, 0) at N_os = S = 2, in float32,
// bfloat16 and float16, which the deploy path (kernels/volterra/ops.py::
// equalize) runs once. `volterra_plan` picks them for exactly that shape.
// Order 3 is off there (M3 = 0), so the template has no third order.
//
// What bounds them. At 64 rows x 7320 symbols the bytes take 1.68 us at
// 3.35 TB/s. The fixed order costs a __fmul_rn and a __fadd_rn a MAC:
// 230 FP32 instructions a symbol, ~3.2 us of FP32 issue on 132 SMs.
// The generic kernel is bound by neither: every MAC reads its window
// sample (2-way bank conflict) and its weight from shared memory, ~336
// shared-memory wavefronts a warp of 32 symbols, ~20 us at this shape.
//
// What the design does about it.
//   * Compile-time memory lengths: every loop unrolls, every window index
//     and weight offset is a constant.
//   * Block (run, row) computes w_run output symbols of one row (grid
//     (ceil(n_out / w_run), rows)), VR_THREADS threads, each thread P
//     adjacent symbols a task.
//   * Staging: the block's window of S·ld samples goes to shared memory as
//     float32, split into S phase rows (sample e in row e % S, at e / S), so
//     the strided reads of adjacent tasks hit adjacent words; a row stride
//     ≡ 32/S (mod 32) words (S > 1) puts the staging stores of a warp on
//     distinct banks.
//   * Padding in the kernel: it reads the unpadded input (any row stride)
//     and takes +0 for a sample before 0 or past the width, as F.pad does.
//     No copy kernel runs before it.
//   * Register blocking (P = VR_PSYM = 4 symbols a task, at 512 symbols a
//     block: the sweep's best, 64 registers, no spills): a task loads its
//     (P-1)·S + 25 window samples into registers once, as P-float vectors
//     of each phase row; order 2's window is the centre of order 1's and
//     reuses the same registers. Each weight read serves P MACs: w1 and W2 live in shared memory as
//     rows of float4 (W2 transposed, so the inner j loop of a column k
//     reads contiguous, broadcast float4s; a layout change, not a change
//     of order).
//   * The order is the plain version's (and the generic kernel's): o1,
//     then o2 as sum_k (sum_j x[j]·W2[j,k])·x[k], then y = (w0 + o1) + o2,
//     one __fmul_rn / __fadd_rn pair at a time from zero. So rb == plain
//     == generic, bitwise, at every run and P. No symmetric folding of W2:
//     it would change the order.
// Every thread reaches every barrier: no thread returns early.

#define VR_THREADS 128
#define VR_MIN_BLOCKS 8          // ≤ 64 registers a thread
#define VR_STAGE 8               // input samples a thread reads at once
#define VR_PSYM 4                // symbols a thread a task
#define VR_W2T 1                 // W2 transposed in shared memory (0: as is)

__host__ __device__ constexpr int vr_cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int vr_rup(int a, int b) {
  return vr_cdiv(a, b) * b;
}
__host__ __device__ constexpr int vr_max(int a, int b) { return a > b ? a : b; }

// The geometry of one block, in floats and bytes from the start of the
// dynamic buffer.
struct VRLayout {
  int tasks;                    // P-symbol tasks a block
  int ld;                       // floats a phase row
  int off_w1, off_w2, bytes;
};

template <int M1, int M2, int S, int P>
struct VR {
  static constexpr int HALO = vr_max(M1 / 2, M2 / 2);
  static constexpr int OFF1 = HALO - M1 / 2;    // order r's window starts
  static constexpr int OFF2 = HALO - M2 / 2;    // at e = q·S + OFF_r
  static constexpr int SPAN = vr_max(OFF1 + M1, OFF2 + M2);
  static constexpr int E = (P - 1) * S + SPAN;  // a task's window samples
  static constexpr int NV = vr_cdiv(vr_cdiv(E, S), P);   // vectors a row
  static constexpr int M1P = vr_rup(M1, 4);     // rows of float4
  static constexpr int M2P = vr_rup(M2, 4);
  static_assert(32 % S == 0, "phase rows land on distinct banks");
  static_assert(P == 1 || P == 2 || P == 4, "P is 1, 2 or 4");
  static_assert(M1 >= 1 && M2 >= 1, "orders 1 and 2 on");

  __host__ __device__ static VRLayout layout(int w_run) {
    VRLayout L{};
    L.tasks = vr_cdiv(w_run, P);
    const int need = (L.tasks - 1) * P + NV * P;
    L.ld = S == 1 ? vr_rup(need, 4)
                  : vr_rup(vr_max(need, 32 / S) - 32 / S, 32) + 32 / S;
    int off = vr_rup(4 * S * L.ld, 16);
    L.off_w1 = off;
    off += 4 * M1P;
    L.off_w2 = off;
    off += 4 * M2 * M2P;
    L.bytes = vr_rup(off, 16);
    return L;
  }
};

struct VRParams {
  const void* x;           // (rows, width), strides (x_row, 1), T
  void* out;               // (rows, n_out), contiguous, T
  const float* w0;         // (1,)
  const float* w1;         // (M1,)
  const float* w2;         // (M2, M2)
  long long x_row;
  int width, n_out, w_run;
  VRLayout lay;
};

// P floats from 4·P-byte aligned shared memory
template <int P>
__device__ __forceinline__ void vr_vec(const float* src, float* dst) {
  if constexpr (P == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
  } else if constexpr (P == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    dst[0] = q.x; dst[1] = q.y;
  } else {
    dst[0] = src[0];
  }
}

// N table entries into shared memory by NT threads, every read of a thread
// before its stores (compile-time trip counts: the reads are in flight
// together)
template <int N, int NT, typename F>
__device__ __forceinline__ void vr_stage(float* dst, F value) {
  constexpr int U = vr_cdiv(N, NT);
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * NT;
    v[u] = i < N ? value(i) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i < N) dst[i] = v[u];
  }
}

// a compiler-only fence at the top of each task: the weight reads do not
// depend on the task, and without it the compiler may hoist them all out
// of the task loop
__device__ __forceinline__ void vr_task_fence() {
  asm volatile("" ::: "memory");
}

template <typename T, int M1, int M2, int S, int P>
__global__ void __launch_bounds__(VR_THREADS, VR_MIN_BLOCKS)
volterra_kernel_rb(const VRParams p) {
  using G = VR<M1, M2, S, P>;
  constexpr int nt = VR_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VRLayout& L = p.lay;
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* w1s = reinterpret_cast<float*>(smem_raw + L.off_w1);
  float* w2s = reinterpret_cast<float*>(smem_raw + L.off_w2);
  const int row = blockIdx.y;
  const int m0 = blockIdx.x * p.w_run;         // first output symbol
  const int tid = threadIdx.x;
  const int ld = L.ld;

  // ---- stage: w1 and W2 as zero-padded rows of float4, the input's
  // ---- phase rows as float32
  vr_stage<G::M1P, nt>(w1s, [&](int i) { return i < M1 ? p.w1[i] : 0.0f; });
#if VR_W2T
  vr_stage<M2 * G::M2P, nt>(w2s, [&](int i) {   // row k holds W2[:, k]
    const int k = i / G::M2P, j = i % G::M2P;
    return j < M2 ? p.w2[j * M2 + k] : 0.0f;
  });
#else
  vr_stage<M2 * M2, nt>(w2s, [&](int i) { return p.w2[i]; });
#endif
  const T* x = static_cast<const T*>(p.x) + row * p.x_row;
  const int start = m0 * S - G::HALO;          // x index of window sample 0
  const int n_slots = S * ld;
  for (int i0 = tid; i0 < n_slots; i0 += VR_STAGE * nt) {
    float v[VR_STAGE];
#pragma unroll
    for (int u = 0; u < VR_STAGE; ++u) {
      const int i = i0 + u * nt, xi = start + i;
      v[u] = i < n_slots && xi >= 0 && xi < p.width ? v_load(x[xi]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < VR_STAGE; ++u) {
      const int i = i0 + u * nt;
      if (i < n_slots) xs[(i % S) * ld + i / S] = v[u];
    }
  }
  __syncthreads();

  // ---- P adjacent symbols a task
  const float w0 = p.w0[0];
  T* out = static_cast<T*>(p.out) + static_cast<long long>(row) * p.n_out +
           m0;
  const int n_here = min(p.w_run, p.n_out - m0);
  for (int g = tid; g < L.tasks; g += nt) {
    vr_task_fence();
    const int base = g * P;
    // the task's window: sample e (from symbol base's first) in registers
    float xw[G::E];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int v = 0; v < G::NV; ++v) {
        float q[P];
        vr_vec<P>(xs + r * ld + base + v * P, q);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int e = (v * P + i) * S + r;
          if (e < G::E) xw[e] = q[i];
        }
      }

    float y[P];
    {   // order 1: o1 = sum_m win1[m] w1[m]
      float o1[P];
#pragma unroll
      for (int q = 0; q < P; ++q) o1[q] = 0.0f;
#pragma unroll
      for (int m4 = 0; m4 < G::M1P / 4; ++m4) {
        const float4 w4 = reinterpret_cast<const float4*>(w1s)[m4];
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int m = 4 * m4 + mm;
          if (m < M1)
#pragma unroll
            for (int q = 0; q < P; ++q)
              o1[q] = __fadd_rn(o1[q],
                                __fmul_rn(xw[q * S + G::OFF1 + m], wv[mm]));
        }
      }
#pragma unroll
      for (int q = 0; q < P; ++q) y[q] = __fadd_rn(w0, o1[q]);
    }
    {   // order 2: o2 = sum_k (sum_j win2[j] W2[j,k]) win2[k]
      float o2[P];
#pragma unroll
      for (int q = 0; q < P; ++q) o2[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < M2; ++k) {
        float t[P];
#pragma unroll
        for (int q = 0; q < P; ++q) t[q] = 0.0f;
#if VR_W2T
#pragma unroll
        for (int j4 = 0; j4 < G::M2P / 4; ++j4) {
          const float4 w4 =
              reinterpret_cast<const float4*>(w2s + k * G::M2P)[j4];
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * j4 + jj;
            if (j < M2)
#pragma unroll
              for (int q = 0; q < P; ++q)
                t[q] = __fadd_rn(t[q],
                                 __fmul_rn(xw[q * S + G::OFF2 + j], wv[jj]));
          }
        }
#else
#pragma unroll
        for (int j = 0; j < M2; ++j) {
          const float w = w2s[j * M2 + k];
#pragma unroll
          for (int q = 0; q < P; ++q)
            t[q] = __fadd_rn(t[q], __fmul_rn(xw[q * S + G::OFF2 + j], w));
        }
#endif
#pragma unroll
        for (int q = 0; q < P; ++q)
          o2[q] = __fadd_rn(o2[q], __fmul_rn(t[q], xw[q * S + G::OFF2 + k]));
      }
#pragma unroll
      for (int q = 0; q < P; ++q) y[q] = __fadd_rn(y[q], o2[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (base + q < n_here) out[base + q] = v_store<T>(y[q]);
  }
}

// ---------------------------------------------------------------------------
// The plan: which kernel a shape runs, and at what run length
// ---------------------------------------------------------------------------
// (m1, m2, m3, stride) of the instance and the output symbols a block its
// plan runs (chosen by `python -m repro_torch.kernels.volterra.sweep`,
// which times other runs, and other P and the untransposed W2 as source
// variants)
static const int VR_SHAPE[4] = {25, 9, 0, 2};
static const int VR_W_RUN = 512;

static bool vr_instance(int m1, int m2, int m3, int stride) {
  return m1 == VR_SHAPE[0] && m2 == VR_SHAPE[1] && m3 == VR_SHAPE[2] &&
         stride == VR_SHAPE[3];
}

// Returns 1 and fills geom = (w_run, p, threads, shared-memory bytes) when
// (m1, m2, m3, stride) runs volterra_kernel_rb; 0 (geom zeroed) for
// volterra_kernel.
extern "C" int volterra_plan(int m1, int m2, int m3, int stride, int* geom) {
  geom[0] = geom[1] = geom[2] = geom[3] = 0;
  if (!vr_instance(m1, m2, m3, stride)) return 0;
  geom[0] = VR_W_RUN;
  geom[1] = VR_PSYM;
  geom[2] = VR_THREADS;
  geom[3] = VR<25, 9, 2, VR_PSYM>::layout(VR_W_RUN).bytes;
  return 1;
}

template <typename T>
static int vr_launch(const VRParams& p, dim3 grid, size_t smem,
                     cudaStream_t stream) {
  auto kern = volterra_kernel_rb<T, 25, 9, 2, VR_PSYM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, VR_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// volterra_kernel_rb at an explicit run (w_run output symbols a block):
// the sweep, chip_smoke.py and the card tests. y[n] for n < n_out reads
// x[n·stride - halo + e], taking +0 outside [0, width). Returns 0, a
// cudaError_t code, -1 (bad arguments), -2 (more shared memory than a
// block can have) or -3 (no register-blocked instance for this shape).
//   x: (rows, width) of type dtype, strides (x_row, 1)
//   w0 (1,), w1 (m1,), w2 (m2, m2): float32, contiguous
//   out: (rows, n_out) of type dtype, contiguous
extern "C" int volterra_rb_launch_at(int w_run, int dtype, const void* x,
                                     void* out, const void* w0,
                                     const void* w1, const void* w2,
                                     int rows, int width, long long x_row,
                                     int n_out, int m1, int m2, int m3,
                                     int stride, void* stream) {
  if (!vr_instance(m1, m2, m3, stride)) return -3;
  if (dtype < DT_F32 || dtype > DT_F16 || rows < 1 || rows > 65535 ||
      width < 1 || n_out < 1 || w_run < 1 || !x || !out || !w0 || !w1 ||
      !w2)
    return -1;
  VRParams p;
  p.lay = VR<25, 9, 2, VR_PSYM>::layout(w_run);
  if (p.lay.bytes > MAX_SMEM_BYTES) return -2;
  p.x = x;
  p.out = out;
  p.w0 = static_cast<const float*>(w0);
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
  p.x_row = x_row;
  p.width = width;
  p.n_out = n_out;
  p.w_run = w_run;
  const dim3 grid(vr_cdiv(n_out, w_run), rows);
  const size_t smem = static_cast<size_t>(p.lay.bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return vr_launch<float>(p, grid, smem, s);
    case DT_BF16: return vr_launch<__nv_bfloat16>(p, grid, smem, s);
    default: return vr_launch<__half>(p, grid, smem, s);
  }
}

// volterra_kernel_rb at the plan's run: what the wrapper launches when
// volterra_plan says so. Same arguments and codes as volterra_rb_launch_at.
extern "C" int volterra_rb_launch(int dtype, const void* x, void* out,
                                  const void* w0, const void* w1,
                                  const void* w2, int rows, int width,
                                  long long x_row, int n_out, int m1, int m2,
                                  int m3, int stride, void* stream) {
  int geom[4];
  if (!volterra_plan(m1, m2, m3, stride, geom)) return -3;
  return volterra_rb_launch_at(geom[0], dtype, x, out, w0, w1, w2, rows,
                               width, x_row, n_out, m1, m2, m3, stride,
                               stream);
}

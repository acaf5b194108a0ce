// Strided VALID 1-D convolution (NCW) plus bias, for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/conv1d/conv1d.py::conv1d
// (_conv1d_kernel). Bound from Python with ctypes
// (src/repro_torch/kernels/conv1d/conv1d.py). Two kernels: the generic
// conv1d_kernel below (any widths), and, after it, conv1d_kernel_rb,
// register-blocked and specialized to the three layer shapes of the
// deployed equalizer (conv1d_plan); every other shape runs the generic one.
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
// cnn_eq does) is what removes the intermediate traffic. Runtime widths
// and one output a thread: conv1d_kernel_rb below is the fast design for
// the shapes it is specialized to.
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

// ===========================================================================
// The register-blocked instances: conv1d_kernel_rb<K, C_IN, C_OUT, S, P>
// ===========================================================================
//
// What they replace. conv1d_kernel above at the three layer shapes of the
// deployed equalizer (equalizer_ht and equalizer_lp: K = 9; (C_in, C_out,
// stride) = (1, 5, 8), (5, 5, 1), (5, 8, 2)), which the deploy path
// (kernels/conv1d/ops.py::conv1d_same_lower) runs once each. `conv1d_plan`
// picks them for exactly those shapes.
//
// What bounds them. The bytes, as above: at 64 rows × 14 640 samples the
// three layers move 7.0, 5.6 and 4.2 MB, 1.8, 1.4 and 1.3 µs at 3.35 TB/s.
// The plain version's fixed order (a __fmul_rn and a __fadd_rn a MAC, no
// FMA) costs two FP32 instructions a MAC: layer 2's 26 M MACs take ~1.8 µs
// of FP32 issue on 132 SMs. At a few µs a launch, what decides is latency:
// one block's global reads while it stages, its chain of shared-memory
// reads and adds, and whether the grid fills the card.
//
// What the design does about it.
//   * Compile-time widths: every tap and channel loop unrolls, every weight
//     index is a constant.
//   * Block (run, row) computes w_run output positions of every output
//     channel (grid (ceil(w_out / w_run), rows)). It stages its input
//     window, C_in × ((w_run - 1)·S + K) samples, in shared memory, split
//     into S phase rows a channel (sample e in row e % S, at e / S), so that
//     the strided reads of adjacent positions hit adjacent words; a row
//     stride ≡ 32/S (mod 32) words (S > 1) puts the staging stores of a
//     warp on distinct banks.
//   * Padding in the kernel: it reads the unpadded input and takes +0 for
//     any sample before 0 or past the width, at a left offset pad_lo (0 for
//     the VALID conv1d, K/2 for SAME_LOWER), as F.pad does; the caller
//     names the output width. No copy kernel runs before it.
//   * Register blocking (P = C1_PPOS positions a thread): a thread computes
//     P adjacent positions of every output channel. One broadcast float4
//     read of a (tap, C_in) pair's weights serves P MACs a channel, one
//     P-float vector read of the inputs C_out MACs; the compiler reads each
//     vector once a task and keeps it while taps use it.
//   * The order is the plain version's: tap-major, then C_in ascending,
//     one __fmul_rn / __fadd_rn pair at a time from zero, bias last.
//   * Stores: the P positions of each output channel, lanes on adjacent
//     positions, so each channel row's stores cover whole sectors.
// Every thread reaches every barrier: no thread returns early.

#define C1_THREADS 128
#define C1_MIN_BLOCKS 8          // ≤ 64 registers a thread
#define C1_STAGE 8               // input samples a thread reads at once
#define C1_PPOS 2                // positions a thread

__host__ __device__ constexpr int c1_cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int c1_rup(int a, int b) {
  return c1_cdiv(a, b) * b;
}
__host__ __device__ constexpr int c1_max(int a, int b) { return a > b ? a : b; }

// The geometry of one block, in floats and bytes from the start of the
// dynamic buffer.
struct C1Layout {
  int tasks;                    // P-position tasks a block
  int ld;                       // floats a phase row
  int off_w, off_b, bytes;
};

template <int K, int C_IN, int C_OUT, int S, int P>
struct C1 {
  static constexpr int COP = c1_rup(C_OUT, 4);   // C_out padded (weights)
  static_assert(32 % S == 0, "phase rows land on distinct banks");
  static_assert(P == 1 || P == 2 || P == 4, "P is 1, 2 or 4");

  __host__ __device__ static C1Layout layout(int w) {
    C1Layout L{};
    L.tasks = c1_cdiv(w, P);
    // a task reads P + (K-1)/S floats of a row, as whole P-float vectors
    const int need = (L.tasks - 1) * P + c1_rup(P + (K - 1) / S, P);
    L.ld = S == 1 ? c1_rup(need, 4)
                  : c1_rup(c1_max(need, 32 / S) - 32 / S, 32) + 32 / S;
    int off = c1_rup(4 * C_IN * S * L.ld, 16);
    L.off_w = off;
    off += 4 * K * C_IN * COP;
    L.off_b = off;
    off += 4 * COP;
    L.bytes = c1_rup(off, 16);
    return L;
  }
};

struct C1RbParams {
  const float* x;          // (rows, C_in, width), strides x_row, x_ch, 1
  const float* w;          // (C_out, C_in, K)
  const float* b;          // (C_out,)
  float* out;              // (rows, C_out, w_out), contiguous
  long long x_row, x_ch;
  int width, pad_lo, w_out, w_run;
  C1Layout lay;
};

// element i of a window of P-float vectors from 4·P-byte aligned shared
// memory
template <int V>
__device__ __forceinline__ float c1_at(const float* src, int i) {
  if constexpr (V == 4) {
    const float4 q = reinterpret_cast<const float4*>(src)[i / 4];
    return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
  } else if constexpr (V == 2) {
    const float2 q = reinterpret_cast<const float2*>(src)[i / 2];
    return i % 2 == 0 ? q.x : q.y;
  } else {
    return src[i];
  }
}

// N table entries into shared memory by NT threads, every read of a thread
// before its stores (compile-time trip counts: the reads are in flight
// together)
template <int N, int NT, typename F>
__device__ __forceinline__ void c1_stage(float* dst, F value) {
  constexpr int U = c1_cdiv(N, NT);
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
__device__ __forceinline__ void c1_task_fence() {
  asm volatile("" ::: "memory");
}

template <int K, int C_IN, int C_OUT, int S, int P>
__global__ void __launch_bounds__(C1_THREADS, C1_MIN_BLOCKS)
conv1d_kernel_rb(const C1RbParams p) {
  using G = C1<K, C_IN, C_OUT, S, P>;
  constexpr int COP = G::COP;
  constexpr int nt = C1_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const C1Layout& L = p.lay;
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ws = reinterpret_cast<float*>(smem_raw + L.off_w);
  float* bs = reinterpret_cast<float*>(smem_raw + L.off_b);
  const int row = blockIdx.y;
  const int m0 = blockIdx.x * p.w_run;         // first output position
  const int tid = threadIdx.x;
  const int ld = L.ld;

  // ---- stage: weights as [kk][ci][c_out padded], bias, input phase rows
  c1_stage<K * C_IN * COP, nt>(ws, [&](int i) {
    const int kk = i / (C_IN * COP), ci = (i / COP) % C_IN, c = i % COP;
    return c < C_OUT ? p.w[(c * C_IN + ci) * K + kk] : 0.0f;
  });
  c1_stage<COP, nt>(bs, [&](int c) { return c < C_OUT ? p.b[c] : 0.0f; });
  const int start = m0 * S - p.pad_lo;         // x index of window sample 0
  const int n_slots = C_IN * S * ld;
  for (int i0 = tid; i0 < n_slots; i0 += C1_STAGE * nt) {
    float v[C1_STAGE];
#pragma unroll
    for (int u = 0; u < C1_STAGE; ++u) {
      const int i = i0 + u * nt;
      const int ci = i / (S * ld), xi = start + i % (S * ld);
      v[u] = i < n_slots && xi >= 0 && xi < p.width
                 ? p.x[row * p.x_row + ci * p.x_ch + xi]
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < C1_STAGE; ++u) {
      const int i = i0 + u * nt;
      const int ci = i / (S * ld), e = i % (S * ld);
      if (i < n_slots) xs[(ci * S + e % S) * ld + e / S] = v[u];
    }
  }
  __syncthreads();

  // ---- P adjacent positions of every output channel a task
  float* out = p.out + static_cast<long long>(row) * C_OUT * p.w_out + m0;
  const int n_here = min(p.w_run, p.w_out - m0);
  for (int g = tid; g < L.tasks; g += nt) {
    c1_task_fence();
    const int base = g * P;
    float acc[C_OUT][P];
#pragma unroll
    for (int c = 0; c < C_OUT; ++c)
#pragma unroll
      for (int q = 0; q < P; ++q) acc[c][q] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int ci = 0; ci < C_IN; ++ci) {
        float wv[COP];
#pragma unroll
        for (int j = 0; j < COP / 4; ++j) {
          const float4 q4 = reinterpret_cast<const float4*>(
              ws + (kk * C_IN + ci) * COP)[j];
          wv[4 * j] = q4.x; wv[4 * j + 1] = q4.y;
          wv[4 * j + 2] = q4.z; wv[4 * j + 3] = q4.w;
        }
        // tap kk of position base + q: phase row kk % S at base + q + kk / S
        const float* xrow = xs + (ci * S + kk % S) * ld + base;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float xv = c1_at<P>(xrow, q + kk / S);
#pragma unroll
          for (int c = 0; c < C_OUT; ++c)
            acc[c][q] = __fadd_rn(acc[c][q], __fmul_rn(wv[c], xv));
        }
      }
#pragma unroll
    for (int c = 0; c < C_OUT; ++c)
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (base + q < n_here)
          out[static_cast<long long>(c) * p.w_out + base + q] =
              __fadd_rn(acc[c][q], bs[c]);
  }
}

// ---------------------------------------------------------------------------
// The plan: which kernel a layer shape runs, and at what run length
// ---------------------------------------------------------------------------
// (k, c_in, c_out, stride) of each instance and the output positions a
// block its plan runs (chosen by `python -m repro_torch.kernels.conv1d.sweep`,
// which times other runs, and other P as source variants)
static const int C1_SHAPES[3][4] = {{9, 1, 5, 8}, {9, 5, 5, 1}, {9, 5, 8, 2}};
static const int C1_W_RUN[3] = {256, 256, 256};

static int c1_instance(int c_in, int c_out, int k, int stride) {
  for (int i = 0; i < 3; ++i)
    if (C1_SHAPES[i][0] == k && C1_SHAPES[i][1] == c_in &&
        C1_SHAPES[i][2] == c_out && C1_SHAPES[i][3] == stride)
      return i;
  return -1;
}

static C1Layout c1_layout(int inst, int w_run) {
  switch (inst) {
    case 0: return C1<9, 1, 5, 8, C1_PPOS>::layout(w_run);
    case 1: return C1<9, 5, 5, 1, C1_PPOS>::layout(w_run);
    default: return C1<9, 5, 8, 2, C1_PPOS>::layout(w_run);
  }
}

// Returns 1 and fills geom = (w_run, p, threads, shared-memory bytes) when
// (c_in, c_out, k, stride) runs conv1d_kernel_rb; 0 (geom zeroed) for
// conv1d_kernel.
extern "C" int conv1d_plan(int c_in, int c_out, int k, int stride,
                           int* geom) {
  geom[0] = geom[1] = geom[2] = geom[3] = 0;
  const int inst = c1_instance(c_in, c_out, k, stride);
  if (inst < 0) return 0;
  geom[0] = C1_W_RUN[inst];
  geom[1] = C1_PPOS;
  geom[2] = C1_THREADS;
  geom[3] = c1_layout(inst, C1_W_RUN[inst]).bytes;
  return 1;
}

template <int K, int C_IN, int C_OUT, int S>
static int c1_launch(const C1RbParams& p, dim3 grid, size_t smem,
                     cudaStream_t stream) {
  auto kern = conv1d_kernel_rb<K, C_IN, C_OUT, S, C1_PPOS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, C1_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// conv1d_kernel_rb at an explicit run (w_run output positions a block):
// the sweep, chip_smoke.py and the card tests. y[c, m] for m < w_out sums
// x[ci, m·stride + kk - pad_lo], taking +0 outside [0, width). Returns 0,
// a cudaError_t code, -1 (bad arguments), -2 (more shared memory than a
// block can have) or -3 (no register-blocked instance for this shape).
//   x: (rows, c_in, width) fp32, strides (x_row, x_ch, 1)
//   w: (c_out, c_in, k), b: (c_out,), out: (rows, c_out, w_out) contiguous
extern "C" int conv1d_rb_launch_at(int w_run, const void* x, const void* w,
                                   const void* b, void* out, int rows,
                                   int width, long long x_row,
                                   long long x_ch, int pad_lo, int w_out,
                                   int c_in, int c_out, int k, int stride,
                                   void* stream) {
  const int inst = c1_instance(c_in, c_out, k, stride);
  if (inst < 0) return -3;
  if (rows < 1 || rows > 65535 || width < 1 || w_out < 1 || w_run < 1 ||
      pad_lo < 0)
    return -1;
  C1RbParams p;
  p.lay = c1_layout(inst, w_run);
  if (p.lay.bytes > MAX_SMEM_BYTES) return -2;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<float*>(out);
  p.x_row = x_row;
  p.x_ch = x_ch;
  p.width = width;
  p.pad_lo = pad_lo;
  p.w_out = w_out;
  p.w_run = w_run;
  const dim3 grid(c1_cdiv(w_out, w_run), rows);
  const size_t smem = static_cast<size_t>(p.lay.bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 0: return c1_launch<9, 1, 5, 8>(p, grid, smem, s);
    case 1: return c1_launch<9, 5, 5, 1>(p, grid, smem, s);
    default: return c1_launch<9, 5, 8, 2>(p, grid, smem, s);
  }
}

// conv1d_kernel_rb at the plan's run: what the wrappers launch when
// conv1d_plan says so. Same arguments and codes as conv1d_rb_launch_at.
extern "C" int conv1d_rb_launch(const void* x, const void* w, const void* b,
                                void* out, int rows, int width,
                                long long x_row, long long x_ch, int pad_lo,
                                int w_out, int c_in, int c_out, int k,
                                int stride, void* stream) {
  int geom[4];
  if (!conv1d_plan(c_in, c_out, k, stride, geom)) return -3;
  return conv1d_rb_launch_at(geom[0], x, w, b, out, rows, width, x_row, x_ch,
                             pad_lo, w_out, c_in, c_out, k, stride, stream);
}

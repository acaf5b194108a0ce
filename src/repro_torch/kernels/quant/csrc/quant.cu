// Fixed-point fake quantization to signed Q(i).(f), for Hopper (sm_90a):
// float32, bfloat16 and float16 tensors, float32 arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/quant/quant.py::
// fixed_point_quantize (_quant_kernel). Bound from Python with ctypes
// (src/repro_torch/kernels/quant/quant.py). Two kernels: quant_kernel, one
// tensor with 16-byte accesses (the wrapper `fixed_point_quantize`), and
// quant_many_kernel, up to QM_MAX_SEGS tensors, each with its own widths,
// in one launch (`fixed_point_quantize_many`, which the deploy path's
// `quantize_params` calls once for the trained CNN's six tensors).
//
// What it computes, per element:
//   scale = 2^f,  hi = 2^i - 1/scale,  lo = -2^i
//   y = clamp(rint(x * scale) / scale, lo, hi)
// rint rounds half to even (jnp.round's rule; never roundf), the division
// is a true division (never a multiply by the reciprocal: 2^-f is exact
// only at integer f, and the widths may be any float), and the clamp is
// min(max(., lo), hi). x is widened to float32 as it is loaded and y is
// rounded once to x's type as it is stored (the dtype codes: 0 float32,
// 1 bfloat16, 2 float16), as the reference computes in f32 and writes x's
// type. The widths (i, f) are runtime values, each either a pointer to a
// float32 on the DEVICE (a learned width that lives on the card: no
// device-to-host sync, no stack kernel) or a value passed with the launch
// (a width the caller gave as a number), the analogue of the TPU kernel's
// SMEM scalars; no width needs a rebuild.
//
// What bounds it on the card. One read and one write per element against
// a handful of FP32 operations, far below the H100's ridge (20 FLOP/B), so
// the floor is the bytes at 3.35 TB/s: 2.24 us for 64 x 14 640 floats. On
// the 648 weights of the deployed CNN (six tensors of 5 to 360) the bytes
// take nanoseconds, and what is left is launch latency: six launches of a
// per-tensor kernel (and a stack kernel for each one's widths) where one
// would do.
//
// What the design does about it.
//   * quant_kernel: QV_BYTES-byte vector loads and stores (4 float32 or 8
//     bfloat16/float16 an access), QV_UNROLL vectors a thread an iteration
//     (1: `python -m repro_torch.kernels.quant.sweep` found 2 no faster
//     and 4 or 8 slower, with too few blocks to fill the card at
//     64 x 14 640), consecutive threads on consecutive vectors, a grid
//     sized to the work and capped at QV_BLOCKS_PER_SM blocks a streaming
//     multiprocessor (a grid-stride loop beyond), the format computed once
//     a thread. Elements before x's first 16-byte boundary (a view at an
//     odd offset) and after its last whole vector run as scalars; the
//     wrapper allocates y at x's offset within 16 bytes, so both line up
//     (otherwise every element runs as a scalar).
//   * quant_many_kernel: a segment table passed by value with the launch
//     (x and y pointers, a length, a type and the two widths of each
//     tensor); thread g takes element g of the tensors laid end to end.
//     One launch for the deploy path's six tensors, no width copied.
//
// Numerics: __fmul_rn and __fdiv_rn (IEEE, never contracted), rintf,
// exp2f, and the plain version (ref.py) runs the same operations in the
// same order, so kernel == plain bitwise in every type; at integer widths
// every step but the rounding is exact.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#define QV_THREADS 256
#define QV_BYTES 16              // bytes a vector access: 4, 8 or 16
#define QV_UNROLL 1              // vectors a thread an iteration
#define QV_BLOCKS_PER_SM 8
#define QM_THREADS 256
#define QM_MAX_SEGS 16           // tensors a quant_many_kernel launch

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// One width: *ptr (float32 on the device) when ptr is set, else value.
struct QWidth {
  const float* ptr;
  float value;
};

struct QFormat {
  float scale, hi, lo;
};

__device__ __forceinline__ QFormat q_format(const QWidth& wi,
                                            const QWidth& wf) {
  const float ib = wi.ptr ? *wi.ptr : wi.value;
  const float fb = wf.ptr ? *wf.ptr : wf.value;
  QFormat f;
  f.scale = exp2f(fb);
  f.hi = exp2f(ib) - __fdiv_rn(1.0f, f.scale);
  f.lo = -exp2f(ib);
  return f;
}

__device__ __forceinline__ float q_apply(float x, const QFormat& f) {
  const float q = __fdiv_rn(rintf(__fmul_rn(x, f.scale)), f.scale);
  return fminf(fmaxf(q, f.lo), f.hi);
}

// An element type as its bits: widened to float32, and a float32 rounded
// once back to it.
template <typename T>
struct QElem;
template <>
struct QElem<float> {
  using bits = unsigned;
  static __device__ __forceinline__ float get(bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ bits put(float v) {
    return __float_as_uint(v);
  }
};
template <>
struct QElem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float get(bits b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ bits put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct QElem<__half> {
  using bits = unsigned short;
  static __device__ __forceinline__ float get(bits b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ bits put(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <int B>
struct QRaw;
template <>
struct QRaw<16> { using type = uint4; };
template <>
struct QRaw<8> { using type = uint2; };
template <>
struct QRaw<4> { using type = unsigned; };

template <typename T>
__device__ __forceinline__ void q_scalar(const T* x, T* y, long long i,
                                         const QFormat& f) {
  using E = QElem<T>;
  const auto* xb = reinterpret_cast<const typename E::bits*>(x);
  auto* yb = reinterpret_cast<typename E::bits*>(y);
  yb[i] = E::put(q_apply(E::get(xb[i]), f));
}

// Elements [0, head) and [n - tail, n) as scalars, the n_vec whole vectors
// from element head as QV_BYTES-byte accesses (x + head and y + head are
// both QV_BYTES-aligned; head = n, n_vec = 0 where they cannot be).
template <typename T>
__global__ void __launch_bounds__(QV_THREADS)
quant_kernel(const T* __restrict__ x, T* __restrict__ y, QWidth wi,
             QWidth wf, long long n, long long head, long long tail,
             long long n_vec) {
  using E = QElem<T>;
  using V = typename QRaw<QV_BYTES>::type;
  constexpr int EPV = QV_BYTES / static_cast<int>(sizeof(typename E::bits));
  union Vec {
    V raw;
    typename E::bits e[EPV];
  };
  const QFormat f = q_format(wi, wf);
  const long long gtid =
      static_cast<long long>(blockIdx.x) * QV_THREADS + threadIdx.x;
  for (long long g = gtid; g < head + tail;
       g += static_cast<long long>(gridDim.x) * QV_THREADS)
    q_scalar(x, y, g < head ? g : n - tail + (g - head), f);

  const V* xv = reinterpret_cast<const V*>(x + head);
  V* yv = reinterpret_cast<V*>(y + head);
  const long long chunk =
      static_cast<long long>(gridDim.x) * QV_THREADS * QV_UNROLL;
  for (long long v0 = static_cast<long long>(blockIdx.x) * QV_THREADS *
                          QV_UNROLL + threadIdx.x;
       v0 < n_vec; v0 += chunk) {
    Vec u[QV_UNROLL];
#pragma unroll
    for (int k = 0; k < QV_UNROLL; ++k) {
      const long long v = v0 + static_cast<long long>(k) * QV_THREADS;
      if (v < n_vec) u[k].raw = xv[v];
    }
#pragma unroll
    for (int k = 0; k < QV_UNROLL; ++k) {
      const long long v = v0 + static_cast<long long>(k) * QV_THREADS;
      if (v < n_vec) {
#pragma unroll
        for (int j = 0; j < EPV; ++j)
          u[k].e[j] = E::put(q_apply(E::get(u[k].e[j]), f));
        yv[v] = u[k].raw;
      }
    }
  }
}

static int q_blocks_cap() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 132;
  return sms * QV_BLOCKS_PER_SM;
}

template <typename T>
static int q_launch(const void* x, void* y, QWidth wi, QWidth wf,
                    long long n, cudaStream_t stream) {
  constexpr int EPV = QV_BYTES / static_cast<int>(sizeof(T));
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  long long head = n;                  // all scalars unless x, y line up
  if (xa % sizeof(T) == 0 && (xa - ya) % QV_BYTES == 0) {
    head = static_cast<long long>((QV_BYTES - xa % QV_BYTES) % QV_BYTES) /
           static_cast<long long>(sizeof(T));
    if (head > n) head = n;
  }
  const long long n_vec = (n - head) / EPV;
  const long long tail = n - head - n_vec * EPV;
  long long blocks = (n_vec + QV_THREADS * QV_UNROLL - 1) /
                     (QV_THREADS * QV_UNROLL);
  const long long sc_blocks = (head + tail + QV_THREADS - 1) / QV_THREADS;
  if (blocks < sc_blocks) blocks = sc_blocks;
  const long long cap = q_blocks_cap();
  if (blocks > cap) blocks = cap;
  quant_kernel<T><<<static_cast<unsigned>(blocks), QV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), wi, wf, n, head, tail,
      n_vec);
  return static_cast<int>(cudaGetLastError());
}

// One tensor of n elements of type dtype (0 float32, 1 bfloat16, 2
// float16); each width a device pointer to one float32 (wi_ptr, wf_ptr)
// or, where that is null, the value beside it. Returns 0, a cudaError_t
// code, or -1 (bad arguments).
extern "C" int quant_launch(int dtype, const void* x, void* y,
                            const void* wi_ptr, float wi_val,
                            const void* wf_ptr, float wf_val, long long n,
                            void* stream) {
  if (n < 1 || !x || !y || dtype < DT_F32 || dtype > DT_F16) return -1;
  const QWidth wi{static_cast<const float*>(wi_ptr), wi_val};
  const QWidth wf{static_cast<const float*>(wf_ptr), wf_val};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return q_launch<float>(x, y, wi, wf, n, s);
    case DT_BF16: return q_launch<__nv_bfloat16>(x, y, wi, wf, n, s);
    default: return q_launch<__half>(x, y, wi, wf, n, s);
  }
}

// ---------------------------------------------------------------------------
// quant_many_kernel: a segment table, one launch for several tensors
// ---------------------------------------------------------------------------

struct QSeg {
  const void* x;
  void* y;
  QWidth wi, wf;
  long long start, n;      // elements before this tensor in the table; its
  int dtype;               // length; its type
};

struct QManyParams {
  QSeg seg[QM_MAX_SEGS];
  long long total;
  int n_segs;
};

template <typename T>
__device__ __forceinline__ void q_seg(const QSeg& s, long long i) {
  q_scalar(static_cast<const T*>(s.x), static_cast<T*>(s.y), i,
           q_format(s.wi, s.wf));
}

__global__ void __launch_bounds__(QM_THREADS)
quant_many_kernel(const QManyParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * QM_THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * QM_THREADS +
                     threadIdx.x;
       g < p.total; g += stride) {
    // the segments at constant indices (a runtime index into the launch's
    // parameters could make the compiler copy them into local memory)
#pragma unroll
    for (int k = 0; k < QM_MAX_SEGS; ++k) {
      const QSeg& s = p.seg[k];
      if (k < p.n_segs && g >= s.start && g < s.start + s.n) {
        const long long i = g - s.start;
        if (s.dtype == DT_F32) q_seg<float>(s, i);
        else if (s.dtype == DT_BF16) q_seg<__nv_bfloat16>(s, i);
        else q_seg<__half>(s, i);
      }
    }
  }
}

// n_segs tensors (1 <= n_segs <= QM_MAX_SEGS) in one launch: tensor k has
// ns[k] >= 1 elements of type dtypes[k] at xs[k], its output at ys[k], and
// its widths at wi_ptrs[k] / wf_ptrs[k] on the device or, where a pointer
// is null, wi_vals[k] / wf_vals[k]. Returns 0, a cudaError_t code, or -1
// (bad arguments).
extern "C" int quant_many_launch(int n_segs, const int* dtypes,
                                 const void* const* xs, void* const* ys,
                                 const long long* ns,
                                 const void* const* wi_ptrs,
                                 const float* wi_vals,
                                 const void* const* wf_ptrs,
                                 const float* wf_vals, void* stream) {
  if (n_segs < 1 || n_segs > QM_MAX_SEGS) return -1;
  QManyParams p{};
  long long total = 0;
  for (int k = 0; k < n_segs; ++k) {
    if (ns[k] < 1 || !xs[k] || !ys[k] || dtypes[k] < DT_F32 ||
        dtypes[k] > DT_F16)
      return -1;
    QSeg& s = p.seg[k];
    s.x = xs[k];
    s.y = ys[k];
    s.wi = QWidth{static_cast<const float*>(wi_ptrs[k]), wi_vals[k]};
    s.wf = QWidth{static_cast<const float*>(wf_ptrs[k]), wf_vals[k]};
    s.start = total;
    s.n = ns[k];
    s.dtype = dtypes[k];
    total += ns[k];
  }
  p.total = total;
  p.n_segs = n_segs;
  long long blocks = (total + QM_THREADS - 1) / QM_THREADS;
  const long long cap = q_blocks_cap();
  if (blocks > cap) blocks = cap;
  quant_many_kernel<<<static_cast<unsigned>(blocks), QM_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

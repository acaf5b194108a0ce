// Fused L-layer CNN equalizer for Hopper (sm_90a): fp32, bf16 and int8.
//
// Replaces the TPU kernels of src/repro/kernels/cnn_eq/cnn_eq.py:
//   MODE_FP32  ::_cnn_eq_kernel with conv_valid_taps       (cnn_eq_fused)
//   MODE_BF16  ::_cnn_eq_kernel with conv_valid_taps_bf16  (cnn_eq_fused_bf16)
//   MODE_INT8  ::_cnn_eq_kernel_int8                       (cnn_eq_fused_int8)
// Two templates, bound from Python with ctypes through plain extern "C"
// launchers (src/repro_torch/kernels/cnn_eq/cnn_eq.py): the generic
// cnn_eq_kernel<MODE> below (three instantiations, any widths), and, after
// it, cnn_eq_kernel_rb, register-blocked and specialized to the paper's
// widths, which all three datapaths run there (cnn_eq_plan); every other
// shape runs the generic kernel.
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
// (C=5, K=9), so there are no tensor cores: plain FP32/INT32 lanes. One
// output a thread at a time, runtime widths: cnn_eq_kernel_rb below is the
// fast design for the widths it is specialized to.
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

// ===========================================================================
// The register-blocked instances: cnn_eq_kernel_rb<MODE, K, C, VP, NOS, P>
// ===========================================================================
//
// What they replace. All three datapaths above (the TPU kernels
// _cnn_eq_kernel with conv_valid_taps, with conv_valid_taps_bf16, and
// _cnn_eq_kernel_int8 of src/repro/kernels/cnn_eq/cnn_eq.py) at the paper's
// widths: three layers, K taps, C channels, V_p parallel outputs, N_os
// samples a symbol, strides (V_p, 1, N_os). `cnn_eq_plan` picks them for
// exactly those dims, in every datapath; every other shape keeps
// cnn_eq_kernel<MODE>.
//
// What bounds them. At (K, C, V_p, N_os) = (9, 5, 8, 2) a final position
// (V_p symbols) costs 900 MACs and moves 64 B in, 32 B out: 9.4 FLOP/B,
// under the card's fp32 ridge, so the byte bound (~1.7 µs at 64 × 7320
// symbols) is the bound. But fp32 and bf16 may not fuse their products
// into FMAs (the plain version rounds every product and every sum in a
// fixed order), so they issue two FP32 instructions a MAC: ~3.2 µs of FP32
// issue at 132 SMs. fp32 also keeps its activations at twice bf16's bytes,
// in shared memory and in the registers of a thread's input windows.
// Below ~10 µs what decides is latency: one block's global reads while it
// stages, its chain of shared-memory reads and adds, and whether the grid
// fills the card.
//
// What the design does about it.
//   * Compile-time widths: every tap loop unrolls, every weight index is a
//     constant.
//   * The kernel splits each row into its own runs of w_run final
//     positions (grid (ceil(n_pos / w_run), rows), whatever tile_m the
//     caller asked for) and recomputes the halo of each run: 2·w_run + 15
//     layer-0 and 2·w_run + 7 layer-1 positions for w_run final ones.
//   * Halo in the kernel: it reads the unpadded (rows, width) input and
//     takes +0 for any sample before 0 or past the width, as F.pad does.
//   * Register blocking (P = RB_PPOS, 2; the template also takes 4, which
//     the sweep times as a source variant; P = 8 spilled at every register
//     cap the sweep tried and was slower): a thread computes P adjacent
//     positions of a layer for all its output channels (P/2 in the last
//     layer), its input window in registers from vector shared-memory
//     reads. One broadcast read of a (tap, C_in) pair's weights serves P
//     MACs a channel, one window read C_out MACs.
//   * Conflict-free layouts: a layer's input is kept split by that layer's
//     stride into phase rows (element e in row e % S, at e / S), so lanes
//     of adjacent positions read adjacent words; layer 0's phase rows sit
//     at a stride ≡ 4 (mod 32) words (8 mod 64 bf16 elements), so the
//     staging stores of a warp land on distinct banks.
//   * fp32 and bf16 share one body (`Act` says how an activation is
//     stored). fp32 stores its activations as they are (the plain version
//     rounds nothing between layers but the sums themselves); bf16 stores
//     them as bf16 (the plain version rounds every layer input to bf16, so
//     storing it is exact) and widens them by a shift. Products and sums
//     are fp32, one __fmul_rn / __fadd_rn pair at a time, tap-major then
//     C_in ascending from 0, bias last: the plain version's order. No
//     tensor cores: an mma sums in its own order and alignment, which is
//     not the plain version's sequential fp32 sum.
//   * fp32's layer 1 holds C windows of P + K - 1 floats in registers (50
//     at P = 2, twice bf16's packed pairs); it fits the 64-register cap
//     without spills. The alternative, reading each (tap, C_in) pair's
//     inputs from shared memory where it uses them (RB_FP32_L1_REGS 0,
//     `SmemWin`, a sweep variant), compiles to as many registers and was
//     ~1 % slower.
//   * int8: activations are requantized into int8 once, packed 4 channels
//     a word (C_in padded to a multiple of 4 with zeros), and every dot is
//     __dp4a over 4 channels of one tap (layer 0, C_in = 1: over 4 taps of
//     its one channel); the int32 sum is exact in any order. The requant
//     (rintf, clamp in float, convert) and the rescale
//     __fadd_rn(__fmul_rn((float)acc, scale[c]), b[c]) are those above.
//   * Each block (RB_THREADS threads) stages its row's weights once,
//     converted and packed into the layout its loops read, with
//     compile-time trip counts, so that all of a thread's global reads are
//     in flight together (`stage`; the input RB_STAGE reads at a time);
//     every task reads the weights from shared memory where it uses them
//     (task_fence).
// Every thread reaches every barrier: no thread returns early, and a run
// that ends past n_pos computes its whole width and stores only positions
// below n_pos.

#define RB_THREADS 128
#define RB_MIN_BLOCKS 8          // ≤ 64 registers a thread
#define RB_STAGE 8               // input samples a thread reads at once
#define RB_FP32_L1_REGS 1        // fp32 layer 1: 0 reads per (tap, C_in)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int rup(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The geometry of one block: positions and tasks per layer, the row
// strides of the activation buffers and the shared-memory offsets, all in
// bytes from the start of the dynamic buffer.
struct RbLayout {
  int t0, t1, t2;               // tasks a layer
  int ld0, ld1, ld2;            // fp32, bf16: elements a row; int8: words
  int off_in, off_a1, off_a2, off_w0, off_w1, off_w2, off_b, bytes;
};

template <int MODE, int K, int C, int VP, int NOS, int P>
struct Rb {
  static constexpr int P2 = P / NOS > 0 ? P / NOS : 1;  // last layer's P
  static constexpr int T = VP * NOS;       // input samples a final position
  static constexpr int HALO = (K / 2) * (1 + 2 * VP);   // receptive_halo
  static constexpr int CP = rup(C, 4);     // fp32, bf16: C_out padded
  static constexpr int VPP = rup(VP, 4);
  static constexpr int KW = cdiv(K, 4);    // int8 layer 0: words of taps
  static constexpr int CW = cdiv(C, 4);    // int8: words a position
  static_assert(P == 2 || P == 4, "P is 2 or 4");
  static_assert(P % NOS == 0, "a layer-1 task fills whole phase rows");
  static_assert(VP % 4 == 0, "output positions store as float4s");
  static_assert(MODE != MODE_INT8 ||
                    ((VP * P) % 16 == 0 && (CW * P) % 4 == 0 &&
                     (CW * NOS * P2) % 4 == 0),
                "int8 windows start on 16 bytes");

  __host__ __device__ static RbLayout layout(int w) {
    RbLayout L{};
    const int n1 = NOS * (w - 1) + K;          // layer-1 positions
    const int n0 = n1 + K - 1;                 // layer-0 positions
    L.t0 = cdiv(n0, P);
    L.t1 = cdiv(n1, P);
    L.t2 = cdiv(w, P2);
    int in_bytes, a1_bytes, a2_bytes, w_words[3];
    if (MODE != MODE_INT8) {
      constexpr int E = MODE == MODE_BF16 ? 2 : 4;   // bytes an activation
      // layer 0: VP phase rows; row 0 is read P + (K-1)/VP elements deep;
      // a row stride ≡ 16 (mod 128) bytes: 8 (mod 64) bf16, 4 (mod 32) fp32
      const int need0 = (L.t0 - 1) * P + rup(P + (K - 1) / VP, P);
      L.ld0 = rup(imax(need0, 16 / E) - 16 / E, 128 / E) + 16 / E;
      const int need1 = (L.t1 - 1) * P + rup(P + K - 1, P);
      L.ld1 = rup(imax(need1, L.t0 * P), 8);
      const int need2 = (L.t2 - 1) * P2 + rup(P2 + (K - 1) / NOS, P2);
      L.ld2 = rup(imax(need2, L.t1 * P / NOS), 8);
      in_bytes = E * VP * L.ld0;
      a1_bytes = E * C * L.ld1;
      a2_bytes = E * C * NOS * L.ld2;
      w_words[0] = K * CP;
      w_words[1] = K * C * CP;
      w_words[2] = K * C * VPP;
    } else {
      // layer 0: bytes; a task reads VP·(P-1)/4 + KW words from VP·base
      const int nw0 = VP * (P - 1) / 4 + KW;
      L.ld0 = (VP * (L.t0 - 1) * P) / 4 + rup(nw0, 4);
      const int nw1 = CW * (P + K - 1);
      L.ld1 = rup(imax(CW * (L.t1 - 1) * P + rup(nw1, 4), CW * L.t0 * P), 4);
      const int nw2 = CW * (NOS * (P2 - 1) + K);
      L.ld2 = rup(imax(CW * NOS * (L.t2 - 1) * P2 + rup(nw2, 4),
                       CW * L.t1 * P), 4);
      in_bytes = 4 * L.ld0;
      a1_bytes = 4 * L.ld1;
      a2_bytes = 4 * L.ld2;
      w_words[0] = C * KW;
      w_words[1] = K * C * CW;
      w_words[2] = K * VP * CW;
    }
    int off = 0;
    L.off_in = off;  off += rup(in_bytes, 16);
    L.off_a1 = off;  off += rup(a1_bytes, 16);
    L.off_a2 = off;  off += rup(a2_bytes, 16);
    L.off_w0 = off;  off += rup(4 * w_words[0], 16);
    L.off_w1 = off;  off += rup(4 * w_words[1], 16);
    L.off_w2 = off;  off += rup(4 * w_words[2], 16);
    L.off_b = off;   // fp32, bf16: b0[CP] b1[CP] b2[VPP]; int8: (b, s) × 3
    off += 4 * (MODE != MODE_INT8 ? 2 * CP + VPP : 2 * (2 * C + VP));
    L.bytes = rup(off, 16);
    return L;
  }

};

struct RbParams {
  const float* x;          // (rows, width), row stride x_stride
  float* out;              // (rows, n_pos·VP), contiguous
  long long x_stride;
  int width, n_pos, w_run, stacked;
  const void* w[3];        // (rows|1, C_out, C_in, K) fp32, bf16 or int8
  const float* b[3];       // (rows|1, C_out)
  const float* scale[3];   // (C_out,) int8 rescale
  float a_scale[3], a_lo[3], a_hi[3];   // int8 requant of each layer input
  RbLayout lay;
};

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// element i of a packed window of bf16 pairs, widened to fp32
template <int N>
__device__ __forceinline__ float bf_at(const uint32_t (&v)[N], int i) {
  return (i & 1) ? bf_hi(v[i >> 1]) : bf_lo(v[i >> 1]);
}
__device__ __forceinline__ uint16_t bf_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// NW 32-bit words from 4·V-byte aligned shared memory in V-word vectors
template <int V, int NW>
__device__ __forceinline__ void ld_words(const uint32_t* src,
                                         uint32_t (&dst)[NW]) {
  static_assert(NW % V == 0, "whole vectors");
#pragma unroll
  for (int i = 0; i < NW / V; ++i) {
    if constexpr (V == 4) {
      const uint4 q = reinterpret_cast<const uint4*>(src)[i];
      dst[4 * i] = q.x; dst[4 * i + 1] = q.y;
      dst[4 * i + 2] = q.z; dst[4 * i + 3] = q.w;
    } else if constexpr (V == 2) {
      const uint2 q = reinterpret_cast<const uint2*>(src)[i];
      dst[2 * i] = q.x; dst[2 * i + 1] = q.y;
    } else {
      dst[i] = src[i];
    }
  }
}

// NE bf16 elements (rounded up to whole V-element vectors, V = 1, 2 or 4)
// from 2·V-byte aligned shared memory, as packed pairs
template <int V, int NE>
struct BfWin {
  static constexpr int NV = cdiv(NE, V);
  static constexpr int NW = V == 1 ? cdiv(NV, 2) : NV * V / 2;
  uint32_t w[NW];
  __device__ __forceinline__ void load(const uint16_t* src) {
    if constexpr (V == 1) {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const uint32_t lo = src[2 * i];
        const uint32_t hi = 2 * i + 1 < NV ? src[2 * i + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
    } else {
      ld_words<V / 2, NW>(reinterpret_cast<const uint32_t*>(src), w);
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    return bf_at(w, i);
  }
};

// NE floats (rounded up to whole V-float vectors, V = 1, 2 or 4) from
// 4·V-byte aligned shared memory, held in registers
template <int V, int NE>
struct FWin {
  static constexpr int NV = cdiv(NE, V);
  float w[NV * V];
  __device__ __forceinline__ void load(const float* src) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if constexpr (V == 4) {
        const float4 q = reinterpret_cast<const float4*>(src)[i];
        w[4 * i] = q.x; w[4 * i + 1] = q.y;
        w[4 * i + 2] = q.z; w[4 * i + 3] = q.w;
      } else if constexpr (V == 2) {
        const float2 q = reinterpret_cast<const float2*>(src)[i];
        w[2 * i] = q.x; w[2 * i + 1] = q.y;
      } else {
        w[i] = src[i];
      }
    }
  }
  __device__ __forceinline__ float operator[](int i) const { return w[i]; }
};

// the same window read where it is used: element i is a lane of the V-float
// vector that holds it, read from shared memory (once a task: the compiler
// merges the reads of one vector)
template <int V, int NE>
struct SmemWin {
  const float* src;
  __device__ __forceinline__ void load(const float* p) { src = p; }
  __device__ __forceinline__ float operator[](int i) const {
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
};

// the N weights of one (tap, C_in) pair, from a row padded to a multiple
// of 4, as broadcast float4 reads (the padding lanes are read, not used)
template <int N>
__device__ __forceinline__ void ld_w(const float* src, float (&dst)[N]) {
  float4 q[cdiv(N, 4)];
#pragma unroll
  for (int i = 0; i < cdiv(N, 4); ++i)
    q[i] = reinterpret_cast<const float4*>(src)[i];
#pragma unroll
  for (int c = 0; c < N; ++c) dst[c] = reinterpret_cast<const float*>(q)[c];
}

// V consecutive bf16 values (V = 1, 2 or 4) to 2·V-byte aligned shared
// memory in one store
template <int V>
__device__ __forceinline__ void st_bf16(uint16_t* dst, const float* v) {
  if constexpr (V == 1) {
    dst[0] = bf_bits(v[0]);
  } else {
    uint32_t u[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      u[i] = static_cast<uint32_t>(bf_bits(v[2 * i])) |
             (static_cast<uint32_t>(bf_bits(v[2 * i + 1])) << 16);
    if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = u[0];
    }
  }
}

// V consecutive floats (V = 1, 2 or 4) to 4·V-byte aligned shared memory
// in one store
template <int V>
__device__ __forceinline__ void st_f32(float* dst, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// How the float datapaths keep an activation in shared memory: fp32 as it
// is, bf16 as its 16 bits (`T`, written by `put`, read one at a time by
// `get`, V at a time by `st`); `Win` is a window held in registers, `L1Win`
// layer 1's (see RB_FP32_L1_REGS); `WT` is the weights' type in memory.
template <int MODE>
struct Act;

template <>
struct Act<MODE_BF16> {
  using T = uint16_t;
  using WT = __nv_bfloat16;
  template <int V, int NE> using Win = BfWin<V, NE>;
  template <int V, int NE> using L1Win = BfWin<V, NE>;
  static __device__ __forceinline__ T put(float v) { return bf_bits(v); }
  static __device__ __forceinline__ float get(T u) {
    return __uint_as_float(static_cast<uint32_t>(u) << 16);
  }
  static __device__ __forceinline__ float weight(WT w) {
    return __bfloat162float(w);
  }
  template <int V>
  static __device__ __forceinline__ void st(T* dst, const float* v) {
    st_bf16<V>(dst, v);
  }
};

template <>
struct Act<MODE_FP32> {
  using T = float;
  using WT = float;
  template <int V, int NE> using Win = FWin<V, NE>;
  template <int V, int NE>
  using L1Win = typename std::conditional<RB_FP32_L1_REGS != 0, FWin<V, NE>,
                                          SmemWin<V, NE>>::type;
  static __device__ __forceinline__ T put(float v) { return v; }
  static __device__ __forceinline__ float get(T v) { return v; }
  static __device__ __forceinline__ float weight(WT w) { return w; }
  template <int V>
  static __device__ __forceinline__ void st(T* dst, const float* v) {
    st_f32<V>(dst, v);
  }
};

// N table entries into shared memory by NT threads: every read of a
// thread first (a compile-time count, predicated, so they are in flight
// together), then its stores
template <int N, int NT, typename T, typename F>
__device__ __forceinline__ void stage(T* dst, F value) {
  constexpr int U = cdiv(N, NT);
  T v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * NT;
    v[u] = i < N ? value(i) : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i < N) dst[i] = v[u];
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

__device__ __forceinline__ float relu(float h) { return h > 0.0f ? h : 0.0f; }

// A compiler-only memory fence at the top of each task: a thread's weight
// reads do not depend on its task, and without it the compiler hoists all
// of a layer's (several hundred) out of the task loop (float weights and
// bf16 activations do not alias by type), which spills at any register cap.
__device__ __forceinline__ void task_fence() { asm volatile("" ::: "memory"); }

// VP outputs of one final position, as float4 stores
template <int VP>
__device__ __forceinline__ void st_out(float* dst, const float* h) {
#pragma unroll
  for (int i = 0; i < VP / 4; ++i)
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
}

template <int MODE, int K, int C, int VP, int NOS, int P>
__global__ void __launch_bounds__(RB_THREADS, RB_MIN_BLOCKS)
cnn_eq_kernel_rb(const RbParams p) {
  using G = Rb<MODE, K, C, VP, NOS, P>;
  constexpr int P2 = G::P2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RbLayout& L = p.lay;
  const int row = blockIdx.y;
  const int m0 = blockIdx.x * p.w_run;        // first final position
  // a fixed block size: the staging loops below have compile-time trip
  // counts, unroll, and issue all of a thread's reads before its stores
  constexpr int nt = RB_THREADS;
  const int tid = threadIdx.x;
  float* bsm = reinterpret_cast<float*>(smem_raw + L.off_b);
  const float* xr = p.x + static_cast<long long>(row) * p.x_stride;
  const int start = m0 * G::T - G::HALO;      // x index of window sample 0
  const long long srow = p.stacked ? row : 0;

  if constexpr (MODE != MODE_INT8) {
    using A = Act<MODE>;
    using T = typename A::T;
    using WT = typename A::WT;
    constexpr int CP = G::CP, VPP = G::VPP;
    // ---- stage: weights as fp32 [kk][ci][c_out padded], biases, input
    float* w0s = reinterpret_cast<float*>(smem_raw + L.off_w0);
    float* w1s = reinterpret_cast<float*>(smem_raw + L.off_w1);
    float* w2s = reinterpret_cast<float*>(smem_raw + L.off_w2);
    const WT* wg0 = static_cast<const WT*>(p.w[0]) + srow * (C * K);
    const WT* wg1 = static_cast<const WT*>(p.w[1]) + srow * (C * C * K);
    const WT* wg2 = static_cast<const WT*>(p.w[2]) + srow * (VP * C * K);
    // smem index i of each table -> its value (weights padded to CP / VPP
    // channels with zeros)
    auto w0v = [&](int i) {
      const int kk = i / CP, c = i % CP;
      return c < C ? A::weight(wg0[c * K + kk]) : 0.0f;
    };
    auto w1v = [&](int i) {
      const int kk = i / (C * CP), ci = (i / CP) % C, c = i % CP;
      return c < C ? A::weight(wg1[(c * C + ci) * K + kk]) : 0.0f;
    };
    auto w2v = [&](int i) {
      const int kk = i / (C * VPP), ci = (i / VPP) % C, c = i % VPP;
      return c < VP ? A::weight(wg2[(c * C + ci) * K + kk]) : 0.0f;
    };
    auto bv = [&](int i) {
      const int l = i < CP ? 0 : i < 2 * CP ? 1 : 2;
      const int c = i - l * CP;
      const int co = l == 2 ? VP : C;
      return c < co ? p.b[l][srow * co + c] : 0.0f;
    };
    stage<K * CP, nt>(w0s, w0v);
    stage<K * C * CP, nt>(w1s, w1v);
    stage<K * C * VPP, nt>(w2s, w2v);
    stage<2 * CP + VPP, nt>(bsm, bv);
    T* xs = reinterpret_cast<T*>(smem_raw + L.off_in);
    for (int i0 = tid; i0 < VP * L.ld0; i0 += RB_STAGE * nt) {
      float v[RB_STAGE];
#pragma unroll
      for (int u = 0; u < RB_STAGE; ++u) {
        const int i = i0 + u * nt, xi = start + i;
        v[u] = i < VP * L.ld0 && xi >= 0 && xi < p.width ? xr[xi] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < RB_STAGE; ++u) {
        const int i = i0 + u * nt;
        if (i < VP * L.ld0) xs[(i % VP) * L.ld0 + i / VP] = A::put(v[u]);
      }
    }
    __syncthreads();

    // ---- layer 0: 1 → C, stride VP; input phase row r holds x[VP·q + r]
    T* a1 = reinterpret_cast<T*>(smem_raw + L.off_a1);
    for (int g = tid; g < L.t0; g += nt) {
      task_fence();
      const int base = g * P;
      float acc[C][P];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[c][q] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        // taps kk of the P positions: phase row kk % VP from base + kk / VP
        const int d = kk / VP;
        typename A::template Win<P, P + (K - 1) / VP> win;
        win.load(xs + (kk % VP) * L.ld0 + base);
        float wv[C];
        ld_w<C>(w0s + kk * CP, wv);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float xv = win[d + q];
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c][q] = __fadd_rn(acc[c][q], __fmul_rn(wv[c], xv));
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float h[P];
#pragma unroll
        for (int q = 0; q < P; ++q) h[q] = relu(__fadd_rn(acc[c][q], bsm[c]));
        A::template st<P>(a1 + c * L.ld1 + base, h);
      }
    }
    __syncthreads();

    // ---- layer 1: C → C, stride 1; output split into NOS phase rows
    T* a2 = reinterpret_cast<T*>(smem_raw + L.off_a2);
    for (int g = tid; g < L.t1; g += nt) {
      task_fence();
      const int base = g * P;
      typename A::template L1Win<P, P + K - 1> win[C];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) win[ci].load(a1 + ci * L.ld1 + base);
      float acc[C][P];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[c][q] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
          float wv[C];
          ld_w<C>(w1s + (kk * C + ci) * CP, wv);
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float xv = win[ci][q + kk];
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[c][q] = __fadd_rn(acc[c][q], __fmul_rn(wv[c], xv));
          }
        }
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int ph = 0; ph < NOS; ++ph) {
          float h[P / NOS];
#pragma unroll
          for (int q = 0; q < P / NOS; ++q)
            h[q] = relu(__fadd_rn(acc[c][NOS * q + ph], bsm[CP + c]));
          A::template st<P / NOS>(a2 + (c * NOS + ph) * L.ld2 + base / NOS, h);
        }
    }
    __syncthreads();

    // ---- layer 2: C → VP, stride NOS, linear; out[m·VP + c]
    for (int g = tid; g < L.t2; g += nt) {
      task_fence();
      const int base = g * P2;
      // phase row ph of channel ci holds layer-1 positions NOS·i + ph; at
      // P2 = 1 each value is read once, where it is used
      const T* a2t = a2 + base;
      typename A::template Win<P2, P2 + (K - 1) / NOS>
          win[C][P2 > 1 ? NOS : 1];
      if constexpr (P2 > 1) {
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
#pragma unroll
          for (int ph = 0; ph < NOS; ++ph)
            win[ci][ph].load(a2t + (ci * NOS + ph) * L.ld2);
      }
      float acc[VP][P2];
#pragma unroll
      for (int c = 0; c < VP; ++c)
#pragma unroll
        for (int q = 0; q < P2; ++q) acc[c][q] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
          float wv[VP];
          ld_w<VP>(w2s + (kk * C + ci) * VPP, wv);
#pragma unroll
          for (int q = 0; q < P2; ++q) {
            float xv;
            if constexpr (P2 > 1) {
              xv = win[ci][kk % NOS][q + kk / NOS];
            } else {
              xv = A::get(a2t[(ci * NOS + kk % NOS) * L.ld2 + kk / NOS]);
            }
#pragma unroll
            for (int c = 0; c < VP; ++c)
              acc[c][q] = __fadd_rn(acc[c][q], __fmul_rn(wv[c], xv));
          }
        }
#pragma unroll
      for (int q = 0; q < P2; ++q) {
        const int m = m0 + base + q;
        if (base + q < p.w_run && m < p.n_pos) {
          float h[VP];
#pragma unroll
          for (int c = 0; c < VP; ++c)
            h[c] = __fadd_rn(acc[c][q], bsm[2 * CP + c]);
          st_out<VP>(p.out + (static_cast<long long>(row) * p.n_pos + m) * VP,
                     h);
        }
      }
    }
  } else {
    constexpr int KW = G::KW, CW = G::CW;
    // ---- stage: weights packed 4 int8 a word, biases and rescales, input
    uint32_t* w0s = reinterpret_cast<uint32_t*>(smem_raw + L.off_w0);
    uint32_t* w1s = reinterpret_cast<uint32_t*>(smem_raw + L.off_w1);
    uint32_t* w2s = reinterpret_cast<uint32_t*>(smem_raw + L.off_w2);
    const int8_t* wg0 = static_cast<const int8_t*>(p.w[0]) + srow * (C * K);
    const int8_t* wg1 = static_cast<const int8_t*>(p.w[1]) + srow * (C * C * K);
    const int8_t* wg2 =
        static_cast<const int8_t*>(p.w[2]) + srow * (VP * C * K);
    // w0s[c][u]: taps 4u .. 4u+3 of channel c; w1s[kk][c][cw]: C_in 4·cw
    // .. 4·cw+3 of (c, kk); w2s likewise
    auto w0v = [&](int i) {
      const int c = i / KW, u = i % KW;
      int t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t[j] = 4 * u + j < K ? wg0[c * K + 4 * u + j] : 0;
      return pack4(t[0], t[1], t[2], t[3]);
    };
    auto w1v = [&](int i) {
      const int kk = i / (C * CW), c = (i / CW) % C, cw = i % CW;
      int t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = 4 * cw + j;
        t[j] = ci < C ? wg1[(c * C + ci) * K + kk] : 0;
      }
      return pack4(t[0], t[1], t[2], t[3]);
    };
    auto w2v = [&](int i) {
      const int kk = i / (VP * CW), c = (i / CW) % VP, cw = i % CW;
      int t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = 4 * cw + j;
        t[j] = ci < C ? wg2[(c * C + ci) * K + kk] : 0;
      }
      return pack4(t[0], t[1], t[2], t[3]);
    };
    // bsm: b0[C] s0[C] b1[C] s1[C] b2[VP] s2[VP]
    auto bv = [&](int i) {
      const int l = i < 2 * C ? 0 : i < 4 * C ? 1 : 2;
      const int j = i - 2 * C * l;
      const int co = l == 2 ? VP : C;
      return j < co ? p.b[l][srow * co + j] : p.scale[l][j - co];
    };
    stage<C * KW, nt>(w0s, w0v);
    stage<K * C * CW, nt>(w1s, w1v);
    stage<K * VP * CW, nt>(w2s, w2v);
    stage<2 * (2 * C + VP), nt>(bsm, bv);
    int8_t* xq = reinterpret_cast<int8_t*>(smem_raw + L.off_in);
    for (int i0 = tid; i0 < 4 * L.ld0; i0 += RB_STAGE * nt) {
      float v[RB_STAGE];
#pragma unroll
      for (int u = 0; u < RB_STAGE; ++u) {
        const int i = i0 + u * nt, xi = start + i;
        v[u] = i < 4 * L.ld0 && xi >= 0 && xi < p.width ? xr[xi] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < RB_STAGE; ++u) {
        const int i = i0 + u * nt;
        if (i < 4 * L.ld0)
          xq[i] = static_cast<int8_t>(
              requant(v[u], p.a_scale[0], p.a_lo[0], p.a_hi[0]));
      }
    }
    __syncthreads();

    // ---- layer 0: 1 → C, stride VP; dots over 4 taps of the one channel
    uint32_t* a1 = reinterpret_cast<uint32_t*>(smem_raw + L.off_a1);
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(xq);
    for (int g = tid; g < L.t0; g += nt) {
      task_fence();
      const int base = g * P;
      constexpr int NW = rup(VP * (P - 1) / 4 + KW, 4);
      uint32_t win[NW];
      ld_words<4, NW>(xw + VP * base / 4, win);
      int acc[C][P];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[c][q] = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int u = 0; u < KW; ++u) {
          const int wq = static_cast<int>(w0s[c * KW + u]);
#pragma unroll
          for (int q = 0; q < P; ++q)
            acc[c][q] = __dp4a(static_cast<int>(win[VP / 4 * q + u]), wq,
                               acc[c][q]);
        }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        int v[4 * CW];
#pragma unroll
        for (int c = 0; c < 4 * CW; ++c) {
          v[c] = 0;
          if (c < C) {
            const float h = relu(__fadd_rn(
                __fmul_rn(static_cast<float>(acc[c][q]), bsm[C + c]), bsm[c]));
            v[c] = requant(h, p.a_scale[1], p.a_lo[1], p.a_hi[1]);
          }
        }
#pragma unroll
        for (int cw = 0; cw < CW; ++cw)
          a1[(base + q) * CW + cw] =
              pack4(v[4 * cw], v[4 * cw + 1], v[4 * cw + 2], v[4 * cw + 3]);
      }
    }
    __syncthreads();

    // ---- layer 1: C → C, stride 1; dots over 4 channels of one tap
    uint32_t* a2 = reinterpret_cast<uint32_t*>(smem_raw + L.off_a2);
    for (int g = tid; g < L.t1; g += nt) {
      task_fence();
      const int base = g * P;
      constexpr int NW = rup(CW * (P + K - 1), 4);
      uint32_t win[NW];
      ld_words<4, NW>(a1 + CW * base, win);
      int acc[C][P];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < P; ++q) acc[c][q] = 0;
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int cw = 0; cw < CW; ++cw) {
            const int wq = static_cast<int>(w1s[(kk * C + c) * CW + cw]);
#pragma unroll
            for (int q = 0; q < P; ++q)
              acc[c][q] = __dp4a(static_cast<int>(win[(q + kk) * CW + cw]),
                                 wq, acc[c][q]);
          }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        int v[4 * CW];
#pragma unroll
        for (int c = 0; c < 4 * CW; ++c) {
          v[c] = 0;
          if (c < C) {
            const float h = relu(__fadd_rn(
                __fmul_rn(static_cast<float>(acc[c][q]), bsm[3 * C + c]),
                bsm[2 * C + c]));
            v[c] = requant(h, p.a_scale[2], p.a_lo[2], p.a_hi[2]);
          }
        }
#pragma unroll
        for (int cw = 0; cw < CW; ++cw)
          a2[(base + q) * CW + cw] =
              pack4(v[4 * cw], v[4 * cw + 1], v[4 * cw + 2], v[4 * cw + 3]);
      }
    }
    __syncthreads();

    // ---- layer 2: C → VP, stride NOS, linear; out[m·VP + c]
    for (int g = tid; g < L.t2; g += nt) {
      task_fence();
      const int base = g * P2;
      constexpr int NW = rup(CW * (NOS * (P2 - 1) + K), 4);
      uint32_t win[NW];
      ld_words<4, NW>(a2 + CW * NOS * base, win);
      int acc[VP][P2];
#pragma unroll
      for (int c = 0; c < VP; ++c)
#pragma unroll
        for (int q = 0; q < P2; ++q) acc[c][q] = 0;
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int c = 0; c < VP; ++c)
#pragma unroll
          for (int cw = 0; cw < CW; ++cw) {
            const int wq = static_cast<int>(w2s[(kk * VP + c) * CW + cw]);
#pragma unroll
            for (int q = 0; q < P2; ++q)
              acc[c][q] = __dp4a(
                  static_cast<int>(win[(NOS * q + kk) * CW + cw]), wq,
                  acc[c][q]);
          }
#pragma unroll
      for (int q = 0; q < P2; ++q) {
        const int m = m0 + base + q;
        if (base + q < p.w_run && m < p.n_pos) {
          float h[VP];
#pragma unroll
          for (int c = 0; c < VP; ++c)
            h[c] = __fadd_rn(
                __fmul_rn(static_cast<float>(acc[c][q]), bsm[4 * C + VP + c]),
                bsm[4 * C + c]);
          st_out<VP>(p.out + (static_cast<long long>(row) * p.n_pos + m) * VP,
                     h);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The plan: which kernel a (mode, layer dims) runs, and at what geometry
// ---------------------------------------------------------------------------
// The paper's widths, the only ones the register-blocked template is
// instantiated for: strides (V_p, 1, N_os)
#define RB_K 9
#define RB_C 5
#define RB_VP 8
#define RB_NOS 2

// the geometry the plan runs: final positions a block W and positions a
// thread P, the same for every datapath (chosen by `python -m
// repro_torch.kernels.cnn_eq.sweep`, which times other W, and other P as
// source variants)
#define RB_W_RUN 60
#define RB_PPOS 2

static bool rb_dims(int mode, int n_layers, const int* kcs) {
  static const int want[3][4] = {{RB_K, 1, RB_C, RB_VP},
                                 {RB_K, RB_C, RB_C, 1},
                                 {RB_K, RB_C, RB_VP, RB_NOS}};
  if (mode < MODE_FP32 || mode > MODE_INT8 || n_layers != 3) return false;
  for (int l = 0; l < 3; ++l)
    for (int j = 0; j < 4; ++j)
      if (kcs[4 * l + j] != want[l][j]) return false;
  return true;
}

// the layout of a block of w_run final positions
static RbLayout rb_layout(int mode, int w_run) {
  switch (mode) {
    case MODE_FP32:
      return Rb<MODE_FP32, RB_K, RB_C, RB_VP, RB_NOS, RB_PPOS>::layout(w_run);
    case MODE_BF16:
      return Rb<MODE_BF16, RB_K, RB_C, RB_VP, RB_NOS, RB_PPOS>::layout(w_run);
    default:
      return Rb<MODE_INT8, RB_K, RB_C, RB_VP, RB_NOS, RB_PPOS>::layout(w_run);
  }
}

// Returns 1 and fills geom = (w_run, p, threads, shared-memory bytes) when
// (mode, dims) runs cnn_eq_kernel_rb; 0 (geom zeroed) for cnn_eq_kernel.
//   kcs: n_layers × (k, c_in, c_out, stride)
extern "C" int cnn_eq_plan(int mode, int n_layers, const int* kcs,
                           int* geom) {
  geom[0] = geom[1] = geom[2] = geom[3] = 0;
  if (!rb_dims(mode, n_layers, kcs)) return 0;
  geom[0] = RB_W_RUN;
  geom[1] = RB_PPOS;
  geom[2] = RB_THREADS;
  geom[3] = rb_layout(mode, RB_W_RUN).bytes;
  return 1;
}

template <int MODE>
static int rb_launch(const RbParams& p, dim3 grid, size_t smem,
                     cudaStream_t stream) {
  auto kern = cnn_eq_kernel_rb<MODE, RB_K, RB_C, RB_VP, RB_NOS, RB_PPOS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, RB_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cnn_eq_kernel_rb at an explicit run (w_run final positions a block, at
// the instances' P and RB_THREADS threads): the sweep, chip_smoke.py and
// the card tests. Returns 0, a cudaError_t code, -1 (bad arguments), -2
// (more shared memory than a block can have) or -3 (no register-blocked
// instance for these dims).
//   x:    (rows, width) fp32, row stride x_stride; out: (rows, n_pos·V_p)
//   kcs:  3 × (k, c_in, c_out, stride)
//   aq:   3 × (a_scale, a_lo, a_hi)        (int8; else ignored)
//   ptrs: 3 × (w, b, scale)                (scale: int8 only)
extern "C" int cnn_eq_rb_launch_at(int w_run, int mode, const void* x,
                                   void* out, int rows, int width,
                                   long long x_stride,
                                   int n_pos, int stacked, const void* kcs_v,
                                   const void* aq_v, const void* ptrs_v,
                                   void* stream) {
  const int* kcs = static_cast<const int*>(kcs_v);
  if (!rb_dims(mode, 3, kcs)) return -3;
  if (rows < 1 || rows > 65535 || n_pos < 1 || width < 1 || w_run < 1)
    return -1;
  RbParams p;
  p.lay = rb_layout(mode, w_run);
  if (p.lay.bytes > MAX_SMEM_BYTES) return -2;
  const float* aq = static_cast<const float*>(aq_v);
  const void* const* ptrs = static_cast<const void* const*>(ptrs_v);
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.x_stride = x_stride;
  p.width = width;
  p.n_pos = n_pos;
  p.w_run = w_run;
  p.stacked = stacked;
  for (int l = 0; l < 3; ++l) {
    p.w[l] = ptrs[3 * l + 0];
    p.b[l] = static_cast<const float*>(ptrs[3 * l + 1]);
    p.scale[l] = static_cast<const float*>(ptrs[3 * l + 2]);
    p.a_scale[l] = aq[3 * l + 0];
    p.a_lo[l] = aq[3 * l + 1];
    p.a_hi[l] = aq[3 * l + 2];
  }
  const dim3 grid(cdiv(n_pos, w_run), rows);
  const size_t smem = static_cast<size_t>(p.lay.bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FP32: return rb_launch<MODE_FP32>(p, grid, smem, s);
    case MODE_BF16: return rb_launch<MODE_BF16>(p, grid, smem, s);
    default:        return rb_launch<MODE_INT8>(p, grid, smem, s);
  }
}

// cnn_eq_kernel_rb at the plan's geometry: what the three wrappers launch
// when cnn_eq_plan says so. Same arguments and codes as
// cnn_eq_rb_launch_at.
extern "C" int cnn_eq_rb_launch(int mode, const void* x, void* out, int rows,
                                int width, long long x_stride, int n_pos,
                                int stacked, const void* kcs_v,
                                const void* aq_v, const void* ptrs_v,
                                void* stream) {
  int geom[4];
  if (!cnn_eq_plan(mode, 3, static_cast<const int*>(kcs_v), geom)) return -3;
  return cnn_eq_rb_launch_at(geom[0], mode, x, out, rows, width, x_stride,
                             n_pos, stacked, kcs_v, aq_v, ptrs_v, stream);
}

// Hopper tile helpers shared by the bf16 tensor-core flash kernels
// (flash_attn.cu, forward; flash_attn_bwd.cu, dK/dV and dQ): asynchronous
// global → shared copies, ldmatrix fragment loads, the m16n8k16 bf16
// product with f32 sums, and bf16 packing.
//
// Fragment layout (mma.sync m16n8k16, lane t, g = t/4, c = t%4):
//   A, 16 × 16 row-major, four registers of two bf16: [0] row g, columns
//     2c, 2c+1; [1] row g + 8, the same columns; [2] row g, columns 2c+8,
//     2c+9; [3] row g + 8, those columns.
//   B, 16 × 8 column-major, two registers: [0] rows 2c, 2c+1 of column g;
//     [1] rows 2c+8, 2c+9 of it.
//   C/D, 16 × 8 f32: [0], [1] at (row g, columns 2c, 2c+1) and [2], [3] at
//     (row g + 8, the same columns).
// An accumulator tile of 16 rows × 16 columns (two C fragments, n-blocks
// 2j and 2j+1) therefore has the layout of one A fragment: [0] = C[2j][0,1],
// [1] = C[2j][2,3], [2] = C[2j+1][0,1], [3] = C[2j+1][2,3]. That is how a
// product's result (P, dS) is fed to the next product without a trip
// through shared memory.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global → shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 × 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane t receives row t/4, columns 2(t%4), 2(t%4)+1 of each
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// the same, transposed: lane t receives rows 2(t%4), 2(t%4)+1 of column t/4
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a · b: a 16 × 16 (row-major fragment), b 16 × 8 (column-major), f32
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 → one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// two f32 x → bf16 pairs hi (x rounded) and lo (what hi missed, rounded):
// hi + lo = x within 2^-17 relative, so two bf16 products give a product
// with an f32 operand to nearly f32 accuracy
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Hopper building blocks shared by the tensor-core kernels: B1 / B2 / B4 /
// B7 (folded_mma.cuh), B5 (conv2d_q8.cu) and B6 (flash_attention.cu).
//
//   * `cp.async`: 16 bytes global -> shared without registers, in commit
//     groups;
//   * `mma.sync` m16n8k16 bf16 -> f32, and `ldmatrix` for its fragments;
//   * `mma.sync` m16n8k32 s8 -> s32 (exact: int32 adds in any order);
//   * float32 on the tensor cores as three TF32 products per fragment
//     (namespace `tf32`): a float is split into hi + lo, both read by `mma`
//     as TF32, and a b = al bh + ah bl + ah bh (the al bl term is below
//     float32's rounding). One TF32 product keeps ~11 bits of each operand:
//     ~50x over a 1e-5 relative limit at K in the thousands (PR 7's B6
//     forward); three keep float32's accuracy.
//
// Every helper is a forced inline of one or a few PTX instructions; a
// kernel includes this header inside no namespace and names them as
// `hmma::...` (or with a using-directive).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hmma {

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// c += a b on one 16 x 8 block, bf16 operands, float sum. a0/a1: rows g and
// g + 8, k = 2t, 2t + 1; a2/a3: the same rows, k = 2t + 8, 2t + 9; b0/b1:
// column g, the same two k pairs.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b on one 16 x 8 block, int8 operands, int32 sum. a0/a1: rows g and
// g + 8, k = 4t .. 4t + 3; a2/a3: the same rows, k = 16 + 4t .. 16 + 4t + 3;
// b0/b1: column g, the same two k quads.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices: lane l names row l % 8 of matrix l / 8;
// register i holds, of matrix i, elements [g][2t] and [g][2t + 1].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Four 8 x 8 bf16 matrices, transposed: lane l names row l % 8 of matrix
// l / 8; register i holds, of matrix i, elements [2t][g] and [2t + 1][g].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

namespace tf32 {

// x = hi + lo, both TF32 as `mma` reads them. `mma` takes a tf32 operand
// from the top 19 bits of its register and drops the other 13, so adding
// half an ulp to the bits (0x1000) makes hi cvt.rna.tf32(x) for a finite x,
// 1 instruction where `cvt.rna` compiles to 4 (it also tests for inf and
// NaN); x - hi is exact in float, and lo is passed as it is, so `mma`
// truncates it to 11 bits (rounding it too read no closer to the plain
// version on the card and cost 4% of the B6 forward's time).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)));
}

// d = a b + c on one 16 x 8 block, TF32 operands, float sum. a[0]/a[1]:
// rows g and g + 8, k = t; a[2]/a[3]: the same rows, k = t + 4; b0/b1:
// column g, k = t and t + 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a b + c in three products, a = ah + al and b = bh + bl: the two
// corrections first, then ah bh
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1,
                                     const float* c) {
  mma_tf32(d, al, bh0, bh1, c);
  mma_tf32(d, ah, bl0, bl1, d);
  mma_tf32(d, ah, bh0, bh1, d);
}

}  // namespace tf32
}  // namespace hmma

// Pieces shared by the int8 conv kernels B4 (folded_conv_q8.cu), B7
// (folded_conv2_q8.cu) and B5 (conv2d_q8.cu): the folded reflect ring's
// source rule, the weight repacking for __dp4a, the f32 epilogue of rpst's
// ops/pallas/folded_conv_q8.py (:238-266) and conv2d_q8.py (:139-149), and
// the deterministic reduction of per-tile channel sums.
//
// Layouts. Activations are NHWC int8 with 4C folded channels; a "word" is
// 4 consecutive channels packed in an int32 (channel g in byte g % 4), the
// operand __dp4a takes. Weights (3, 3, 4C, 4Co) int8 are repacked on the
// chip into words of 4 consecutive INPUT channels for one output channel,
// so that __dp4a(x_word, w_word) is 4 products of one output channel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace q8 {

// Folded channel layout (ops/folded.py): channel g of 4C lies in sub-
// position block g / C, C = 4C / 4; blocks {0, 1} are sub-row 0 (the first
// 2C channels), blocks {0, 2} sub-column 0.
//
// Source row of ring row r (-1 or H) for a channel in the first half (true)
// or the second half: ops/folded.py _row_ring. Interior rows map to
// themselves.
__device__ __forceinline__ int ring_row(int r, int H, bool first_half) {
  if (r < 0) return first_half ? 1 : 0;
  if (r >= H) return first_half ? H - 1 : H - 2;
  return r;
}

// Source column of ring column c (-1 or W): ops/folded.py _col_ring.
__device__ __forceinline__ int ring_col(int c, int W, bool subcol0) {
  if (c < 0) return subcol0 ? 1 : 0;
  if (c >= W) return subcol0 ? W - 1 : W - 2;
  return c;
}

__device__ __forceinline__ bool first_half(int g, int C4) { return g < C4 / 2; }
__device__ __forceinline__ bool subcol0(int g, int C4) {
  return ((g / (C4 / 4)) & 1) == 0;
}

// rows r[k] = bytes (co0..co3) of input channel ci + k -> out[j] = bytes
// (ci..ci+3) of output channel co0 + j (a 4x4 byte transpose).
__device__ __forceinline__ void transpose4x4(const int32_t r[4],
                                             int32_t out[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // c0 d0 c1 d1
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // a2 b2 a3 b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // c2 d2 c3 d3
  out[0] = __byte_perm(t0, t1, 0x5410);                 // a0 b0 c0 d0
  out[1] = __byte_perm(t0, t1, 0x7632);                 // a1 b1 c1 d1
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// Stage the repacked words of output channels [co0, co0 + 4 * units_co)
// and input words [cw0, cw0 + n_cw) of all 9 taps: dst[(tap * n_cw + cw) *
// dst_stride + co] (co relative to co0). Words past C4 or C4o are zero.
__device__ __forceinline__ void stage_weights(
    const int8_t* __restrict__ w, int32_t* dst, int dst_stride, int C4,
    int C4o, int cw0, int n_cw, int co0, int units_co, int tid,
    int nthreads) {
  const int total = 9 * n_cw * units_co;
  for (int u = tid; u < total; u += nthreads) {
    const int co4 = u % units_co;
    const int cw = (u / units_co) % n_cw;
    const int tap = u / (units_co * n_cw);
    const int g = 4 * (cw0 + cw);
    const int go = co0 + 4 * co4;
    int32_t r[4] = {0, 0, 0, 0};
    if (g < C4 && go < C4o) {
      const int8_t* base = w + ((size_t)tap * C4 + g) * C4o + go;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r[k] = *reinterpret_cast<const int32_t*>(base + (size_t)k * C4o);
    }
    int32_t c[4];
    transpose4x4(r, c);
    *reinterpret_cast<int4*>(dst + (size_t)(tap * n_cw + cw) * dst_stride +
                             4 * co4) = make_int4(c[0], c[1], c[2], c[3]);
  }
}

// rpst's epilogue, rounding for rounding: y = float(acc) * deq + bias as
// two roundings (no FMA contraction), lrelu 0.2.
__device__ __forceinline__ float epilogue(int32_t acc, float deq, float bias) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias);
  return y >= 0.f ? y : __fmul_rn(0.2f, y);
}

// The same two roundings with the slope as an argument (B5, conv2d_q8.cu):
// where(y >= 0, y, alpha * y), so alpha = 0 gives -0.0 for a negative y
// and alpha = 1 gives y back, as rpst's ops/pallas/conv2d_q8.py (:142-143).
__device__ __forceinline__ float epilogue_alpha(int32_t acc, float deq,
                                                float bias, float alpha) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias);
  return y >= 0.f ? y : __fmul_rn(alpha, y);
}

// clip(round_half_even(y * inv), -127, 127) as int8 bits in the low byte.
__device__ __forceinline__ uint32_t requant(float y, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(const uint32_t b[4]) {
  return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
}

// Store 4 consecutive channels' bf16 values (8 bytes, 8-byte aligned).
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst,
                                             const float v[4]) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                         __float2bfloat16_rn(v[1]));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                         __float2bfloat16_rn(v[3]));
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Block-level channel sums, deterministic: each thread holds TN partial
// sums of the channels its lane group owns (lanes l, l^8, l^16, l^24 share
// channels when CG = 8); they are combined by a fixed shuffle pattern, the
// 8 warps' results then summed in warp order by one thread per channel.
// red: >= nwarps * 128 floats of shared scratch. Writes out[co] for co <
// n_co (co relative to the block's first channel), channel of q given by
// chan(q).
template <int TN, int CG>
__device__ __forceinline__ void block_channel_sums(const float (&v)[TN],
                                                   float* red, float* out,
                                                   int n_co, int tid,
                                                   int nthreads) {
  static_assert(CG == 8, "lane groups assume 8 channel groups per warp");
  const int lane = tid & 31, warp = tid >> 5, tc = lane & (CG - 1);
  float s[TN];
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    s[q] = v[q];
    s[q] += __shfl_xor_sync(0xffffffffu, s[q], 8);
    s[q] += __shfl_xor_sync(0xffffffffu, s[q], 16);
  }
  if (lane < CG) {
#pragma unroll
    for (int q = 0; q < TN; ++q)
      red[warp * 128 + (q / 4) * (CG * 4) + tc * 4 + (q % 4)] = s[q];
  }
  __syncthreads();
  const int nwarps = nthreads >> 5;
  for (int co = tid; co < n_co; co += nthreads) {
    float acc = 0.f;
    for (int k = 0; k < nwarps; ++k) acc += red[k * 128 + co];
    out[co] = acc;
  }
  __syncthreads();
}

// out[n, c] = sum over t of part[(n * tiles + t) * stride + c], c < C, in
// tile order, accumulated in double: one thread per (n, c).
__global__ void finalize_sums(const float* __restrict__ part,
                              float* __restrict__ out, int tiles, int stride,
                              int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (c >= C) return;
  double acc = 0.0;
  for (int t = 0; t < tiles; ++t)
    acc += part[((size_t)n * tiles + t) * stride + c];
  out[(size_t)n * C + c] = static_cast<float>(acc);
}

inline void launch_finalize(const float* part, float* out, int N, int tiles,
                            int stride, int C, cudaStream_t s) {
  dim3 grid((C + 127) / 128, N);
  finalize_sums<<<grid, 128, 0, s>>>(part, out, tiles, stride, C);
}

}  // namespace q8

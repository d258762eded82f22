// Pieces shared by the int8 conv kernels B4 (folded_conv_q8.cu), B7
// (folded_conv2_q8.cu) and B5 (conv2d_q8.cu): the folded reflect ring's
// source rule, the f32 epilogue of rpst's ops/pallas/folded_conv_q8.py
// (:238-266) and conv2d_q8.py (:139-149), and the deterministic sum of
// per-tile channel sums. Activations are NHWC int8 with 4C folded channels.

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

// The per-image sums of per-tile partials: part holds, per image n and
// tile t, a row of `stride` floats; columns [start[k], start[k + 1]) of the
// rows are summed into out[k] (N, start[k + 1] - start[k]). Deterministic
// and parallel: a block of FIN_CHUNKS x FIN_COLS threads takes FIN_COLS
// columns of one image; thread (chunk, column) adds its contiguous chunk of
// the tiles in order in double, then the chunks' sums are added in chunk
// order in double and rounded to float.
constexpr int FIN_COLS = 32, FIN_CHUNKS = 32;

struct SumOuts {
  float* out[4];
  int start[5];
  int count;  // outputs; columns [0, start[count])
};

__global__ void __launch_bounds__(FIN_COLS * FIN_CHUNKS)
    finalize_sums(const float* __restrict__ part, const SumOuts o, int tiles,
                  int stride) {
  __shared__ double red[FIN_CHUNKS][FIN_COLS + 1];
  const int col = threadIdx.x % FIN_COLS, chunk = threadIdx.x / FIN_COLS;
  const int c = blockIdx.x * FIN_COLS + col;
  const size_t n = blockIdx.y;
  const int ncols = o.start[o.count];
  const int per = (tiles + FIN_CHUNKS - 1) / FIN_CHUNKS;
  const int t0 = chunk * per;
  const int t1 = t0 + per < tiles ? t0 + per : tiles;
  double acc = 0.0;
  if (c < ncols) {
    const float* p = part + n * tiles * stride + c;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) acc += p[(size_t)t * stride];
  }
  red[chunk][col] = acc;
  __syncthreads();
  if (chunk != 0 || c >= ncols) return;
  double sum = 0.0;
  for (int k = 0; k < FIN_CHUNKS; ++k) sum += red[k][col];
  int k = 0;
  while (c >= o.start[k + 1]) ++k;
  const int width = o.start[k + 1] - o.start[k];
  o.out[k][n * width + c - o.start[k]] = static_cast<float>(sum);
}

inline void launch_finalize(const float* part, const SumOuts& o, int N,
                            int tiles, int stride, cudaStream_t s) {
  const dim3 grid((o.start[o.count] + FIN_COLS - 1) / FIN_COLS, N);
  finalize_sums<<<grid, FIN_COLS * FIN_CHUNKS, 0, s>>>(part, o, tiles,
                                                        stride);
}

}  // namespace q8

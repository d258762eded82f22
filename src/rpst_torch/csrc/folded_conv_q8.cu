// B4 on Hopper: the int8 fused folded conv of the quantized serving path.
//
// Replaces the TPU kernel `fused_folded_conv_q8` in
// src/rpst/ops/pallas/folded_conv_q8.py (wrapper :281, body `_make_kernel`
// :72). On the folded (space-to-depth) NHWC layout it computes
//
//   y   = lrelu_0.2(float(conv3x3(reflect_ring(x)) as int32) * deq + bias)
//   out = clip(round_half_even(y * inv), -127, 127) as int8, or bf16(y)
//
// with x (N, H, W, 4C) int8, the folded kernel w (3, 3, 4C, 4Co) int8 HWIO,
// scales (3, 4Co) float rows [deq = x_scale * w_scale, bias, inv =
// 1 / out_scale]. With stats it also writes s1 = sum y and s2 = sum y^2
// per image and channel, float, over the post-activation values before
// requantization (the AdaIN statistics of rpst's fused epilogue). The
// epilogue rounds exactly as rpst's (q8_common.cuh), so int8 and bf16
// outputs are bit-equal to the plain version.
//
// The reflect ring, rows and columns, is built here from x as tiles are
// staged (rpst builds the ring rows on the host, :317-318): ring row -1
// takes its first 2C channels from row 1 and the rest from row 0, row H
// from rows H-1 / H-2; ring column -1 takes sub-column-0 blocks {0, 2} from
// column 1 and blocks {1, 3} from column 0, column W from W-1 / W-2.
//
// What bounds it on the card. At 512px a 128->128 folded layer is 256 *
// 256 * 128 * 128 * 9 = 9.7 G multiply-adds; __dp4a does 4 a lane, so 2.4
// G instructions, against 64 per SM and clock on an H100 (about 0.17 ms at
// 1.7 GHz on 132 SMs). Its int8 activations are 8 MB in and out per 512px
// image, 5 us at 3.35 TB/s. So it is bound by the integer pipe and by
// feeding it from shared memory, not by device memory.
//
// What this simple design does about it. One block owns a TH x TW tile of
// folded pixels and TCO = 128 output channels (all of them on the
// flagship's path, so each input word is staged once). It walks the input
// channels in chunks of KW words: it stages the input tile plus its
// one-pixel halo (reflect ring included) as packed words, and the chunk's
// 9 taps of weights repacked to input-channel words, in shared memory.
// Each thread then accumulates a PX-pixel x TN-channel int32 register tile
// with __dp4a: one weight word read serves PX pixels, one input word 3 taps
// x TN channels. The thread's channels are interleaved (4 consecutive per
// group of 32) so that a warp's 16-byte weight reads hit distinct banks.
// Stats: per-thread sums, a fixed shuffle/warp-order block reduction into a
// per-tile partial, and a second kernel that sums the tiles in order
// (deterministic; no float atomics). No tensor cores yet (int8 mma/wgmma),
// no TMA: that is later work held to this kernel.

#include "q8_common.cuh"

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output cols per block
constexpr int PX = 4;        // consecutive output pixels per thread (along W)
constexpr int CG = 8;        // channel groups per block
constexpr int TN = 16;       // output channels per thread
constexpr int TCO = CG * TN;                    // 128 channels per block
constexpr int THREADS = CG * (TH * TW / PX);    // 256
constexpr int KW = 8;        // input words (32 channels) per chunk

template <bool OUT_INT8, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
    folded_conv_q8_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scales, void* y,
                          float* __restrict__ part, int H, int W, int C4,
                          int C4o, int tiles_w) {
  __shared__ int32_t xs[KW][TH + 2][TW + 2];
  __shared__ __align__(16) int32_t ws[9 * KW * TCO];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int n = blockIdx.z;
  const int CW = C4 / 4;

  const int tc = tid % CG;
  const int tp = tid / CG;
  const int ty = tp / (TW / PX);
  const int tx = (tp % (TW / PX)) * PX;

  const int8_t* xn = x + (size_t)n * H * W * C4;

  int32_t acc[PX][TN];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0;

  for (int cw0 = 0; cw0 < CW; cw0 += KW) {
    // ---- input tile + halo as words; ring rows/cols by the folded rule,
    // zeros beyond them (ragged tiles) and past 4C
    for (int idx = tid; idx < KW * (TH + 2) * (TW + 2); idx += THREADS) {
      const int cw = idx % KW;
      const int pix = idx / KW;
      const int cc = pix % (TW + 2);
      const int rr = pix / (TW + 2);
      const int g = 4 * (cw0 + cw);
      const int rg = r0 - 1 + rr;
      const int cg = c0 - 1 + cc;
      int32_t v = 0;
      if (g < C4 && rg <= H && cg <= W) {
        const int sr = q8::ring_row(rg, H, q8::first_half(g, C4));
        const int sc = q8::ring_col(cg, W, q8::subcol0(g, C4));
        v = *reinterpret_cast<const int32_t*>(
            xn + ((size_t)sr * W + sc) * C4 + g);
      }
      xs[cw][rr][cc] = v;
    }
    q8::stage_weights(w, ws, TCO, C4, C4o, cw0, KW, co0, TCO / 4, tid,
                      THREADS);
    __syncthreads();

#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll 2
      for (int cw = 0; cw < KW; ++cw) {
        int32_t a[PX + 2];
#pragma unroll
        for (int m = 0; m < PX + 2; ++m) a[m] = xs[cw][ty + dr][tx + m];
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int4* wp = reinterpret_cast<const int4*>(
              ws + ((dr * 3 + dc) * KW + cw) * TCO);
          int32_t wq[TN];
#pragma unroll
          for (int j = 0; j < TN / 4; ++j) {
            const int4 v = wp[j * CG + tc];
            wq[4 * j] = v.x; wq[4 * j + 1] = v.y;
            wq[4 * j + 2] = v.z; wq[4 * j + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              acc[p][q] = __dp4a(a[p + dc], wq[q], acc[p][q]);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: the thread's channels j * (CG * 4) + tc * 4 + e, in
  // groups of 4 consecutive (one packed store per pixel and group)
  float s1[TN], s2[TN];
  const int r = r0 + ty;
#pragma unroll
  for (int j = 0; j < TN / 4; ++j) {
    const int go = co0 + j * (CG * 4) + tc * 4;
    const bool okc = go < C4o;  // C4o % 4 == 0: all 4 channels or none
    float deq[4], bias[4], inv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      deq[e] = okc ? __ldg(scales + go + e) : 0.f;
      bias[e] = okc ? __ldg(scales + C4o + go + e) : 0.f;
      inv[e] = okc ? __ldg(scales + 2 * C4o + go + e) : 0.f;
      s1[4 * j + e] = 0.f;
      s2[4 * j + e] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int c = c0 + tx + p;
      const bool valid = r < H && c < W;
      float v[4];
      uint32_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = q8::epilogue(acc[p][4 * j + e], deq[e], bias[e]);
        if constexpr (STATS) {
          if (valid) {
            s1[4 * j + e] += v[e];
            s2[4 * j + e] += v[e] * v[e];
          }
        }
        if constexpr (OUT_INT8) b[e] = q8::requant(v[e], inv[e]);
      }
      if (valid && okc) {
        const size_t off = (((size_t)n * H + r) * W + c) * C4o + go;
        if constexpr (OUT_INT8)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y) + off) =
              q8::pack4(b);
        else
          q8::store_bf16x4(static_cast<__nv_bfloat16*>(y) + off, v);
      }
    }
  }

  if constexpr (STATS) {
    // the weight tile is free after the last chunk's barrier
    float* red = reinterpret_cast<float*>(ws);
    const int n_co = min(TCO, C4o - co0);
    const int tiles = gridDim.x;
    float* p1 = part + ((size_t)n * tiles + tile) * 2 * C4o + co0;
    q8::block_channel_sums<TN, CG>(s1, red, p1, n_co, tid, THREADS);
    q8::block_channel_sums<TN, CG>(s2, red, p1 + C4o, n_co, tid, THREADS);
  }
}

template <bool OUT_INT8, bool STATS>
void launch_main(const int8_t* x, const int8_t* w, const float* scales,
                 void* y, float* part, int N, int H, int W, int C4, int C4o,
                 cudaStream_t s) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_w * ((H + TH - 1) / TH);
  dim3 grid(tiles, (C4o + TCO - 1) / TCO, N);
  folded_conv_q8_kernel<OUT_INT8, STATS><<<grid, THREADS, 0, s>>>(
      x, w, scales, y, part, H, W, C4, C4o, tiles_w);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors (x, w int8; scales, s1, s2 float; y int8 or bf16); `part` is
// float scratch of N * tiles * 2 * C4o (tiles from rpst_folded_conv_q8_tiles)
// and s1, s2, part may be null without stats. Needs C4 % 16 == 0, C4o % 4
// == 0, H, W >= 2. Returns the cudaError_t of the launches.
extern "C" int rpst_folded_conv_q8_tiles(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

extern "C" int rpst_folded_conv_q8(const void* x, const void* w,
                                   const void* scales, void* y, void* s1,
                                   void* s2, void* part, int N, int H, int W,
                                   int C4, int C4o, int out_int8,
                                   int with_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  float* pp = static_cast<float*>(part);
  if (out_int8 && with_stats)
    launch_main<true, true>(xp, wp, sp, y, pp, N, H, W, C4, C4o, s);
  else if (out_int8)
    launch_main<true, false>(xp, wp, sp, y, pp, N, H, W, C4, C4o, s);
  else if (with_stats)
    launch_main<false, true>(xp, wp, sp, y, pp, N, H, W, C4, C4o, s);
  else
    launch_main<false, false>(xp, wp, sp, y, pp, N, H, W, C4, C4o, s);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !with_stats) return err;
  const int tiles = rpst_folded_conv_q8_tiles(H, W);
  q8::launch_finalize(pp, static_cast<float*>(s1), N, tiles, 2 * C4o, C4o, s);
  q8::launch_finalize(pp + C4o, static_cast<float*>(s2), N, tiles, 2 * C4o,
                      C4o, s);
  return static_cast<int>(cudaGetLastError());
}

// B7 on Hopper: two chained int8 folded conv layers in one kernel.
//
// Replaces the TPU kernel `fused_folded_conv2_q8` in
// src/rpst/ops/pallas/folded_conv2_q8.py (wrapper :254, body
// `_make_kernel2` :79). It computes, on the folded NHWC layout,
//
//   y1 = B4(x,  w1, scales1, int8 out)       (N, H, W, 4Cm) int8
//   y2 = B4(y1, w2, scales2, int8 or bf16)   (N, H, W, 4Co)
//
// bit-equal to two B4 launches (folded_conv_q8.cu): the same int32 sums, the
// same f32 epilogue and requantization (q8_common.cuh), and layer 2 reads
// the requantized y1 with its reflect ring built from y1 itself. With stats
// it writes the four per-image channel sums of both layers' post-activation
// values (s11, s12 over y1; s21, s22 over y2), as B4 does for one layer.
//
// What bounds it on the card. Each layer's arithmetic is B4's (9.7 G
// multiply-adds per 128->128 layer of a 512px image, on the __dp4a pipe);
// the pair saves only the read of y1 from device memory (8 MB per 512px
// image), and pays for the halo of layer 1 it recomputes. Which of the two
// wins is a measurement (PERF.md), as it was on the TPU (rpst.policy
// FUSED2_ENCODE).
//
// What the design does about it. rpst keeps whole rows in VMEM; a block
// here owns a TH x TW tile of output pixels and keeps in shared memory:
// the input tile with a 2-pixel halo (x's reflect ring rows and columns
// built as it is staged), one layer's full repacked weights (at most 4C,
// 4Cm, 4Co = 128: 147 KB of dynamic shared memory, the only way both fit),
// and layer 1's requantized output over the tile plus a 1-pixel halo.
// Layer 1 is computed at every in-image position of that halo region
// (recomputed by the neighbouring blocks too, identically), so no block
// waits on another. The halo positions outside the image are then filled
// by the reflect rule from the computed ones (rows by channel half,
// columns by sub-column block, as rpst's `_lane_select_half` and
// `_col_shifts` do at :197-204), w2 replaces w1, and layer 2 runs on the
// tile. Layer-1 statistics are summed over the tile's own positions only,
// never over the recomputed halo. Stats reduce per tile in a fixed order
// and a second kernel sums the tiles in order (deterministic).

#include "q8_common.cuh"

namespace {

constexpr int TH = 8;                 // output rows per block
constexpr int TW = 16;                // output cols per block
constexpr int R1H = TH + 2;           // layer-1 rows computed (1-pixel halo)
constexpr int R1W = TW + 2;
constexpr int XH = TH + 4;            // input rows staged (2-pixel halo)
constexpr int XW = TW + 4;
constexpr int CG = 8;                 // channel groups per block
constexpr int TN = 16;                // output channels per thread
constexpr int TCO = CG * TN;          // 128: every channel of a layer
constexpr int THREADS = 256;
constexpr int PX1 = 3;                // layer-1 pixels per item (R1W = 6 * 3)
constexpr int PX2 = 4;                // layer-2 pixels per item (TW = 4 * 4)
static_assert(R1W % PX1 == 0 && TW % PX2 == 0, "item widths");

size_t smem_words(int C4, int C4m) {
  const int CW = C4 / 4, CWm = C4m / 4;
  return (size_t)CW * XH * XW + (size_t)9 * (CW > CWm ? CW : CWm) * TCO +
         (size_t)CWm * R1H * R1W + 8 * 128;
}

// acc[p][q] += conv over the `cw_n` input words of `src` (word-major planes
// of `rows` x `cols` words) at rows row0 + dr, cols col0 + p + dc, with the
// weights `wt` [(tap * cw_n + cw) * TCO + channel].
template <int PX>
__device__ __forceinline__ void conv_item(const int32_t* __restrict__ src,
                                          int rows, int cols, int cw_n,
                                          const int32_t* __restrict__ wt,
                                          int row0, int col0, int tc,
                                          int32_t (&acc)[PX][TN]) {
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0;
#pragma unroll
  for (int dr = 0; dr < 3; ++dr) {
#pragma unroll 2
    for (int cw = 0; cw < cw_n; ++cw) {
      const int32_t* row = src + ((size_t)cw * rows + row0 + dr) * cols + col0;
      int32_t a[PX + 2];
#pragma unroll
      for (int m = 0; m < PX + 2; ++m) a[m] = row[m];
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        const int4* wp = reinterpret_cast<const int4*>(
            wt + ((dr * 3 + dc) * cw_n + cw) * TCO);
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
}

template <bool OUT2_INT8, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    folded_conv2_q8_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w1,
                           const float* __restrict__ sc1,
                           const int8_t* __restrict__ w2,
                           const float* __restrict__ sc2,
                           int8_t* __restrict__ y1, void* y2,
                           float* __restrict__ part, int H, int W, int C4,
                           int C4m, int C4o, int tiles_w) {
  extern __shared__ __align__(16) int32_t smem[];
  const int CW = C4 / 4, CWm = C4m / 4;
  int32_t* xt = smem;                                  // [CW][XH][XW]
  int32_t* wt = xt + CW * XH * XW;                     // [9][CW|CWm][TCO]
  int32_t* y1s = wt + 9 * (CW > CWm ? CW : CWm) * TCO;  // [CWm][R1H][R1W]
  float* red = reinterpret_cast<float*>(y1s + CWm * R1H * R1W);  // [8][128]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int n = blockIdx.z;
  const int tc = tid % CG;
  const int tiles = gridDim.x;
  const int stride = 2 * C4m + 2 * C4o;  // floats of one tile's partials
  float* tpart = part + ((size_t)n * tiles + tile) * stride;

  // ---- stage x rows r0-2 .. r0+TH+1, cols c0-2 .. c0+TW+1 with the
  // reflect ring at -1 / H / W; positions beyond the ring are never read
  // by an in-image layer-1 position and stay zero
  const int8_t* xn = x + (size_t)n * H * W * C4;
  for (int idx = tid; idx < CW * XH * XW; idx += THREADS) {
    const int cw = idx % CW;
    const int pix = idx / CW;
    const int cc = pix % XW;
    const int rr = pix / XW;
    const int g = 4 * cw;
    const int rg = r0 - 2 + rr;
    const int cg = c0 - 2 + cc;
    int32_t v = 0;
    if (rg >= -1 && rg <= H && cg >= -1 && cg <= W) {
      const int sr = q8::ring_row(rg, H, q8::first_half(g, C4));
      const int sc = q8::ring_col(cg, W, q8::subcol0(g, C4));
      v = *reinterpret_cast<const int32_t*>(xn + ((size_t)sr * W + sc) * C4 +
                                            g);
    }
    xt[(cw * XH + rr) * XW + cc] = v;
  }
  q8::stage_weights(w1, wt, TCO, C4, C4m, 0, CW, 0, TCO / 4, tid, THREADS);
  __syncthreads();

  // ---- layer 1 over the R1H x R1W region (image rows r0-1.., cols c0-1..)
  float s11[TN], s12[TN];
#pragma unroll
  for (int q = 0; q < TN; ++q) s11[q] = s12[q] = 0.f;
  for (int it = tid; it < R1H * (R1W / PX1) * CG; it += THREADS) {
    const int pg = it / CG;
    const int rr = pg / (R1W / PX1);
    const int cc0 = (pg % (R1W / PX1)) * PX1;
    int32_t acc[PX1][TN];
    conv_item<PX1>(xt, XH, XW, CW, wt, rr, cc0, tc, acc);
    const int r = r0 - 1 + rr;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int go = j * (CG * 4) + tc * 4;
      const bool okc = go < C4m;
      float deq[4], bias[4], inv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        deq[e] = okc ? __ldg(sc1 + go + e) : 0.f;
        bias[e] = okc ? __ldg(sc1 + C4m + go + e) : 0.f;
        inv[e] = okc ? __ldg(sc1 + 2 * C4m + go + e) : 0.f;
      }
#pragma unroll
      for (int p = 0; p < PX1; ++p) {
        const int cc = cc0 + p;
        const int c = c0 - 1 + cc;
        const bool owned = r >= 0 && r < H && c >= 0 && c < W && rr >= 1 &&
                           rr <= TH && cc >= 1 && cc <= TW;
        uint32_t b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = q8::epilogue(acc[p][4 * j + e], deq[e], bias[e]);
          if constexpr (STATS) {
            if (owned) {
              s11[4 * j + e] += v;
              s12[4 * j + e] += v * v;
            }
          }
          b[e] = q8::requant(v, inv[e]);
        }
        if (okc) {
          const uint32_t word = q8::pack4(b);
          y1s[((go / 4) * R1H + rr) * R1W + cc] = static_cast<int32_t>(word);
          if (owned)
            *reinterpret_cast<uint32_t*>(
                y1 + (((size_t)n * H + r) * W + c) * C4m + go) = word;
        }
      }
    }
  }
  __syncthreads();  // y1s complete; w1 and the x tile no longer read

  if constexpr (STATS) {
    q8::block_channel_sums<TN, CG>(s11, red, tpart, C4m, tid, THREADS);
    q8::block_channel_sums<TN, CG>(s12, red, tpart + C4m, C4m, tid, THREADS);
  }

  // ---- layer 2's reflect ring from y1 (out-of-image halo positions take
  // the in-image position the folded rule names), and w2 in place of w1
  for (int idx = tid; idx < CWm * R1H * R1W; idx += THREADS) {
    const int cw = idx % CWm;
    const int pix = idx / CWm;
    const int cc = pix % R1W;
    const int rr = pix / R1W;
    const int r = r0 - 1 + rr;
    const int c = c0 - 1 + cc;
    const bool on_ring = r == -1 || r == H || c == -1 || c == W;
    if (on_ring && r >= -1 && r <= H && c >= -1 && c <= W) {
      const int g = 4 * cw;
      const int sr = q8::ring_row(r, H, q8::first_half(g, C4m));
      const int sc = q8::ring_col(c, W, q8::subcol0(g, C4m));
      y1s[(cw * R1H + rr) * R1W + cc] =
          y1s[(cw * R1H + (sr - r0 + 1)) * R1W + (sc - c0 + 1)];
    }
  }
  q8::stage_weights(w2, wt, TCO, C4m, C4o, 0, CWm, 0, TCO / 4, tid, THREADS);
  __syncthreads();

  // ---- layer 2 over the owned TH x TW tile
  float s21[TN], s22[TN];
#pragma unroll
  for (int q = 0; q < TN; ++q) s21[q] = s22[q] = 0.f;
  for (int it = tid; it < TH * (TW / PX2) * CG; it += THREADS) {
    const int pg = it / CG;
    const int ty = pg / (TW / PX2);
    const int tx = (pg % (TW / PX2)) * PX2;
    int32_t acc[PX2][TN];
    conv_item<PX2>(y1s, R1H, R1W, CWm, wt, ty, tx, tc, acc);
    const int r = r0 + ty;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int go = j * (CG * 4) + tc * 4;
      const bool okc = go < C4o;
      float deq[4], bias[4], inv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        deq[e] = okc ? __ldg(sc2 + go + e) : 0.f;
        bias[e] = okc ? __ldg(sc2 + C4o + go + e) : 0.f;
        inv[e] = okc ? __ldg(sc2 + 2 * C4o + go + e) : 0.f;
      }
#pragma unroll
      for (int p = 0; p < PX2; ++p) {
        const int c = c0 + tx + p;
        const bool valid = r < H && c < W;
        float v[4];
        uint32_t b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = q8::epilogue(acc[p][4 * j + e], deq[e], bias[e]);
          if constexpr (STATS) {
            if (valid) {
              s21[4 * j + e] += v[e];
              s22[4 * j + e] += v[e] * v[e];
            }
          }
          if constexpr (OUT2_INT8) b[e] = q8::requant(v[e], inv[e]);
        }
        if (valid && okc) {
          const size_t off = (((size_t)n * H + r) * W + c) * C4o + go;
          if constexpr (OUT2_INT8)
            *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y2) + off) =
                q8::pack4(b);
          else
            q8::store_bf16x4(static_cast<__nv_bfloat16*>(y2) + off, v);
        }
      }
    }
  }

  if constexpr (STATS) {
    q8::block_channel_sums<TN, CG>(s21, red, tpart + 2 * C4m, C4o, tid,
                                   THREADS);
    q8::block_channel_sums<TN, CG>(s22, red, tpart + 2 * C4m + C4o, C4o, tid,
                                   THREADS);
  }
}

template <bool OUT2_INT8, bool STATS>
int launch_main(const int8_t* x, const int8_t* w1, const float* sc1,
                const int8_t* w2, const float* sc2, int8_t* y1, void* y2,
                float* part, int N, int H, int W, int C4, int C4m, int C4o,
                cudaStream_t s) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_w * ((H + TH - 1) / TH);
  const size_t bytes = 4 * smem_words(C4, C4m);
  auto kernel = folded_conv2_q8_kernel<OUT2_INT8, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles, 1, N);
  kernel<<<grid, THREADS, bytes, s>>>(x, w1, sc1, w2, sc2, y1, y2, part, H,
                                      W, C4, C4m, C4o, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors (x, w1, w2, y1 int8; scales, stats float; y2 int8 or bf16);
// `part` is float scratch of N * tiles * (2 * C4m + 2 * C4o) (tiles from
// rpst_folded_conv2_q8_tiles); the stats and part may be null without
// stats. Needs C4 % 16 == 0, C4m % 16 == 0, C4o % 4 == 0, each <= 128, and
// H, W >= 2. Returns the cudaError_t of the launches.
extern "C" int rpst_folded_conv2_q8_tiles(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

extern "C" int rpst_folded_conv2_q8(
    const void* x, const void* w1, const void* scales1, const void* w2,
    const void* scales2, void* y1, void* y2, void* s11, void* s12, void* s21,
    void* s22, void* part, int N, int H, int W, int C4, int C4m, int C4o,
    int out_int8, int with_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* w1p = static_cast<const int8_t*>(w1);
  const int8_t* w2p = static_cast<const int8_t*>(w2);
  const float* s1p = static_cast<const float*>(scales1);
  const float* s2p = static_cast<const float*>(scales2);
  int8_t* y1p = static_cast<int8_t*>(y1);
  float* pp = static_cast<float*>(part);
  int err;
  if (out_int8 && with_stats)
    err = launch_main<true, true>(xp, w1p, s1p, w2p, s2p, y1p, y2, pp, N, H,
                                  W, C4, C4m, C4o, s);
  else if (out_int8)
    err = launch_main<true, false>(xp, w1p, s1p, w2p, s2p, y1p, y2, pp, N, H,
                                   W, C4, C4m, C4o, s);
  else if (with_stats)
    err = launch_main<false, true>(xp, w1p, s1p, w2p, s2p, y1p, y2, pp, N, H,
                                   W, C4, C4m, C4o, s);
  else
    err = launch_main<false, false>(xp, w1p, s1p, w2p, s2p, y1p, y2, pp, N,
                                    H, W, C4, C4m, C4o, s);
  if (err != 0 || !with_stats) return err;
  const int tiles = rpst_folded_conv2_q8_tiles(H, W);
  const int stride = 2 * C4m + 2 * C4o;
  q8::launch_finalize(pp, static_cast<float*>(s11), N, tiles, stride, C4m, s);
  q8::launch_finalize(pp + C4m, static_cast<float*>(s12), N, tiles, stride,
                      C4m, s);
  q8::launch_finalize(pp + 2 * C4m, static_cast<float*>(s21), N, tiles,
                      stride, C4o, s);
  q8::launch_finalize(pp + 2 * C4m + C4o, static_cast<float*>(s22), N, tiles,
                      stride, C4o, s);
  return static_cast<int>(cudaGetLastError());
}

// B5 on Hopper: the standard-layout 3x3 conv of the wide-channel paths, int8
// (quantized serving, int8 VGG loss targets) and bf16.
//
// Replaces the TPU kernels `fused_conv2d_q8` (wrapper :220) and
// `fused_conv2d_bf16` (:154) of src/rpst/ops/pallas/conv2d_q8.py, which
// share the body `_make_kernel` (:36). On the plain NHWC layout:
//
//   int8:  y   = act(float(conv3x3(pad(x)) as int32) * deq + bias)
//          out = clip(round_half_even(y * inv), -127, 127) as int8, or bf16(y)
//   bf16:  out = bf16(act(conv3x3(pad(x)) in float + bias))
//   act(y) = y >= 0 ? y : alpha * y   (alpha 0 = relu, 1 = none, 0.2 = lrelu)
//
// with x (N, H, W, C), w (3, 3, C, Co) HWIO, and for int8 scales (3, Co)
// float rows [deq = x_scale * w_scale, bias, inv = 1 / out_scale]. `pad` is
// one pixel of reflection (row -1 = row 1, row H = row H-2, the same for
// columns) or of zeros, which is exact on int8 because the quantizer is
// symmetric. The halo is read by index while a tile is staged: there are no
// row slabs and no `rings` operand as in the TPU kernel. The int8 epilogue
// rounds as rpst's does (q8_common.cuh: two roundings, no FMA, half to
// even), so int8 and bf16 outputs are bit-equal to the plain version.
//
// What bounds it on the card. The widest layer of a 512px adain stylize,
// (2, 512, 512, 256 -> 512), is 6.2e11 multiply-adds; __dp4a does 4 a lane,
// 64 lanes per SM and clock, so about 11 ms at 1.7 GHz on 132 SMs, against
// 0.6 ms on the int8 tensor cores and 0.12 ms for its 400 MB of device
// memory traffic. So it is bound by operations: by the integer pipe and by
// feeding it from shared memory.
//
// What this simple design does about it. B4's tiling (folded_conv_q8.cu)
// on the unfolded layout: one block owns a TH x TW tile of pixels and TCO =
// 128 output channels, walks the input channels in chunks of KW words,
// stages the input tile with its halo as packed words and the chunk's 9
// taps of weights repacked to input-channel words, and each thread
// accumulates PX pixels x TN channels in int32 registers. The bf16 mode has
// the same tiling on CUDA-core FMAs with float staging (no path of the port
// calls it; it is held against its plain version). No tensor cores yet
// (int8 mma/wgmma), no TMA: that is later work held to this kernel.

#include "q8_common.cuh"

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output cols per block
constexpr int PX = 4;        // consecutive output pixels per thread (along W)
constexpr int CG = 8;        // channel groups per block
constexpr int TN = 16;       // output channels per thread
constexpr int TCO = CG * TN;                    // 128 channels per block
constexpr int THREADS = CG * (TH * TW / PX);    // 256
constexpr int KW = 8;        // int8: input words (32 channels) per chunk
constexpr int KC = 8;        // bf16: input channels per chunk

// Source row/column of padded index i in [-1, n]: itself inside the image;
// for reflect -1 -> 1 and n -> n - 2; -1 (no source: zero) otherwise.
template <bool REFLECT>
__device__ __forceinline__ int pad_src(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (!REFLECT) return -1;
  if (i == -1) return 1;
  if (i == n) return n - 2;
  return -1;
}

template <bool OUT_INT8, bool REFLECT>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_q8_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scales, void* y, int H, int W,
                     int C, int Co, int tiles_w, float alpha) {
  __shared__ int32_t xs[KW][TH + 2][TW + 2];
  __shared__ __align__(16) int32_t ws[9 * KW * TCO];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int n = blockIdx.z;
  const int CW = C / 4;

  const int tc = tid % CG;
  const int tp = tid / CG;
  const int ty = tp / (TW / PX);
  const int tx = (tp % (TW / PX)) * PX;

  const int8_t* xn = x + (size_t)n * H * W * C;

  int32_t acc[PX][TN];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0;

  for (int cw0 = 0; cw0 < CW; cw0 += KW) {
    // ---- input tile + halo as words; zeros where the pad is zero, beyond
    // the halo of a ragged tile, and past C
    for (int idx = tid; idx < KW * (TH + 2) * (TW + 2); idx += THREADS) {
      const int cw = idx % KW;
      const int pix = idx / KW;
      const int cc = pix % (TW + 2);
      const int rr = pix / (TW + 2);
      const int g = 4 * (cw0 + cw);
      const int sr = pad_src<REFLECT>(r0 - 1 + rr, H);
      const int sc = pad_src<REFLECT>(c0 - 1 + cc, W);
      int32_t v = 0;
      if (g < C && sr >= 0 && sc >= 0)
        v = *reinterpret_cast<const int32_t*>(
            xn + ((size_t)sr * W + sc) * C + g);
      xs[cw][rr][cc] = v;
    }
    q8::stage_weights(w, ws, TCO, C, Co, cw0, KW, co0, TCO / 4, tid, THREADS);
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
  const int r = r0 + ty;
#pragma unroll
  for (int j = 0; j < TN / 4; ++j) {
    const int go = co0 + j * (CG * 4) + tc * 4;
    const bool okc = go < Co;  // Co % 4 == 0: all 4 channels or none
    float deq[4], bias[4], inv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      deq[e] = okc ? __ldg(scales + go + e) : 0.f;
      bias[e] = okc ? __ldg(scales + Co + go + e) : 0.f;
      inv[e] = (okc && OUT_INT8) ? __ldg(scales + 2 * Co + go + e) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int c = c0 + tx + p;
      float v[4];
      uint32_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = q8::epilogue_alpha(acc[p][4 * j + e], deq[e], bias[e], alpha);
        if constexpr (OUT_INT8) b[e] = q8::requant(v[e], inv[e]);
      }
      if (r < H && c < W && okc) {
        const size_t off = (((size_t)n * H + r) * W + c) * Co + go;
        if constexpr (OUT_INT8)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y) + off) =
              q8::pack4(b);
        else
          q8::store_bf16x4(static_cast<__nv_bfloat16*>(y) + off, v);
      }
    }
  }
}

// bf16 in, float accumulate, bf16 out: the same tiling, operands staged as
// floats, KC input channels per chunk.
template <bool REFLECT>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int H, int W, int C,
                       int Co, int tiles_w, float alpha) {
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9 * KC * TCO];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int n = blockIdx.z;

  const int tc = tid % CG;
  const int tp = tid / CG;
  const int ty = tp / (TW / PX);
  const int tx = (tp % (TW / PX)) * PX;

  const __nv_bfloat16* xn = x + (size_t)n * H * W * C;

  float acc[PX][TN];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0.f;

  for (int k0 = 0; k0 < C; k0 += KC) {  // C % KC == 0
    // ---- input tile + halo: one 16-byte read (8 channels) per pixel
    for (int pix = tid; pix < (TH + 2) * (TW + 2); pix += THREADS) {
      const int cc = pix % (TW + 2);
      const int rr = pix / (TW + 2);
      const int sr = pad_src<REFLECT>(r0 - 1 + rr, H);
      const int sc = pad_src<REFLECT>(c0 - 1 + cc, W);
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (sr >= 0 && sc >= 0)
        u = *reinterpret_cast<const uint4*>(xn + ((size_t)sr * W + sc) * C +
                                            k0);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int k = 0; k < KC; ++k) xs[k][rr][cc] = __bfloat162float(h[k]);
    }
    // ---- the chunk's 9 taps of weights: ws[(tap * KC + k) * TCO + co]
    for (int u8 = tid; u8 < 9 * KC * (TCO / 8); u8 += THREADS) {
      const int co8 = u8 % (TCO / 8);
      const int k = (u8 / (TCO / 8)) % KC;
      const int tap = u8 / ((TCO / 8) * KC);
      const int go = co0 + 8 * co8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (go < Co)  // Co % 8 == 0: all 8 channels or none
        u = *reinterpret_cast<const uint4*>(
            w + ((size_t)tap * C + k0 + k) * Co + go);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
      float* dst = ws + (tap * KC + k) * TCO + 8 * co8;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
    }
    __syncthreads();

#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll 2
      for (int k = 0; k < KC; ++k) {
        float a[PX + 2];
#pragma unroll
        for (int m = 0; m < PX + 2; ++m) a[m] = xs[k][ty + dr][tx + m];
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((dr * 3 + dc) * KC + k) * TCO);
          float wq[TN];
#pragma unroll
          for (int j = 0; j < TN / 4; ++j) {
            const float4 v = wp[j * CG + tc];
            wq[4 * j] = v.x; wq[4 * j + 1] = v.y;
            wq[4 * j + 2] = v.z; wq[4 * j + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              acc[p][q] = fmaf(a[p + dc], wq[q], acc[p][q]);
        }
      }
    }
    __syncthreads();
  }

  const int r = r0 + ty;
#pragma unroll
  for (int j = 0; j < TN / 4; ++j) {
    const int go = co0 + j * (CG * 4) + tc * 4;
    const bool okc = go < Co;
    float b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = okc ? __ldg(bias + go + e) : 0.f;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int c = c0 + tx + p;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = acc[p][4 * j + e] + b[e];
        v[e] = t >= 0.f ? t : alpha * t;
      }
      if (r < H && c < W && okc)
        q8::store_bf16x4(y + (((size_t)n * H + r) * W + c) * Co + go, v);
    }
  }
}

dim3 grid_of(int N, int H, int W, int Co, int* tiles_w) {
  *tiles_w = (W + TW - 1) / TW;
  return dim3(*tiles_w * ((H + TH - 1) / TH), (Co + TCO - 1) / TCO, N);
}

template <bool OUT_INT8, bool REFLECT>
void launch_q8(const int8_t* x, const int8_t* w, const float* scales, void* y,
               int N, int H, int W, int C, int Co, float alpha,
               cudaStream_t s) {
  int tiles_w;
  const dim3 grid = grid_of(N, H, W, Co, &tiles_w);
  conv2d_q8_kernel<OUT_INT8, REFLECT><<<grid, THREADS, 0, s>>>(
      x, w, scales, y, H, W, C, Co, tiles_w, alpha);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous,
// 16-byte aligned tensors. Each returns the cudaError_t of its launch.
//
// int8: x (N, H, W, C) and w (3, 3, C, Co) int8, scales (3, Co) float, y
// int8 (out_int8) or bf16. Needs C % 4 == 0, Co % 4 == 0, H, W >= 2.
extern "C" int rpst_conv2d_q8(const void* x, const void* w,
                              const void* scales, void* y, int N, int H,
                              int W, int C, int Co, int out_int8, int reflect,
                              float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  if (out_int8 && reflect)
    launch_q8<true, true>(xp, wp, sp, y, N, H, W, C, Co, alpha, s);
  else if (out_int8)
    launch_q8<true, false>(xp, wp, sp, y, N, H, W, C, Co, alpha, s);
  else if (reflect)
    launch_q8<false, true>(xp, wp, sp, y, N, H, W, C, Co, alpha, s);
  else
    launch_q8<false, false>(xp, wp, sp, y, N, H, W, C, Co, alpha, s);
  return static_cast<int>(cudaGetLastError());
}

// bf16: x (N, H, W, C), w (3, 3, C, Co) and y (N, H, W, Co) bf16, bias (Co,)
// float. Needs C % 8 == 0, Co % 8 == 0, H, W >= 2.
extern "C" int rpst_conv2d_bf16(const void* x, const void* w,
                                const void* bias, void* y, int N, int H,
                                int W, int C, int Co, int reflect,
                                float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  int tiles_w;
  const dim3 grid = grid_of(N, H, W, Co, &tiles_w);
  if (reflect)
    conv2d_bf16_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, bp, yp, H, W, C,
                                                      Co, tiles_w, alpha);
  else
    conv2d_bf16_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, bp, yp, H, W,
                                                       C, Co, tiles_w, alpha);
  return static_cast<int>(cudaGetLastError());
}

// B1 on Hopper: reflect-ring pad + 3x3 folded conv + bias + leaky ReLU.
//
// Replaces the TPU kernel `fused_folded_conv` in
// src/rpst/ops/pallas/folded_conv.py (wrapper :650, body `_make_kernel` :40).
// It computes, on the folded (space-to-depth) NHWC tensor,
//
//   y = lrelu_alpha(conv3x3(reflect_pad1(x)) + b)
//
// with x (N, Hf, Wf, 4C), the folded kernel k (3, 3, 4C, 4Co) HWIO, the bias
// (4Co,) and y (N, Hf, Wf, 4Co) in x's type (float or bfloat16). The two
// reflect ring ROWS come in as `rings` (N, 2, Wf, 4C): row 0 is read as the
// row above x, row 1 as the row below (the wrapper builds them with
// rpst_torch.ops.folded._row_ring, or a caller overrides them). The reflect
// ring COLUMNS are built here: folded column -1 takes its sub-column-0
// channel blocks {0, 2} from column 1 and its sub-column-1 blocks {1, 3} from
// column 0; column Wf takes them from Wf-1 and Wf-2. A channel g lies in a
// sub-column-0 block when (g / C) % 2 == 0. Corners follow from applying the
// column rule to the ring rows, as ops/folded.py's folded_reflect_pad does.
//
// What bounds it on the card. The folded kernel does 4x the MACs of the
// unfolded conv (3/4 of its taps are structural zeros): at 512px one
// 128->128 folded layer is 256*256*128*128*9*2 = 19.3 GFLOP, against
// 67 TFLOP/s of float32 FMA on an H100 SXM at 700 W (data sheet). Its
// activations are 256*256*128 values in and out: about 16 MB per layer per
// 512px bf16 image, 32 MB in f32, against 3.35 TB/s. So the kernel is
// bound by arithmetic, not by memory, as long as every input value is read
// from device memory about once per block and reused from shared memory.
//
// What this simple design does about it. One block owns an output tile of
// TH x TW folded pixels and TCO output channels. It walks the input
// channels in chunks of KC; for each chunk it stages the input tile plus its
// one-pixel halo (reflect ring included) and the 9 x KC x TCO weights in
// shared memory as float, then every thread accumulates a 4-pixel x TN-channel
// register tile over the 9 taps in float32. Each input value staged serves up
// to 9 taps x TCO channels and each weight TH x TW pixels. The epilogue adds the
// bias, applies lrelu_alpha and stores in x's type. There is no tensor-core
// path yet (wgmma), no TMA, and no skipping of the structural zeros: those
// are for later work; this kernel is the correct baseline they are held to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output cols per block
constexpr int KC = 16;       // input channels per shared-memory chunk
constexpr int PX = 4;        // consecutive output pixels per thread (along W)
constexpr int CG = 8;        // channel groups per block
constexpr int THREADS = CG * (TH * TW / PX);  // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// TN output channels per thread; the block covers TCO = CG * TN channels.
template <typename T, int TN>
__global__ void __launch_bounds__(THREADS)
    folded_conv_kernel(const T* __restrict__ x, const T* __restrict__ rings,
                       const T* __restrict__ k, const T* __restrict__ b,
                       T* __restrict__ y, int H, int W, int C4, int C4o,
                       float alpha, int tiles_w) {
  constexpr int TCO = CG * TN;
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][KC][TCO];

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int n = blockIdx.z;
  const int C = C4 / 4;

  const int tc = tid % CG;             // channels co0 + tc*TN .. + TN-1
  const int tp = tid / CG;             // pixel group
  const int ty = tp / (TW / PX);       // tile row
  const int tx = (tp % (TW / PX)) * PX;  // first tile col of PX consecutive

  const T* xn = x + (size_t)n * H * W * C4;
  const T* rn = rings + (size_t)n * 2 * W * C4;

  float acc[PX][TN];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[j][q] = 0.f;

  for (int ci0 = 0; ci0 < C4; ci0 += KC) {
    // ---- stage the input tile + halo; rows -1/H come from `rings`, cols
    // -1/W are the in-kernel reflect ring columns; beyond that (ragged
    // tiles) and past C4 the tile holds zeros that no stored output reads.
    for (int idx = tid; idx < KC * (TH + 2) * (TW + 2); idx += THREADS) {
      const int ci = idx % KC;
      const int pix = idx / KC;
      const int cc = pix % (TW + 2);
      const int rr = pix / (TW + 2);
      const int g = ci0 + ci;
      const int rg = r0 - 1 + rr;
      const int cg = c0 - 1 + cc;
      float v = 0.f;
      if (g < C4 && rg <= H && cg <= W) {
        const bool subcol0 = ((g / C) & 1) == 0;
        int cs = cg;
        if (cg < 0) cs = subcol0 ? 1 : 0;
        else if (cg == W) cs = subcol0 ? W - 1 : W - 2;
        const T* src;
        if (rg < 0) src = rn + (size_t)cs * C4;
        else if (rg == H) src = rn + ((size_t)W + cs) * C4;
        else src = xn + ((size_t)rg * W + cs) * C4;
        v = to_f32(src[g]);
      }
      xs[ci][rr][cc] = v;
    }
    // ---- stage the 9 x KC x TCO weight chunk (zeros past C4 / C4o)
    for (int idx = tid; idx < 9 * KC * TCO; idx += THREADS) {
      const int co = idx % TCO;
      const int ci = (idx / TCO) % KC;
      const int tap = idx / (TCO * KC);
      const int g = ci0 + ci;
      const int go = co0 + co;
      float v = 0.f;
      if (g < C4 && go < C4o) v = to_f32(k[((size_t)tap * C4 + g) * C4o + go]);
      ws[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll 4
      for (int ci = 0; ci < KC; ++ci) {
        float a[PX + 2];
#pragma unroll
        for (int m = 0; m < PX + 2; ++m) a[m] = xs[ci][ty + dr][tx + m];
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          float w[TN];
          const float* wp = &ws[dr * 3 + dc][ci][tc * TN];
          if constexpr (TN % 4 == 0) {
#pragma unroll
            for (int q = 0; q < TN; q += 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(wp + q);
              w[q] = w4.x; w[q + 1] = w4.y; w[q + 2] = w4.z; w[q + 3] = w4.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < TN; ++q) w[q] = wp[q];
          }
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              acc[j][q] = fmaf(a[j + dc], w[q], acc[j][q]);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: bias + lrelu_alpha in f32, store in T
  const int r = r0 + ty;
  if (r >= H) return;
  float bias[TN];
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    const int go = co0 + tc * TN + q;
    bias[q] = go < C4o ? to_f32(b[go]) : 0.f;
  }
  T* yrow = y + ((size_t)n * H + r) * W * C4o;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int c = c0 + tx + j;
    if (c >= W) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int go = co0 + tc * TN + q;
      if (go < C4o) {
        const float v = acc[j][q] + bias[q];
        yrow[(size_t)c * C4o + go] = from_f32<T>(v >= 0.f ? v : alpha * v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* rings, const void* k, const void* b,
           void* y, int N, int H, int W, int C4, int C4o, float alpha,
           void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_w * ((H + TH - 1) / TH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(rings);
  const T* kp = static_cast<const T*>(k);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (C4o <= 2 * CG) {  // narrow outputs (the 4*3-channel image layer)
    dim3 grid(tiles, (C4o + 2 * CG - 1) / (2 * CG), N);
    folded_conv_kernel<T, 2><<<grid, THREADS, 0, s>>>(
        xp, rp, kp, bp, yp, H, W, C4, C4o, alpha, tiles_w);
  } else {
    dim3 grid(tiles, (C4o + 8 * CG - 1) / (8 * CG), N);
    folded_conv_kernel<T, 8><<<grid, THREADS, 0, s>>>(
        xp, rp, kp, bp, yp, H, W, C4, C4o, alpha, tiles_w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors; `stream` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int rpst_folded_conv_f32(const void* x, const void* rings,
                                    const void* k, const void* b, void* y,
                                    int N, int H, int W, int C4, int C4o,
                                    float alpha, void* stream) {
  return launch<float>(x, rings, k, b, y, N, H, W, C4, C4o, alpha, stream);
}

extern "C" int rpst_folded_conv_bf16(const void* x, const void* rings,
                                     const void* k, const void* b, void* y,
                                     int N, int H, int W, int C4, int C4o,
                                     float alpha, void* stream) {
  return launch<__nv_bfloat16>(x, rings, k, b, y, N, H, W, C4, C4o, alpha,
                               stream);
}

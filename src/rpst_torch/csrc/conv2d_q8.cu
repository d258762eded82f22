// B5 on Hopper: the standard-layout 3x3 conv of the wide-channel paths, int8
// (quantized serving, int8 VGG loss targets) and bf16, on the tensor cores.
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
// with x (N, H, W, C) and, for int8, scales (3, Co) float rows [deq = x_scale
// * w_scale, bias, inv = 1 / out_scale]. `pad` is one pixel of reflection
// (row -1 = row 1, row H = row H-2, the same for columns) or of zeros, which
// is exact on int8 because the quantizer is symmetric. The halo is read by
// index while a tile is staged: there are no row slabs and no `rings` operand
// as in the TPU kernel. The int8 epilogue rounds as rpst's does
// (q8_common.cuh: two roundings, no FMA, half to even) and the int32 sum is
// exact in any order, so int8 and bf16 outputs are bit-equal to the plain
// version.
//
// Weights arrive repacked once per layer (ops/conv2d_q8.py
// `pack_conv2d_weights`), K-major in 32-byte steps: (3, 3, ceil(C / KE), Co,
// KE) with KE = 32 int8 or 16 bf16 input channels, zeros past C. The public
// functions keep taking HWIO.
//
// What bounds it on the card. The widest layer of a 512px adain stylize,
// (2, 512, 512, 256 -> 512), is 1.2e12 operations against 400 MB of tensors:
// 0.6 ms on the int8 tensor cores, 0.12 ms of memory traffic. Bound by
// operations; the integer pipe (__dp4a) cannot go below ~11 ms there.
//
// What the design does about it. An implicit GEMM on `mma.sync` (m16n8k32 s8
// -> s32; m16n8k16 bf16 -> f32 for the bf16 mode): M = the tile's pixels, N =
// output channels, K = 9 taps x C. `mma.sync` and not `wgmma`: wgmma reads A
// through a shared-memory matrix descriptor, which cannot express "the same
// halo tile shifted by one pixel row / column" for a ragged 18-wide halo
// without staging the tile once per tap; with mma.sync a tap is an address
// offset into one staged tile.
//   * A block of 256 threads (8 warps, 4 along pixels x 2 along channels)
//     owns 8 rows x 16 columns of pixels and TCO output channels. An mma row
//     block is 16 consecutive pixels of one tile row. Two tilings are built,
//     TCO = 128 and 64, and a launch takes 128 only when that still gives
//     every SM 16 blocks (`pick_tile`): measured on the H100 at the paths' 14
//     shapes, 128 channels win by 10% on the 512 x 512 layers (4096 blocks
//     and more) and lose by up to 40% on the deep small ones ((2, 32, 32, 512
//     -> 512) is 64 blocks of 128 x 128 for 132 SMs); between 256 and 1024
//     blocks the two read within 7%. A third tiling of 4 rows x 64 channels
//     won at no shape and was dropped.
//   * K is walked in steps of 32 bytes per pixel. The halo tile ((TH + 2) x
//     18 pixels x 32 bytes) is staged once per step and serves all 9 taps;
//     the step's weights are 9 x TCO rows of 32 bytes. Both arrive by
//     `cp.async` (16 bytes, zero-filled for padding, ragged edges, channels
//     past C or Co) into a ring of 2 (TCO = 128) or 3 (TCO = 64) stages, so
//     the next step's loads run under this step's mma, with one
//     __syncthreads a step.
//     C that is no multiple of 16 bytes (C = 36) takes plain 4-byte loads for
//     the input instead, since cp.async needs aligned sources.
//   * Fragments without bank conflicts and without ldmatrix: the order of K
//     inside a step is free as long as A and B agree, so lane t of a quad
//     takes bytes [8t, 8t + 8) of a row for both k-halves of its fragment
//     (one 8-byte shared load); the 4 rows a half-warp reads are 128
//     contiguous bytes.
//   * Epilogue: an accumulator fragment holds 2 adjacent channels of rows g
//     and g + 8; neighbouring lanes swap halves so each ends with 4
//     consecutive channels of one pixel, stored as one packed word (int8) or
//     two (bf16).

#include <type_traits>

#include "mma_common.cuh"
#include "q8_common.cuh"

namespace {

using namespace hmma;  // cp.async, mma_bf16

constexpr int TH = 8;         // tile rows
constexpr int TW = 16;        // tile columns: one mma row block
constexpr int HALO_W = TW + 2;
constexpr int KB = 32;        // bytes of K per pixel and step
constexpr int THREADS = 256;
constexpr int WM = 4;         // warps along pixels
constexpr int WN = 2;         // warps along output channels

template <int TCO>
struct Tile {
  static constexpr int MT = TH / WM;        // mma row blocks per warp
  static constexpr int NT = TCO / WN / 8;   // mma column blocks per warp
  static constexpr int STAGES = TCO == 128 ? 2 : 3;
  static constexpr int X_PIECES = (TH + 2) * HALO_W * 2;  // 16-byte pieces
  static constexpr int XP = (X_PIECES + THREADS - 1) / THREADS;
  static constexpr int W_PIECES = 9 * TCO * 2;
  static constexpr int XS_BYTES = X_PIECES * 16;
  static constexpr int STAGE_BYTES = XS_BYTES + W_PIECES * 16;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

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

// c += a b on one 16 x 8 block. a0/a1: rows g / g + 8, the lane's first
// k-half; a2/a3: the same rows, second k-half; b0/b1: column g, the two
// k-halves.
__device__ __forceinline__ void mma_step(int32_t (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_step(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  mma_bf16(c, a0, a1, a2, a3, b0, b1);
}

// MODE 0: int8 in, int8 out; 1: int8 in, bf16 out; 2: bf16 in and out.
// x (N, H, W, C) with rows of CB = C * sizeof(element) bytes; wp the packed
// weights (9, ksteps, Co, 32 bytes); rows: MODE 0/1 the (3, Co) scales, MODE
// 2 the (Co,) bias. grid (tiles, ceil(Co / TCO), N).
template <int TCO, int MODE, bool REFLECT>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_mma_kernel(const unsigned char* __restrict__ x,
                      const unsigned char* __restrict__ wp,
                      const float* __restrict__ rows, void* y, int H, int W,
                      int CB, int ksteps, int Co, int tiles_w, float alpha) {
  using T = Tile<TCO>;
  using Acc = typename std::conditional<MODE == 2, float, int32_t>::type;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const size_t n = blockIdx.z;
  const unsigned char* xn = x + n * H * W * CB;
  const bool x16 = CB % 16 == 0;  // cp.async needs 16-byte aligned sources

  // the thread's pieces of the halo tile: byte offset of the source pixel
  // (+ 16 for the second piece), -1 where the tile stages zeros
  long long xoff[T::XP];
#pragma unroll
  for (int p = 0; p < T::XP; ++p) {
    const int idx = tid + p * THREADS;
    const int pix = idx >> 1;
    const int sr = pad_src<REFLECT>(r0 - 1 + pix / HALO_W, H);
    const int sc = pad_src<REFLECT>(c0 - 1 + pix % HALO_W, W);
    xoff[p] = (idx < T::X_PIECES && sr >= 0 && sc >= 0)
                  ? ((long long)sr * W + sc) * CB + (idx & 1) * 16
                  : -1;
  }

  auto load_stage = [&](int ks, int stage) {
    unsigned char* xs = smem + stage * T::STAGE_BYTES;
    unsigned char* ws = xs + T::XS_BYTES;
    const int kb = ks * KB;
#pragma unroll
    for (int p = 0; p < T::XP; ++p) {
      const int idx = tid + p * THREADS;
      if (idx >= T::X_PIECES) continue;
      const int b0 = kb + (idx & 1) * 16;  // first byte of the piece in a row
      if (x16) {
        const bool ok = xoff[p] >= 0 && b0 < CB;
        cp_async16(xs + idx * 16, ok ? xn + xoff[p] + kb : xn, ok ? 16 : 0);
      } else {  // CB % 4 == 0: word by word, zeros past the row's end
        int32_t v[4] = {0, 0, 0, 0};
        if (xoff[p] >= 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (b0 + 4 * j < CB)
              v[j] = *reinterpret_cast<const int32_t*>(xn + xoff[p] + kb +
                                                       4 * j);
        }
        *reinterpret_cast<int4*>(xs + idx * 16) =
            make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int idx = tid; idx < T::W_PIECES; idx += THREADS) {
      const int co = (idx >> 1) % TCO;
      const int tap = (idx >> 1) / TCO;
      const bool ok = co0 + co < Co;
      const unsigned char* src =
          wp + (((size_t)tap * ksteps + ks) * Co + co0 + co) * KB +
          (idx & 1) * 16;
      cp_async16(ws + idx * 16, ok ? src : wp, ok ? 16 : 0);
    }
  };

  Acc acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    // step ks has landed; every warp is past step ks - 1, whose stage the
    // next load overwrites
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    if (ks + T::STAGES - 1 < ksteps)
      load_stage(ks + T::STAGES - 1, (ks + T::STAGES - 1) % T::STAGES);
    cp_async_commit();

    const unsigned char* xs = smem + (ks % T::STAGES) * T::STAGE_BYTES;
    const unsigned char* ws = xs + T::XS_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
      uint2 lo[T::MT], hi[T::MT];  // pixels g and g + 8 of the row block
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int pix = (wm * T::MT + i + dr) * HALO_W + dc + g;
        lo[i] = *reinterpret_cast<const uint2*>(xs + pix * KB + 8 * t);
        hi[i] = *reinterpret_cast<const uint2*>(xs + (pix + 8) * KB + 8 * t);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int co = wn * (T::NT * 8) + j * 8 + g;
        const uint2 b = *reinterpret_cast<const uint2*>(
            ws + (tap * TCO + co) * KB + 8 * t);
#pragma unroll
        for (int i = 0; i < T::MT; ++i)
          mma_step(acc[i][j], lo[i].x, hi[i].x, lo[i].y, hi[i].y, b.x, b.y);
      }
    }
  }

  // ---- epilogue. A fragment has channels 2t, 2t + 1 of pixels g (c[0],
  // c[1]) and g + 8 (c[2], c[3]); lanes t and t ^ 1 swap so the even lane
  // holds 4 consecutive channels of pixel g and the odd lane of pixel g + 8.
  const bool odd = t & 1;
  const int c = c0 + g + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    const int go = co0 + wn * (T::NT * 8) + j * 8 + 2 * (t & ~1);
    const bool okc = go < Co;  // Co % 4 == 0: all 4 channels or none
    float deq[4], bias[4], inv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MODE == 2) {
        bias[e] = okc ? __ldg(rows + go + e) : 0.f;
        deq[e] = inv[e] = 0.f;
      } else {
        deq[e] = okc ? __ldg(rows + go + e) : 0.f;
        bias[e] = okc ? __ldg(rows + Co + go + e) : 0.f;
        inv[e] = (okc && MODE == 0) ? __ldg(rows + 2 * Co + go + e) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const Acc* a = acc[i][j];
      const Acc g0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const Acc g1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      const Acc q[4] = {odd ? g0 : a[0], odd ? g1 : a[1], odd ? a[2] : g0,
                        odd ? a[3] : g1};
      float v[4];
      uint32_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (MODE == 2) {
          const float s = q[e] + bias[e];
          v[e] = s >= 0.f ? s : alpha * s;
        } else {
          v[e] = q8::epilogue_alpha(q[e], deq[e], bias[e], alpha);
          if constexpr (MODE == 0) b[e] = q8::requant(v[e], inv[e]);
        }
      }
      const int r = r0 + wm * T::MT + i;
      if (r < H && c < W && okc) {
        const size_t off = ((n * H + r) * W + c) * Co + go;
        if constexpr (MODE == 0)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y) + off) =
              q8::pack4(b);
        else
          q8::store_bf16x4(static_cast<__nv_bfloat16*>(y) + off, v);
      }
    }
  }
}

template <int TCO, int MODE, bool REFLECT>
int launch_tile(const void* x, const void* wp, const float* rows, void* y,
                int N, int H, int W, int C, int Co, float alpha,
                cudaStream_t s) {
  using T = Tile<TCO>;
  constexpr int ESIZE = MODE == 2 ? 2 : 1;
  auto kernel = conv2d_mma_kernel<TCO, MODE, REFLECT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_w * ((H + TH - 1) / TH), (Co + TCO - 1) / TCO, N);
  const int CB = C * ESIZE;
  kernel<<<grid, THREADS, T::SMEM_BYTES, s>>>(
      static_cast<const unsigned char*>(x),
      static_cast<const unsigned char*>(wp), rows, y, H, W, CB,
      (CB + KB - 1) / KB, Co, tiles_w, alpha);
  return static_cast<int>(cudaGetLastError());
}

// 1: TCO = 128, 2: TCO = 64 (see the header: 128 channels pay only on grids
// that fill the card many times over).
int pick_tile(int N, int H, int W, int Co) {
  int dev = 0, sms = 0;  // of the current device, asked at every launch
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long long blocks = (long long)((W + TW - 1) / TW) *
                           ((H + TH - 1) / TH) * ((Co + 127) / 128) * N;
  return blocks >= 16LL * sms ? 1 : 2;
}

template <int MODE, bool REFLECT>
int launch_mode(const void* x, const void* wp, const float* rows, void* y,
                int N, int H, int W, int C, int Co, float alpha,
                cudaStream_t s) {
  if (pick_tile(N, H, W, Co) == 1)
    return launch_tile<128, MODE, REFLECT>(x, wp, rows, y, N, H, W, C, Co,
                                              alpha, s);
  return launch_tile<64, MODE, REFLECT>(x, wp, rows, y, N, H, W, C, Co,
                                           alpha, s);
}

bool shape_ok(int N, int H, int W, int C, int Co, int unit) {
  return N >= 1 && N <= 65535 && H >= 2 && W >= 2 && C >= unit &&
         Co >= unit && C % unit == 0 && Co % unit == 0 &&
         (Co + 63) / 64 <= 65535;
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous,
// 16-byte aligned tensors. Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue for a shape it refuses).
//
// int8: x (N, H, W, C) int8; wp the packed weights (3, 3, ceil(C / 32), Co,
// 32) int8; scales (3, Co) float; y int8 (out_int8) or bf16. Needs C % 4 ==
// 0, Co % 4 == 0, H, W >= 2.
extern "C" int rpst_conv2d_q8(const void* x, const void* wp,
                              const void* scales, void* y, int N, int H,
                              int W, int C, int Co, int out_int8, int reflect,
                              float alpha, void* stream) {
  if (!shape_ok(N, H, W, C, Co, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  if (out_int8 && reflect)
    return launch_mode<0, true>(x, wp, sp, y, N, H, W, C, Co, alpha, s);
  if (out_int8)
    return launch_mode<0, false>(x, wp, sp, y, N, H, W, C, Co, alpha, s);
  if (reflect)
    return launch_mode<1, true>(x, wp, sp, y, N, H, W, C, Co, alpha, s);
  return launch_mode<1, false>(x, wp, sp, y, N, H, W, C, Co, alpha, s);
}

// bf16: x (N, H, W, C) and y (N, H, W, Co) bf16; wp the packed weights (3,
// 3, ceil(C / 16), Co, 16) bf16; bias (Co,) float. Needs C % 8 == 0, Co % 8
// == 0, H, W >= 2.
extern "C" int rpst_conv2d_bf16(const void* x, const void* wp,
                                const void* bias, void* y, int N, int H,
                                int W, int C, int Co, int reflect,
                                float alpha, void* stream) {
  if (!shape_ok(N, H, W, C, Co, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (reflect)
    return launch_mode<2, true>(x, wp, bp, y, N, H, W, C, Co, alpha, s);
  return launch_mode<2, false>(x, wp, bp, y, N, H, W, C, Co, alpha, s);
}

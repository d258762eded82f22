// B4 on Hopper: the int8 fused folded conv of the quantized serving path, on
// the tensor cores.
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
// requantization (the AdaIN statistics of rpst's fused epilogue).
//
// The reflect ring, rows and columns, is built from x as tiles are staged
// (rpst builds the ring rows on the host, :317-318): ring row -1 takes its
// first 2C channels from row 1 and the rest from row 0, row H from rows
// H-1 / H-2; ring column -1 takes sub-column-0 blocks {0, 2} from column 1
// and blocks {1, 3} from column 0, column W from W-1 / W-2.
//
// What bounds it on the card. At (1, 256, 256, 128 -> 128) a folded kernel
// made by fold_conv_kernel (and quantized: its zero blocks stay zero) holds
// the unfolded conv's 2.42 G multiply-adds, 0.0024 ms at the int8 tensor
// cores' 1,979 TOP/s; its int8 activations are 16.8 MB in and out, 0.0050
// ms at 3.35 TB/s. So it is bound by bytes, as long as each staged value is
// reused from shared memory; a dense kernel is 4x the operations (0.0098).
//
// What the design does about it. The main loop is folded_mma.cuh's, with
// int8 operands: `mma.sync` m16n8k32 s8 -> s32 on 8 x 16-pixel tiles, K in
// steps of 32 channels through a two-stage `cp.async` ring, and only the
// listed (tap, input block, output block) blocks of the kernel, from the
// per-launch table built on the device (prep_weights_kernel). At the
// flagship's 4C = 128 a K step is one input block, so a folded kernel's
// step stages and multiplies 9 of the 36 (tap, output block) pairs; at 4C =
// 16 a step spans all four blocks and takes their union. int32 sums are
// exact in any order (|acc| <= 9 * 4C * 127^2 < 2^31 for 4C < 14,000), so
// the int8 and bf16 outputs are bit-equal to the plain version; the
// epilogue rounds exactly as rpst's (q8_common.cuh: two roundings, half to
// even). Each lane's two channels of pixels g and g + 8 are swapped with its
// neighbour so that a lane stores 4 consecutive channels of one pixel.
//
// Stats, deterministic: folded_mma.cuh `q8_epilogue` sums each tile's
// in-image pixels per channel in a written order (per thread, then a fixed
// shuffle tree, then the warp rows in order) into a per-tile partial, and
// q8::finalize_sums adds the tiles in a fixed order in double. B7
// (folded_conv2_q8.cu) repeats that order on its layer 1, so its sums are
// bit-equal to a B4 launch's.

#include "folded_mma.cuh"

namespace {

using folded::KB;
using folded::THREADS;
using folded::TH;
using folded::TW;

constexpr int STAGES = 2;  // two 42 KB stages: two blocks per SM

struct Q8Args {
  const int8_t* x;
  const unsigned char* wp;  // w packed K-major (9, ksteps, 4Co, 32)
  const unsigned* bits;     // its block table (9 words)
  const float* scales;      // (3, 4Co)
  void* y;                  // (N, H, W, 4Co) int8 or bf16
  float* part;              // (N, tiles, 2 * 4Co) with stats
  int H, W, C4, C4o, ksteps, tiles_w;
};

template <bool WIDE, bool OUT_INT8, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
    folded_conv_q8_kernel(const Q8Args a) {
  using S = folded::Shape<WIDE>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ folded::Tables tb;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int H = a.H, W = a.W;
  const int tile = blockIdx.x;
  const int r0 = (tile / a.tiles_w) * TH;
  const int c0 = (tile % a.tiles_w) * TW;
  const size_t n = blockIdx.z;
  const folded::Layer<WIDE> L(a.C4, a.C4o, a.ksteps, blockIdx.y);
  folded::init_tables(tb, a.bits, L, KB, tid);
  const folded::Halo<int8_t, S, false> halo(a.x, nullptr, n, r0, c0, H, W,
                                            a.C4, tid);
  const folded::Weights<WIDE> wts(L, tb, a.wp, tid);
  const folded::Tiles<WIDE> nt(L, tb, wn);
  int apix[S::MT];
#pragma unroll
  for (int i = 0; i < S::MT; ++i) apix[i] = (wm * S::MT + i) * S::HALO_W + g;

  int32_t acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int no_ring = 0;

  auto load = [&](int ks, unsigned char* stage) {
    halo.load(stage, ks, tid);
    wts.load(stage + S::XS_BYTES, ks,
             folded::step_mask(tb, L.C4in, L.Cin, KB, ks));
  };
  auto compute = [&](int ks, unsigned char* stage) {
    folded::mma_taps<int8_t, S::HALO_W, WIDE, false>(
        stage, stage + S::XS_BYTES,
        folded::step_mask(tb, L.C4in, L.Cin, KB, ks), apix, nt, g, t, acc,
        no_ring, [](int, int, uint2&, uint2&) { return false; });
  };
  folded::prefetch<STAGES>(L.ksteps, smem, S::STAGE_BYTES, load);
  folded::run<STAGES>(L.ksteps, smem, S::STAGE_BYTES, load, compute);
  hmma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the stats' scratch

  float* p1 = a.part + ((size_t)n * gridDim.x + tile) * 2 * a.C4o;
  folded::q8_epilogue<WIDE, STATS>(
      L, nt, a.scales, acc, wm, lane, r0, c0, H, W,
      reinterpret_cast<float*>(smem), p1, p1 + a.C4o,
      [&](int i, int j, const float (&v)[4]) {
        folded::q8_store<WIDE, OUT_INT8>(L, nt, a.scales, a.y, n,
                                         r0 + wm * S::MT + i, c0, H, W,
                                         lane, j, v);
      });
}

template <bool WIDE, bool OUT_INT8, bool STATS>
int launch_cfg(const Q8Args& a, int N, cudaStream_t s) {
  using S = folded::Shape<WIDE>;
  auto kernel = folded_conv_q8_kernel<WIDE, OUT_INT8, STATS>;
  const int smem = S::smem_bytes(STAGES);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cout = a.C4o / 4;
  const bool blocked = WIDE && Cout % 8 == 0;
  const int gy = blocked ? (Cout + folded::TQ - 1) / folded::TQ
                         : (a.C4o + S::TCO - 1) / S::TCO;
  const dim3 grid(a.tiles_w * ((a.H + TH - 1) / TH), gy, N);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool OUT_INT8, bool STATS>
int launch_mode(const Q8Args& a, int N, cudaStream_t s) {
  if (a.C4o <= 16) return launch_cfg<false, OUT_INT8, STATS>(a, N, s);
  return launch_cfg<true, OUT_INT8, STATS>(a, N, s);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous,
// 16-byte aligned tensors (x, w int8; scales, s1, s2 float; y int8 or bf16);
// wp is int8 scratch of 9 * ceil(4C / 32) * 4Co * 32 and bits uint32
// scratch of 9, which the launch fills with w packed K-major and its
// non-zero block table ahead of the main kernel; `part` is float scratch of
// N * tiles * 2 * C4o (tiles from rpst_folded_conv_q8_tiles), and s1, s2,
// part may be null without stats. Needs C4 % 16 == 0, C4o % 4 == 0, H, W >=
// 2. Returns the cudaError_t of the launches (cudaErrorInvalidValue for a
// shape it refuses).
extern "C" int rpst_folded_conv_q8_tiles(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

extern "C" int rpst_folded_conv_q8(const void* x, const void* w, void* wp,
                                   void* bits, const void* scales, void* y,
                                   void* s1, void* s2, void* part, int N,
                                   int H, int W, int C4, int C4o,
                                   int out_int8, int with_stats,
                                   void* stream) {
  if (!folded::shape_ok(N, H, W, C4, C4o) || C4 % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Q8Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.wp = static_cast<const unsigned char*>(wp);
  a.bits = static_cast<const unsigned*>(bits);
  a.scales = static_cast<const float*>(scales);
  a.y = y;
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.C4 = C4;
  a.C4o = C4o;
  a.ksteps = folded::ksteps_of(C4, 1);
  a.tiles_w = (W + TW - 1) / TW;
  int err = folded::prep_weights<int8_t>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wp),
      static_cast<unsigned*>(bits), C4, C4o, a.ksteps, s);
  if (err != 0) return err;
  if (out_int8 && with_stats)
    err = launch_mode<true, true>(a, N, s);
  else if (out_int8)
    err = launch_mode<true, false>(a, N, s);
  else if (with_stats)
    err = launch_mode<false, true>(a, N, s);
  else
    err = launch_mode<false, false>(a, N, s);
  if (err != 0 || !with_stats) return err;
  const q8::SumOuts o{{static_cast<float*>(s1), static_cast<float*>(s2)},
                      {0, C4o, 2 * C4o},
                      2};
  q8::launch_finalize(a.part, o, N, rpst_folded_conv_q8_tiles(H, W), 2 * C4o,
                      s);
  return static_cast<int>(cudaGetLastError());
}

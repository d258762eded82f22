// B7 on Hopper: two chained int8 folded conv layers in one kernel, on the
// tensor cores.
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
// values (s11, s12 over y1; s21, s22 over y2), float32 sums included
// bit-equal to B4's.
//
// What bounds it on the card. Each layer is B4's work (2.42 G multiply-adds
// of a folded 128->128 kernel on a 512px image, 0.0024 ms of int8), plus the
// layer-1 halo it recomputes (1.5x layer 1's mma here); its bytes are x,
// y1 and y2 once, 25.2 MB (0.0075 ms at 3.35 TB/s). Against two B4
// launches it saves one write and one read of y1 (16.8 MB a 512px image,
// ~5 us) and pays for the halo: which wins is a measurement (PERF.md,
// rpst_torch.policy.FUSE_PAIRS).
//
// What the design does about it. B4's main loop (folded_mma.cuh), twice, in
// one block of 256 threads on B4's 8 x 16 output tile:
//   * Layer 1 runs on x staged with a 2-pixel border (x's reflect ring at
//     -1 / H / W, zeros beyond) in B4's exact warp and fragment layout on
//     the tile's interior, so that its per-tile stats partials are B4's by
//     construction (q8_epilogue's written order). Its 1-pixel halo ring
//     (two rows of 18, two columns of 8) is four more mma row blocks with
//     the B fragments the interior loads anyway (as B2's ring adjoint):
//     block 0 the row above (columns -1 .. 14), 1 the row below, 2 the
//     column left (rows 0 .. 7) and right, 3 the four corners' neighbours
//     (columns 15, 16 of both rows), one block per warp row.
//   * y1 is requantized into shared memory as layer 2's A tile ((TH + 2) x
//     (TW + 2) pixels, 32 channels a K step), at every in-image position of
//     the region (the neighbouring blocks recompute the same values); the
//     positions on y1's reflect ring are then filled from the computed ones
//     by the channel-half (rows) and sub-column (columns) rule, as rpst's
//     `_lane_select_half` / `_col_shifts` (:197-204). The tile's own y1 goes
//     to device memory from there, 16 bytes a thread.
//   * Layer 2 runs from that tile, w2 streamed through the same `cp.async`
//     ring, and B4's epilogue writes y2 and its stats.
// Each layer takes only its kernel's listed blocks (a per-launch table for
// each, built on the device). Stats reduce per tile in the written order
// and one more kernel (q8::finalize_sums, B4's) sums the tiles in a fixed
// order: deterministic.

#include "folded_mma.cuh"

namespace {

using folded::KB;
using folded::THREADS;
using folded::TH;
using folded::TW;

constexpr int STAGES = 2;
constexpr int R1W = TW + 2;          // layer 1's region: the tile and its
constexpr int R1PX = (TH + 2) * R1W;  // 1-pixel halo, layer 2's A tile

struct PairArgs {
  const int8_t* x;
  const unsigned char* wp1;  // w1, w2 packed K-major
  const unsigned char* wp2;
  const unsigned* bits1;     // their block tables (9 words each)
  const unsigned* bits2;
  const float* sc1;
  const float* sc2;
  int8_t* y1;
  void* y2;
  float* part;               // (N, tiles, 2 * C4m + 2 * C4o) with stats
  int H, W, C4, C4m, C4o, ks1, ks2, tiles_w;
};

// Position (pr, pc) of row m of layer 1's ring block rb, relative to the
// tile's first pixel (-1 .. TH, -1 .. TW); false for rows 4 .. 15 of block
// 3, which are computed at a position inside the staged tile and dropped.
__device__ __forceinline__ bool ring_pos(int rb, int m, int& pr, int& pc) {
  if (rb < 2) {
    pr = rb == 0 ? -1 : TH;
    pc = m - 1;
    return true;
  }
  if (rb == 2) {
    pr = m & 7;
    pc = m < 8 ? -1 : TW;
    return true;
  }
  pr = (m & 2) ? TH : -1;
  pc = TW - 1 + (m & 1);
  return m < 4;
}

template <bool W1, bool W2>
struct PairShape {
  using S1 = folded::Shape<W1, 2>;  // layer 1: x with a 2-pixel border
  using S2 = folded::Shape<W2, 1>;  // layer 2: A from the y1 tile
  static constexpr int STRIDE = S1::STAGE_BYTES > S2::WS_BYTES
                                    ? S1::STAGE_BYTES
                                    : S2::WS_BYTES;
  static constexpr int RED_BYTES = 2 * S1::WM * S1::TCO * 4 >
                                           2 * S2::WM * S2::TCO * 4
                                       ? 2 * S1::WM * S1::TCO * 4
                                       : 2 * S2::WM * S2::TCO * 4;
  static_assert(RED_BYTES <= STAGES * STRIDE, "stats scratch in the ring");
  static int smem_bytes(int ks2) { return STAGES * STRIDE + ks2 * R1PX * KB; }
};

// one block per SM: held to 128 registers (two blocks), layer 1's 96
// accumulators spill, 1-11% slower on the H100 (PERF.md)
template <bool W1, bool W2, bool OUT2_INT8, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    folded_conv2_q8_kernel(const PairArgs a) {
  using P = PairShape<W1, W2>;
  using S1 = typename P::S1;
  using S2 = typename P::S2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* y1s = smem + STAGES * P::STRIDE;  // [ks2][R1PX][32]
  // the stats' scratch: the ring, between the two layers' pipelines
  float* red = reinterpret_cast<float*>(smem);
  __shared__ folded::Tables tb1, tb2;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = a.H, W = a.W;
  const int tile = blockIdx.x;
  const int r0 = (tile / a.tiles_w) * TH;
  const int c0 = (tile % a.tiles_w) * TW;
  const size_t n = blockIdx.z;
  const folded::Layer<W1> L1(a.C4, a.C4m, a.ks1, 0);
  const folded::Layer<W2> L2(a.C4m, a.C4o, a.ks2, 0);
  folded::init_tables(tb1, a.bits1, L1, KB, tid);
  folded::init_tables(tb2, a.bits2, L2, KB, tid);
  float* tpart =
      a.part + ((size_t)n * gridDim.x + tile) * (2 * a.C4m + 2 * a.C4o);

  // ---- layer 1 on the tile and its 1-pixel halo
  {
    const int wm = warp % S1::WM, wn = warp / S1::WM;
    const folded::Halo<int8_t, S1, false> halo(a.x, nullptr, n, r0, c0, H, W,
                                               a.C4, tid);
    const folded::Weights<W1> wts(L1, tb1, a.wp1, tid);
    const folded::Tiles<W1> nt(L1, tb1, wn);
    int apix[S1::MT];  // the interior: tile row ti at staged row ti + 1
#pragma unroll
    for (int i = 0; i < S1::MT; ++i)
      apix[i] = (wm * S1::MT + i + 1) * S1::HALO_W + 1 + g;
    // the warp row's ring block (wm < 4): its rows g and g + 8
    const bool has_ring = wm < 4;
    int rpr[2], rpc[2], rbase[2];
    bool rused[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rused[h] = ring_pos(wm & 3, g + 8 * h, rpr[h], rpc[h]);
      rbase[h] = (rpr[h] + 1) * S1::HALO_W + rpc[h] + 1;
    }

    int32_t acc[S1::MT][S1::NT][4], racc[S1::NT][4];
#pragma unroll
    for (int j = 0; j < S1::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        racc[j][e] = 0;
#pragma unroll
        for (int i = 0; i < S1::MT; ++i) acc[i][j][e] = 0;
      }

    auto load = [&](int ks, unsigned char* stage) {
      halo.load(stage, ks, tid);
      wts.load(stage + S1::XS_BYTES, ks,
               folded::step_mask(tb1, L1.C4in, L1.Cin, KB, ks));
    };
    auto compute = [&](int ks, unsigned char* stage) {
      auto ring = [&](int dr, int dc, uint2& rlo, uint2& rhi) -> bool {
        if (!has_ring) return false;
        const int off = dr * S1::HALO_W + dc;
        rlo = folded::lds64(stage + (rbase[0] + off) * KB + 8 * t);
        rhi = folded::lds64(stage + (rbase[1] + off) * KB + 8 * t);
        return true;
      };
      folded::mma_taps<int8_t, S1::HALO_W, W1, true>(
          stage, stage + S1::XS_BYTES,
          folded::step_mask(tb1, L1.C4in, L1.Cin, KB, ks), apix, nt, g, t,
          acc, racc, ring);
    };
    folded::prefetch<STAGES>(L1.ksteps, smem, P::STRIDE, load);
    folded::run<STAGES>(L1.ksteps, smem, P::STRIDE, load, compute);
    hmma::cp_async_wait<0>();
    __syncthreads();  // the ring is free: the stats' scratch

    // two requantized channels (ch, ch + 1) of region pixel pix into y1s
    auto put = [&](int pix, int ch, float v0, float v1, float i0, float i1) {
      const uint32_t b = q8::requant(v0, i0) | (q8::requant(v1, i1) << 8);
      *reinterpret_cast<uint16_t*>(y1s + ((ch / KB) * R1PX + pix) * KB +
                                   ch % KB) = static_cast<uint16_t>(b);
    };
    // the interior: B4's stats, then y1 into y1s
    folded::q8_epilogue<W1, STATS>(
        L1, nt, a.sc1, acc, wm, lane, r0, c0, H, W, red, tpart,
        tpart + a.C4m, [&](int i, int j, const float (&v)[4]) {
          const int ch = L1.chan(nt.ncol[j] + 2 * t);
          if (ch < 0) return;
          const float i0 = __ldg(a.sc1 + 2 * a.C4m + ch);
          const float i1 = __ldg(a.sc1 + 2 * a.C4m + ch + 1);
          const int pix = (wm * S1::MT + i + 1) * R1W + g + 1;
          put(pix, ch, v[0], v[1], i0, i1);
          put(pix + 8, ch, v[2], v[3], i0, i1);
        });
    // the ring, at its in-image positions
    if (has_ring) {
#pragma unroll
      for (int j = 0; j < S1::NT; ++j) {
        const int ch = L1.chan(nt.ncol[j] + 2 * t);
        if (ch < 0) continue;
        float deq[2], bias[2], inv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          deq[e] = __ldg(a.sc1 + ch + e);
          bias[e] = __ldg(a.sc1 + a.C4m + ch + e);
          inv[e] = __ldg(a.sc1 + 2 * a.C4m + ch + e);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + rpr[h], c = c0 + rpc[h];
          if (!rused[h] || r < 0 || r >= H || c < 0 || c >= W) continue;
          put((rpr[h] + 1) * R1W + rpc[h] + 1, ch,
              q8::epilogue(racc[j][2 * h], deq[0], bias[0]),
              q8::epilogue(racc[j][2 * h + 1], deq[1], bias[1]), inv[0],
              inv[1]);
        }
      }
    }
  }
  __syncthreads();  // y1s holds every in-image position of the region

  // ---- y1's reflect ring in y1s, a word (4 channels: one block, one half)
  // at a time from the in-image position the folded rule names
  const int words = a.C4m / 4;
  for (int idx = tid; idx < R1PX * words; idx += THREADS) {
    const int pix = idx / words, wd = idx % words;
    const int r = r0 - 1 + pix / R1W, c = c0 - 1 + pix % R1W;
    const bool on_ring = r == -1 || r == H || c == -1 || c == W;
    if (!on_ring || r < -1 || r > H || c < -1 || c > W) continue;
    const int ch = 4 * wd;
    const int sr = q8::ring_row(r, H, q8::first_half(ch, a.C4m));
    const int sc = q8::ring_col(c, W, q8::subcol0(ch, a.C4m));
    const int spix = (sr - r0 + 1) * R1W + (sc - c0 + 1);
    const int base = (ch / KB) * R1PX;
    *reinterpret_cast<uint32_t*>(y1s + (base + pix) * KB + ch % KB) =
        *reinterpret_cast<const uint32_t*>(y1s + (base + spix) * KB +
                                           ch % KB);
  }
  // ---- the tile's own y1 to device memory, 16 bytes a thread
  const int pieces = a.C4m / 16;
  for (int idx = tid; idx < TH * TW * pieces; idx += THREADS) {
    const int p = idx / pieces, b = (idx % pieces) * 16;
    const int r = r0 + p / TW, c = c0 + p % TW;
    if (r >= H || c >= W) continue;
    const int pix = (p / TW + 1) * R1W + p % TW + 1;
    *reinterpret_cast<uint4*>(a.y1 + (((size_t)n * H + r) * W + c) * a.C4m +
                              b) =
        *reinterpret_cast<const uint4*>(y1s + ((b / KB) * R1PX + pix) * KB +
                                        b % KB);
  }
  __syncthreads();  // the ring filled before layer 2 reads it

  // ---- layer 2 from y1s
  {
    const int wm = warp % S2::WM, wn = warp / S2::WM;
    const folded::Weights<W2> wts(L2, tb2, a.wp2, tid);
    const folded::Tiles<W2> nt(L2, tb2, wn);
    int apix[S2::MT];
#pragma unroll
    for (int i = 0; i < S2::MT; ++i) apix[i] = (wm * S2::MT + i) * R1W + g;
    int32_t acc[S2::MT][S2::NT][4];
#pragma unroll
    for (int i = 0; i < S2::MT; ++i)
#pragma unroll
      for (int j = 0; j < S2::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    int no_ring = 0;

    auto load = [&](int ks, unsigned char* stage) {
      wts.load(stage, ks, folded::step_mask(tb2, L2.C4in, L2.Cin, KB, ks));
    };
    auto compute = [&](int ks, unsigned char* stage) {
      folded::mma_taps<int8_t, R1W, W2, false>(
          y1s + ks * R1PX * KB, stage,
          folded::step_mask(tb2, L2.C4in, L2.Cin, KB, ks), apix, nt, g, t,
          acc, no_ring, [](int, int, uint2&, uint2&) { return false; });
    };
    folded::prefetch<STAGES>(L2.ksteps, smem, P::STRIDE, load);
    folded::run<STAGES>(L2.ksteps, smem, P::STRIDE, load, compute);
    hmma::cp_async_wait<0>();
    __syncthreads();

    float* p2 = tpart + 2 * a.C4m;
    folded::q8_epilogue<W2, STATS>(
        L2, nt, a.sc2, acc, wm, lane, r0, c0, H, W, red, p2, p2 + a.C4o,
        [&](int i, int j, const float (&v)[4]) {
          folded::q8_store<W2, OUT2_INT8>(L2, nt, a.sc2, a.y2, n,
                                          r0 + wm * S2::MT + i, c0, H, W,
                                          lane, j, v);
        });
  }
}

template <bool W1, bool W2, bool OUT2_INT8, bool STATS>
int launch_cfg(const PairArgs& a, int N, cudaStream_t s) {
  auto kernel = folded_conv2_q8_kernel<W1, W2, OUT2_INT8, STATS>;
  const int smem = PairShape<W1, W2>::smem_bytes(a.ks2);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.tiles_w * ((a.H + TH - 1) / TH), 1, N);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the tilings B4 takes for 4Cm and 4Co (folded::launch: narrow at <= 16)
template <bool OUT2_INT8, bool STATS>
int launch_mode(const PairArgs& a, int N, cudaStream_t s) {
  const bool w1 = a.C4m > 16, w2 = a.C4o > 16;
  if (w1 && w2) return launch_cfg<true, true, OUT2_INT8, STATS>(a, N, s);
  if (w1) return launch_cfg<true, false, OUT2_INT8, STATS>(a, N, s);
  if (w2) return launch_cfg<false, true, OUT2_INT8, STATS>(a, N, s);
  return launch_cfg<false, false, OUT2_INT8, STATS>(a, N, s);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous,
// 16-byte aligned tensors (x, w1, w2, y1 int8; scales, stats float; y2 int8
// or bf16); wp is int8 scratch of 9 * 32 * (ceil(4C / 32) * 4Cm +
// ceil(4Cm / 32) * 4Co) and bits uint32 scratch of 18, which the launch
// fills with w1 then w2 packed K-major and their block tables; `part` is
// float scratch of N * tiles * (2 * C4m + 2 * C4o) (tiles from
// rpst_folded_conv2_q8_tiles); the stats and part may be null without
// stats. Needs C4 % 16 == 0, C4m % 16 == 0, C4o % 4 == 0, each <= 128, and
// H, W >= 2. Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for a shape it refuses).
extern "C" int rpst_folded_conv2_q8_tiles(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

extern "C" int rpst_folded_conv2_q8(
    const void* x, const void* w1, const void* scales1, const void* w2,
    const void* scales2, void* wp, void* bits, void* y1, void* y2, void* s11,
    void* s12, void* s21, void* s22, void* part, int N, int H, int W, int C4,
    int C4m, int C4o, int out_int8, int with_stats, void* stream) {
  if (!folded::shape_ok(N, H, W, C4, C4m) ||
      !folded::shape_ok(N, H, W, C4m, C4o) || C4 % 16 || C4m % 16 ||
      C4 > 128 || C4m > 128 || C4o > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PairArgs a{};
  a.x = static_cast<const int8_t*>(x);
  a.ks1 = folded::ksteps_of(C4, 1);
  a.ks2 = folded::ksteps_of(C4m, 1);
  int8_t* wp1 = static_cast<int8_t*>(wp);
  int8_t* wp2 = wp1 + (size_t)9 * a.ks1 * C4m * KB;
  unsigned* bits1 = static_cast<unsigned*>(bits);
  a.wp1 = reinterpret_cast<const unsigned char*>(wp1);
  a.wp2 = reinterpret_cast<const unsigned char*>(wp2);
  a.bits1 = bits1;
  a.bits2 = bits1 + 9;
  a.sc1 = static_cast<const float*>(scales1);
  a.sc2 = static_cast<const float*>(scales2);
  a.y1 = static_cast<int8_t*>(y1);
  a.y2 = y2;
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.C4 = C4;
  a.C4m = C4m;
  a.C4o = C4o;
  a.tiles_w = (W + TW - 1) / TW;
  int err = folded::prep_weights<int8_t>(static_cast<const int8_t*>(w1), wp1,
                                         bits1, C4, C4m, a.ks1, s);
  if (err == 0)
    err = folded::prep_weights<int8_t>(static_cast<const int8_t*>(w2), wp2,
                                       bits1 + 9, C4m, C4o, a.ks2, s);
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
  const q8::SumOuts o{{static_cast<float*>(s11), static_cast<float*>(s12),
                       static_cast<float*>(s21), static_cast<float*>(s22)},
                      {0, C4m, 2 * C4m, 2 * C4m + C4o, 2 * C4m + 2 * C4o},
                      4};
  q8::launch_finalize(a.part, o, N, rpst_folded_conv2_q8_tiles(H, W),
                      2 * C4m + 2 * C4o, s);
  return static_cast<int>(cudaGetLastError());
}

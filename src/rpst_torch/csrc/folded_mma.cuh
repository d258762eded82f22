// The tensor-core main loop of B1 (folded_conv.cu) and B2
// (folded_conv_bwd.cu): a 3x3 conv on the folded (space-to-depth) NHWC
// layout as an implicit GEMM on `mma.sync`, which takes only the non-zero
// (tap, input block, output block) blocks of the folded kernel.
//
//   B1: y  = lrelu_alpha(conv3x3(reflect_ring(x)) + b), the ring rows from
//        `rings` or by the reflect rule from x, the ring columns by the
//        channel-block rule;
//   B2: dx = conv3x3(zero_pad(gz), khat) + the adjoint of the reflect ring.
//
// Folded channel g of 4C lies in block g / C (C = 4C / 4): blocks {0, 1} are
// sub-row 0, {0, 2} sub-column 0 (ops/folded.py). A folded kernel made by
// `fold_conv_kernel` is non-zero on only 36 of its 3 x 3 x 4 x 4 (tap,
// input block, output block) blocks of C x Co: 9 per output block, as the
// unfolded conv it stands for. The launch lists them, a (3, 3, 4, 4) table
// of 0/1 built on the device from the kernel it is given, and the K loop
// takes a block only where it is listed: a folded kernel costs the MACs of
// the unfolded conv, a dense one all 144 blocks, and both give the sums of
// the plain version (for finite inputs: a skipped 0 x inf is not a NaN).
// The table and the K-major copy of the weights are made per launch by a
// small kernel ahead of the main one (prep_weights_kernel), as bits of 9
// words in a scratch buffer the wrapper passes.
//
// What bounds it on the card. At (1, 256, 256, 128 -> 128) the unfolded
// work is 4.83 GFLOP: 0.0098 ms of TF32, 0.029 ms at three TF32 products,
// 0.0049 ms of bf16; the tensors are ~67 MB in float32 (0.020 ms). A dense
// kernel is 4x the operations. So it is bound by operations, as long as
// each staged value is reused from shared memory.
//
// What the design does about it (B5's structure, conv2d_q8.cu):
//   * A block of 256 threads owns TH x TW = 8 x 16 output pixels (an mma
//     row block is 16 pixels of one tile row) and TCO output channels. The
//     wide tiling (4 warps along pixels x 2 along channels, TCO = 128) takes
//     TQ = 32 channels of EACH output block when Co is a multiple of 8, so
//     that no 8-channel n-tile straddles two output blocks and every warp
//     holds the same share of every block: the skip is the same branch in
//     all warps, and no warp waits on another at the barrier. Otherwise (Co
//     = 3: 4Co = 12) and for 4Co <= 16 (the narrow tiling: 8 warps along
//     pixels, 16 channels) the channels are contiguous and an n-tile's mask
//     is the union of the blocks it touches.
//   * K is walked in steps of 32 bytes per pixel: 16 bf16 or 8 float
//     channels. A step lies in one input block when C is a multiple of it
//     (C = 32, 64, 128); for the 12-wide images (C = 3) it spans all four
//     and its mask is their union. One staged halo tile ((TH + 2) x (TW +
//     2) pixels x 32 bytes) serves all 9 taps, and the step's weights are
//     the listed (tap, n-tile) rows of 32 bytes, packed K-major per launch
//     (the layout of ops/folded_conv.py `pack_k_major`). Both arrive by
//     `cp.async` into a ring of STAGES; a 16-byte piece whose channels need
//     two different sources (a ring column at C = 3) or whose row is not
//     16-byte aligned (12 bf16 channels) is loaded element by element.
//   * The K loop reads each step's listed (tap, output block) bits from a
//     per-block table in shared memory and takes the n-tiles of a warp in
//     pairs, which share one output block in the blocked tiling: a pair is
//     one branch and two B loads ahead of its mma (PERF.md: 8-22% over
//     single n-tiles on the card).
//   * Fragments as B5's: lane t reads bytes [8t, 8t + 8) of a 32-byte row
//     for both A (pixels g, g + 8) and B (channel g); the order of K inside
//     a step is free as long as A and B agree. bf16: one m16n8k16. float32:
//     the two floats are k = t and t + 4 of an m16n8k8, as three TF32
//     products (mma_common.cuh `tf32::mma3`): one TF32 product cannot hold
//     1e-4 at K = 9 x 4C. Each tap's three products start a fresh chain
//     and are added to the sum in float32, as B6 does (`mma_f32`).
//   * B2's ring adjoint (folded_conv_bwd.cu) is four more mma row blocks of
//     the same main loop: the ring row above (tap row 2 on halo row 1) and
//     below (tap row 0), the ring column left (tap column 2 on halo column
//     1) and right (tap column 0), each owned by one warp row of a tile
//     that needs it, with the B fragments the main blocks load anyway.
//     After the loop they go through shared memory to the threads that own
//     the outputs they land on; dx is written once, with no atomics.
//   * Epilogue in float32: B1 adds the bias and applies lrelu_alpha (a
//     negative y at alpha = 0 gives -0.0, as the plain version's
//     where(y >= 0, y, alpha * y)); stored in x's type, two channels a lane.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace folded {

constexpr int TH = 8;                 // tile rows
constexpr int TW = 16;                // tile columns: one mma row block
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int KB = 32;                // bytes of K per pixel and step
constexpr int THREADS = 256;
constexpr int TQ = 32;                // channels of each output block (wide)
constexpr int RING_ROWS = 16;         // rows of a ring block (one mma block)

template <bool WIDE>
struct Shape {
  static constexpr int WM = WIDE ? 4 : 8;        // warps along pixels
  static constexpr int WN = WIDE ? 2 : 1;        // warps along channels
  static constexpr int MT = TH / WM;             // mma row blocks per warp
  static constexpr int TCO = WIDE ? 4 * TQ : 16;
  static constexpr int NT = TCO / WN / 8;        // n-tiles per warp
  static constexpr int X_PIECES = HALO_PX * 2;   // 16-byte pieces
  static constexpr int XP = (X_PIECES + THREADS - 1) / THREADS;
  static constexpr int WSTEP = THREADS / (2 * TCO);  // taps between a
                                                     // thread's weight pieces
  static constexpr int XS_BYTES = HALO_PX * KB;
  static constexpr int STAGE_BYTES = XS_BYTES + 9 * TCO * KB;
  static constexpr int RING_BYTES = 4 * RING_ROWS * TCO * 4;
  static __host__ __device__ constexpr int smem_bytes(int stages) {
    return stages * STAGE_BYTES > RING_BYTES ? stages * STAGE_BYTES
                                             : RING_BYTES;
  }
};

template <typename T>
struct Args {
  const T* x;                  // B1: x (N, H, W, C4in); B2: gz
  const T* rings;              // B1: (N, 2, W, C4in) or null; B2: null
  const unsigned char* wp;     // packed weights (9, ksteps, C4out, 32 bytes)
  const unsigned* bits;        // (9,): bit 4 s_in + s_out of a listed block
  const T* bias;               // B1: (C4out,); B2: unused
  T* y;                        // (N, H, W, C4out)
  int H, W, C4in, C4out, ksteps, tiles_w;
  float alpha;
};

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
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hmma::pack_bf16(a, b);
}

__device__ __forceinline__ uint2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// c += a b on one 16 x 8 block from B5-order fragments: lo / hi the lane's
// 8 bytes of rows g / g + 8, b those of column g. bfloat16: one m16n8k16;
// float32: three TF32 products, the A fragment split once (ah, al) for
// every n-tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint2 lo, uint2 hi,
                                         uint2 b) {
  hmma::mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
}
__device__ __forceinline__ void split_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                        uint2 lo, uint2 hi) {
  hmma::tf32::split(__uint_as_float(lo.x), ah[0], al[0]);
  hmma::tf32::split(__uint_as_float(hi.x), ah[1], al[1]);
  hmma::tf32::split(__uint_as_float(lo.y), ah[2], al[2]);
  hmma::tf32::split(__uint_as_float(hi.y), ah[3], al[3]);
}
// c += a b in float32: a fresh chain of the three products (from zero),
// then one rounded float add. `mma` adds its products to the accumulator
// with truncation, so a chain carried over every tap and K step (432 of
// them at 4C = 128, 1728 at 512) drifts by ~2^-23 of the sum per link,
// always the same way: ~1e-4 of it at these depths, the whole tolerance.
__device__ __forceinline__ void mma_f32(float (&c)[4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t bh0,
                                        uint32_t bh1, uint32_t bl0,
                                        uint32_t bl1) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float d[4];
  hmma::tf32::mma3(d, ah, al, bh0, bh1, bl0, bl1, zero);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// One kernel for B1 (BWD false) and B2 (true). grid (tiles, channel tiles,
// N). T float or __nv_bfloat16.
template <typename T, bool WIDE, bool BWD, int MINB, int STAGES>
__global__ void __launch_bounds__(THREADS, MINB)
    folded_mma_kernel(const Args<T> a) {
  using S = Shape<WIDE>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int ES = sizeof(T);
  constexpr int KE = KB / ES;  // channels per K step
  constexpr int PE = KE / 2;   // channels per 16-byte piece
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned long long s_bits[4];  // per input block: 4 tap + out
  __shared__ unsigned long long s_step[64];  // per K step (the first 64)
  __shared__ unsigned char s_ntm[S::TCO / 8];  // n-tile -> its out blocks

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int H = a.H, W = a.W, C4in = a.C4in, C4out = a.C4out;
  const int r0 = (blockIdx.x / a.tiles_w) * TH;
  const int c0 = (blockIdx.x % a.tiles_w) * TW;
  const size_t n = blockIdx.z;
  const int Cin = C4in / 4, Cout = C4out / 4;
  const bool blocked = WIDE && Cout % 8 == 0;
  // blocked: channels s * Cout + q0 + [0, TQ) of each output block s;
  // otherwise co0 + [0, TCO)
  const int cbase = blockIdx.y * (blocked ? TQ : S::TCO);

  // the block's output channel of local column cl, or -1 past the layer
  auto chan = [&](int cl) -> int {
    if (blocked) {
      const int q = cbase + cl % TQ;
      return q < Cout ? (cl / TQ) * Cout + q : -1;
    }
    return cbase + cl < C4out ? cbase + cl : -1;
  };

  if (tid < 4) {
    unsigned long long bits = 0;
    for (int tap = 0; tap < 9; ++tap)
      bits |= (unsigned long long)((a.bits[tap] >> (4 * tid)) & 15u)
              << (4 * tap);
    s_bits[tid] = bits;
  }
  if (tid < S::TCO / 8) {
    unsigned m = 0;
    for (int e = 0; e < 8; ++e) {
      const int ch = chan(tid * 8 + e);
      if (ch >= 0) m |= 1u << (ch / Cout);
    }
    s_ntm[tid] = static_cast<unsigned char>(m);
  }

  // ---- the thread's halo pieces: the source row of a channel of the first
  // half (sub-row 0: blocks {0, 1}) and of the second, and the source
  // column of a channel of sub-column 0 (blocks {0, 2}) and of sub-column
  // 1; they differ only on B1's ring. Rows H and H + 1 name the rows of
  // `rings`; without it the ring rows are x's by the reflect rule (row -1:
  // first half from row 1, second from row 0; row H: from H-1, H-2). -1
  // where the tile stages zeros.
  int srow[S::XP][2], scol[S::XP][2];
#pragma unroll
  for (int p = 0; p < S::XP; ++p) {
    const int idx = tid + p * THREADS;
    const int pix = idx >> 1;
    const int rg = r0 - 1 + pix / HALO_W, cg = c0 - 1 + pix % HALO_W;
    srow[p][0] = srow[p][1] = scol[p][0] = scol[p][1] = -1;
    if (idx >= S::X_PIECES) continue;
    if (BWD) {
      if (rg >= 0 && rg < H && cg >= 0 && cg < W) {
        srow[p][0] = srow[p][1] = rg;
        scol[p][0] = scol[p][1] = cg;
      }
    } else if (rg >= -1 && rg <= H && cg >= -1 && cg <= W) {
      if (rg >= 0 && rg < H) {
        srow[p][0] = srow[p][1] = rg;
      } else if (a.rings != nullptr) {
        srow[p][0] = srow[p][1] = rg < 0 ? H : H + 1;
      } else {
        srow[p][0] = rg < 0 ? 1 : H - 1;
        srow[p][1] = rg < 0 ? 0 : H - 2;
      }
      scol[p][0] = cg < 0 ? 1 : cg == W ? W - 1 : cg;
      scol[p][1] = cg < 0 ? 0 : cg == W ? W - 2 : cg;
    }
  }
  auto pixel = [&](int row, int col) -> const T* {
    return row < H ? a.x + ((n * H + row) * W + col) * C4in
                   : a.rings + ((n * 2 + row - H) * W + col) * C4in;
  };
  // cp.async reads 16-byte aligned sources only
  const bool aligned16 =
      (C4in * ES) % 16 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.rings) % 16 == 0;
  const T zero = from_f32<T>(0.f);
  // a piece's channels lie in one block (and one half) when C % PE == 0
  const bool one_block_pieces = Cin % PE == 0;
  const int half = C4in / 2;

  __syncthreads();  // s_bits, s_ntm

  // the thread's weight pieces: 16 bytes of local column wcl's 32-byte row,
  // the same in every step, for taps wtap0, wtap0 + WSTEP, ...
  const int wpiece = tid % (2 * S::TCO);
  const int wch = chan(wpiece >> 1);
  const int wtap0 = S::WSTEP == 1 ? 0 : tid / (2 * S::TCO);
  // staged when either n-tile of its pair is listed: the other one's rows
  // then hold the zeros the table says are there
  const unsigned wmask = s_ntm[wpiece >> 4] | s_ntm[(wpiece >> 4) ^ 1];
  const size_t wstep = (size_t)C4out * KB, wtap = wstep * a.ksteps;
  const unsigned char* wsrc =
      a.wp + (size_t)(wch >= 0 ? wch : 0) * KB + (wpiece & 1) * 16;

  // (tap, output block) bits listed for the input blocks K step ks spans
  auto step_bits = [&](int ks) -> unsigned long long {
    const int k0 = ks * KE;
    const int k1 = (k0 + KE < C4in ? k0 + KE : C4in) - 1;
    unsigned long long m = 0;
    for (int s = k0 / Cin; s <= k1 / Cin; ++s) m |= s_bits[s];
    return m;
  };
  if (tid < 64 && tid < a.ksteps) s_step[tid] = step_bits(tid);
  __syncthreads();
  auto step_mask = [&](int ks) -> unsigned long long {
    return ks < 64 ? s_step[ks] : step_bits(ks);
  };

  auto load_stage = [&](int ks, int stage) {
    unsigned char* xs = smem + stage * S::STAGE_BYTES;
    unsigned char* ws = xs + S::XS_BYTES;
    const int k0 = ks * KE;
    const unsigned long long m = step_mask(ks);
#pragma unroll
    for (int p = 0; p < S::XP; ++p) {
      const int idx = tid + p * THREADS;
      if (idx >= S::X_PIECES) continue;
      const int g0 = k0 + (idx & 1) * PE;  // first channel of the piece
      unsigned char* dst = xs + idx * 16;
      const bool uniform = (srow[p][0] == srow[p][1] &&
                            scol[p][0] == scol[p][1]) || one_block_pieces;
      if (aligned16 && uniform) {
        // whole pieces: all channels past C4in or none (C4in % PE == 0)
        const bool ok = srow[p][0] >= 0 && g0 < C4in;
        hmma::cp_async16(
            dst,
            ok ? pixel(srow[p][g0 >= half], scol[p][(g0 / Cin) & 1]) + g0
               : a.x,
            ok ? 16 : 0);
      } else {  // element by element, each channel from its own source
        T* d = reinterpret_cast<T*>(dst);
#pragma unroll
        for (int e = 0; e < PE; ++e) {
          const int ch = g0 + e;
          d[e] = (srow[p][0] >= 0 && ch < C4in)
                     ? pixel(srow[p][ch >= half], scol[p][(ch / Cin) & 1])[ch]
                     : zero;
        }
      }
    }
    const unsigned char* wk = wsrc + ks * wstep;
#pragma unroll
    for (int i = 0; i < (9 + S::WSTEP - 1) / S::WSTEP; ++i) {
      const int tap = wtap0 + i * S::WSTEP;
      if (tap >= 9) break;
      if (!((m >> (4 * tap)) & wmask)) continue;  // an n-tile never read
      hmma::cp_async16(ws + (tap * S::TCO) * KB + wpiece * 16,
                       wch >= 0 ? wk + tap * wtap : a.wp, wch >= 0 ? 16 : 0);
    }
  };

  // the warp's n-tiles: first local column; the listed output blocks of
  // each pair (2p, 2p + 1), which share one in the blocked tiling
  int ncol[S::NT];
  unsigned nmask[S::NT / 2];
#pragma unroll
  for (int j = 0; j < S::NT; ++j)
    ncol[j] = !WIDE ? 8 * j
              : blocked ? (j >> 1) * TQ + wn * 16 + (j & 1) * 8
                        : wn * (S::TCO / 2) + 8 * j;
#pragma unroll
  for (int p = 0; p < S::NT / 2; ++p)
    nmask[p] = s_ntm[ncol[2 * p] >> 3] | s_ntm[ncol[2 * p + 1] >> 3];

  // ---- B2's ring blocks: 0 the ring row above, 1 below, 2 the ring column
  // left, 3 right; warp row wm owns ring wm where the tile needs it
  const int ring = BWD && wm < 4 ? wm : -1;
  const bool need[4] = {r0 == 0, r0 + TH - 1 >= H - 2, c0 == 0,
                        c0 + TW - 1 >= W - 2};
  const bool ring_on = (ring == 0 && need[0]) || (ring == 1 && need[1]) ||
                       (ring == 2 && need[2]) || (ring == 3 && need[3]);
  const int hb = H - r0;  // halo row of gz row H - 1 (bottom ring's input)

  float acc[S::MT][S::NT][4];
  float racc[BWD ? S::NT : 1][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < (BWD ? S::NT : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) racc[j][e] = 0.f;

  const int ksteps = a.ksteps;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    hmma::cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    // step ks has landed; every warp is past step ks - 1, whose stage the
    // next load overwrites
    hmma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ks + STAGES - 1 < ksteps)
      load_stage(ks + STAGES - 1, (ks + STAGES - 1) % STAGES);
    hmma::cp_async_commit();

    const unsigned char* xs = smem + (ks % STAGES) * S::STAGE_BYTES;
    const unsigned char* ws = xs + S::XS_BYTES;
    const unsigned long long m = step_mask(ks);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned tmask = (m >> (4 * tap)) & 15u;
      if (!tmask) continue;  // the same branch in every thread
      const int dr = tap / 3, dc = tap % 3;
      uint2 lo[S::MT], hi[S::MT];
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        const int pix = (wm * S::MT + i + dr) * HALO_W + dc + g;
        lo[i] = lds64(xs + pix * KB + 8 * t);
        hi[i] = lds64(xs + (pix + 8) * KB + 8 * t);
      }
      // the ring block's rows, where this tap reaches it
      bool rtap = false;
      uint2 rlo = make_uint2(0u, 0u), rhi = make_uint2(0u, 0u);
      if (BWD && ring_on) {
        if (ring < 2) {
          rtap = dr == (ring == 0 ? 2 : 0);
          if (rtap) {
            const int pix = (ring == 0 ? 1 : hb) * HALO_W + dc + g;
            rlo = lds64(xs + pix * KB + 8 * t);
            rhi = lds64(xs + (pix + 8) * KB + 8 * t);
          }
        } else {
          rtap = dc == (ring == 2 ? 2 : 0);
          if (rtap) {
            // row r of the block is tile row r - 1: halo row r - 1 + dr
            const int col = ring == 2 ? 1 : W - c0;
            if (g - 1 + dr >= 0)
              rlo = lds64(xs + ((g - 1 + dr) * HALO_W + col) * KB + 8 * t);
            if (g + dr <= 2)
              rhi = lds64(xs + ((g + 7 + dr) * HALO_W + col) * KB + 8 * t);
          }
        }
      }
      uint32_t ah[S::MT][4], al[S::MT][4], rah[4], ral[4];
      if constexpr (F32) {
#pragma unroll
        for (int i = 0; i < S::MT; ++i) split_a(ah[i], al[i], lo[i], hi[i]);
        if (BWD && rtap) split_a(rah, ral, rlo, rhi);
      }
      // n-tiles in pairs (2p, 2p + 1): one branch and both B fragments
      // loaded ahead of their mma
#pragma unroll
      for (int p = 0; p < S::NT / 2; ++p) {
        if (!(tmask & nmask[p])) continue;  // the same in every warp
        uint2 bp[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          bp[q] = lds64(ws + (tap * S::TCO + ncol[2 * p + q] + g) * KB +
                        8 * t);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = 2 * p + q;
          const uint2 b = bp[q];
          if constexpr (F32) {
            uint32_t bh0, bl0, bh1, bl1;
            hmma::tf32::split(__uint_as_float(b.x), bh0, bl0);
            hmma::tf32::split(__uint_as_float(b.y), bh1, bl1);
#pragma unroll
            for (int i = 0; i < S::MT; ++i)
              mma_f32(acc[i][j], ah[i], al[i], bh0, bh1, bl0, bl1);
            if (BWD && rtap)
              mma_f32(racc[BWD ? j : 0], rah, ral, bh0, bh1, bl0, bl1);
          } else {
#pragma unroll
            for (int i = 0; i < S::MT; ++i)
              mma_bf16(acc[i][j], lo[i], hi[i], b);
            if (BWD && rtap) mma_bf16(racc[BWD ? j : 0], rlo, rhi, b);
          }
        }
      }
    }
  }

  // ---- B2: the ring blocks to shared memory, [ring][row][local column]
  float* rb = reinterpret_cast<float*>(smem);
  if constexpr (BWD) {
    hmma::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the last stage
    if (ring_on) {
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        float* row = rb + (ring * RING_ROWS + g) * S::TCO + ncol[j] + 2 * t;
        row[0] = racc[j][0];
        row[1] = racc[j][1];
        row[8 * S::TCO] = racc[j][2];
        row[8 * S::TCO + 1] = racc[j][3];
      }
    }
    __syncthreads();
  }

  // ---- epilogue: a fragment holds channels 2t, 2t + 1 of pixels g (c[0],
  // c[1]) and g + 8 (c[2], c[3]) of its row block
#pragma unroll
  for (int j = 0; j < S::NT; ++j) {
    const int cl = ncol[j] + 2 * t;
    const int ch = chan(cl);  // ch and ch + 1: C4out is even
    if (ch < 0) continue;
    float bias[2] = {0.f, 0.f};
    if constexpr (!BWD) {
      bias[0] = to_f32(a.bias[ch]);
      bias[1] = to_f32(a.bias[ch + 1]);
    }
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      const int ti = wm * S::MT + i;
      const int r = r0 + ti;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tj = g + 8 * h;
        const int c = c0 + tj;
        if (r >= H || c >= W) continue;
        float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        if constexpr (BWD) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int blk = (ch + e) / Cout;
            const bool sj0 = (blk & 1) == 0, si0 = blk < 2;
            const float* col = rb + cl + e;
            const bool hit_l = need[2] && ((c == 1 && sj0) || (c == 0 && !sj0));
            const bool hit_r =
                need[3] && ((c == W - 1 && sj0) || (c == W - 2 && !sj0));
            // ring columns: on this row (ring block row ti + 1)
            if (hit_l) v[e] += col[(2 * RING_ROWS + ti + 1) * S::TCO];
            if (hit_r) v[e] += col[(3 * RING_ROWS + ti + 1) * S::TCO];
            // ring rows, their corners scattered by the column rule
            if (need[0] && ((r == 1 && si0) || (r == 0 && !si0))) {
              v[e] += col[(0 * RING_ROWS + tj) * S::TCO];
              if (hit_l) v[e] += col[(2 * RING_ROWS + 0) * S::TCO];
              if (hit_r) v[e] += col[(3 * RING_ROWS + 0) * S::TCO];
            }
            if (need[1] && ((r == H - 1 && si0) || (r == H - 2 && !si0))) {
              v[e] += col[(1 * RING_ROWS + tj) * S::TCO];
              if (hit_l) v[e] += col[(2 * RING_ROWS + hb + 1) * S::TCO];
              if (hit_r) v[e] += col[(3 * RING_ROWS + hb + 1) * S::TCO];
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = v[e] + bias[e];
            v[e] = s >= 0.f ? s : a.alpha * s;
          }
        }
        store2(a.y + ((n * H + r) * W + c) * C4out + ch, v[0], v[1]);
      }
    }
  }
}

// The launch's weight preparation: k (3, 3, C4in, C4out) HWIO -> wp (9,
// ksteps, C4out, KE) K-major, zeros past C4in (ops/folded_conv.py
// `pack_k_major`), and bits[tap] |= 1 << (4 s_in + s_out) for every entry
// that is not 0 (NaN included: ops/folded_conv.py `block_table`). One block
// per (tap, K step); bits zeroed before.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    prep_weights_kernel(const T* __restrict__ k, T* __restrict__ wp,
                        unsigned* __restrict__ bits, int C4in, int C4out,
                        int ksteps) {
  constexpr int KE = KB / sizeof(T);
  __shared__ unsigned s_or;
  const int tap = blockIdx.x / ksteps, ks = blockIdx.x % ksteps;
  const int Cin = C4in / 4, Cout = C4out / 4;
  if (threadIdx.x == 0) s_or = 0;
  __syncthreads();
  unsigned mine = 0;
  T* out = wp + (size_t)blockIdx.x * C4out * KE;
  // reads along co (coalesced), writes KE apart
  for (int i = threadIdx.x; i < C4out * KE; i += THREADS) {
    const int e = i / C4out, co = i % C4out;
    const int ci = ks * KE + e;
    T v = from_f32<T>(0.f);
    if (ci < C4in) {
      v = k[((size_t)tap * C4in + ci) * C4out + co];
      if (!(to_f32(v) == 0.f)) mine |= 1u << (4 * (ci / Cin) + co / Cout);
    }
    out[co * KE + e] = v;
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicOr(&s_or, mine);
  __syncthreads();
  if (threadIdx.x == 0 && s_or) atomicOr(bits + tap, s_or);
}

template <typename T, bool WIDE, bool BWD, int MINB, int STAGES>
int launch_cfg(const Args<T>& a, int N, cudaStream_t s) {
  using S = Shape<WIDE>;
  auto kernel = folded_mma_kernel<T, WIDE, BWD, MINB, STAGES>;
  const int smem = S::smem_bytes(STAGES);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cout = a.C4out / 4;
  const bool blocked = WIDE && Cout % 8 == 0;
  const int gy = blocked ? (Cout + TQ - 1) / TQ
                         : (a.C4out + S::TCO - 1) / S::TCO;
  const dim3 grid(a.tiles_w * ((a.H + TH - 1) / TH), gy, N);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline bool shape_ok(int N, int H, int W, int C4in, int C4out) {
  return N >= 1 && N <= 65535 && H >= 2 && W >= 2 && C4in >= 4 &&
         C4out >= 4 && C4in % 4 == 0 && C4out % 4 == 0;
}

// Fill `a` for a layer, prepare its weights from the HWIO kernel `k` into
// the scratch `wp` / `bits` (see prep_weights_kernel), and launch the
// tiling its output width takes. MINB / STAGES: blocks per SM the
// registers are held to, cp.async stages.
template <typename T, bool BWD, int MINB, int STAGES>
int launch(Args<T> a, const T* k, T* wp, unsigned* bits, int N,
           cudaStream_t s) {
  if (!shape_ok(N, a.H, a.W, a.C4in, a.C4out))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ksteps = (a.C4in * static_cast<int>(sizeof(T)) + KB - 1) / KB;
  a.tiles_w = (a.W + TW - 1) / TW;
  a.wp = reinterpret_cast<const unsigned char*>(wp);
  a.bits = bits;
  cudaError_t err = cudaMemsetAsync(bits, 0, 9 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  prep_weights_kernel<T><<<9 * a.ksteps, THREADS, 0, s>>>(
      k, wp, bits, a.C4in, a.C4out, a.ksteps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.C4out <= 16) return launch_cfg<T, false, BWD, MINB, STAGES>(a, N, s);
  return launch_cfg<T, true, BWD, MINB, STAGES>(a, N, s);
}

}  // namespace folded

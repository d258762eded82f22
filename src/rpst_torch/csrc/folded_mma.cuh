// The tensor-core main loop of the folded convs: B1 (folded_conv.cu), B2
// (folded_conv_bwd.cu), B4 (folded_conv_q8.cu) and both layers of B7
// (folded_conv2_q8.cu). A 3x3 conv on the folded (space-to-depth) NHWC
// layout as an implicit GEMM on `mma.sync`, which takes only the non-zero
// (tap, input block, output block) blocks of the folded kernel.
//
//   B1: y  = lrelu_alpha(conv3x3(reflect_ring(x)) + b), the ring rows from
//        `rings` or by the reflect rule from x, the ring columns by the
//        channel-block rule;
//   B2: dx = conv3x3(zero_pad(gz), khat) + the adjoint of the reflect ring;
//   B4: the same conv on int8 x and weights, summed in int32, with the
//        int8 epilogue of q8_common.cuh (the section "int8" below);
//   B7: two B4 layers in one block, layer 2 reading layer 1 from shared
//        memory (folded_conv2_q8.cu).
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
// words in a scratch buffer the wrapper passes. `quantize_weights` keeps a
// folded kernel's zero blocks exactly zero (round(0 / s) = 0), so an int8
// fold lists the same 36 blocks.
//
// What bounds it on the card. At (1, 256, 256, 128 -> 128) the unfolded
// work is 4.83 GFLOP: 0.0098 ms of TF32, 0.029 ms at three TF32 products,
// 0.0049 ms of bf16, 0.0024 ms of int8; the tensors are ~67 MB in float32
// (0.020 ms), 16.8 MB in int8 (0.0050 ms). A dense kernel is 4x the
// operations. So it is bound by operations in float (bytes in int8), as long
// as each staged value is reused from shared memory.
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
//   * K is walked in steps of 32 bytes per pixel: 16 bf16, 8 float or 32
//     int8 channels. A step lies in one input block when C is a multiple of
//     it (C = 32, 64, 128: at the flagship's int8 4C = 128 one step is one
//     block, so the skip takes whole steps' blocks); for the 12-wide images
//     (C = 3) and int8 4C = 16 it spans all four and its mask is their
//     union. One staged halo tile ((TH + 2) x (TW + 2) pixels x 32 bytes)
//     serves all 9 taps, and the step's weights are the listed (tap,
//     n-tile) rows of 32 bytes, packed K-major per launch (the layout of
//     ops/folded_conv.py `pack_k_major`). Both arrive by `cp.async` into a
//     ring of STAGES; a 16-byte piece whose channels need two different
//     sources (a ring column at C = 3, 4) or whose row is not 16-byte
//     aligned (12 bf16 channels) is loaded element by element.
//   * The K loop reads each step's listed (tap, output block) bits from a
//     per-block table in shared memory and takes the n-tiles of a warp in
//     pairs, which share one output block in the blocked tiling: a pair is
//     one branch and two B loads ahead of its mma (PERF.md: 8-22% over
//     single n-tiles on the card).
//   * Fragments as B5's: lane t reads bytes [8t, 8t + 8) of a 32-byte row
//     for both A (pixels g, g + 8) and B (channel g); the order of K inside
//     a step is free as long as A and B agree. bf16: one m16n8k16; int8:
//     one m16n8k32 (s8 -> s32, exact in any order). float32: the two floats
//     are k = t and t + 4 of an m16n8k8, as three TF32 products
//     (mma_common.cuh `tf32::mma3`): one TF32 product cannot hold 1e-4 at K
//     = 9 x 4C. Each tap's three products start a fresh chain and are added
//     to the sum in float32, as B6 does (`mma_f32`).
//   * Extra row blocks ride on the same loop with the B fragments the main
//     blocks load anyway (`mma_taps`' ring): B2's ring adjoint is four of
//     them (the ring row above: tap row 2 on halo row 1; below: tap row 0;
//     the ring column left: tap column 2 on halo column 1; right: tap column
//     0), each owned by one warp row of a tile that needs it; after the
//     loop they go through shared memory to the threads that own the
//     outputs they land on, and dx is written once, with no atomics. B7's
//     layer 1 computes its 1-pixel halo ring the same way (four blocks, all
//     taps, folded_conv2_q8.cu).
//   * Epilogue in float32: B1 adds the bias and applies lrelu_alpha (a
//     negative y at alpha = 0 gives -0.0, as the plain version's
//     where(y >= 0, y, alpha * y)); stored in x's type, two channels a lane.
//     int8: `q8_epilogue` below.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma_common.cuh"
#include "q8_common.cuh"

namespace folded {

constexpr int TH = 8;                 // tile rows
constexpr int TW = 16;                // tile columns: one mma row block
constexpr int KB = 32;                // bytes of K per pixel and step
constexpr int THREADS = 256;
constexpr int TQ = 32;                // channels of each output block (wide)
constexpr int RING_ROWS = 16;         // rows of a ring block (one mma block)

// HB: the border of the staged input tile around the output tile (1 for a
// 3x3 conv; 2 for B7's layer 1, which also computes its own 1-pixel halo)
template <bool WIDE, int HB = 1>
struct Shape {
  static constexpr int WM = WIDE ? 4 : 8;        // warps along pixels
  static constexpr int WN = WIDE ? 2 : 1;        // warps along channels
  static constexpr int MT = TH / WM;             // mma row blocks per warp
  static constexpr int TCO = WIDE ? 4 * TQ : 16;
  static constexpr int NT = TCO / WN / 8;        // n-tiles per warp
  static constexpr int BORDER = HB;
  static constexpr int HALO_H = TH + 2 * HB;
  static constexpr int HALO_W = TW + 2 * HB;
  static constexpr int HALO_PX = HALO_H * HALO_W;
  static constexpr int X_PIECES = HALO_PX * 2;   // 16-byte pieces
  static constexpr int XP = (X_PIECES + THREADS - 1) / THREADS;
  static constexpr int WSTEP = THREADS / (2 * TCO);  // taps between a
                                                     // thread's weight pieces
  static constexpr int XS_BYTES = HALO_PX * KB;
  static constexpr int WS_BYTES = 9 * TCO * KB;
  static constexpr int STAGE_BYTES = XS_BYTES + WS_BYTES;
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
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return static_cast<int8_t>(v);
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
// int8: one m16n8k32; float32: three TF32 products, the A fragment split
// once (ah, al) for every n-tile.
__device__ __forceinline__ void mma_frag(float (&c)[4], uint2 lo, uint2 hi,
                                         uint2 b) {
  hmma::mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
}
__device__ __forceinline__ void mma_frag(int32_t (&c)[4], uint2 lo, uint2 hi,
                                         uint2 b) {
  hmma::mma_s8(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
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

// ---------------------------------------------------------------- pieces
// of the main loop, shared by the kernels named at the top

// One layer's channels on a block. blocked (WIDE and Cout % 8 == 0): local
// column cl is channel (cl / TQ) * Cout + cbase + cl % TQ; otherwise cbase
// + cl. ksteps: K steps of KB bytes over C4in.
template <bool WIDE>
struct Layer {
  int C4in, C4out, Cin, Cout, ksteps, cbase;
  bool blocked;
  __device__ Layer(int c4in, int c4out, int ks, int by)
      : C4in(c4in), C4out(c4out), Cin(c4in / 4), Cout(c4out / 4),
        ksteps(ks), blocked(WIDE && (c4out / 4) % 8 == 0) {
    cbase = by * (blocked ? TQ : Shape<WIDE>::TCO);
  }
  // the block's output channel of local column cl, or -1 past the layer
  __device__ __forceinline__ int chan(int cl) const {
    if (blocked) {
      const int q = cbase + cl % TQ;
      return q < Cout ? (cl / TQ) * Cout + q : -1;
    }
    return cbase + cl < C4out ? cbase + cl : -1;
  }
};

// A layer's block table in shared memory: per input block its (tap, output
// block) bits; per K step (the first 64) the union over the blocks it
// spans; per n-tile the output blocks its channels lie in.
struct Tables {
  unsigned long long bits[4];
  unsigned long long step[64];
  unsigned char ntm[16];
};

// (tap, output block) bits listed for the input blocks K step ks spans, KE
// channels a step
__device__ __forceinline__ unsigned long long step_bits(const Tables& tb,
                                                        int C4in, int Cin,
                                                        int KE, int ks) {
  const int k0 = ks * KE;
  const int k1 = (k0 + KE < C4in ? k0 + KE : C4in) - 1;
  unsigned long long m = 0;
  for (int s = k0 / Cin; s <= k1 / Cin; ++s) m |= tb.bits[s];
  return m;
}
__device__ __forceinline__ unsigned long long step_mask(const Tables& tb,
                                                        int C4in, int Cin,
                                                        int KE, int ks) {
  return ks < 64 ? tb.step[ks] : step_bits(tb, C4in, Cin, KE, ks);
}

// Fill `tb` from the launch's table (9 words); every thread calls it, and it
// ends at a barrier.
template <bool WIDE>
__device__ __forceinline__ void init_tables(Tables& tb, const unsigned* bits,
                                            const Layer<WIDE>& L, int KE,
                                            int tid) {
  if (tid < 4) {
    unsigned long long b = 0;
    for (int tap = 0; tap < 9; ++tap)
      b |= (unsigned long long)((bits[tap] >> (4 * tid)) & 15u) << (4 * tap);
    tb.bits[tid] = b;
  }
  if (tid < Shape<WIDE>::TCO / 8) {
    unsigned m = 0;
    for (int e = 0; e < 8; ++e) {
      const int ch = L.chan(tid * 8 + e);
      if (ch >= 0) m |= 1u << (ch / L.Cout);
    }
    tb.ntm[tid] = static_cast<unsigned char>(m);
  }
  __syncthreads();
  if (tid < 64 && tid < L.ksteps)
    tb.step[tid] = step_bits(tb, L.C4in, L.Cin, KE, tid);
  __syncthreads();
}

// The thread's pieces of the staged halo tile of S (its rows start at r0 -
// HB, its columns at c0 - HB): the source row of a channel of the first
// half (sub-row 0: blocks {0, 1}) and of the second, and the source column
// of a channel of sub-column 0 (blocks {0, 2}) and of sub-column 1; they
// differ only on the reflect ring. ZERO: zeros outside the image (B2).
// Otherwise rows H and H + 1 name the rows of `rings`; without it the ring
// rows are x's by the reflect rule (row -1: first half from row 1, second
// from row 0; row H: from H-1, H-2), and the ring columns follow the
// channel-block rule. -1 where the tile stages zeros (past the ring).
template <typename T, class S, bool ZERO>
struct Halo {
  const T* x;      // image n's first pixel, and its ring rows
  const T* rings;
  int srow[S::XP][2], scol[S::XP][2];
  int H, W, C4in, Cin, half;
  bool aligned16, one_block_pieces;

  __device__ Halo(const T* x_, const T* rings_, size_t n, int r0, int c0,
                  int H_, int W_, int c4in, int tid)
      : H(H_), W(W_), C4in(c4in), Cin(c4in / 4), half(c4in / 2) {
    constexpr int ES = sizeof(T);
    constexpr int PE = KB / ES / 2;  // channels per 16-byte piece
    x = x_ + n * H * W * C4in;
    rings = rings_ ? rings_ + n * 2 * W * C4in : nullptr;
    // cp.async reads 16-byte aligned sources only
    aligned16 = (C4in * ES) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(x_) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(rings_) % 16 == 0;
    // a piece's channels lie in one block (and one half) when C % PE == 0
    one_block_pieces = Cin % PE == 0;
#pragma unroll
    for (int p = 0; p < S::XP; ++p) {
      const int idx = tid + p * THREADS;
      const int pix = idx >> 1;
      const int rg = r0 - S::BORDER + pix / S::HALO_W;
      const int cg = c0 - S::BORDER + pix % S::HALO_W;
      srow[p][0] = srow[p][1] = scol[p][0] = scol[p][1] = -1;
      if (idx >= S::X_PIECES) continue;
      if (ZERO) {
        if (rg >= 0 && rg < H && cg >= 0 && cg < W) {
          srow[p][0] = srow[p][1] = rg;
          scol[p][0] = scol[p][1] = cg;
        }
      } else if (rg >= -1 && rg <= H && cg >= -1 && cg <= W) {
        if (rg >= 0 && rg < H) {
          srow[p][0] = srow[p][1] = rg;
        } else if (rings != nullptr) {
          srow[p][0] = srow[p][1] = rg < 0 ? H : H + 1;
        } else {
          srow[p][0] = rg < 0 ? 1 : H - 1;
          srow[p][1] = rg < 0 ? 0 : H - 2;
        }
        scol[p][0] = cg < 0 ? 1 : cg == W ? W - 1 : cg;
        scol[p][1] = cg < 0 ? 0 : cg == W ? W - 2 : cg;
      }
    }
  }

  __device__ __forceinline__ const T* pixel(int row, int col) const {
    return row < H ? x + ((size_t)row * W + col) * C4in
                   : rings + ((size_t)(row - H) * W + col) * C4in;
  }

  // stage K step ks of the halo tile into xs
  __device__ __forceinline__ void load(unsigned char* xs, int ks,
                                       int tid) const {
    constexpr int KE = KB / sizeof(T);
    constexpr int PE = KE / 2;
    const int k0 = ks * KE;
    const T zero = from_f32<T>(0.f);
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
               : x,
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
  }
};

// The thread's weight pieces: 16 bytes of local column wpiece / 2's 32-byte
// row, the same in every step, for taps tap0, tap0 + WSTEP, ...; staged
// where either n-tile of its pair is listed (the other one's rows then hold
// the zeros the table says are there).
template <bool WIDE>
struct Weights {
  using S = Shape<WIDE>;
  const unsigned char* src;  // also the (unread) source of a zero fill
  int wstep, wtap;           // bytes a K step, a tap (shape_ok: < 2^31)
  int piece, tap0;
  unsigned mask;
  bool ok;

  __device__ Weights(const Layer<WIDE>& L, const Tables& tb,
                     const unsigned char* wp, int tid) {
    piece = tid % (2 * S::TCO);
    const int ch = L.chan(piece >> 1);
    ok = ch >= 0;
    tap0 = S::WSTEP == 1 ? 0 : tid / (2 * S::TCO);
    mask = tb.ntm[piece >> 4] | tb.ntm[(piece >> 4) ^ 1];
    wstep = L.C4out * KB;
    wtap = wstep * L.ksteps;
    src = wp + (size_t)(ok ? ch : 0) * KB + (piece & 1) * 16;
  }

  // stage K step ks's listed rows (m: its (tap, output block) bits) into ws
  __device__ __forceinline__ void load(unsigned char* ws, int ks,
                                       unsigned long long m) const {
    const unsigned char* wk = src + (size_t)ks * wstep;
#pragma unroll
    for (int i = 0; i < (9 + S::WSTEP - 1) / S::WSTEP; ++i) {
      const int tap = tap0 + i * S::WSTEP;
      if (tap >= 9) break;
      if (!((m >> (4 * tap)) & mask)) continue;  // an n-tile never read
      hmma::cp_async16(ws + (tap * S::TCO) * KB + piece * 16,
                       ok ? wk + (size_t)tap * wtap : src, ok ? 16 : 0);
    }
  }
};

// The warp's n-tiles: first local column; the listed output blocks of each
// pair (2p, 2p + 1), which share one in the blocked tiling.
template <bool WIDE>
struct Tiles {
  using S = Shape<WIDE>;
  int ncol[S::NT];
  unsigned nmask[S::NT / 2];
  __device__ Tiles(const Layer<WIDE>& L, const Tables& tb, int wn) {
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
      ncol[j] = !WIDE ? 8 * j
                : L.blocked ? (j >> 1) * TQ + wn * 16 + (j & 1) * 8
                            : wn * (S::TCO / 2) + 8 * j;
#pragma unroll
    for (int p = 0; p < S::NT / 2; ++p)
      nmask[p] = tb.ntm[ncol[2 * p] >> 3] | tb.ntm[ncol[2 * p + 1] >> 3];
  }
};

// One K step of the main loop: acc[i][j] += A(row block i) B(n-tile j) over
// the step's listed (tap, output block) blocks. xs: the staged A tile, HALO_W
// pixels a row, 32 bytes a pixel; apix[i]: the tile pixel of A row g of row
// block i at tap (0, 0) (row g + 8 is 8 pixels on); ws: the step's weights;
// g, t: the lane's fragment row and column.
// RING: one more row block, racc, whose A rows the functor
// ring(dr, dc, rlo, rhi) loads where tap (dr, dc) reaches it (returns false
// where it does not).
template <typename T, int HALO_W, bool WIDE, bool RING, class Acc,
          class RAcc, class RingFn>
__device__ __forceinline__ void mma_taps(
    const unsigned char* xs, const unsigned char* ws, unsigned long long m,
    const int (&apix)[Shape<WIDE>::MT], const Tiles<WIDE>& nt, int g, int t,
    Acc (&acc)[Shape<WIDE>::MT][Shape<WIDE>::NT][4], RAcc& racc,
    RingFn ring) {
  using S = Shape<WIDE>;
  constexpr bool F32 = std::is_same<T, float>::value;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const unsigned tmask = (m >> (4 * tap)) & 15u;
    if (!tmask) continue;  // the same branch in every thread
    const int dr = tap / 3, dc = tap % 3;
    const int off = dr * HALO_W + dc;
    uint2 lo[S::MT], hi[S::MT];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      lo[i] = lds64(xs + (apix[i] + off) * KB + 8 * t);
      hi[i] = lds64(xs + (apix[i] + off + 8) * KB + 8 * t);
    }
    bool rtap = false;
    uint2 rlo = make_uint2(0u, 0u), rhi = make_uint2(0u, 0u);
    if constexpr (RING) rtap = ring(dr, dc, rlo, rhi);
    uint32_t ah[S::MT][4], al[S::MT][4], rah[4], ral[4];
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i) split_a(ah[i], al[i], lo[i], hi[i]);
      if (RING && rtap) split_a(rah, ral, rlo, rhi);
    }
    // n-tiles in pairs (2p, 2p + 1): one branch and both B fragments
    // loaded ahead of their mma
#pragma unroll
    for (int p = 0; p < S::NT / 2; ++p) {
      if (!(tmask & nt.nmask[p])) continue;  // the same in every warp
      uint2 bp[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        bp[q] = lds64(ws + (tap * S::TCO + nt.ncol[2 * p + q] + g) * KB +
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
          if constexpr (RING)
            if (rtap) mma_f32(racc[j], rah, ral, bh0, bh1, bl0, bl1);
        } else {
#pragma unroll
          for (int i = 0; i < S::MT; ++i) mma_frag(acc[i][j], lo[i], hi[i], b);
          if constexpr (RING)
            if (rtap) mma_frag(racc[j], rlo, rhi, b);
        }
      }
    }
  }
}

// The cp.async ring over K steps: prefetch issues the first STAGES - 1
// loads; run waits for step ks, lets every warp pass the barrier (so the
// stage the next load overwrites is free), issues step ks + STAGES - 1 and
// computes step ks. load(ks, stage) / compute(ks, stage) get the stage's
// first byte.
template <int STAGES, class Load>
__device__ __forceinline__ void prefetch(int ksteps, unsigned char* ring,
                                         int stride, Load load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load(s, ring + s * stride);
    hmma::cp_async_commit();
  }
}
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void run(int ksteps, unsigned char* ring,
                                    int stride, Load load, Compute compute) {
  for (int ks = 0; ks < ksteps; ++ks) {
    hmma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ks + STAGES - 1 < ksteps)
      load(ks + STAGES - 1, ring + ((ks + STAGES - 1) % STAGES) * stride);
    hmma::cp_async_commit();
    compute(ks, ring + (ks % STAGES) * stride);
  }
}

// ---------------------------------------------------------------- B1 / B2

// One kernel for B1 (BWD false) and B2 (true). grid (tiles, channel tiles,
// N). T float or __nv_bfloat16.
template <typename T, bool WIDE, bool BWD, int MINB, int STAGES>
__global__ void __launch_bounds__(THREADS, MINB)
    folded_mma_kernel(const Args<T> a) {
  using S = Shape<WIDE>;
  constexpr int KE = KB / sizeof(T);  // channels per K step
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Tables tb;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int H = a.H, W = a.W;
  const int r0 = (blockIdx.x / a.tiles_w) * TH;
  const int c0 = (blockIdx.x % a.tiles_w) * TW;
  const size_t n = blockIdx.z;
  const Layer<WIDE> L(a.C4in, a.C4out, a.ksteps, blockIdx.y);
  init_tables(tb, a.bits, L, KE, tid);
  const Halo<T, S, BWD> halo(a.x, a.rings, n, r0, c0, H, W, a.C4in, tid);
  const Weights<WIDE> wts(L, tb, a.wp, tid);
  const Tiles<WIDE> nt(L, tb, wn);
  int apix[S::MT];
#pragma unroll
  for (int i = 0; i < S::MT; ++i) apix[i] = (wm * S::MT + i) * S::HALO_W + g;

  // ---- B2's ring blocks: 0 the ring row above, 1 below, 2 the ring column
  // left, 3 right; warp row wm owns ring wm where the tile needs it
  const int ring = BWD && wm < 4 ? wm : -1;
  const bool need[4] = {r0 == 0, r0 + TH - 1 >= H - 2, c0 == 0,
                        c0 + TW - 1 >= W - 2};
  const bool ring_on = (ring == 0 && need[0]) || (ring == 1 && need[1]) ||
                       (ring == 2 && need[2]) || (ring == 3 && need[3]);
  const int hb = H - r0;  // halo row of gz row H - 1 (bottom ring's input)

  float acc[S::MT][S::NT][4];
  float racc[S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < S::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) racc[j][e] = 0.f;

  auto load = [&](int ks, unsigned char* stage) {
    halo.load(stage, ks, tid);
    wts.load(stage + S::XS_BYTES, ks,
             step_mask(tb, L.C4in, L.Cin, KE, ks));
  };
  auto compute = [&](int ks, unsigned char* stage) {
    const unsigned char* xs = stage;
    // the ring block's rows, where this tap reaches it
    auto ring_rows = [&](int dr, int dc, uint2& rlo, uint2& rhi) -> bool {
      if (!ring_on) return false;
      if (ring < 2) {
        if (dr != (ring == 0 ? 2 : 0)) return false;
        const int pix = (ring == 0 ? 1 : hb) * S::HALO_W + dc + g;
        rlo = lds64(xs + pix * KB + 8 * t);
        rhi = lds64(xs + (pix + 8) * KB + 8 * t);
        return true;
      }
      if (dc != (ring == 2 ? 2 : 0)) return false;
      // row r of the block is tile row r - 1: halo row r - 1 + dr
      const int col = ring == 2 ? 1 : W - c0;
      if (g - 1 + dr >= 0)
        rlo = lds64(xs + ((g - 1 + dr) * S::HALO_W + col) * KB + 8 * t);
      if (g + dr <= 2)
        rhi = lds64(xs + ((g + 7 + dr) * S::HALO_W + col) * KB + 8 * t);
      return true;
    };
    mma_taps<T, S::HALO_W, WIDE, BWD>(
        xs, stage + S::XS_BYTES, step_mask(tb, L.C4in, L.Cin, KE, ks), apix,
        nt, g, t, acc, racc, ring_rows);
  };
  prefetch<STAGES>(L.ksteps, smem, S::STAGE_BYTES, load);
  run<STAGES>(L.ksteps, smem, S::STAGE_BYTES, load, compute);

  // ---- B2: the ring blocks to shared memory, [ring][row][local column]
  float* rb = reinterpret_cast<float*>(smem);
  if constexpr (BWD) {
    hmma::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the last stage
    if (ring_on) {
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        float* row = rb + (ring * RING_ROWS + g) * S::TCO + nt.ncol[j] + 2 * t;
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
  const int Cout = L.Cout;
#pragma unroll
  for (int j = 0; j < S::NT; ++j) {
    const int cl = nt.ncol[j] + 2 * t;
    const int ch = L.chan(cl);  // ch and ch + 1: C4out is even
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
        store2(a.y + ((n * H + r) * W + c) * a.C4out + ch, v[0], v[1]);
      }
    }
  }
}

// The launch's weight preparation: k (3, 3, C4in, C4out) HWIO -> wp (9,
// ksteps, C4out, KE) K-major, zeros past C4in (ops/folded_conv.py
// `pack_k_major`), and bits[tap] |= 1 << (4 s_in + s_out) for every entry
// that is not 0 (NaN included: ops/folded_conv.py `block_table`). One block
// per (tap, K step), a thread per 16-byte piece of a column's row: reads
// along co (coalesced), one vector store; bits zeroed before.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    prep_weights_kernel(const T* __restrict__ k, T* __restrict__ wp,
                        unsigned* __restrict__ bits, int C4in, int C4out,
                        int ksteps) {
  constexpr int KE = KB / sizeof(T);
  constexpr int PE = KE / 2;  // elements of a 16-byte piece
  __shared__ unsigned s_or;
  const int tap = blockIdx.x / ksteps, ks = blockIdx.x % ksteps;
  const int Cin = C4in / 4, Cout = C4out / 4;
  if (threadIdx.x == 0) s_or = 0;
  __syncthreads();
  unsigned mine = 0;
  T* out = wp + (size_t)blockIdx.x * C4out * KE;
  for (int i = threadIdx.x; i < C4out * 2; i += THREADS) {
    const int co = i >> 1, e0 = (i & 1) * PE;
    unsigned char piece[16];
#pragma unroll
    for (int e = 0; e < PE; ++e) {
      const int ci = ks * KE + e0 + e;
      T v = from_f32<T>(0.f);
      if (ci < C4in) {
        v = k[((size_t)tap * C4in + ci) * C4out + co];
        if (!(to_f32(v) == 0.f)) mine |= 1u << (4 * (ci / Cin) + co / Cout);
      }
      memcpy(piece + e * sizeof(T), &v, sizeof(T));
    }
    uint4 u;
    memcpy(&u, piece, 16);
    *reinterpret_cast<uint4*>(out + co * KE + e0) = u;
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicOr(&s_or, mine);
  __syncthreads();
  if (threadIdx.x == 0 && s_or) atomicOr(bits + tap, s_or);
}

// Zero `bits` (9 words) and fill it and `wp` from k; returns the cudaError_t.
template <typename T>
int prep_weights(const T* k, T* wp, unsigned* bits, int C4in, int C4out,
                 int ksteps, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(bits, 0, 9 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  prep_weights_kernel<T><<<9 * ksteps, THREADS, 0, s>>>(k, wp, bits, C4in,
                                                        C4out, ksteps);
  return static_cast<int>(cudaGetLastError());
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
         C4out >= 4 && C4in % 4 == 0 && C4out % 4 == 0 &&
         4LL * C4in * C4out < (1LL << 31);  // Weights' int strides
}

inline int ksteps_of(int C4in, int elem_size) {
  return (C4in * elem_size + KB - 1) / KB;
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
  a.ksteps = ksteps_of(a.C4in, static_cast<int>(sizeof(T)));
  a.tiles_w = (a.W + TW - 1) / TW;
  a.wp = reinterpret_cast<const unsigned char*>(wp);
  a.bits = bits;
  const int err = prep_weights<T>(k, wp, bits, a.C4in, a.C4out, a.ksteps, s);
  if (err != 0) return err;
  if (a.C4out <= 16) return launch_cfg<T, false, BWD, MINB, STAGES>(a, N, s);
  return launch_cfg<T, true, BWD, MINB, STAGES>(a, N, s);
}

// ---------------------------------------------------------------- int8
//
// The epilogue of the int8 layers (B4, and both layers of B7), on the
// accumulators of the main loop above in its warp and fragment layout:
//
//   v   = lrelu_0.2(float(acc) * deq + bias)       (q8::epilogue, rpst's
//                                                   two roundings)
//   out = clip(round_half_even(v * inv)) as int8 (q8::requant), or bf16(v)
//
// With stats, the tile's per-channel sums of v and of v * v over its
// in-image pixels, in this order, which B7's layer 1 repeats on the same
// accumulators to stay bit-equal to a B4 launch:
//   1. each thread, per channel of its fragment: s = 0; for row block i
//      (0 .. MT-1), then pixel g before g + 8: s = s + v and q = q +
//      round(v * v) (__fadd_rn / __fmul_rn: two roundings, no FMA);
//   2. across the 8 lanes of one t (g = 0 .. 7): s += shfl_xor(s, 4), then
//      8, then 16, i.e. ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7));
//   3. across the WM warp rows in order: p = 0; for wm: p = p + red[wm];
//      p is the tile's partial of the channel, written to `part`;
//   4. q8::finalize_sums adds each image's tile partials in 32 contiguous
//      chunks of tiles, each in tile order in double, then the chunks in
//      order in double, rounded to float.

// (v for one fragment: pixels g (v[0], v[1]) and g + 8 (v[2], v[3]) of its
// row block, channels ch, ch + 1)
template <bool WIDE, bool STATS, class Sink>
__device__ __forceinline__ void q8_epilogue(
    const Layer<WIDE>& L, const Tiles<WIDE>& nt, const float* scales,
    const int32_t (&acc)[Shape<WIDE>::MT][Shape<WIDE>::NT][4], int wm,
    int lane, int r0, int c0, int H, int W, float* red, float* p1,
    float* p2, Sink sink) {
  using S = Shape<WIDE>;
  const int g = lane >> 2, t = lane & 3;
  const int C4o = L.C4out;
#pragma unroll
  for (int j = 0; j < S::NT; ++j) {
    const int ch = L.chan(nt.ncol[j] + 2 * t);  // ch, ch + 1 (C4out even)
    float deq[2], bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      deq[e] = ch >= 0 ? __ldg(scales + ch + e) : 0.f;
      bias[e] = ch >= 0 ? __ldg(scales + C4o + ch + e) : 0.f;
    }
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      const int r = r0 + wm * S::MT + i;
      float v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool valid = r < H && c0 + g + 8 * h < W;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[2 * h + e] = q8::epilogue(acc[i][j][2 * h + e], deq[e], bias[e]);
          if constexpr (STATS) {
            if (valid) {
              s1[e] = __fadd_rn(s1[e], v[2 * h + e]);
              s2[e] = __fadd_rn(s2[e], __fmul_rn(v[2 * h + e],
                                                 v[2 * h + e]));
            }
          }
        }
      }
      sink(i, j, v);
    }
    if constexpr (STATS) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int x = 4; x <= 16; x *= 2) {
          s1[e] = __fadd_rn(s1[e], __shfl_xor_sync(0xffffffffu, s1[e], x));
          s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(0xffffffffu, s2[e], x));
        }
        if (g == 0) {
          red[wm * S::TCO + nt.ncol[j] + 2 * t + e] = s1[e];
          red[(S::WM + wm) * S::TCO + nt.ncol[j] + 2 * t + e] = s2[e];
        }
      }
    }
  }
  if constexpr (STATS) {
    __syncthreads();
    for (int cl = threadIdx.x; cl < S::TCO; cl += THREADS) {
      const int ch = L.chan(cl);
      if (ch < 0) continue;
      float a1 = 0.f, a2 = 0.f;
      for (int k = 0; k < S::WM; ++k) {
        a1 = __fadd_rn(a1, red[k * S::TCO + cl]);
        a2 = __fadd_rn(a2, red[(S::WM + k) * S::TCO + cl]);
      }
      p1[ch] = a1;
      p2[ch] = a2;
    }
  }
}

// Store one fragment's values (q8_epilogue's sink): lanes t and t ^ 1 swap
// halves so that the even lane holds 4 consecutive channels of pixel g and
// the odd lane of pixel g + 8, stored as one packed int8 word (requantized
// by row 2 of the scales) or four bf16.
template <bool WIDE, bool OUT_INT8>
__device__ __forceinline__ void q8_store(const Layer<WIDE>& L,
                                         const Tiles<WIDE>& nt,
                                         const float* scales, void* y,
                                         size_t n, int r, int c0, int H,
                                         int W, int lane, int j,
                                         const float (&v)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
  const float x1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
  const float q[4] = {odd ? x0 : v[0], odd ? x1 : v[1], odd ? v[2] : x0,
                      odd ? v[3] : x1};
  const int ch = L.chan(nt.ncol[j] + 2 * (t & ~1));  // 4 channels or none
  const int c = c0 + g + (odd ? 8 : 0);
  if (ch < 0 || r >= H || c >= W) return;
  const size_t off = (((size_t)n * H + r) * W + c) * L.C4out + ch;
  if constexpr (OUT_INT8) {
    uint32_t b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      b[e] = q8::requant(q[e], __ldg(scales + 2 * L.C4out + ch + e));
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y) + off) =
        q8::pack4(b);
  } else {
    q8::store_bf16x4(static_cast<__nv_bfloat16*>(y) + off, q);
  }
}

}  // namespace folded

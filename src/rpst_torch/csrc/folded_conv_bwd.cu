// B2 and B3 on Hopper: the backward pair of B1 (reflect-ring pad + 3x3
// folded conv + bias + activation).
//
// Replaces the TPU kernels in src/rpst/ops/pallas/folded_conv.py:
//   B2 `fused_folded_conv_grad_input`  (wrapper :339, body
//      `_make_bwd_input_kernel` :165)
//   B3 `fused_folded_conv_grad_weight` (wrapper :468, body
//      `_make_bwd_weight_kernel` :382)
// They run inside the autograd Functions of rpst_torch/ops/folded_conv.py,
// which form gz = where(y > 0, g, alpha * g) from the saved output first.
// Each has a second mode for a row shard of the image (row-sharded
// training, rpst's `folded_conv_act_halo` :604), whose two virtual rows
// above and below came from the neighbour shards (or the reflect ring at
// the image's edge) through B1's `rings`:
//   B2 `row_rings=False` (rpst :339, ring branch :312-331): the adjoint of
//      the ring ROWS is left out (the caller routes their gradient, from
//      ops/folded_conv.py `fused_folded_conv_ring_grads`, back to where
//      the rows came from); the ring columns' adjoint stays on every row;
//   B3 with given rings (rpst :468, ring rows read at :445-447): the ring
//      rows are read from `rings` (N, 2, W, 4C), row 0 above and row 1
//      below, their ring columns by the same channel-block rule, in place
//      of the rows it otherwise builds from x's reflect ring.
//
// B2 computes dx (N, H, W, 4C) from gz (N, H, W, 4Co) and the rotated,
// transposed kernel khat[r, c] = kf[2 - r, 2 - c]^T, (3, 3, 4Co, 4C):
//   * the interior: a SAME-zero 3x3 conv of gz with khat;
//   * the adjoint of the reflect ring columns, every row: the ring column
//     left of x receives G[:, -1] = the 1-column conv of gz column 0 with
//     khat[:, 2]; it came from column 1 for the sub-column-0 channel blocks
//     {0, 2} ((g / C) % 2 == 0) and from column 0 for {1, 3}, so it is
//     scattered back there; mirrored on the right (gz column W-1 with
//     khat[:, 0], onto columns W-1 and W-2);
//   * the adjoint of the reflect ring rows: G[-1, :] = the 1-row conv of gz
//     row 0 with khat[2, :], plus its own two corners (gz[0, 0] with
//     khat[2, 2] and gz[0, W-1] with khat[2, 0], scattered by the column
//     rule), goes to row 1 for the sub-row-0 blocks {0, 1} ((g / C) / 2 ==
//     0) and to row 0 for {2, 3}; mirrored at the bottom with gz row H-1
//     and khat[0, :].
// Each output value is owned by one thread, which adds every ring term that
// lands on it: dx is written once, with no atomics.
//
// B3 computes dk (3, 3, 4C, 4Co) and db (4Co,), both float, from x
// (N, H, W, 4C) and gz:
//   dk[dr, dc, i, o] = sum over n, r, c of xpad[n, r+dr, c+dc, i] gz[n, r, c, o]
//   db[o]            = sum over n, r, c of gz[n, r, c, o]
// where xpad is x with the reflect ring, read from x by B1's rules (ring
// rows by the channel half, ring columns by the channel-block parity).
//
// What bounds them on the card. Both do the MACs of B1: at 512px one
// 128->128 folded layer is 19.3 GFLOP for each of them with a dense folded
// kernel (4.83 GFLOP of it in the 36 blocks a fold of an image kernel
// lists), against 989 TFLOP/s of bf16 or 495 of TF32 on an H100 SXM at 700
// W (data sheet); x and gz are 67 MB in float32 (0.020 ms at 3.35 TB/s). So
// B3's listed blocks at 4C = 128 are bound by bytes, the rest by operations,
// as long as each value staged in shared memory is reused many times.
//
// What the designs do about it.
//   B2 runs on the tensor cores: B1's main loop (folded_mma.cuh) over the
//   zero-padded gz with khat, skipping khat's zero blocks as B1 skips kf's,
//   and the ring adjoint as four more mma row blocks of the same loop (the
//   ring rows above and below, the ring columns left and right, in the
//   tiles that touch them), added to the outputs they land on through
//   shared memory in the epilogue. dx is written once, with no atomics.
//   B3 runs on the tensor cores as a GEMM per tap, dk[tap] =
//   window_tap(xpad)^T gz, reduced over the N*H*W positions (K): both
//   operands are position-major, so A is staged transposed (as dK = P^T dO
//   in B6d) and both reach `mma` by `ldmatrix.trans` (bf16) or scalar
//   fragment loads (f32, three TF32 products). The wrapper passes a work
//   list (ops/folded_conv.py `b3_items`): per tap, the blocks to compute
//   form a dense sub-GEMM over a set of input blocks and a set of output
//   blocks (dense: all 4 x 4; a fold of an image kernel, on the caller's
//   word: 4 x 4 at the centre tap, 2 x 2 at an edge, 1 x 1 at a corner, the
//   36 blocks the fold's backward reads), cut into tiles of up to 8 warp
//   tiles of 32 x 32 sized to it, so that no tile is mostly unlisted; a
//   tile of fewer warp tiles splits each chunk's K steps among groups of
//   warps. A block owns one item and one segment of positions, and walks it
//   in chunks of 8 mma K steps (64 positions in float32, 128 in bf16)
//   through a two-stage `cp.async` ring; per chunk it first resolves each
//   position's source pixel per input block (ring rows and columns by
//   their channel rules), so that staging is a 16-byte copy per piece.
//   Accuracy: `mma` adds into its accumulator with truncation, so each
//   chunk is a fresh `mma` chain (at most 8 K steps, 24 products in
//   float32), added to a float32 register sum with an ordinary add.
//   Deterministic: each block writes its partial tile once, a second small
//   kernel sums the segments' partials in a fixed order (no float
//   atomicAdd), and the groups of warps of a split tile are added in a
//   fixed order through shared memory. db is summed in the same launch by
//   items of its own, whose blocks stage gz alone (summed by all threads of
//   a dk tile's blocks instead, bf16 B3 ran 1.37x slower: PERF.md). No
//   wgmma and no TMA yet.

#include "folded_mma.cuh"

namespace {

// B2: bf16 two blocks per SM, two cp.async stages, as B1; float32 one block
// per SM (the ring blocks' accumulators beside the split operands take ~190
// registers), three stages
template <typename T>
int launch_grad_input(const void* gz, const void* khat, void* wp, void* bits,
                      void* dx, int N, int H, int W, int C4o, int C4,
                      bool row_rings, void* stream) {
  folded::Args<T> a{};
  a.row_rings = row_rings ? 1 : 0;
  a.x = static_cast<const T*>(gz);
  a.y = static_cast<T*>(dx);
  a.H = H;
  a.W = W;
  a.C4in = C4o;
  a.C4out = C4;
  const T* kp = static_cast<const T*>(khat);
  T* wpp = static_cast<T*>(wp);
  unsigned* bp = static_cast<unsigned*>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value)
    return folded::launch<T, true, 1, 3>(a, kp, wpp, bp, N, s);
  else
    return folded::launch<T, true, 2, 2>(a, kp, wpp, bp, N, s);
}

// ---------------------------------------------------------------- B3

namespace b3 {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEPS = 8;      // mma K steps per chunk
constexpr int STAGES = 2;     // chunks in the cp.async ring
constexpr int FIELDS = 8;     // int32 per item (ops/folded_conv.py B3_FIELDS)
constexpr int TILE = 8192;    // floats of an item's partial tile (B3_TILE)
constexpr int MAX_TMN = 192;  // TM + TN of the widest item (4 x 2 warp tiles)

template <typename T>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int KSTEP = F32 ? 8 : 16;  // positions per mma K step
  static constexpr int KC = STEPS * KSTEP;    // positions per chunk (B3_CHUNK)
  static constexpr int PE = 16 / (int)sizeof(T);  // elements per 16 bytes
  // a stage: KC rows of x (TM + 8) and of gz (TN + 8); the 8 elements over
  // put the rows of an `ldmatrix` (bf16) or of a fragment load (f32, rows
  // t) on distinct banks. Two stages: 104 KB, two blocks per SM
  static constexpr int STAGE = KC * (MAX_TMN + 16);
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(T);
};

// Channel of gathered index v along an axis of blocks of cb channels each,
// `packed` = count | block j << (4 + 4 j) (ops/folded_conv.py _pack_blocks)
__device__ __forceinline__ int block_of(int packed, int j) {
  return (packed >> (4 + 4 * j)) & 15;
}
__device__ __forceinline__ int gathered_channel(int packed, int cb, int v) {
  const int j = v / cb;
  return block_of(packed, j) * cb + (v - j * cb);
}

// One block: item blockIdx.x of the work list, position segment
// blockIdx.y. Warp w computes warp tile w % (wtm wtn) of the item's tile
// (32 x 32: two m16 x four n8 fragments) over the chunk's K steps k with k
// % groups == w / (wtm wtn). A db item's block sums gz's columns instead.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    grad_weight_mma(const T* __restrict__ x, const T* __restrict__ rings,
                    const T* __restrict__ gz,
                    const int* __restrict__ items, float* __restrict__ dk,
                    float* __restrict__ db, float* __restrict__ dk_part,
                    float* __restrict__ db_part, int H, int W, int C4,
                    int C4o, long P, int seg_len) {
  using Cf = Cfg<T>;
  constexpr int KC = Cf::KC, PE = Cf::PE, KSTEP = Cf::KSTEP;
  extern __shared__ __align__(128) unsigned char smem[];
  // per chunk position and input block: the pixel (n H + row) W + col of x
  // the tap's window reads there (ring rows and columns resolved), or -2 -
  // (n 2 + ring row) W - col for a row of `rings`, -1 past the segment; one
  // buffer per stage
  __shared__ int s_src[STAGES][KC][4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int* it = items + (size_t)blockIdx.x * FIELDS;
  const int tap = it[0], m0 = it[1], n0 = it[2], wtm = it[3], wtn = it[4];
  const int inb = it[5], outb = it[6];
  // a db item stages gz alone and sums its columns; the others compute a
  // tile of dk
  const bool do_db = it[7] != 0;
  const int C = C4 / 4, Co = C4o / 4;
  const int Mg = (inb & 15) * C, Ng = (outb & 15) * Co;
  const int TM = 32 * wtm, TN = 32 * wtn;
  const int XS = TM + 8, GS = TN + 8;
  const int nwt = wtm * wtn, groups = WARPS / nwt;
  const int wt = warp % nwt, kpart = warp / nwt;
  const int wmi = wt % wtm, wni = wt / wtm;
  const int dr = tap / 3, dc = tap % 3;
  const long p_begin = (long)blockIdx.y * seg_len;
  const long p_end = p_begin + seg_len < P ? p_begin + seg_len : P;
  const T zero = folded::from_f32<T>(0.f);

  // the thread's 16-byte pieces: one column of pieces of x (gathered rows
  // xm .. xm + PE - 1) and of gz (columns gn ..), every xr-th / gr-th row
  const int xpr = TM / PE, gpr = TN / PE;  // powers of 2, <= 32
  const int xk0 = tid / xpr, xr = THREADS / xpr;
  const int gk0 = tid / gpr, gr = THREADS / gpr;
  const int xm = m0 + (tid % xpr) * PE, gn = n0 + (tid % gpr) * PE;
  // whole pieces by cp.async where a piece lies in one channel block and
  // rows are 16-byte aligned; element by element otherwise (C = 3)
  const bool x_fast = C % PE == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(rings) % 16 == 0;
  const bool g_fast =
      Co % PE == 0 && reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const int xblk = xm < Mg ? block_of(inb, xm / C) : 0;
  const int xch = xm < Mg ? gathered_channel(inb, C, xm) : 0;
  const int gch = gn < Ng ? gathered_channel(outb, Co, gn) : 0;

  auto stage_x = [&](int st) {
    return reinterpret_cast<T*>(smem) + st * Cf::STAGE;
  };
  // the first element of the pixel s_src names
  auto src_px = [&](int pix) {
    return pix >= 0 ? x + (size_t)pix * C4 : rings + (size_t)(-2 - pix) * C4;
  };

  auto fill_src = [&](long pb, int buf) {
    if (do_db) return;
    for (int e = tid; e < KC * 4; e += THREADS) {
      const int k = e >> 2, s = e & 3;
      const long p = pb + k;
      int pix = -1;
      if (p < p_end) {
        // 32-bit: the launch refuses N H W >= 2^31
        const int pi = (int)p, hw = H * W;
        const int n = pi / hw;
        const int rem = pi - n * hw;
        const int r = rem / W;
        int rg = r + dr - 1, cg = rem - r * W + dc - 1;
        // ring rows by the channel half (sub-row s / 2), or the given
        // rows; ring columns by the block parity (sub-column s % 2), as
        // ops/folded.py builds them
        const int ring = rg < 0 ? 0 : rg == H ? 1 : -1;
        if (cg < 0) cg = (s & 1) == 0 ? 1 : 0;
        else if (cg == W) cg = (s & 1) == 0 ? W - 1 : W - 2;
        if (ring >= 0 && rings != nullptr) {
          pix = -2 - ((n * 2 + ring) * W + cg);
        } else {
          if (rg < 0) rg = (s >> 1) == 0 ? 1 : 0;
          else if (rg == H) rg = (s >> 1) == 0 ? H - 1 : H - 2;
          pix = (n * H + rg) * W + cg;
        }
      }
      s_src[buf][k][s] = pix;
    }
  };

  auto load_stage = [&](long pb, int st) {
    T* xs = stage_x(st);
    T* gs = xs + KC * XS;
    for (int k = xk0; k < (do_db ? 0 : KC); k += xr) {
      T* dst = xs + k * XS + (xm - m0);
      if (x_fast) {
        const int pix = xm < Mg ? s_src[st][k][xblk] : -1;
        hmma::cp_async16(dst, pix != -1 ? src_px(pix) + xch : x,
                         pix != -1 ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < PE; ++q) {
          const int m = xm + q;
          T v = zero;
          if (m < Mg) {
            const int pix = s_src[st][k][block_of(inb, m / C)];
            if (pix != -1) v = src_px(pix)[gathered_channel(inb, C, m)];
          }
          dst[q] = v;
        }
      }
    }
    for (int k = gk0; k < KC; k += gr) {
      T* dst = gs + k * GS + (gn - n0);
      const long p = pb + k;
      if (g_fast) {
        const bool ok = gn < Ng && p < p_end;
        hmma::cp_async16(dst, ok ? gz + (size_t)p * C4o + gch : gz,
                         ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < PE; ++q) {
          const int n = gn + q;
          dst[q] = (n < Ng && p < p_end)
                       ? gz[(size_t)p * C4o + gathered_channel(outb, Co, n)]
                       : zero;
        }
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float dbs[4] = {0.f, 0.f, 0.f, 0.f};

  const int nchunks = (int)((p_end - p_begin + KC - 1) / KC);
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c)
    if (c < nchunks) fill_src(p_begin + (long)c * KC, c);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load_stage(p_begin + (long)c * KC, c);
    hmma::cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    const int st = ch % STAGES, nxt = ch + STAGES - 1;
    // the sources of chunk nxt: their buffer's last reader was the load of
    // chunk ch - 1, before an earlier barrier
    if (nxt < nchunks) fill_src(p_begin + (long)nxt * KC, nxt % STAGES);
    hmma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ch landed; every warp is past chunk ch - 1
    if (nxt < nchunks) load_stage(p_begin + (long)nxt * KC, nxt % STAGES);
    hmma::cp_async_commit();

    const T* xs = stage_x(st);
    const T* gs = xs + KC * XS;
    if (do_db) {
      // thread tid sums column tid % TN over rows tid / TN + r THREADS / TN
      // (r = 0, 1, ...), in four sums by r % 4 (KC is a multiple of 4
      // THREADS / TN)
      const int rs = THREADS / TN;
      for (int k = tid / TN; k < KC; k += 4 * rs)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dbs[u] += folded::to_f32(gs[(k + u * rs) * GS + tid % TN]);
      continue;
    }
    // a fresh mma chain per chunk (at most STEPS K steps), added to acc in
    // float32: `mma` truncates as it adds into its accumulator
    float sum[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[i][j][q] = 0.f;
    for (int ks = kpart; ks < STEPS; ks += groups) {
      const int k0 = ks * KSTEP;
      if constexpr (Cf::F32) {
        // A (m, k) = xs[k][m]: rows g, g + 8 at k = t, t + 4; B (k, n) =
        // gs[k][n]: column g at k = t, t + 4. Three TF32 products.
        const T* pa = xs + (k0 + t) * XS + 32 * wmi + g;
        const T* pg = gs + (k0 + t) * GS + 32 * wni + g;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          hmma::tf32::split(pa[16 * i], ah[i][0], al[i][0]);
          hmma::tf32::split(pa[16 * i + 8], ah[i][1], al[i][1]);
          hmma::tf32::split(pa[4 * XS + 16 * i], ah[i][2], al[i][2]);
          hmma::tf32::split(pa[4 * XS + 16 * i + 8], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          hmma::tf32::split(pg[8 * j], bh0, bl0);
          hmma::tf32::split(pg[4 * GS + 8 * j], bh1, bl1);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            hmma::tf32::mma3(sum[i][j], ah[i], al[i], bh0, bh1, bl0, bl1,
                             sum[i][j]);
        }
      } else {
        // both operands by ldmatrix.trans from their position-major rows:
        // A matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
        // (k 8-15, m 8-15); B (k 0-7, n 0-7), (k 8-15, n 0-7), then n 8-15
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hmma::ldmatrix_x4_trans(
              a[i], xs + (k0 + (lane & 7) + 8 * (lane >> 4)) * XS +
                        32 * wmi + 16 * i + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b[4];
          hmma::ldmatrix_x4_trans(
              b, gs + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * GS +
                     32 * wni + 16 * h + 8 * (lane >> 4));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            hmma::mma_bf16(sum[i][2 * h], a[i][0], a[i][1], a[i][2], a[i][3],
                           b[0], b[1]);
            hmma::mma_bf16(sum[i][2 * h + 1], a[i][0], a[i][1], a[i][2],
                           a[i][3], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += sum[i][j][q];
  }

  hmma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the last stage
  float* red = reinterpret_cast<float*>(smem);
  const bool direct = gridDim.y == 1;
  if (do_db) {
    // each column's THREADS / TN partial sums added in order; a db item's
    // gathered columns are the output channels
    red[tid] = (dbs[0] + dbs[1]) + (dbs[2] + dbs[3]);
    __syncthreads();
    if (tid < TN && n0 + tid < Ng) {
      float sum = red[tid];
      for (int r = 1; r < THREADS / TN; ++r) sum += red[r * TN + tid];
      (direct ? db : db_part + (size_t)blockIdx.y * C4o)[n0 + tid] = sum;
    }
    return;
  }

  // ---- the K groups of a split tile, added in order through shared memory
  if (groups > 1) {
    if (kpart > 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        red[(warp * 32 + e) * 32 + lane] = acc[e >> 4][(e >> 2) & 3][e & 3];
    }
    __syncthreads();
    if (kpart == 0) {
      for (int p = 1; p < groups; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[e >> 4][(e >> 2) & 3][e & 3] +=
              red[((p * nwt + wt) * 32 + e) * 32 + lane];
    }
  }

  // ---- the tile: to dk (one segment) or to the segment's partial
  if (kpart == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int lm = 32 * wmi + 16 * i + g + 8 * (q >> 1);
          const int ln = 32 * wni + 8 * j + 2 * t + (q & 1);
          if (direct) {
            const int m = m0 + lm, n = n0 + ln;
            if (m < Mg && n < Ng)
              dk[((size_t)tap * C4 + gathered_channel(inb, C, m)) * C4o +
                 gathered_channel(outb, Co, n)] = acc[i][j][q];
          } else {
            dk_part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE +
                    lm * TN + ln] = acc[i][j][q];
          }
        }
  }
}

// dk at every computed entry = sum over segments s = 0..S-1, in that order,
// of the items' partial tiles; db likewise. Entries of blocks no item
// computes keep the zeros the launch wrote.
__global__ void grad_weight_reduce(const float* __restrict__ dk_part,
                                   const float* __restrict__ db_part,
                                   const int* __restrict__ items,
                                   float* __restrict__ dk,
                                   float* __restrict__ db, int S, int n_items,
                                   int C4, int C4o) {
  const long K = (long)n_items * TILE;
  const int C = C4 / 4, Co = C4o / 4;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < K + C4o;
       e += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < K) {
      const int* it = items + (e / TILE) * FIELDS;
      const int local = (int)(e % TILE), TN = 32 * it[4];
      const int lm = local / TN, ln = local - lm * TN;
      const int m = it[1] + lm, n = it[2] + ln;
      if (it[7] || lm >= 32 * it[3] || m >= (it[5] & 15) * C ||
          n >= (it[6] & 15) * Co)
        continue;
      for (int t = 0; t < S; ++t) s += dk_part[(size_t)t * K + e];
      dk[((size_t)it[0] * C4 + gathered_channel(it[5], C, m)) * C4o +
         gathered_channel(it[6], Co, n)] = s;
    } else {
      const long o = e - K;
      for (int t = 0; t < S; ++t) s += db_part[(size_t)t * C4o + o];
      db[o] = s;
    }
  }
}

}  // namespace b3

template <typename T>
int launch_grad_weight(const void* x, const void* rings, const void* gz,
                       const void* items, void* dk, void* db, void* dk_part,
                       void* db_part, int n_items, int N, int H, int W,
                       int C4, int C4o, int seg_len, void* stream) {
  using Cf = b3::Cfg<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = (long)N * H * W;
  if (!folded::shape_ok(N, H, W, C4, C4o) || P >= (1L << 31) ||
      n_items < 1 || n_items > 65535 || seg_len < 1 || seg_len % Cf::KC ||
      2L * N * W >= (1L << 30))  // the ring rows' codes in s_src
    return static_cast<int>(cudaErrorInvalidValue);
  const long S = (P + seg_len - 1) / seg_len;
  if (S > 65535 || (S > 1 && (dk_part == nullptr || db_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = b3::grad_weight_mma<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cf::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_items, (unsigned)S), b3::THREADS, Cf::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(rings),
      static_cast<const T*>(gz), static_cast<const int*>(items),
      static_cast<float*>(dk),
      static_cast<float*>(db), static_cast<float*>(dk_part),
      static_cast<float*>(db_part), H, W, C4, C4o, P, seg_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  long blocks = ((long)n_items * b3::TILE + C4o + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  b3::grad_weight_reduce<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(db_part),
      static_cast<const int*>(items), static_cast<float*>(dk),
      static_cast<float*>(db), (int)S, n_items, C4, C4o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors; `stream` is a cudaStream_t. Each returns the cudaError_t of its
// launches.
//
// B2: gz (N, H, W, C4o) and dx (N, H, W, C4) of T; khat (3, 3, C4o, C4) of
// T; wp scratch of 9 * ceil(C4o / KE) * C4 * KE T (KE = 8 float or 16 bf16)
// and bits scratch of 9 uint32, filled by the launch with khat packed
// K-major and its non-zero block table. cudaErrorInvalidValue for a shape
// it refuses (H, W >= 2, channels multiples of 4). `_halo_` leaves out the
// ring rows' adjoint (row_rings=False).
extern "C" int rpst_folded_conv_grad_input_f32(const void* gz,
                                               const void* khat, void* wp,
                                               void* bits, void* dx, int N,
                                               int H, int W, int C4o, int C4,
                                               void* stream) {
  return launch_grad_input<float>(gz, khat, wp, bits, dx, N, H, W, C4o, C4,
                                  true, stream);
}

extern "C" int rpst_folded_conv_grad_input_bf16(const void* gz,
                                                const void* khat, void* wp,
                                                void* bits, void* dx, int N,
                                                int H, int W, int C4o,
                                                int C4, void* stream) {
  return launch_grad_input<__nv_bfloat16>(gz, khat, wp, bits, dx, N, H, W,
                                          C4o, C4, true, stream);
}

extern "C" int rpst_folded_conv_grad_input_halo_f32(
    const void* gz, const void* khat, void* wp, void* bits, void* dx, int N,
    int H, int W, int C4o, int C4, void* stream) {
  return launch_grad_input<float>(gz, khat, wp, bits, dx, N, H, W, C4o, C4,
                                  false, stream);
}

extern "C" int rpst_folded_conv_grad_input_halo_bf16(
    const void* gz, const void* khat, void* wp, void* bits, void* dx, int N,
    int H, int W, int C4o, int C4, void* stream) {
  return launch_grad_input<__nv_bfloat16>(gz, khat, wp, bits, dx, N, H, W,
                                          C4o, C4, false, stream);
}

// B3: x (N, H, W, C4) and gz (N, H, W, C4o) of T; items (n_items, 8)
// int32 on the device, the work list of ops/folded_conv.py `b3_items`
// (dense, or the listed blocks); dk (3, 3, C4, C4o) and db (C4o,) float.
// The N*H*W positions are cut into S = ceil(N*H*W / seg_len) segments
// (seg_len a multiple of the chunk: 64 float32, 128 bf16); for S > 1,
// dk_part (S, n_items * 8192) and db_part (S, C4o) are float scratch
// (unused, may be null, for S == 1). dk's blocks that no item lists are
// left as they are: the caller zeros them for the listed mode. `_rings_`
// takes the two virtual rows, rings (N, 2, W, C4) of T, in place of x's
// reflect ring.
extern "C" int rpst_folded_conv_grad_weight_f32(
    const void* x, const void* gz, const void* items, void* dk, void* db,
    void* dk_part, void* db_part, int n_items, int N, int H, int W, int C4,
    int C4o, int seg_len, void* stream) {
  return launch_grad_weight<float>(x, nullptr, gz, items, dk, db, dk_part,
                                   db_part, n_items, N, H, W, C4, C4o,
                                   seg_len, stream);
}

extern "C" int rpst_folded_conv_grad_weight_bf16(
    const void* x, const void* gz, const void* items, void* dk, void* db,
    void* dk_part, void* db_part, int n_items, int N, int H, int W, int C4,
    int C4o, int seg_len, void* stream) {
  return launch_grad_weight<__nv_bfloat16>(x, nullptr, gz, items, dk, db,
                                           dk_part, db_part, n_items, N, H,
                                           W, C4, C4o, seg_len, stream);
}

extern "C" int rpst_folded_conv_grad_weight_rings_f32(
    const void* x, const void* rings, const void* gz, const void* items,
    void* dk, void* db, void* dk_part, void* db_part, int n_items, int N,
    int H, int W, int C4, int C4o, int seg_len, void* stream) {
  return launch_grad_weight<float>(x, rings, gz, items, dk, db, dk_part,
                                   db_part, n_items, N, H, W, C4, C4o,
                                   seg_len, stream);
}

extern "C" int rpst_folded_conv_grad_weight_rings_bf16(
    const void* x, const void* rings, const void* gz, const void* items,
    void* dk, void* db, void* dk_part, void* db_part, int n_items, int N,
    int H, int W, int C4, int C4o, int seg_len, void* stream) {
  return launch_grad_weight<__nv_bfloat16>(x, rings, gz, items, dk, db,
                                           dk_part, db_part, n_items, N, H,
                                           W, C4, C4o, seg_len, stream);
}

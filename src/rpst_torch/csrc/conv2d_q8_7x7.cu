// B5's 7x7 form on Hopper: the int8 7x7 conv with three pixels of
// reflection of LD v1's big branch, on `wgmma` with its weights staged once
// for every 512 pixels, in a persistent grid of two-block clusters.
//
// It replaces no Pallas kernel: it computes what src/rpst/models/
// fast_path_q8.py `_xla_conv_q8` (:1415) asks of the TPU compiler's own int8
// conv. On the plain NHWC layout:
//
//   y   = act(float(conv7x7(reflect_pad3(x)) as int32) * deq + bias)
//   out = clip(round_half_even(y * inv), -127, 127) as int8, or bf16(y)
//   act(y) = y >= 0 ? y : alpha * y
//
// with x (N, H, W, C) int8 and scales (3, Co) float rows [deq = x_scale *
// w_scale, bias, inv = 1 / out_scale]. Row -3 = row 3 and row H + 2 = row
// H - 4 (the same for columns), so H, W >= 4. The int32 sum is exact while
// 49 * C * 127^2 < 2^31, that is for C <= 2048, and exact in any order, so
// every block's result is deterministic; the epilogue is q8_common.cuh's (two
// roundings, no FMA, half to even). int8 and bf16 outputs are bit-equal to
// ops/conv2d_q8.py `fused_conv2d_q8_plain`.
//
// Weights arrive repacked once per layer (ops/conv2d_q8.py
// `pack_conv2d_weights`, 7x7 branch) in the no-swizzle core-matrix order a
// `wgmma` shared-memory descriptor reads, K-major: (7, 7, ceil(C / 32),
// ceil(Co / 8), 2, 8, 16) int8, packed[dr, dc, s, q, h, r, b] = w[dr, dc, 32 s
// + 16 h + b, 8 q + r], zeros past C and Co. One (tap, 32-channel chunk) block
// of TCO output channels is then TCO x 32 contiguous bytes: per 8 channels
// two core matrices of 8 rows x 16 bytes, the K halves 128 bytes apart, the
// 8-channel groups 256.
//
// What bounds it on the card. LD v1's widest layer at a 512px pair, (2, 512,
// 512, 256 -> 256), is 3.4e12 int8 operations against 270 MB of tensors: 1.70
// ms at the int8 tensor-core peak, 0.08 ms of memory traffic. Bound by
// operations. The previous form (mma.sync on 128-pixel blocks, the 7x7
// instance of conv2d_q8.cu's kernel up to commit 56c9483) read 5.63 ms raw
// there on an H100 80GB HBM3 at 700 W because each block of 128 pixels x 128
// channels staged its share of the 3.2 MB weight tensor again: 15.7 GB a
// launch from L2 into shared memory, 82% of it weights, ~9 TB/s at the
// bound; and every warp loaded its own copy of the weight fragments through
// shared memory.
//
// What the design does about it (measured on an H100 80GB HBM3 at 700 W
// by tools/b5_compile_check.py --k7 --parent, the previous form in the same
// call: 3.34 ms raw at (2, 512, 512, 256 -> 256), 51% of the bound, 1.64x
// the previous form; 0.915 ms at 128 -> 128, 46.5%, 1.60x).
//   * `wgmma.mma_async.m64n128k32.s32.s8.s8`, both operands read from shared
//     memory through descriptors (no per-warp fragment loads). A is possible
//     from shared memory because an M block is an 8 x 8 pixel square: its 8
//     core matrices are 8 halo rows of 8 consecutive pixels, 16 bytes each,
//     at the uniform stride of one halo row, so tap (dr, dc) is the same
//     descriptor moved by (dr * HALO_W + dc) pixels. The halo is stored as two
//     planes, one per 16-byte K half, so a pixel's 16 bytes are one core
//     matrix row and the planes are the descriptor's K step (LBO).
//   * A block (CTA) works on 16 x 16 pixels and TCO = 128 output channels at
//     a time: two consumer warpgroups of two 8 x 8 squares each (2 x 64
//     int32 accumulators a thread) and a producer warpgroup, of which one
//     warp issues the copies; `setmaxnreg` hands the producer's registers to
//     the consumers (ptxas still fits them in 168 with 36 bytes of spills in
//     the int8 instance; without it, in a 288-thread block, the kernel read
//     3-5% slower in the same call). Two blocks along pixels form a cluster;
//     each copies half of every weight stage with `cp.async.bulk ...
//     .multicast::cluster` into both, so a staged weight byte serves 512
//     pixels (the previous form's: 128). One block a cluster (twice the
//     weight bytes, 7.1 GB) read 4-13% faster: the two blocks wait on each
//     other's releases; it is over the byte budget and not taken.
//   * The grid is persistent: at most one block a SM in whole clusters;
//     cluster c takes the work items c, c + clusters, ... (a pair of pixel
//     tiles, a channel block, an image). The producer walks all its items'
//     K chunks as one sequence, so a tile's first stages load while the
//     consumers write the previous tile out (5-10% faster than a block a
//     tile; 15% slower while ptxas injected waits into a flat loop over
//     chunks: see the consumer loop).
//   * A step is one kernel row (7 taps) of one 32-byte K chunk: the 7 taps'
//     weights (7 x 4 KB) in a ring of STAGES = 7 (4 read 8-9% slower: more
//     stages give slack to the two blocks that wait on each other),
//     filled by bulk copies that complete on an `mbarrier` (full), released
//     by both blocks' consumer warpgroups (empty: 4 arrivals, two of them
//     remote). The input halo ((16 + 6) x (16 + 6) pixels x 32 bytes) is
//     staged once per K chunk, in a ring of two, by the producer warp's 32
//     lanes with `cp.async` (zero-filled for padding and channels past C;
//     4-byte loads where rows are not 16-byte aligned, C = 36), tracked by
//     `cp.async.mbarrier.arrive`; the halo of chunk k + 1 is staged after
//     chunk k's last weight step is issued. A consumer waits, issues its 14
//     wgmma of the step, commits, and after `wgmma.wait_group 1` releases
//     the previous step (2 groups in flight read 5% slower).
//   * Bytes from L2 into shared memory, per launch at (2, 512, 512, 256 ->
//     256) (ops/conv2d_q8.py `b5_7x7_plan`, pinned by a CPU test): weights
//     2048 cluster items x 49 taps x 8 chunks x 128 x 32 bytes = 3.29 GB,
//     halos 4096 tiles x 8 chunks x 15,488 bytes = 0.51 GB (at most:
//     zero-filled pieces read nothing), 3.80 GB in all (the previous form:
//     15.7 GB). At 128 -> 128: 0.82 + 0.13 = 0.95 GB (3.9). The launch reads
//     ~1.1 TB/s from L2 (chip_smoke.py phase 44), below the 2.8-3.7 TB/s a
//     plain copy over an L2-resident buffer reaches on the same card
//     (tools/b5_compile_check.py --k7).
//   * The tile pick. One tiling: the register file caps a block at 256 x 128
//     int32 accumulators, TCO = 128 fits both LD v1 widths (128 and 256
//     channels) without padding, and the persistent grid leaves no wave
//     quantization beyond the last round of items. 231,824 bytes of shared
//     memory: one block a SM.
//   * Epilogue: a warp's accumulator rows are two pixel rows of its square;
//     per 8 channels a lane holds channels 2t, 2t + 1 of both (the mma.sync
//     m16n8 layout), and neighbouring lanes swap halves so each stores 4
//     consecutive channels of one pixel (one word int8, two bf16).
//   * A barrier wait that spins 2^26 polls (a lost arrival: far beyond any
//     copy's latency) traps, so a fault aborts the launch with an error
//     instead of hanging the card.

#include "mma_common.cuh"
#include "q8_common.cuh"

namespace {

constexpr int TH = 16, TW = 16;  // pixel tile of a block
constexpr int HALO_H = TH + 6, HALO_W = TW + 6;
constexpr int HALO_PIX = HALO_H * HALO_W;
constexpr int PLANE = HALO_PIX * 16;  // one 16-byte K half of every pixel
constexpr int HALO_BYTES = 2 * PLANE;
constexpr int TCO = 128;
constexpr int TAP_BYTES = TCO * 32;
constexpr int W_STAGE = 7 * TAP_BYTES;  // one kernel row of one K chunk
constexpr int STAGES = 7;
constexpr int HSTAGES = 2;
// wgmma groups a consumer leaves in flight when it releases a step's stage
constexpr int INFLIGHT = 1;
constexpr int CLUSTER = 2;    // blocks along pixels sharing each weight stage
constexpr int CONSUMERS = 2;  // warpgroups
// the consumer warpgroups and a producer warpgroup, of which one warp works;
// registers moved to the consumers (setmaxnreg): 128 x 56 + 256 x 216 <=
// 65,536
constexpr int THREADS = CONSUMERS * 128 + 128;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 216;
constexpr int H_OFF = STAGES * W_STAGE;
constexpr int BAR_OFF = H_OFF + HSTAGES * HALO_BYTES;
// barriers: full[STAGES], empty[STAGES], hfull[HSTAGES], hempty[HSTAGES]
constexpr int SMEM_BYTES = BAR_OFF + 8 * 2 * (STAGES + HSTAGES);
// descriptor strides: B (a tap's weights) K halves 128 bytes apart, 8-row
// channel groups 256; A (the halo) K halves a plane apart, pixel rows a halo
// row apart
constexpr uint32_t B_LBO = 128, B_SBO = 256;
constexpr uint32_t A_LBO = PLANE, A_SBO = HALO_W * 16;
constexpr long long SPIN_LIMIT = 1LL << 26;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spin until the phase of `parity` has completed; CLUSTER_SCOPE acquires
// what other blocks of the cluster released
template <bool CLUSTER_SCOPE = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    if constexpr (CLUSTER_SCOPE)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if (spins == SPIN_LIMIT) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at the same offset in cluster block `rank`
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 r;\n mapa.shared::cluster.u32 r, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];\n}\n" ::
          "r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// the barrier's arrival of this thread fires when its earlier cp.async
// copies have landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// `bytes` from global memory to offset `dst` of every block in `mask`,
// completing on the barrier at offset `bar` of each
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// generic-proxy writes (cp.async, st.shared) -> async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// a shared-memory matrix descriptor, no swizzle: start, leading (K) and
// stride (M / N) byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of d across a fence or wait
__device__ __forceinline__ void pin(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B: A 64 x 32 int8 (descriptor a), B 128 x 32 int8 K-major
// (descriptor b), d the thread's 64 int32 of the 64 x 128 sum
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// source row / column of padded index i in [-3, n + 3): reflection; -1 (a
// zero) past it (a block beyond the image)
__device__ __forceinline__ int pad_src(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (i < 0 && i >= -3) return -i;
  if (i >= n && i < n + 3) return 2 * n - 2 - i;
  return -1;
}

// Where the work item `item` of a cluster puts block `rank`: its pixel
// tile's first row and column, its first output channel, its image. Items
// run over (pairs of pixel tiles, channel blocks, images); a tile past the
// image's last (an odd count) lies below it and computes zeros.
struct Tile {
  int r0, c0, co0;
  size_t n;
};
__device__ __forceinline__ Tile tile_at(int item, int pairs, int co_blocks,
                                        int tiles_w, uint32_t rank) {
  const int rest = item / pairs;
  const int tile = (item % pairs) * CLUSTER + rank;
  return {(tile / tiles_w) * TH, (tile % tiles_w) * TW,
          (rest % co_blocks) * TCO, static_cast<size_t>(rest / co_blocks)};
}

// x (N, H, W, C) int8, wp the packed weights, rows the (3, Co) scales. A
// persistent grid of clusters (at most one block a SM): cluster c takes the
// work items c, c + clusters, ... (`tile_at`); the producer walks their K
// chunks as one sequence, so a tile's first stages load while the
// consumers write the previous tile out.
template <bool OUT_INT8>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    conv7x7_wgmma_kernel(const unsigned char* __restrict__ x,
                         const unsigned char* __restrict__ wp,
                         const float* __restrict__ rows, void* y, int H,
                         int W, int C, int Co, int tiles_w, int pairs,
                         int items, float alpha) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BAR_OFF, empty = full + 8 * STAGES;
  const uint32_t hfull = empty + 8 * STAGES, hempty = hfull + 8 * HSTAGES;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  const int co_blocks = (Co + TCO - 1) / TCO;
  const int ksteps = (C + 31) / 32;
  const int co8 = (Co + 7) / 8 * 8;
  // this cluster's K chunks, all its items' in a row
  const int mine = items > cluster ? (items - cluster - 1) / clusters + 1 : 0;
  const int chunks = mine * ksteps;
  auto tile_of = [&](int g) {  // the tile of this block's chunk g
    return tile_at(cluster + (g / ksteps) * clusters, pairs, co_blocks,
                   tiles_w, rank);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * CLUSTER);
    }
    for (int h = 0; h < HSTAGES; ++h) {
      mbar_init(hfull + 8 * h, 32);
      mbar_init(hempty + 8 * h, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (warp >= CONSUMERS * 4) {
    // ---- producer warpgroup: its first warp stages, the others idle
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4) {
      const bool x16 = C % 16 == 0;  // cp.async needs 16-byte aligned sources
      // chunk g's halo into ring slot g % HSTAGES
      auto stage_halo = [&](int g) {
        const Tile t = tile_of(g);
        const int kc = g % ksteps, hs = g % HSTAGES;
        const unsigned char* xn = x + t.n * H * W * C;
        mbar_wait(hempty + 8 * hs, ((g / HSTAGES) & 1) ^ 1);
        fence_proxy_async();  // the consumers' wgmma reads before the writes
        unsigned char* hb = smem + H_OFF + hs * HALO_BYTES;
        for (int idx = lane; idx < 2 * HALO_PIX; idx += 32) {
          const int pix = idx >> 1, half = idx & 1;
          const int sr = pad_src(t.r0 - 3 + pix / HALO_W, H);
          const int sc = pad_src(t.c0 - 3 + pix % HALO_W, W);
          const int b0 = kc * 32 + half * 16;  // first byte of the piece
          unsigned char* dst = hb + half * PLANE + pix * 16;
          const bool in = sr >= 0 && sc >= 0;
          const unsigned char* src =
              in ? xn + ((size_t)sr * W + sc) * C + b0 : x;
          if (x16) {
            const bool ok = in && b0 < C;
            hmma::cp_async16(dst, src, ok ? 16 : 0);
          } else {  // C % 4 == 0: word by word, zeros past the row's end
            int32_t v[4] = {0, 0, 0, 0};
            if (in) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (b0 + 4 * j < C)
                  v[j] = *reinterpret_cast<const int32_t*>(src + 4 * j);
            }
            *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
          }
        }
        if (x16)
          cp_async_arrive(hfull + 8 * hs);
        else
          mbar_arrive(hfull + 8 * hs);
      };
      if (chunks > 0) stage_halo(0);
      for (int g = 0, step = 0; g < chunks; ++g) {
        const int kc = g % ksteps;
        const int co0 = tile_of(g).co0;
        // bytes of a tap's block this channel block holds
        const int valid = min(TCO, co8 - co0) * 32;
        for (int dr = 0; dr < 7; ++dr, ++step) {
          const int s = step % STAGES;
          if (lane == 0) {
            mbar_wait<true>(empty + 8 * s, ((step / STAGES) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, 7 * valid);
            // this block's half of each tap's channel rows, to both blocks
            const int lo = rank * (TAP_BYTES / CLUSTER);
            const int hi = min(valid, lo + TAP_BYTES / CLUSTER);
            if (hi > lo)
              for (int dc = 0; dc < 7; ++dc)
                bulk_multicast(
                    base + s * W_STAGE + dc * TAP_BYTES + lo,
                    wp + ((size_t)((dr * 7 + dc) * ksteps + kc) * co8 + co0) *
                                 32 + lo,
                    hi - lo, full + 8 * s, (1u << CLUSTER) - 1);
          }
          __syncwarp();
        }
        if (g + 1 < chunks) stage_halo(g + 1);
      }
    }
    // no block leaves while the other may still copy into its shared
    // memory or arrive on its barriers
    __syncwarp();
    cluster_sync();
  } else {
    // ---- consumer warpgroups: wg owns pixel rows 8 wg .. 8 wg + 7 of the
    // tile, two 8 x 8 squares (columns 0-7 and 8-15)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4;
    int32_t acc[2][64];
    for (int it = 0, g = 0, step = 0; it < mine; ++it) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[q][i] = 0;
      // the tile's loop nests inside the item's: every path from a wgmma
      // to the accumulators' next use passes the wait below, so ptxas
      // injects no waits of its own (it did into a flat loop over chunks)
      for (int kc = 0; kc < ksteps; ++kc, ++g) {
        const int hs = g % HSTAGES;
        mbar_wait(hfull + 8 * hs, (g / HSTAGES) & 1);
        fence_proxy_async();  // the producer's halo writes before wgmma
        const uint32_t hb = base + H_OFF + hs * HALO_BYTES;
        for (int dr = 0; dr < 7; ++dr, ++step) {
          const int s = step % STAGES;
          mbar_wait(full + 8 * s, (step / STAGES) & 1);
          pin(acc[0]);
          pin(acc[1]);
          wgmma_fence();
#pragma unroll
          for (int dc = 0; dc < 7; ++dc) {
            const uint64_t b =
                desc(base + s * W_STAGE + dc * TAP_BYTES, B_LBO, B_SBO);
#pragma unroll
            for (int q = 0; q < 2; ++q)
              wgmma_s8(acc[q],
                       desc(hb + ((8 * wg + dr) * HALO_W + 8 * q + dc) * 16,
                            A_LBO, A_SBO),
                       b);
          }
          wgmma_commit();
          // step - INFLIGHT's wgmma have read their stage
          wgmma_wait<INFLIGHT>();
          pin(acc[0]);
          pin(acc[1]);
          if (tid % 128 == 0) {
            if (step >= INFLIGHT) {
              const uint32_t prev = empty + 8 * ((step - INFLIGHT) % STAGES);
              for (uint32_t r = 0; r < CLUSTER; ++r) mbar_arrive_at(prev, r);
            }
            if (dr == INFLIGHT - 1 && g > 0)  // chunk g - 1's last step
              mbar_arrive(hempty + 8 * ((g - 1) % HSTAGES));
          }
        }
      }
      wgmma_wait<0>();
      pin(acc[0]);
      pin(acc[1]);

      // ---- the tile's epilogue. Warp w of the warpgroup holds accumulator
      // rows 16 w .. 16 w + 15 of each square: pixel row 2 w (columns g) in
      // elements 0, 1 and row 2 w + 1 in 2, 3 of each 8-channel group j;
      // lanes t and t ^ 1 swap so the even lane holds 4 consecutive
      // channels of row 2 w and the odd lane of row 2 w + 1.
      const Tile t4 = tile_of(g - 1);
      const int w4 = warp % 4, gq = lane >> 2, t = lane & 3;
      const bool odd = t & 1;
      const int r = t4.r0 + 8 * wg + 2 * w4 + (odd ? 1 : 0);
#pragma unroll
      for (int j = 0; j < TCO / 8; ++j) {
        const int go = t4.co0 + j * 8 + 2 * (t & ~1);
        const bool okc = go < Co;  // Co % 4 == 0: all 4 channels or none
        float deq[4], bias[4], inv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          deq[e] = okc ? __ldg(rows + go + e) : 0.f;
          bias[e] = okc ? __ldg(rows + Co + go + e) : 0.f;
          inv[e] = (okc && OUT_INT8) ? __ldg(rows + 2 * Co + go + e) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int32_t* a = acc[q] + 4 * j;
          const int32_t g0 =
              __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
          const int32_t g1 =
              __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
          const int32_t v4[4] = {odd ? g0 : a[0], odd ? g1 : a[1],
                                 odd ? a[2] : g0, odd ? a[3] : g1};
          float v[4];
          uint32_t b[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = q8::epilogue_alpha(v4[e], deq[e], bias[e], alpha);
            if constexpr (OUT_INT8) b[e] = q8::requant(v[e], inv[e]);
          }
          const int c = t4.c0 + 8 * q + gq;
          if (r < H && c < W && okc) {
            const size_t off = ((t4.n * H + r) * W + c) * Co + go;
            if constexpr (OUT_INT8)
              *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y) + off) =
                  q8::pack4(b);
            else
              q8::store_bf16x4(static_cast<__nv_bfloat16*>(y) + off, v);
          }
        }
      }
    }
    cluster_sync();
  }
}

template <bool OUT_INT8>
int launch(const void* x, const void* wp, const float* rows, void* y, int N,
           int H, int W, int C, int Co, float alpha, cudaStream_t s) {
  auto kernel = conv7x7_wgmma_kernel<OUT_INT8>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;  // of the current device, asked at every launch
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int tiles_w = (W + TW - 1) / TW;
  const int pairs = (tiles_w * ((H + TH - 1) / TH) + CLUSTER - 1) / CLUSTER;
  const long long items = (long long)pairs * ((Co + TCO - 1) / TCO) * N;
  if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int clusters =
      static_cast<int>(items < sms / CLUSTER ? items : sms / CLUSTER);
  kernel<<<clusters * CLUSTER, THREADS, SMEM_BYTES, s>>>(
      static_cast<const unsigned char*>(x),
      static_cast<const unsigned char*>(wp), rows, y, H, W, C, Co, tiles_w,
      pairs, static_cast<int>(items), alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous,
// 16-byte aligned tensors: x (N, H, W, C) int8; wp the packed weights (7, 7,
// ceil(C / 32), ceil(Co / 8), 2, 8, 16) int8; scales (3, Co) float; y (N, H,
// W, Co) int8 (out_int8) or bf16. Needs C % 4 == 0, Co % 4 == 0, C <= 2048
// (the exact int32 sum), H, W >= 4. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape it refuses).
extern "C" int rpst_conv2d_q8_7x7(const void* x, const void* wp,
                                  const void* scales, void* y, int N, int H,
                                  int W, int C, int Co, int out_int8,
                                  float alpha, void* stream) {
  if (N < 1 || N > 65535 || H < 4 || W < 4 || C < 4 || Co < 4 || C % 4 ||
      Co % 4 || C > 2048 || (Co + TCO - 1) / TCO > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  if (out_int8) return launch<true>(x, wp, sp, y, N, H, W, C, Co, alpha, s);
  return launch<false>(x, wp, sp, y, N, H, W, C, Co, alpha, s);
}

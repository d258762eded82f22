// B6 on Hopper: blockwise softmax attention for SANet, forward (B6a), forward
// with the per-row log-sum-exp (B6b), and the two backward kernels dQ (B6c)
// and dK/dV (B6d).
//
// Replaces the four TPU kernels of src/rpst/ops/pallas/flash_attention.py:
// `_flash_fwd_2d` (:260, body `_fwd_kernel` :36), `_flash_fwd_lse_2d` (:109,
// body `_fwd_kernel_lse` :72) and the two calls of `_flash_bwd_2d` (:208,
// bodies `_bwd_dq_kernel` :143 and `_bwd_dkv_kernel` :173). Per image, with
// Q (Nq, C), K and V (Nk, C), no 1/sqrt(C) and no mask:
//
//   S = Q K^T (float)            O   = softmax(S) V
//   P = exp(S - LSE)             LSE = rowmax(S) + log(rowsum(exp(S - rowmax)))
//   dV = P^T dO                  dS  = P * (dO V^T - Delta), Delta = rowsum(dO * O)
//   dQ = dS K                    dK  = dS^T Q
//
// Scores, the softmax state and every sum are float; P (forward, dV) and dS
// (dQ, dK) are rounded to the tensors' type before their second product, as
// the TPU kernels cast them, so the bfloat16 entry points round where rpst
// rounds. The (Nq, Nk) matrices never exist in device memory. LSE and Delta
// are (N, Nq) float: the TPU's 128-lane replicated layout is not carried
// over. The batch is a grid dimension (rpst vmaps a per-image kernel), so a
// call is one launch whatever N.
//
// What bounds it on the card. The relu4_1 module of a 512px stylize, Nq = Nk
// = 4096 at C = 512, is 3.4e10 operations forward, against 25 MB of tensors:
// bound by operations by three orders of magnitude. Both forward entry points
// run their two products on the tensor cores. A float32 product must stay as
// accurate as float32 (the logits are unscaled; one TF32 product moves O by
// 5e-4 of its size), so the float32 forward runs three TF32 products per
// fragment (below): its ceiling is a third of the 495 TFLOP/s TF32 rate the
// bound is stated against, still 2.5x the 67 TFLOP/s of float FMAs on the
// CUDA cores, which the backward kernels use. In both forwards the limit is
// feeding `mma` from shared memory, and in float32 also the instructions that
// split each operand.
//
// The bfloat16 forward (B6a, B6b: `flash_fwd_mma_kernel`).
//   * bf16 x bf16 products are exact in float and summed in float
//     (`mma.sync.m16n8k16`, bf16 -> f32), so its scores are float sums of
//     exact products; P is rounded to bf16 before the second product, where
//     rpst rounds it, and the row sum is taken from the unrounded p.
//     `mma.sync` and not `wgmma`: wgmma's 64-row tile would leave 64 blocks
//     for the 132 SMs at Nq = 4096, batch 1.
//   * One block of 256 threads owns QM = 32 query rows, resident in shared
//     memory, and sweeps the keys in tiles of KN = 64. The 8 warps are 2 row
//     groups of 16 rows x 4: in the score product warp w takes the tile's
//     keys 16w .. 16w + 15 over all of C; in the second product it takes the
//     channels [wC/4, (w + 1)C/4) over all 64 keys, so the (32, C) float
//     accumulator is 64 registers a thread at C = 512.
//   * The running max and sum of a row are combined across its 4 warps
//     through 1 KB of shared memory in a fixed order (bit-stable runs). P
//     goes once through a 5 KB bf16 tile, written in the order the `mma` A
//     fragment reads it (one 8-byte store and load per lane).
//   * K and V tiles (64 x C bf16, 64 KB at C = 512) arrive by `cp.async` in a
//     ring of two buffers over the sequence K0, V0, K1, V1, ...: V_j loads
//     under the score product of tile j, K_j+1 under its second product.
//     Rows are padded so fragment loads hit every bank once: Q and K rows by
//     32 bytes (lane t of a quad reads bytes [8t, 8t + 8) of a 32-byte k-step
//     for both k-halves, the order of K inside a step being free), V rows by
//     16 (read through `ldmatrix.trans`, which makes the transposed operand
//     of P V free).
//   * Ragged shapes: rows past Nq or Nk are staged as zeros (cp.async
//     zero-fill), keys past Nk scored -inf, rows past Nq never stored.
//
// The float32 forward (B6a, B6b: `flash_fwd_tf32_kernel`).
//   * Three TF32 products per fragment (`mma.sync.m16n8k8` tf32 -> f32, as
//     CUTLASS's OpMultiplyAddFastF32): each float32 operand x is loaded from
//     shared memory once and split in registers into hi = x rounded to TF32
//     (to nearest) and lo = x - hi (exact), which `mma` truncates to TF32; a
//     b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the two corrections summed
//     first, a_lo b_lo (< 2^-22 of a b) dropped. Used for S = Q K^T and for
//     P V; P is not rounded in float32, so it is split like any operand. A
//     split is 3 instructions (`split`), the kernel's largest cost after the
//     products: one TF32 product would be 3x fewer `mma` and no split, but
//     moves O by 5e-4 of its size.
//   * The sums inside `mma` are not IEEE round-to-nearest on every
//     generation, so no `mma` chain is long: a score is summed over 16
//     channels (6 products) in `mma`, and those partial sums are added in
//     float32; a tile's P V (12 products) goes into a fresh accumulator and
//     then into the running one as acc * alpha + tile, one float32 FMA.
//   * Shared memory decides the tiling: a float32 row is 2 KB at C = 512, so
//     a block owns QM = 32 query rows (64 KB, resident) and sweeps the keys
//     in tiles of KN = 32; the K and V tiles (64 KB each) alternate through
//     a two-buffer `cp.async` ring (V_j under the scores of tile j, K_j+1
//     under its P V), 224 KB in all, one block per SM.
//   * Warps are laid out so that a split operand feeds several products.
//     Scores: warp (rg, wq) of 2 row groups x 4 forms the partial scores of
//     its 16 rows x all 32 keys over a quarter of C (an A fragment feeds 4 n
//     blocks); the four partial tiles go through 20 KB of shared memory and
//     are added in a fixed order. P V: warp w owns the 32-channel groups w
//     and w + 8 of all 32 rows (a V fragment feeds 2 m blocks): 64
//     accumulator registers, and 64 for the tile's.
//   * Fragments are read without bank conflicts by 16-byte loads. Q and K
//     rows are padded to C + 16 floats and lane t of a quad reads channels
//     4t .. 4t + 3 of a 16-channel step: 4t and 4t + 1 are its k = t and t + 4
//     of the first m16n8k8, 4t + 2 and 4t + 3 of the second (the order of k
//     inside a step is free as long as A and B agree). V rows are padded to
//     C + 8 floats, and the 4 n blocks of a group take interleaved channels
//     (column j of block r is channel 4j + r of the group's 32), so lane g
//     reads its B values of all four with one 16-byte load per key; the
//     output store undoes the interleave. P goes through a 4.5 KB float tile.
//   * Row max and sum cross the 4 warps of a row group through 1 KB of shared
//     memory in a fixed order; the sum is taken from the unrounded p; the
//     running max and sum, 1/l and LSE = m + log(l) stay float32 in
//     registers, kept by every warp for all 32 rows. Runs are bit-stable.
//   * Ragged shapes: rows past Nq or Nk are staged as zeros (cp.async
//     zero-fill), keys past Nk scored -inf, rows past Nq never stored.
//
// The two backward kernels (both types).
//   * One block of 256 threads owns BM = 32 rows (of Q; of K in the dK/dV
//     kernel) and sweeps the other operand in tiles of BN = 128 rows; the
//     sequential grid axis of the TPU kernel is the loop inside the block.
//   * C = 512 is the hard part: a (32, 512) float accumulator is 64 KB. It
//     lives in registers, 64 a thread: warp w owns rows 4w..4w+3 and lane l
//     the channels 4l..4l+3 of each 128-channel group.
//   * The score tile (32 x 128) is a register-blocked product, 4 x 4 a thread
//     (rows 4w+i, columns l + 32j), with C walked in chunks of KC = 32 staged
//     in shared memory.
//   * P (or dS) goes through a 16 KB shared tile into the second product,
//     whose other operand is staged JV = 16 rows (32 KB) at a time.
//   * The dK/dV kernel never uses atomics: a block owns its K rows and sweeps
//     all Q tiles, so its sums have a fixed order. Two (32, 512) accumulators
//     do not fit the registers, so the grid's y axis picks dV or dK and each
//     half recomputes its score tile (10 products of a tile where a fused
//     kernel would do 8).
//   * Ragged shapes: rows past Nq or Nk are staged as zeros, scored -inf (so
//     their P is 0) and never stored. C must be a multiple of 128, at most
//     512 (SANet's width).
// Occupancy at batch 1 (every kernel owns 32 rows a block): Nq = 4096 gives
// 128 blocks for 132 SMs, Nq = 1024 gives 32; K is not split across blocks
// (that needs a second pass). The backward kernels still run float FMAs on
// converted values: tensor cores for them are later work held to this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 32;             // rows a block owns
constexpr int BN = 128;            // rows of the swept operand per tile
constexpr int KC = 32;             // channels per staged chunk of a score tile
constexpr int KCP = KC + 4;        // padded row: float4 reads hit 8 bank groups
constexpr int JV = 16;             // swept rows per chunk of the second product
constexpr int CMAX = 512;          // widest C (4 groups of 128 channels)
constexpr int THREADS = 256;
// The backward kernels are built for 1 and for 2 blocks per SM (MINB: 255
// or 128 registers a thread) and a launch picks by its block count
// (one_block_per_sm). -DB6_MIN_BLOCKS=1|2 forces one build for every launch
// (tools/b6_compile_check.py --min-blocks), to compare the two.
#ifndef B6_MIN_BLOCKS
#define B6_MIN_BLOCKS 0
#endif
constexpr int RW = BM / (THREADS / 32);   // 4 rows per warp
constexpr int CJ = BN / 32;               // 4 score columns per lane
constexpr int NCC = CMAX / 128;           // 4 channel groups per lane
// staging (the larger of the two phases) + the P / dS tile
constexpr int STAGE_FLOATS =
    (JV * CMAX > (BM + BN) * KCP) ? JV * CMAX : (BM + BN) * KCP;
constexpr int SMEM_BYTES = (STAGE_FLOATS + BM * BN) * (int)sizeof(float);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
// x rounded to the tensors' type, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Stage rows [r0, r0 + rows) x channels [c0, c0 + KC) of a (n_rows, C) matrix
// into dst[rows][KCP] as floats; rows past n_rows become zeros.
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ src, int r0,
                                            int n_rows, int rows, int C,
                                            int c0, float* dst, int tid) {
  for (int t = tid; t < rows * (KC / 4); t += THREADS) {
    const int row = t / (KC / 4);
    const int c4 = t % (KC / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < n_rows)
      v = load4(src + (size_t)(r0 + row) * C + c0 + 4 * c4);
    store4(dst + row * KCP + 4 * c4, v);
  }
}

// s[i][j] = sum_c A[a0 + 4w + i][c] * B[b0 + lane + 32j][c]: the (BM, BN)
// score tile, 4 x 4 a thread. Ends with every thread past the last read of
// the staging buffer.
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ A, int a0,
                                           int na, const T* __restrict__ B,
                                           int b0, int nb, int C, float* stage,
                                           float (&s)[RW][CJ], int tid) {
  float* As = stage;
  float* Bs = stage + BM * KCP;
  const int w = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += KC) {
    stage_chunk(A, a0, na, BM, C, c0, As, tid);
    stage_chunk(B, b0, nb, BN, C, c0, Bs, tid);
    __syncthreads();
#pragma unroll
    for (int c4 = 0; c4 < KC / 4; ++c4) {
      float4 a[RW], b[CJ];
#pragma unroll
      for (int i = 0; i < RW; ++i) a[i] = load4(As + (RW * w + i) * KCP + 4 * c4);
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = load4(Bs + (lane + 32 * j) * KCP + 4 * c4);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
    __syncthreads();
  }
}

// acc[i][g][e] += sum_j P[4w + i][j] * V[b0 + j][128g + 4 lane + e] over the
// tile's BN rows (those below nb): the second product, V staged JV rows at a
// time. P is the block's shared (BM, BN) tile; a warp reads only the rows it
// wrote. Ends with every thread past the last read of the staging buffer.
template <typename T>
__device__ __forceinline__ void accumulate_tile(const float* P,
                                                const T* __restrict__ V,
                                                int b0, int nb, int C,
                                                float* stage,
                                                float (&acc)[RW][NCC][4],
                                                int tid) {
  const int w = tid >> 5, lane = tid & 31;
  const int c4n = C / 4;
  for (int j0 = 0; j0 < BN && b0 + j0 < nb; j0 += JV) {
    for (int t = tid; t < JV * c4n; t += THREADS) {
      const int row = t / c4n;
      const int c4 = t % c4n;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b0 + j0 + row < nb)
        v = load4(V + (size_t)(b0 + j0 + row) * C + 4 * c4);
      store4(stage + row * C + 4 * c4, v);
    }
    __syncthreads();
#pragma unroll
    for (int j4 = 0; j4 < JV; j4 += 4) {
      float4 p[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) p[i] = load4(P + (RW * w + i) * BN + j0 + j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < NCC; ++g) {
          if (128 * g < C) {
            const float4 v = load4(stage + (j4 + e) * C + 128 * g + 4 * lane);
#pragma unroll
            for (int i = 0; i < RW; ++i) {
              const float pv = comp(p[i], e);
              acc[i][g][0] = fmaf(pv, v.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(pv, v.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(pv, v.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(pv, v.w, acc[i][g][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[RW][NCC][4]) {
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int g = 0; g < NCC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
}

// Rows r0 + 4w + i (below n_rows) of a (n_rows, C) matrix <- acc * scale[i].
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int r0,
                                           int n_rows, int C,
                                           const float (&acc)[RW][NCC][4],
                                           const float (&scale)[RW], int tid) {
  const int w = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = r0 + RW * w + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < NCC; ++g)
      if (128 * g < C)
        store4(dst + (size_t)r * C + 128 * g + 4 * lane,
               make_float4(acc[i][g][0] * scale[i], acc[i][g][1] * scale[i],
                           acc[i][g][2] * scale[i], acc[i][g][3] * scale[i]));
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 forward on the tensor cores.

namespace tc {

constexpr int QM = 32;           // query rows a block owns
constexpr int KN = 64;           // keys per tile
constexpr int PS = KN * 2 + 32;  // bytes of a P row (padded)
constexpr int RED_FLOATS = 2 * (QM / 16) * 4 * 16;  // max and sum partials

// bytes of a Q or K row (padded by 32) and of a V row (padded by 16)
__host__ __device__ constexpr int qk_stride(int C) { return 2 * C + 32; }
__host__ __device__ constexpr int v_stride(int C) { return 2 * C + 16; }
__host__ __device__ constexpr int smem_bytes(int C) {
  return (QM + 2 * KN) * qk_stride(C) + QM * PS + RED_FLOATS * 4;
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// c += a b on one 16 x 8 block, bf16 operands, float sum. a0/a1: rows g and
// g + 8, k = 2t, 2t + 1; a2/a3: the same rows, k = 2t + 8, 2t + 9; b0/b1:
// column g, the same two k pairs.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lane l names row l % 8 of matrix
// l / 8; register i holds, of matrix i, elements [2t][g] and [2t + 1][g].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + rows) of a (n_rows, CB bytes) matrix -> dst rows of
// `stride` bytes; rows past n_rows become zeros. A warp takes whole rows.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int stride,
                                           const unsigned char* src, int r0,
                                           int rows, int n_rows, int CB,
                                           int warp, int lane) {
  for (int row = warp; row < rows; row += THREADS / 32) {
    const bool ok = r0 + row < n_rows;
    const unsigned char* s = src + (size_t)(r0 + row) * CB;
    for (int pc = lane; pc < CB / 16; pc += 32)
      cp_async16(dst + row * stride + pc * 16, ok ? s + pc * 16 : src,
                 ok ? 16 : 0);
  }
}

}  // namespace tc

// B6a (WITH_LSE false) and B6b (true), bfloat16. grid (ceil(Nq / 32), N).
template <bool WITH_LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int Nq, int Nk, int C) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char sm[];
  const int CB = 2 * C, QS = qk_stride(C), VS = v_stride(C);
  unsigned char* qs = sm;
  unsigned char* kbuf = qs + QM * QS;   // ring buffer 0: the K tiles
  unsigned char* vbuf = kbuf + KN * QS;  // ring buffer 1: the V tiles
  unsigned char* ps = vbuf + KN * QS;
  float* red_max = reinterpret_cast<float*>(ps + QM * PS);
  float* red_sum = red_max + RED_FLOATS / 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 2, wq = warp & 3;  // row group, warp of the group
  const int q0 = blockIdx.x * QM;
  const size_t n = blockIdx.y;
  const unsigned char* qg =
      reinterpret_cast<const unsigned char*>(q + n * Nq * C);
  const unsigned char* kg =
      reinterpret_cast<const unsigned char*>(k + n * Nk * C);
  const unsigned char* vg =
      reinterpret_cast<const unsigned char*>(v + n * Nk * C);
  o += n * Nq * C;

  stage_rows(qs, QS, qg, q0, QM, Nq, CB, warp, lane);
  stage_rows(kbuf, QS, kg, 0, KN, Nk, CB, warp, lane);
  cp_async_commit();

  // rows rg * 16 + g (index 0) and + 8 (index 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[16][4];  // column block j: channels wq * C / 4 + 8j + 2t, + 1
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int pairs = C / 64;  // pairs of column blocks of this warp's C / 4
  const float* rmax = red_max + rg * 64;
  const float* rsum = red_sum + rg * 64;

  for (int k0 = 0; k0 < Nk; k0 += KN) {
    // K of this tile has landed; every warp is past the last tile's second
    // product, so the V buffer and the P tile are free
    cp_async_wait_all();
    __syncthreads();
    stage_rows(vbuf, VS, vg, k0, KN, Nk, CB, warp, lane);
    cp_async_commit();

    // ---- scores of rows rg * 16 .. + 15 x keys wq * 16 .. + 15
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const unsigned char* qa = qs + (rg * 16 + g) * QS + 8 * t;
    const unsigned char* kb = kbuf + (wq * 16 + g) * QS + 8 * t;
#pragma unroll 4
    for (int kk = 0; kk < C / 16; ++kk) {
      const uint2 a_lo = *reinterpret_cast<const uint2*>(qa + kk * 32);
      const uint2 a_hi =
          *reinterpret_cast<const uint2*>(qa + 8 * QS + kk * 32);
      const uint2 b0 = *reinterpret_cast<const uint2*>(kb + kk * 32);
      const uint2 b1 = *reinterpret_cast<const uint2*>(kb + 8 * QS + kk * 32);
      mma_bf16(s[0], a_lo.x, a_hi.x, a_lo.y, a_hi.y, b0.x, b0.y);
      mma_bf16(s[1], a_lo.x, a_hi.x, a_lo.y, a_hi.y, b1.x, b1.y);
    }
    // s[j][0], s[j][1]: row g, keys wq * 16 + 8j + 2t, + 1; s[j][2], [3]:
    // row g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + wq * 16 + 8 * j + 2 * t + (e & 1) >= Nk) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) red_max[rg * 64 + wq * 16 + g + 8 * r] = mx[r];
    }
    __syncthreads();

    // every tile holds a key below Nk, so m_new is finite and every exp
    // below takes a non-positive argument (exp(-inf) = 0 on the first tile)
    float alpha[2], sum[2];
    uint32_t pw[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      const float m_new = fmaxf(
          m[r], fmaxf(fmaxf(rmax[row], rmax[16 + row]),
                      fmaxf(rmax[32 + row], rmax[48 + row])));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      float p[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) p[j][e] = expf(s[j][2 * r + e] - m_new);
      sum[r] = (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      if (t == 0) red_sum[rg * 64 + wq * 16 + row] = sum[r];
      pw[r][0] = pack_bf16(p[0][0], p[0][1]);  // k = 2t, 2t + 1 of step wq
      pw[r][1] = pack_bf16(p[1][0], p[1][1]);  // k = 2t + 8, 2t + 9
      *reinterpret_cast<uint2*>(ps + (rg * 16 + row) * PS + wq * 32 + 8 * t) =
          make_uint2(pw[r][0], pw[r][1]);
    }
    // V of this tile has landed; P and the sums are written; every warp is
    // past the score product, so the K buffer is free
    cp_async_wait_all();
    __syncthreads();
    if (k0 + KN < Nk) stage_rows(kbuf, QS, kg, k0 + KN, KN, Nk, CB, warp, lane);
    cp_async_commit();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      l[r] = l[r] * alpha[r] +
             (((rsum[row] + rsum[16 + row]) + rsum[32 + row]) + rsum[48 + row]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // ---- acc += P V over the tile's 4 steps of 16 keys
    const unsigned char* pa = ps + (rg * 16 + g) * PS + 8 * t;
    // ldmatrix: lane -> key (lane & 7) + 8 * ((lane >> 3) & 1) of the step,
    // channels + 8 * (lane >> 4)
    const unsigned char* vb = vbuf + ((lane & 7) + 8 * ((lane >> 3) & 1)) * VS +
                              2 * (wq * (C / 4) + 8 * (lane >> 4));
#pragma unroll
    for (int ks = 0; ks < KN / 16; ++ks) {
      const uint2 a_lo = *reinterpret_cast<const uint2*>(pa + ks * 32);
      const uint2 a_hi =
          *reinterpret_cast<const uint2*>(pa + 8 * PS + ks * 32);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (np < pairs) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + ks * 16 * VS + np * 32);
          mma_bf16(acc[2 * np], a_lo.x, a_hi.x, a_lo.y, a_hi.y, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a_lo.x, a_hi.x, a_lo.y, a_hi.y, b[2],
                   b[3]);
        }
      }
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rg * 16 + g + 8 * r;
    if (row >= Nq) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < 2 * pairs)
        *reinterpret_cast<uint32_t*>(o + (size_t)row * C + wq * (C / 4) +
                                     8 * j + 2 * t) =
            pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    if (WITH_LSE && wq == 0 && t == 0)
      lse[n * Nq + row] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// The float32 forward on the tensor cores, three TF32 products a fragment.

namespace tf {

constexpr int QM = 32;         // query rows a block owns
constexpr int KN = 32;         // keys per tile
constexpr int PSW = KN + 4;    // floats of a P row (padded)
constexpr int SPW = KN + 8;    // floats of a partial score row (padded)
constexpr int RED_FLOATS = 2 * (QM / 16) * 4 * 16;  // max and sum partials
constexpr int PART_FLOATS = 4 * QM * SPW;           // 4 partial score tiles

// floats of a Q or K row (16 mod 32: 16-byte fragment loads of 8 lanes hit 8
// bank groups) and of a V row (8 mod 32); the V buffer is sized as K's
__host__ __device__ constexpr int qk_stride(int C) { return C + 16; }
__host__ __device__ constexpr int v_stride(int C) { return C + 8; }
__host__ __device__ constexpr int smem_bytes(int C) {
  return 4 * ((QM + 2 * KN) * qk_stride(C) + PART_FLOATS + QM * PSW +
              RED_FLOATS);
}

// x = hi + lo, both TF32 as `mma` reads them. `mma` takes a tf32 operand
// from the top 19 bits of its register and drops the other 13, so adding
// half an ulp to the bits (0x1000) makes hi cvt.rna.tf32(x) for a finite x,
// 1 instruction where `cvt.rna` compiles to 4 (it also tests for inf and
// NaN); x - hi is exact in float, and lo is passed as it is, so `mma`
// truncates it to 11 bits (rounding it too read no closer to the plain
// version on the card and cost 4% of the kernel's time).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)));
}

// d = a b + c on one 16 x 8 block, TF32 operands, float sum. a[0]/a[1]:
// rows g and g + 8, k = t; a[2]/a[3]: the same rows, k = t + 4; b0/b1:
// column g, k = t and t + 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a b + c in three products, a = ah + al and b = bh + bl: the two
// corrections first, then ah bh
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1,
                                     const float* c) {
  mma_tf32(d, al, bh0, bh1, c);
  mma_tf32(d, ah, bl0, bl1, d);
  mma_tf32(d, ah, bh0, bh1, d);
}

}  // namespace tf

// B6a (WITH_LSE false) and B6b (true), float32. grid (ceil(Nq / 32), N).
template <bool WITH_LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int Nq, int Nk, int C) {
  using namespace tf;
  extern __shared__ __align__(128) float smf[];
  const int QS = qk_stride(C), VS = v_stride(C), CB = 4 * C;
  float* qs = smf;
  float* kbuf = qs + QM * QS;    // ring buffer 0: the K tiles
  float* vbuf = kbuf + KN * QS;  // ring buffer 1: the V tiles
  float* part = vbuf + KN * QS;  // [wq][row][key] partial scores
  float* ps = part + PART_FLOATS;
  float* red_max = ps + QM * PSW;
  float* red_sum = red_max + RED_FLOATS / 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 2, wq = warp & 3;  // row group, warp of the group
  const int q0 = blockIdx.x * QM;
  const size_t n = blockIdx.y;
  const unsigned char* qg =
      reinterpret_cast<const unsigned char*>(q + n * Nq * C);
  const unsigned char* kg =
      reinterpret_cast<const unsigned char*>(k + n * Nk * C);
  const unsigned char* vg =
      reinterpret_cast<const unsigned char*>(v + n * Nk * C);
  o += n * Nq * C;
  unsigned char* qs_b = reinterpret_cast<unsigned char*>(qs);
  unsigned char* kbuf_b = reinterpret_cast<unsigned char*>(kbuf);
  unsigned char* vbuf_b = reinterpret_cast<unsigned char*>(vbuf);

  tc::stage_rows(qs_b, 4 * QS, qg, q0, QM, Nq, CB, warp, lane);
  tc::stage_rows(kbuf_b, 4 * QS, kg, 0, KN, Nk, CB, warp, lane);
  tc::cp_async_commit();

  // the softmax state of rows 16mb + g (h = 0) and + 8 (h = 1), kept by
  // every warp (the same operations in the same order: equal everywhere)
  float m[2][2], l[2][2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mb][h] = -INFINITY;
      l[mb][h] = 0.f;
    }
  // P V: this warp owns the 32-channel groups warp and warp + 8 (below C /
  // 32) of all 32 rows; acc[gs][mb][r] is n block r of group warp + 8gs,
  // m block mb: column j is channel 32 (warp + 8gs) + 4j + r; elements 0, 1
  // row 16mb + g, columns 2t, 2t + 1; elements 2, 3 row 16mb + g + 8
  float acc[2][2][4][4];
#pragma unroll
  for (int gs = 0; gs < 2; ++gs)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gs][mb][r][e] = 0.f;
  const int groups = C / 32;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < Nk; k0 += KN) {
    // K of this tile has landed; every warp is past the last tile's second
    // product, so the V buffer and the P tile are free
    tc::cp_async_wait_all();
    __syncthreads();
    tc::stage_rows(vbuf_b, 4 * VS, vg, k0, KN, Nk, CB, warp, lane);
    tc::cp_async_commit();

    // ---- partial scores of rows rg * 16 .. + 15 x the tile's 32 keys over
    // the channels [wq C / 4, (wq + 1) C / 4), 16 at a time: lane t reads
    // channels 4t .. 4t + 3 of each (4t, 4t + 1 are k = t, t + 4 of the
    // first k-step, 4t + 2, 4t + 3 of the second)
    float s[4][4];  // key block j: row g, keys 8j + 2t, + 1; row g + 8
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const float* qa = qs + (rg * 16 + g) * QS + wq * (C / 4) + 4 * t;
    const float* kb = kbuf + g * QS + wq * (C / 4) + 4 * t;
#pragma unroll 1
    for (int c0 = 0; c0 < C / 4; c0 += 16) {
      const float4 x0 = *reinterpret_cast<const float4*>(qa + c0);
      const float4 x8 = *reinterpret_cast<const float4*>(qa + 8 * QS + c0);
      float4 y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = *reinterpret_cast<const float4*>(kb + 8 * j * QS + c0);
      uint32_t ah[4], al[4];
      float sum16[4][4];
      split(x0.x, ah[0], al[0]);
      split(x8.x, ah[1], al[1]);
      split(x0.y, ah[2], al[2]);
      split(x8.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(y[j].x, bh0, bl0);
        split(y[j].y, bh1, bl1);
        mma3(sum16[j], ah, al, bh0, bh1, bl0, bl1, zero);
      }
      split(x0.z, ah[0], al[0]);
      split(x8.z, ah[1], al[1]);
      split(x0.w, ah[2], al[2]);
      split(x8.w, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(y[j].z, bh0, bl0);
        split(y[j].w, bh1, bl1);
        mma3(sum16[j], ah, al, bh0, bh1, bl0, bl1, sum16[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sum16[j][e];
    }
    {
      float* dst = part + wq * (QM * SPW) + (rg * 16 + g) * SPW + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(dst + 8 * SPW + 8 * j) =
            make_float2(s[j][2], s[j][3]);
      }
    }
    __syncthreads();

    // ---- the scores of rows rg * 16 + g (+ 8) x keys wq * 8 + 2t, + 1: the
    // four partial sums added in order
    float sc[4];
    {
      const float* src = part + (rg * 16 + g) * SPW + wq * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 a = *reinterpret_cast<const float2*>(src + 8 * h * SPW);
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          const float2 b = *reinterpret_cast<const float2*>(
              src + w * (QM * SPW) + 8 * h * SPW);
          a.x += b.x;
          a.y += b.y;
        }
        sc[2 * h] = a.x;
        sc[2 * h + 1] = a.y;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + wq * 8 + 2 * t + (e & 1) >= Nk) sc[e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[e]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) red_max[rg * 64 + wq * 16 + g + 8 * h] = mx[h];
    }
    __syncthreads();

    // every tile holds a key below Nk, so m_new is finite and every exp
    // below takes a non-positive argument (exp(-inf) = 0 on the first tile)
    float alpha[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rmax = red_max + mb * 64 + g + 8 * h;
        const float m_new =
            fmaxf(m[mb][h], fmaxf(fmaxf(rmax[0], rmax[16]),
                                  fmaxf(rmax[32], rmax[48])));
        alpha[mb][h] = expf(m[mb][h] - m_new);
        m[mb][h] = m_new;
        if (mb == rg) {  // this warp's scores: P and its row sum
          const float p0 = expf(sc[2 * h] - m_new);
          const float p1 = expf(sc[2 * h + 1] - m_new);
          float sum = p0 + p1;
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if (t == 0) red_sum[mb * 64 + wq * 16 + g + 8 * h] = sum;
          *reinterpret_cast<float2*>(ps + (mb * 16 + g + 8 * h) * PSW +
                                     wq * 8 + 2 * t) = make_float2(p0, p1);
        }
      }
    // V of this tile has landed; P and the sums are written; every warp is
    // past the score product, so the K buffer is free
    tc::cp_async_wait_all();
    __syncthreads();
    if (k0 + KN < Nk)
      tc::stage_rows(kbuf_b, 4 * QS, kg, k0 + KN, KN, Nk, CB, warp, lane);
    tc::cp_async_commit();

#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rsum = red_sum + mb * 64 + g + 8 * h;
        l[mb][h] = l[mb][h] * alpha[mb][h] +
                   (((rsum[0] + rsum[16]) + rsum[32]) + rsum[48]);
      }

    // ---- tile = P V over the tile's 4 steps of 8 keys, then acc = acc *
    // alpha + tile
    float tile[2][2][4][4];
#pragma unroll
    for (int ks = 0; ks < KN / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const float* pa = ps + (mb * 16 + g) * PSW + 8 * ks + t;
        split(pa[0], ah[mb][0], al[mb][0]);
        split(pa[8 * PSW], ah[mb][1], al[mb][1]);
        split(pa[4], ah[mb][2], al[mb][2]);
        split(pa[8 * PSW + 4], ah[mb][3], al[mb][3]);
      }
#pragma unroll
      for (int gs = 0; gs < 2; ++gs) {
        const int grp = warp + 8 * gs;
        if (grp < groups) {
          // keys 8ks + t and + 4, channels 32 grp + 4g .. + 3: column g of
          // the group's 4 n blocks
          const float* vb = vbuf + (8 * ks + t) * VS + 32 * grp + 4 * g;
          const float4 v0 = *reinterpret_cast<const float4*>(vb);
          const float4 v1 = *reinterpret_cast<const float4*>(vb + 4 * VS);
          const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t bh0, bl0, bh1, bl1;
            split(b0[r], bh0, bl0);
            split(b1[r], bh1, bl1);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
              mma3(tile[gs][mb][r], ah[mb], al[mb], bh0, bh1, bl0, bl1,
                   ks == 0 ? zero : tile[gs][mb][r]);
          }
        }
      }
    }
#pragma unroll
    for (int gs = 0; gs < 2; ++gs) {
      if (warp + 8 * gs < groups) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[gs][mb][r][e] = fmaf(acc[gs][mb][r][e], alpha[mb][e >> 1],
                                       tile[gs][mb][r][e]);
      }
    }
  }

  // columns 2t (element 2h) and 2t + 1 (2h + 1) of the group's n blocks 0..3:
  // channels 32 grp + 8t .. + 3 and 32 grp + 8t + 4 .. + 7
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + mb * 16 + g + 8 * h;
      if (row >= Nq) continue;
      const float inv = 1.f / l[mb][h];
#pragma unroll
      for (int gs = 0; gs < 2; ++gs) {
        const int grp = warp + 8 * gs;
        if (grp < groups) {
          const float(&a)[4][4] = acc[gs][mb];
          float* dst = o + (size_t)row * C + 32 * grp + 8 * t;
          *reinterpret_cast<float4*>(dst) =
              make_float4(a[0][2 * h] * inv, a[1][2 * h] * inv,
                          a[2][2 * h] * inv, a[3][2 * h] * inv);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(a[0][2 * h + 1] * inv, a[1][2 * h + 1] * inv,
                          a[2][2 * h + 1] * inv, a[3][2 * h + 1] * inv);
        }
      }
      if (WITH_LSE && warp == 0 && t == 0)
        lse[n * Nq + row] = m[mb][h] + logf(l[mb][h]);
    }
}

// B6c: dQ. grid (ceil(Nq / BM), N).
template <typename T, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Nq, int Nk, int C) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* P = smem + STAGE_FLOATS;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM;
  const size_t n = blockIdx.y;
  q += n * Nq * C;
  d_o += n * Nq * C;
  dq += n * Nq * C;
  k += n * Nk * C;
  v += n * Nk * C;
  lse += n * Nq;
  delta += n * Nq;

  float row_lse[RW], row_delta[RW], acc[RW][NCC][4];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = q0 + RW * w + i;
    row_lse[i] = r < Nq ? lse[r] : 0.f;
    row_delta[i] = r < Nq ? delta[r] : 0.f;
  }
  zero_acc(acc);

  for (int k0 = 0; k0 < Nk; k0 += BN) {
    float s[RW][CJ], dp[RW][CJ];
    score_tile(q, q0, Nq, k, k0, Nk, C, stage, s, tid);
    score_tile(d_o, q0, Nq, v, k0, Nk, C, stage, dp, tid);
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool ok = k0 + lane + 32 * j < Nk && q0 + RW * w + i < Nq;
        const float p = ok ? expf(s[i][j] - row_lse[i]) : 0.f;
        P[(RW * w + i) * BN + lane + 32 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    __syncwarp();
    accumulate_tile(P, k, k0, Nk, C, stage, acc, tid);
  }
  const float one[RW] = {1.f, 1.f, 1.f, 1.f};
  store_rows(dq, q0, Nq, C, acc, one, tid);
}

// B6d: dV (blockIdx.y == 0) or dK (1) of the block's BM rows of K, swept over
// all Q tiles in order. grid (ceil(Nk / BM), 2, N).
template <typename T, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Nq, int Nk, int C) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* P = smem + STAGE_FLOATS;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * BM;
  const bool want_dk = blockIdx.y == 1;
  const size_t n = blockIdx.z;
  q += n * Nq * C;
  d_o += n * Nq * C;
  k += n * Nk * C;
  v += n * Nk * C;
  lse += n * Nq;
  delta += n * Nq;
  T* out = (want_dk ? dk : dv) + n * Nk * C;

  float acc[RW][NCC][4];
  zero_acc(acc);

  for (int r0 = 0; r0 < Nq; r0 += BN) {
    // the tile transposed: s[i][j] = S[r0 + lane + 32j][j0 + 4w + i]
    float s[RW][CJ], dp[RW][CJ], col_lse[CJ], col_delta[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int r = r0 + lane + 32 * j;
      col_lse[j] = r < Nq ? lse[r] : 0.f;
      col_delta[j] = r < Nq ? delta[r] : 0.f;
    }
    score_tile(k, j0, Nk, q, r0, Nq, C, stage, s, tid);
    if (want_dk) score_tile(v, j0, Nk, d_o, r0, Nq, C, stage, dp, tid);
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool ok = r0 + lane + 32 * j < Nq && j0 + RW * w + i < Nk;
        const float p = ok ? expf(s[i][j] - col_lse[j]) : 0.f;
        P[(RW * w + i) * BN + lane + 32 * j] =
            round_to<T>(want_dk ? p * (dp[i][j] - col_delta[j]) : p);
      }
    __syncwarp();
    accumulate_tile(P, want_dk ? q : d_o, r0, Nq, C, stage, acc, tid);
  }
  const float one[RW] = {1.f, 1.f, 1.f, 1.f};
  store_rows(out, j0, Nk, C, acc, one, tid);
}

template <typename K>
cudaError_t opt_in(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

bool shape_ok(int N, int Nq, int Nk, int C) {
  return N >= 1 && N <= 65535 && Nq >= 1 && Nk >= 1 && C >= 128 &&
         C <= CMAX && C % 128 == 0;
}

// Which register budget a launch of `blocks` blocks takes: when they fit one
// per SM, the 255-register build (no spills; a second resident block would
// find no work), else the 128-register build with two blocks per SM.
bool one_block_per_sm(int blocks) {
  if (B6_MIN_BLOCKS) return B6_MIN_BLOCKS == 1;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  return blocks <= sms;
}

template <bool WITH_LSE>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o,
                   void* lse, int N, int Nq, int Nk, int C, void* stream) {
  const int bytes = tc::smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<WITH_LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + tc::QM - 1) / tc::QM, N);
  flash_fwd_mma_kernel<WITH_LSE>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Nq, Nk,
          C);
  return (int)cudaGetLastError();
}

template <bool WITH_LSE>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                    void* lse, int N, int Nq, int Nk, int C, void* stream) {
  const int bytes = tf::smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<WITH_LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + tf::QM - 1) / tf::QM, N);
  flash_fwd_tf32_kernel<WITH_LSE>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(lse), Nq, Nk, C);
  return (int)cudaGetLastError();
}

// float32: three TF32 products a fragment; bfloat16: one bf16 product
template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int N,
        int Nq, int Nk, int C, void* stream) {
  if (!shape_ok(N, Nq, Nk, C)) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return lse != nullptr
               ? launch_fwd_mma<true>(q, k, v, o, lse, N, Nq, Nk, C, stream)
               : launch_fwd_mma<false>(q, k, v, o, lse, N, Nq, Nk, C, stream);
  else
    return lse != nullptr
               ? launch_fwd_tf32<true>(q, k, v, o, lse, N, Nq, Nk, C, stream)
               : launch_fwd_tf32<false>(q, k, v, o, lse, N, Nq, Nk, C,
                                        stream);
}

template <typename T, int MINB>
int launch_dq(const void* q, const void* k, const void* v, const void* d_o,
              const void* lse, const void* delta, void* dq, int N, int Nq,
              int Nk, int C, void* stream) {
  cudaError_t err = opt_in(flash_bwd_dq_kernel<T, MINB>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + BM - 1) / BM, N);
  flash_bwd_dq_kernel<T, MINB>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(d_o),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), Nq, Nk, C);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
           const void* lse, const void* delta, void* dq, int N, int Nq, int Nk,
           int C, void* stream) {
  if (!shape_ok(N, Nq, Nk, C)) return (int)cudaErrorInvalidValue;
  return one_block_per_sm(((Nq + BM - 1) / BM) * N)
             ? launch_dq<T, 1>(q, k, v, d_o, lse, delta, dq, N, Nq, Nk, C,
                               stream)
             : launch_dq<T, 2>(q, k, v, d_o, lse, delta, dq, N, Nq, Nk, C,
                               stream);
}

template <typename T, int MINB>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, void* dk, void* dv, int N,
               int Nq, int Nk, int C, void* stream) {
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<T, MINB>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nk + BM - 1) / BM, 2, N);
  flash_bwd_dkv_kernel<T, MINB>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(d_o),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), Nq, Nk, C);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
            const void* lse, const void* delta, void* dk, void* dv, int N,
            int Nq, int Nk, int C, void* stream) {
  if (!shape_ok(N, Nq, Nk, C)) return (int)cudaErrorInvalidValue;
  return one_block_per_sm(((Nk + BM - 1) / BM) * 2 * N)
             ? launch_dkv<T, 1>(q, k, v, d_o, lse, delta, dk, dv, N, Nq, Nk,
                                C, stream)
             : launch_dkv<T, 2>(q, k, v, d_o, lse, delta, dk, dv, N, Nq, Nk,
                                C, stream);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous,
// 16-byte aligned tensors: q, o, d_o, dq (N, Nq, C); k, v, dk, dv (N, Nk, C),
// all float (f32) or all bfloat16 (bf16); lse, delta (N, Nq) float. C is a
// multiple of 128, at most 512; N at most 65535. Each returns the
// cudaError_t of its launch (cudaErrorInvalidValue for a shape it refuses).
//
// Forward: lse == NULL launches B6a, otherwise B6b, which also writes lse.
extern "C" int rpst_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int N, int Nq, int Nk,
                                  int C, void* stream) {
  return fwd<float>(q, k, v, o, lse, N, Nq, Nk, C, stream);
}
extern "C" int rpst_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int N, int Nq, int Nk,
                                   int C, void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, o, lse, N, Nq, Nk, C, stream);
}
// B6c
extern "C" int rpst_flash_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* d_o,
                                     const void* lse, const void* delta,
                                     void* dq, int N, int Nq, int Nk, int C,
                                     void* stream) {
  return bwd_dq<float>(q, k, v, d_o, lse, delta, dq, N, Nq, Nk, C, stream);
}
extern "C" int rpst_flash_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* d_o,
                                      const void* lse, const void* delta,
                                      void* dq, int N, int Nq, int Nk, int C,
                                      void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, v, d_o, lse, delta, dq, N, Nq, Nk, C,
                               stream);
}
// B6d
extern "C" int rpst_flash_bwd_dkv_f32(const void* q, const void* k,
                                      const void* v, const void* d_o,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int N, int Nq,
                                      int Nk, int C, void* stream) {
  return bwd_dkv<float>(q, k, v, d_o, lse, delta, dk, dv, N, Nq, Nk, C,
                        stream);
}
extern "C" int rpst_flash_bwd_dkv_bf16(const void* q, const void* k,
                                       const void* v, const void* d_o,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int N, int Nq,
                                       int Nk, int C, void* stream) {
  return bwd_dkv<__nv_bfloat16>(q, k, v, d_o, lse, delta, dk, dv, N, Nq, Nk, C,
                                stream);
}

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
// bound by operations by three orders of magnitude. Every kernel runs its
// products on the tensor cores. A float32 product must stay as accurate as
// float32 (the logits are unscaled; one TF32 product moves O by 5e-4 of its
// size, the gradients by 4e-4 to 8e-4), so the float32 kernels run three
// TF32 products per fragment (below): their ceiling is a third of the 495
// TFLOP/s TF32 rate the bound is stated against, still 2.5x the 67 TFLOP/s
// of float FMAs on the CUDA cores. The limit is feeding `mma` from shared
// memory, and in float32 also the instructions that split each operand.
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
// The two backward kernels (B6c: `flash_bwd_dq_kernel`, B6d:
// `flash_bwd_dkv_kernel`; both types, one source each).
//   * A block of 256 threads owns RM = 16 rows (of Q in B6c, of K in B6d),
//     resident in shared memory with their dO (or V) rows, and sweeps the
//     other side in tiles of TN = 32 rows; the sequential grid axis of the
//     TPU kernel is the loop inside the block. No sum crosses blocks, so
//     there are no atomics and dQ, dK and dV are bit-equal run to run.
//   * Products on the tensor cores as in the forward of the same type:
//     bfloat16 one `mma.sync.m16n8k16` product per fragment (operands by
//     `ldmatrix`, the transposed B operand by `ldmatrix.trans`; rows padded
//     by 16 bytes so every 8-row load hits each bank once); float32 three
//     TF32 `mma.sync.m16n8k8` products per fragment (`tf::split`,
//     `tf::mma3`), fragments by 16-byte loads, a fresh `mma` chain per 8
//     channels of a score and per tile of the second product, added to the
//     float32 sums outside `mma`.
//   * Per tile, the score tile S and dP = dO V^T (16 x 32 each), one after
//     the other: in bfloat16 warp w forms the 16 x 8 block w % 4 over half
//     of C (w / 4); in float32 the blocks 2 (w % 2) and + 1 over a quarter
//     of C (w / 2), so a split A fragment feeds two blocks (eight 3-product
//     chains in flight a warp). The parts go through shared memory (10 KB
//     bf16, 20 KB f32) and are added in order, then P = exp(S - LSE) and
//     dS = P (dP - Delta) are formed once per element (float; rounded to
//     the tensors' type only where they are stored as the next product's A
//     operand, as rpst casts them) into a 16 x 32 tile. Keys past Nk and rows past Nq give P = dS = 0
//     explicitly (a zero row with LSE read as 0 would give P = 1).
//   * Second products: warp w owns the 32-channel groups w and w + 8 of
//     the block's 16 rows. B6c: dQ += dS K. B6d: dV += P^T dO, then dK +=
//     dS^T Q, from the one score tile (8 tile products, where blocks split
//     by output would form it twice, 10). The accumulators: 32 registers
//     a thread for dQ, 64 for dK and dV.
//   * The swept operands arrive through a two-buffer `cp.async` ring, one
//     load in flight under each phase: B6c loads K_j under dO V_j^T and
//     V_j+1 under S and dS K_j; B6d loads Q_j under V dO_j^T and dO_j+1
//     under dS^T Q_j.
//   * Shared memory at C = 512: float32 223 KB (a staged row is 2 KB), one
//     block per SM; bfloat16 110 KB, two. Registers (ptxas): B6c 182 f32 /
//     104 bf16, B6d 210 / 127, no spills. At batch 1, Nq = 4096 gives 256
//     blocks, Nq = 1024 gives 64 for the 132 SMs.
//   * What bounds them: in bfloat16 the swept side that each block re-reads,
//     ~2 GB from L2 at (1, 4096, 4096, 512); in float32 the instructions
//     that split each operand, as in the forward (~20% of the 3 x TF32
//     ceiling; splitting the `mma` chains further gained 1.15x).
// C must be a multiple of 128, at most 512 (SANet's width), for every
// kernel of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CMAX = 512;  // widest C (SANet's width)

// ---------------------------------------------------------------------------
// The bfloat16 forward on the tensor cores.

namespace tc {

using namespace hmma;  // cp.async, mma_bf16, ldmatrix, pack_bf16

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

using namespace hmma::tf32;  // split, mma_tf32, mma3

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

// ---------------------------------------------------------------------------
// The backward kernels on the tensor cores (both types).

namespace bw {

constexpr int RM = 16;       // rows a block owns: of Q (B6c), of K (B6d)
constexpr int TN = 32;       // rows of the swept operand per tile
constexpr int SPW = TN + 8;  // floats of a partial score row (padded)

// How the 8 warps share a 16 x 32 score tile: warp w forms NBW of its four
// 16 x 8 blocks over one of PARTS parts of C. float32 two blocks over a
// quarter (a split A fragment feeds both), bfloat16 one over a half.
template <typename T>
struct score_split {
  static constexpr int NBW = std::is_same<T, float>::value ? 2 : 1;
  static constexpr int PARTS = 2 * NBW;
  // [S, dP][part of C][row][column]: the parts' partial scores
  static constexpr int FLOATS = 2 * PARTS * RM * SPW;
};

// Elements of a staged row: C + 8 bf16 (16 bytes over: `ldmatrix` rows hit
// every bank once) or C + 16 floats (16-byte fragment loads of 8 lanes hit
// 8 bank groups). Elements of a P or dS tile row: 40 bf16 (80 bytes,
// `ldmatrix`) or 36 floats (scalar fragment loads).
template <typename T>
__host__ __device__ constexpr int row_stride(int C) {
  return std::is_same<T, float>::value ? C + 16 : C + 8;
}
template <typename T>
__host__ __device__ constexpr int tile_stride() {
  return std::is_same<T, float>::value ? TN + 4 : TN + 8;
}
// Q, dO (or K, V) resident, a K and a V (or Q and dO) tile, the partial
// scores and two P / dS tiles: 223 KB in float32 at C = 512, one block per
// SM; 110 KB in bfloat16, two
template <typename T>
__host__ __device__ constexpr int smem_bytes(int C) {
  return (2 * RM + 2 * TN) * row_stride<T>(C) * (int)sizeof(T) +
         score_split<T>::FLOATS * 4 +
         2 * RM * tile_stride<T>() * (int)sizeof(T);
}
template <typename T>
struct blocks_per_sm {
  static constexpr int value = std::is_same<T, float>::value ? 1 : 2;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(a, b);
}

// s[j] += a b^T over the channels [c0, c1) on 16 x 8 block j: rows g and
// g + 8 of a (the block's 16 rows), row g of the 8 rows b + 8j. float32:
// two blocks, three TF32 products per fragment; lane t reads channels
// 4t .. 4t + 3 of a 16-channel step (4t, 4t + 1 are k = t, t + 4 of its
// first m16n8k8, 4t + 2, 4t + 3 of its second), and the A fragment is split
// once for both blocks. Each m16n8k8 is a fresh `mma` chain of three
// products, so two steps of 16 channels give eight independent chains
// (`mma`'s latency, not its rate, bounds a chain); a step's two sums are
// added, then the step's sum to s, in float32.
__device__ __forceinline__ void score_part(float (&s)[2][4], const float* a,
                                           const float* b, int rs, int c0,
                                           int c1, int lane) {
  constexpr int STEPS = 2;  // 16-channel steps per iteration
  const int g = lane >> 2, t = lane & 3;
  const float* pa = a + g * rs + 4 * t;
  const float* pb = b + g * rs + 4 * t;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int c = c0; c < c1; c += 16 * STEPS) {
    float sum[STEPS][2][2][4];  // step, block, k-step
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int ci = c + 16 * i;
      const float4 x0 = ld4(pa + ci), x8 = ld4(pa + 8 * rs + ci);
      const float4 y[2] = {ld4(pb + ci), ld4(pb + 8 * rs + ci)};
      uint32_t ah[2][4], al[2][4];
      tf::split(x0.x, ah[0][0], al[0][0]);
      tf::split(x8.x, ah[0][1], al[0][1]);
      tf::split(x0.y, ah[0][2], al[0][2]);
      tf::split(x8.y, ah[0][3], al[0][3]);
      tf::split(x0.z, ah[1][0], al[1][0]);
      tf::split(x8.z, ah[1][1], al[1][1]);
      tf::split(x0.w, ah[1][2], al[1][2]);
      tf::split(x8.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bh[4], bl[4];
        tf::split(y[j].x, bh[0], bl[0]);
        tf::split(y[j].y, bh[1], bl[1]);
        tf::split(y[j].z, bh[2], bl[2]);
        tf::split(y[j].w, bh[3], bl[3]);
        tf::mma3(sum[i][j][0], ah[0], al[0], bh[0], bh[1], bl[0], bl[1],
                 zero);
        tf::mma3(sum[i][j][1], ah[1], al[1], bh[2], bh[3], bl[2], bl[3],
                 zero);
      }
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sum[i][j][0][e] + sum[i][j][1][e];
  }
}
// bfloat16: one product per fragment, A and B by `ldmatrix`, 32 channels a
// step, the two 16-channel halves of a step into two `mma` chains added at
// the end.
__device__ __forceinline__ void score_part(float (&s1)[1][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int rs,
                                           int c0, int c1, int lane) {
  const __nv_bfloat16* pa = a + (lane & 15) * rs + 8 * (lane >> 4);
  const __nv_bfloat16* pb = b + (lane & 7) * rs + 8 * (lane >> 3);
  float(&s)[4] = s1[0];
  float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int c = c0; c < c1; c += 32) {
    uint32_t x[4], y[4], z[4];
    tc::ldmatrix_x4(x, pa + c);
    tc::ldmatrix_x4(y, pa + c + 16);
    tc::ldmatrix_x4(z, pb + c);
    tc::mma_bf16(s, x[0], x[1], x[2], x[3], z[0], z[1]);
    tc::mma_bf16(s2, y[0], y[1], y[2], y[3], z[2], z[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] += s2[e];
}

// A warp's NB partial score blocks nb0 .. nb0 + NB - 1 into the partial
// tile `part` (rows g and g + 8, columns 8 nb + 2t, + 1)
template <int NB>
__device__ __forceinline__ void put_part(float* part, const float (&s)[NB][4],
                                         int nb0, int lane) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float* p = part + (lane >> 2) * SPW + 8 * (nb0 + j) + 2 * (lane & 3);
    store2(p, s[j][0], s[j][1]);
    store2(p + 8 * SPW, s[j][2], s[j][3]);
  }
}
// Element (r, c), (r, c + 1) of a score tile: its PARTS parts added in order
template <int PARTS>
__device__ __forceinline__ float2 sum_part(const float* part, int r, int c) {
  float2 a = *reinterpret_cast<const float2*>(part + r * SPW + c);
#pragma unroll
  for (int i = 1; i < PARTS; ++i) {
    const float2 b =
        *reinterpret_cast<const float2*>(part + i * RM * SPW + r * SPW + c);
    a.x += b.x;
    a.y += b.y;
  }
  return a;
}

// acc += tile bt over the tile's TN rows: tile (RM x TN, P or dS) is the A
// operand, bt (TN rows x C, k along its rows) the B operand. A warp owns the
// 32-channel groups warp and warp + 8 (below C / 32), 4 n blocks each.
// float32: column j of n block r is channel 32 grp + 4j + r, so lane g reads
// its B values of all four with one 16-byte load per row; the tile's 12
// products go into a fresh sum, added to acc in float32.
__device__ __forceinline__ void second(float (&acc)[2][4][4],
                                       const float* tile, const float* bt,
                                       int rs, int C, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3, groups = C / 32;
  constexpr int TS = tile_stride<float>();
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float sum[2][4][4];
#pragma unroll
  for (int ks = 0; ks < TN / 8; ++ks) {
    const float* pa = tile + g * TS + 8 * ks + t;
    uint32_t ah[4], al[4];
    tf::split(pa[0], ah[0], al[0]);
    tf::split(pa[8 * TS], ah[1], al[1]);
    tf::split(pa[4], ah[2], al[2]);
    tf::split(pa[8 * TS + 4], ah[3], al[3]);
#pragma unroll
    for (int gs = 0; gs < 2; ++gs) {
      const int grp = warp + 8 * gs;
      if (grp < groups) {
        const float* pb = bt + (8 * ks + t) * rs + 32 * grp + 4 * g;
        const float4 v0 = ld4(pb), v1 = ld4(pb + 4 * rs);
        const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t bh0, bl0, bh1, bl1;
          tf::split(b0[r], bh0, bl0);
          tf::split(b1[r], bh1, bl1);
          tf::mma3(sum[gs][r], ah, al, bh0, bh1, bl0, bl1,
                   ks == 0 ? zero : sum[gs][r]);
        }
      }
    }
  }
#pragma unroll
  for (int gs = 0; gs < 2; ++gs)
    if (warp + 8 * gs < groups)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gs][r][e] += sum[gs][r][e];
}
// bfloat16: n block nb of a group is channels 32 grp + 8 nb .. + 7; the tile
// by `ldmatrix`, bt by `ldmatrix.trans`; summed in acc by `mma`.
__device__ __forceinline__ void second(float (&acc)[2][4][4],
                                       const __nv_bfloat16* tile,
                                       const __nv_bfloat16* bt, int rs, int C,
                                       int warp, int lane) {
  const int groups = C / 32;
  constexpr int TS = tile_stride<__nv_bfloat16>();
  const __nv_bfloat16* pa = tile + (lane & 15) * TS + 8 * (lane >> 4);
  // ldmatrix.trans: lane -> row (lane & 7) + 8 ((lane >> 3) & 1) of the
  // step, channels + 8 (lane >> 4)
  const __nv_bfloat16* pb =
      bt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * rs + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < TN / 16; ++ks) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, pa + 16 * ks);
#pragma unroll
    for (int gs = 0; gs < 2; ++gs) {
      const int grp = warp + 8 * gs;
      if (grp < groups) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, pb + 16 * ks * rs + 32 * grp + 16 * h);
          tc::mma_bf16(acc[gs][2 * h], a[0], a[1], a[2], a[3], b[0], b[1]);
          tc::mma_bf16(acc[gs][2 * h + 1], a[0], a[1], a[2], a[3], b[2],
                       b[3]);
        }
      }
    }
  }
}

// Rows g and g + 8 (below `rows`) of a block's 16 output rows from acc
__device__ __forceinline__ void store_out(float* dst, int rows, int C,
                                          const float (&acc)[2][4][4],
                                          int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= rows) continue;
#pragma unroll
    for (int gs = 0; gs < 2; ++gs) {
      const int grp = warp + 8 * gs;
      if (grp < C / 32) {
        const float(&a)[4][4] = acc[gs];
        float* d = dst + (size_t)(g + 8 * h) * C + 32 * grp + 8 * t;
        *reinterpret_cast<float4*>(d) =
            make_float4(a[0][2 * h], a[1][2 * h], a[2][2 * h], a[3][2 * h]);
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(a[0][2 * h + 1], a[1][2 * h + 1], a[2][2 * h + 1],
                        a[3][2 * h + 1]);
      }
    }
  }
}
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, int rows, int C,
                                          const float (&acc)[2][4][4],
                                          int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= rows) continue;
#pragma unroll
    for (int gs = 0; gs < 2; ++gs) {
      const int grp = warp + 8 * gs;
      if (grp < C / 32)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          store2(dst + (size_t)(g + 8 * h) * C + 32 * grp + 8 * nb + 2 * t,
                 acc[gs][nb][2 * h], acc[gs][nb][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int gs = 0; gs < 2; ++gs)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gs][r][e] = 0.f;
}

}  // namespace bw

// B6c: dQ of the block's 16 query rows, the keys swept in tiles of 32.
// grid (ceil(Nq / 16), N).
template <typename T>
__global__ void __launch_bounds__(THREADS, bw::blocks_per_sm<T>::value)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Nq, int Nk, int C) {
  using namespace bw;
  extern __shared__ __align__(128) unsigned char sm[];
  const int RS = row_stride<T>(C), TS = tile_stride<T>();
  const int RB = RS * (int)sizeof(T), CB = C * (int)sizeof(T);
  T* qs = reinterpret_cast<T*>(sm);
  T* dos = qs + RM * RS;
  T* kb = dos + RM * RS;  // ring buffer 0: the K tiles
  T* vb = kb + TN * RS;   // ring buffer 1: the V tiles
  float* part = reinterpret_cast<float*>(vb + TN * RS);
  T* ds = reinterpret_cast<T*>(part + score_split<T>::FLOATS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this warp's score blocks NBW nbg .. + NBW - 1 over part pc of C
  constexpr int NBW = score_split<T>::NBW, PARTS = score_split<T>::PARTS;
  const int nbg = warp % (4 / NBW), pc = warp / (4 / NBW);
  const int c0 = pc * (C / PARTS), c1 = c0 + C / PARTS;
  float* part_s = part + pc * RM * SPW;
  float* part_dp = part + (PARTS + pc) * RM * SPW;
  const int q0 = blockIdx.x * RM;
  const size_t n = blockIdx.y;
  const auto bytes = [](const T* p) {
    return reinterpret_cast<const unsigned char*>(p);
  };
  const unsigned char* kg = bytes(k + n * Nk * C);
  const unsigned char* vg = bytes(v + n * Nk * C);
  tc::stage_rows(sm, RB, bytes(q + n * Nq * C), q0, RM, Nq, CB, warp, lane);
  tc::stage_rows(reinterpret_cast<unsigned char*>(dos), RB,
                 bytes(d_o + n * Nq * C), q0, RM, Nq, CB, warp, lane);
  tc::stage_rows(reinterpret_cast<unsigned char*>(vb), RB, vg, 0, TN, Nk, CB,
                 warp, lane);
  tc::cp_async_commit();

  // the element-wise step's two values: row er, keys ec and ec + 1
  const int er = tid >> 4, ec = 2 * (tid & 15);
  const bool row_ok = q0 + er < Nq;
  const float row_lse = row_ok ? lse[n * Nq + q0 + er] : 0.f;
  const float row_delta = row_ok ? delta[n * Nq + q0 + er] : 0.f;
  float acc[2][4][4];
  zero(acc);

  for (int k0 = 0; k0 < Nk; k0 += TN) {
    // V of this tile has landed; every warp is past the last tile's dS K,
    // so the K buffer is free
    tc::cp_async_wait_all();
    __syncthreads();
    tc::stage_rows(reinterpret_cast<unsigned char*>(kb), RB, kg, k0, TN, Nk,
                   CB, warp, lane);
    tc::cp_async_commit();
    float dp[NBW][4] = {};
    score_part(dp, dos, vb + 8 * NBW * nbg * RS, RS, c0, c1, lane);
    put_part(part_dp, dp, NBW * nbg, lane);
    // K of this tile has landed; every warp is past dO V^T, so the V buffer
    // is free
    tc::cp_async_wait_all();
    __syncthreads();
    if (k0 + TN < Nk)
      tc::stage_rows(reinterpret_cast<unsigned char*>(vb), RB, vg, k0 + TN,
                     TN, Nk, CB, warp, lane);
    tc::cp_async_commit();
    float s[NBW][4] = {};
    score_part(s, qs, kb + 8 * NBW * nbg * RS, RS, c0, c1, lane);
    put_part(part_s, s, NBW * nbg, lane);
    __syncthreads();
    {
      const float2 sv = sum_part<PARTS>(part, er, ec);
      const float2 dv = sum_part<PARTS>(part + PARTS * RM * SPW, er, ec);
      const float p0 = row_ok && k0 + ec < Nk ? expf(sv.x - row_lse) : 0.f;
      const float p1 =
          row_ok && k0 + ec + 1 < Nk ? expf(sv.y - row_lse) : 0.f;
      store2(ds + er * TS + ec, p0 * (dv.x - row_delta),
             p1 * (dv.y - row_delta));
    }
    __syncthreads();
    second(acc, ds, kb, RS, C, warp, lane);
  }
  store_out(dq + (n * Nq + q0) * C, Nq - q0, C, acc, warp, lane);
}

// B6d: dK and dV of the block's 16 key rows, the queries swept in tiles of
// 32 in order (no atomics). grid (ceil(Nk / 16), N).
template <typename T>
__global__ void __launch_bounds__(THREADS, bw::blocks_per_sm<T>::value)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Nq, int Nk, int C) {
  using namespace bw;
  extern __shared__ __align__(128) unsigned char sm[];
  const int RS = row_stride<T>(C), TS = tile_stride<T>();
  const int RB = RS * (int)sizeof(T), CB = C * (int)sizeof(T);
  T* ks = reinterpret_cast<T*>(sm);
  T* vs = ks + RM * RS;
  T* qb = vs + RM * RS;   // ring buffer 0: the Q tiles
  T* dob = qb + TN * RS;  // ring buffer 1: the dO tiles
  float* part = reinterpret_cast<float*>(dob + TN * RS);
  T* pt = reinterpret_cast<T*>(part + score_split<T>::FLOATS);  // P^T
  T* dst = pt + RM * TS;                               // dS^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this warp's score blocks NBW nbg .. + NBW - 1 over part pc of C
  constexpr int NBW = score_split<T>::NBW, PARTS = score_split<T>::PARTS;
  const int nbg = warp % (4 / NBW), pc = warp / (4 / NBW);
  const int c0 = pc * (C / PARTS), c1 = c0 + C / PARTS;
  float* part_s = part + pc * RM * SPW;
  float* part_dp = part + (PARTS + pc) * RM * SPW;
  const int j0 = blockIdx.x * RM;
  const size_t n = blockIdx.y;
  const auto bytes = [](const T* p) {
    return reinterpret_cast<const unsigned char*>(p);
  };
  const unsigned char* qg = bytes(q + n * Nq * C);
  const unsigned char* dog = bytes(d_o + n * Nq * C);
  lse += n * Nq;
  delta += n * Nq;
  tc::stage_rows(sm, RB, bytes(k + n * Nk * C), j0, RM, Nk, CB, warp, lane);
  tc::stage_rows(reinterpret_cast<unsigned char*>(vs), RB,
                 bytes(v + n * Nk * C), j0, RM, Nk, CB, warp, lane);
  tc::stage_rows(reinterpret_cast<unsigned char*>(dob), RB, dog, 0, TN, Nq,
                 CB, warp, lane);
  tc::cp_async_commit();

  // the element-wise step's two values: key er, queries ec and ec + 1
  const int er = tid >> 4, ec = 2 * (tid & 15);
  const bool key_ok = j0 + er < Nk;
  float acc_k[2][4][4], acc_v[2][4][4];
  zero(acc_k);
  zero(acc_v);

  for (int q0 = 0; q0 < Nq; q0 += TN) {
    // dO of this tile has landed; every warp is past the last tile's
    // dS^T Q, so the Q buffer is free
    tc::cp_async_wait_all();
    __syncthreads();
    tc::stage_rows(reinterpret_cast<unsigned char*>(qb), RB, qg, q0, TN, Nq,
                   CB, warp, lane);
    tc::cp_async_commit();
    float dp[NBW][4] = {};
    score_part(dp, vs, dob + 8 * NBW * nbg * RS, RS, c0, c1, lane);
    put_part(part_dp, dp, NBW * nbg, lane);
    tc::cp_async_wait_all();  // Q of this tile has landed
    __syncthreads();
    float s[NBW][4] = {};
    score_part(s, ks, qb + 8 * NBW * nbg * RS, RS, c0, c1, lane);
    put_part(part_s, s, NBW * nbg, lane);
    __syncthreads();
    {
      const float2 sv = sum_part<PARTS>(part, er, ec);
      const float2 dpv = sum_part<PARTS>(part + PARTS * RM * SPW, er, ec);
      const float sc[2] = {sv.x, sv.y}, dd[2] = {dpv.x, dpv.y};
      float p[2], d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q0 + ec + e;
        const bool ok = key_ok && col < Nq;
        p[e] = ok ? expf(sc[e] - lse[col]) : 0.f;
        d[e] = ok ? p[e] * (dd[e] - delta[col]) : 0.f;
      }
      store2(pt + er * TS + ec, p[0], p[1]);
      store2(dst + er * TS + ec, d[0], d[1]);
    }
    __syncthreads();
    second(acc_v, pt, dob, RS, C, warp, lane);
    // every warp is past P^T dO, so the dO buffer is free
    __syncthreads();
    if (q0 + TN < Nq)
      tc::stage_rows(reinterpret_cast<unsigned char*>(dob), RB, dog, q0 + TN,
                     TN, Nq, CB, warp, lane);
    tc::cp_async_commit();
    second(acc_k, dst, qb, RS, C, warp, lane);
  }
  store_out(dk + (n * Nk + j0) * C, Nk - j0, C, acc_k, warp, lane);
  store_out(dv + (n * Nk + j0) * C, Nk - j0, C, acc_v, warp, lane);
}

bool shape_ok(int N, int Nq, int Nk, int C) {
  return N >= 1 && N <= 65535 && Nq >= 1 && Nk >= 1 && C >= 128 &&
         C <= CMAX && C % 128 == 0;
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

// Shared memory beyond 48 KB, and the carveout that holds two bfloat16
// blocks on an SM
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
           const void* lse, const void* delta, void* dq, int N, int Nq, int Nk,
           int C, void* stream) {
  if (!shape_ok(N, Nq, Nk, C)) return (int)cudaErrorInvalidValue;
  const int bytes = bw::smem_bytes<T>(C);
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + bw::RM - 1) / bw::RM, N);
  flash_bwd_dq_kernel<T>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(d_o),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), Nq, Nk, C);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
            const void* lse, const void* delta, void* dk, void* dv, int N,
            int Nq, int Nk, int C, void* stream) {
  if (!shape_ok(N, Nq, Nk, C)) return (int)cudaErrorInvalidValue;
  const int bytes = bw::smem_bytes<T>(C);
  const cudaError_t err = opt_in(flash_bwd_dkv_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nk + bw::RM - 1) / bw::RM, N);
  flash_bwd_dkv_kernel<T>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(d_o),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), Nq, Nk, C);
  return (int)cudaGetLastError();
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

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
// bound by operations by three orders of magnitude. This kernel runs them as
// float FMAs on the CUDA cores (the float32 entry point must keep float32
// products: TF32 would lose the 1e-4 agreement, and the logits are unscaled),
// whose peak is 67 TFLOP/s, a seventh of the TF32 tensor-core rate the bound
// is stated against.
//
// What this simple design does about it.
//   * One block of 256 threads owns BM = 32 rows (of Q; of K in the dK/dV
//     kernel) and sweeps the other operand in tiles of BN = 128 rows; the
//     sequential grid axis of the TPU kernel is the loop inside the block.
//   * C = 512 is the hard part: a (32, 512) float accumulator is 64 KB. It
//     lives in registers, 64 a thread: warp w owns rows 4w..4w+3 and lane l
//     the channels 4l..4l+3 of each 128-channel group.
//   * The score tile (32 x 128) is a register-blocked product, 4 x 4 a thread
//     (rows 4w+i, columns l + 32j), with C walked in chunks of KC = 32 staged
//     in shared memory; a row's 128 scores then sit in one warp, so the
//     running max and sum are warp shuffles and never touch shared memory.
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
// Occupancy at batch 1: Nq = 4096 gives 128 blocks for 132 SMs, Nq = 1024
// gives 32; K is not split across blocks (that needs a second pass). No
// tensor cores (mma / wgmma for the bfloat16 entry points), no TMA, no
// double buffering yet: that is later work held to this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;             // rows a block owns
constexpr int BN = 128;            // rows of the swept operand per tile
constexpr int KC = 32;             // channels per staged chunk of a score tile
constexpr int KCP = KC + 4;        // padded row: float4 reads hit 8 bank groups
constexpr int JV = 16;             // swept rows per chunk of the second product
constexpr int CMAX = 512;          // widest C (4 groups of 128 channels)
constexpr int THREADS = 256;
// Each kernel is built for 1 and for 2 blocks per SM (MINB: 255 or 128
// registers a thread) and a launch picks by its block count
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// B6a (WITH_LSE false) and B6b (true). grid (ceil(Nq / BM), N).
template <typename T, bool WITH_LSE, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Nq, int Nk, int C) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* P = smem + STAGE_FLOATS;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM;
  const size_t n = blockIdx.y;
  q += n * Nq * C;
  k += n * Nk * C;
  v += n * Nk * C;
  o += n * Nq * C;

  float m[RW], l[RW], acc[RW][NCC][4];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero_acc(acc);

  for (int k0 = 0; k0 < Nk; k0 += BN) {
    float s[RW][CJ];
    score_tile(q, q0, Nq, k, k0, Nk, C, stage, s, tid);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (k0 + lane + 32 * j >= Nk) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a column below Nk, so m_new is finite and every exp
      // below takes a non-positive argument (exp(-inf) = 0 on the first tile)
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        P[(RW * w + i) * BN + lane + 32 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NCC; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    __syncwarp();
    accumulate_tile(P, v, k0, Nk, C, stage, acc, tid);
  }

  float inv[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) inv[i] = 1.f / l[i];
  store_rows(o, q0, Nq, C, acc, inv, tid);
  if (WITH_LSE && lane == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = q0 + RW * w + i;
      if (r < Nq) lse[n * Nq + r] = m[i] + logf(l[i]);
    }
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

template <typename T, bool WITH_LSE, int MINB>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int N, int Nq, int Nk, int C, void* stream) {
  cudaError_t err = opt_in(flash_fwd_kernel<T, WITH_LSE, MINB>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + BM - 1) / BM, N);
  flash_fwd_kernel<T, WITH_LSE, MINB>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), Nq, Nk, C);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int N,
        int Nq, int Nk, int C, void* stream) {
  if (!shape_ok(N, Nq, Nk, C)) return (int)cudaErrorInvalidValue;
  const bool one = one_block_per_sm(((Nq + BM - 1) / BM) * N);
  if (lse != nullptr)
    return one ? launch_fwd<T, true, 1>(q, k, v, o, lse, N, Nq, Nk, C, stream)
               : launch_fwd<T, true, 2>(q, k, v, o, lse, N, Nq, Nk, C, stream);
  return one ? launch_fwd<T, false, 1>(q, k, v, o, lse, N, Nq, Nk, C, stream)
             : launch_fwd<T, false, 2>(q, k, v, o, lse, N, Nq, Nk, C, stream);
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

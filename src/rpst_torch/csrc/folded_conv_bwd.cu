// B2 and B3 on Hopper: the backward pair of B1 (reflect-ring pad + 3x3
// folded conv + bias + activation).
//
// Replaces the TPU kernels in src/rpst/ops/pallas/folded_conv.py:
//   B2 `fused_folded_conv_grad_input`  (wrapper :339, body
//      `_make_bwd_input_kernel` :165)
//   B3 `fused_folded_conv_grad_weight` (wrapper :468, body
//      `_make_bwd_weight_kernel` :382)
// They run inside the autograd Function of rpst_torch/ops/folded_conv.py,
// which forms gz = where(y > 0, g, alpha * g) from the saved output first.
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
// (N, H, W, 4C), its ring rows `rings` (N, 2, W, 4C) and gz:
//   dk[dr, dc, i, o] = sum over n, r, c of xpad[n, r+dr, c+dc, i] gz[n, r, c, o]
//   db[o]            = sum over n, r, c of gz[n, r, c, o]
// where xpad is x with the reflect ring (rows from `rings`, columns and
// corners by the column rule, as B1 builds them).
//
// What bounds them on the card. Both do the MACs of B1: at 512px one
// 128->128 folded layer is 19.3 GFLOP for each of them, against 67 TFLOP/s
// of float32 FMA on an H100 SXM at 700 W (data sheet); the tensors they read
// and write are tens of MB. So they are bound by arithmetic, as long as each
// value staged in shared memory is reused many times.
//
// What this simple design does about it.
//   B2 is B1's tiling with the zero halo: a block owns TH x TW output pixels
//   and TCO dx channels, stages gz with a one-pixel zero halo and the 9 x KC
//   x TCO khat chunk in shared memory as float, and accumulates a 4-pixel x
//   TN-channel register tile in float32. The ring adjoint touches only the
//   two outer rows and columns on each side; the threads that own them add
//   it in the epilogue from global memory (a few 1-pixel dot products).
//   B3 is a GEMM per tap, dk[tap] = window_tap(xpad)^T . gz, reduced over
//   N*H*W positions. A block owns one tap and a TI x TO tile of (i, o) (128
//   x 128 at the hidden widths) and walks a segment of positions, KP at a
//   time, through shared memory; each thread holds an 8 x 8 register tile
//   fed by float4 reads. Per chunk, 2 KP threads first resolve each
//   position's source row (ring row or x row, reflect column by channel
//   parity), so that staging is a plain indexed load per value. Segments split the reduction so
//   that the narrow layers still fill the card. The reduction is
//   deterministic: each block writes its partial once, and a second small
//   kernel sums the partials in a fixed order (no float atomicAdd). db is
//   summed in the same pass by the blocks of tap 0 and the first i tile.
//   No tensor cores (wgmma) and no TMA yet: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;        // B2: output rows per block
constexpr int TW = 16;       // B2: output cols per block
constexpr int KC = 16;       // B2: gz channels per shared-memory chunk
constexpr int PX = 4;        // B2: consecutive output pixels per thread
constexpr int CG = 8;        // B2: channel groups per block
constexpr int THREADS = CG * (TH * TW / PX);  // 256
constexpr int KP = 32;       // B3: positions per shared-memory chunk

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

// acc[q] += sum_o g[o] * kt[o * C4 + g0 + q] for the channels g0 + q < C4:
// one gz pixel (C4o values) against one khat tap (C4o x C4).
template <typename T, int TN>
__device__ __forceinline__ void pixel_dot(float (&acc)[TN],
                                          const T* __restrict__ g,
                                          const T* __restrict__ kt, int C4o,
                                          int C4, int g0) {
  for (int o = 0; o < C4o; ++o) {
    const float gv = to_f32(g[o]);
    const T* kp = kt + (size_t)o * C4 + g0;
#pragma unroll
    for (int q = 0; q < TN; ++q)
      if (g0 + q < C4) acc[q] = fmaf(gv, to_f32(kp[q]), acc[q]);
  }
}

// ---------------------------------------------------------------- B2
template <typename T, int TN>
__global__ void __launch_bounds__(THREADS)
    grad_input_kernel(const T* __restrict__ gz, const T* __restrict__ khat,
                      T* __restrict__ dx, int H, int W, int C4o, int C4,
                      int tiles_w) {
  constexpr int TCO = CG * TN;
  __shared__ float gs[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][KC][TCO];

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int n = blockIdx.z;

  const int tc = tid % CG;
  const int tp = tid / CG;
  const int ty = tp / (TW / PX);
  const int tx = (tp % (TW / PX)) * PX;

  const T* gn = gz + (size_t)n * H * W * C4o;
  const size_t tap_stride = (size_t)C4o * C4;

  float acc[PX][TN];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[j][q] = 0.f;

  for (int ci0 = 0; ci0 < C4o; ci0 += KC) {
    // ---- stage the gz tile with a one-pixel ZERO halo (SAME-zero conv)
    for (int idx = tid; idx < KC * (TH + 2) * (TW + 2); idx += THREADS) {
      const int ci = idx % KC;
      const int pix = idx / KC;
      const int cc = pix % (TW + 2);
      const int rr = pix / (TW + 2);
      const int o = ci0 + ci;
      const int rg = r0 - 1 + rr;
      const int cg = c0 - 1 + cc;
      float v = 0.f;
      if (o < C4o && rg >= 0 && rg < H && cg >= 0 && cg < W)
        v = to_f32(gn[((size_t)rg * W + cg) * C4o + o]);
      gs[ci][rr][cc] = v;
    }
    // ---- stage the 9 x KC x TCO khat chunk (zeros past C4o / C4)
    for (int idx = tid; idx < 9 * KC * TCO; idx += THREADS) {
      const int co = idx % TCO;
      const int ci = (idx / TCO) % KC;
      const int tap = idx / (TCO * KC);
      const int o = ci0 + ci;
      const int g = co0 + co;
      float v = 0.f;
      if (o < C4o && g < C4) v = to_f32(khat[tap * tap_stride + (size_t)o * C4 + g]);
      ws[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll 4
      for (int ci = 0; ci < KC; ++ci) {
        float a[PX + 2];
#pragma unroll
        for (int m = 0; m < PX + 2; ++m) a[m] = gs[ci][ty + dr][tx + m];
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          float w[TN];
          const float* wp = &ws[dr * 3 + dc][ci][tc * TN];
          if constexpr (TN % 4 == 0) {
#pragma unroll
            for (int q = 0; q < TN; q += 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(wp + q);
              w[q] = w4.x; w[q + 1] = w4.y; w[q + 2] = w4.z; w[q + 3] = w4.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < TN; ++q) w[q] = wp[q];
          }
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              acc[j][q] = fmaf(a[j + dc], w[q], acc[j][q]);
        }
      }
    }
    __syncthreads();
  }

  const int r = r0 + ty;
  if (r >= H) return;
  const int C = C4 / 4;
  const int cb = c0 + tx;           // this thread's first column
  const int g0 = co0 + tc * TN;     // this thread's first dx channel

  // ---- adjoint of the ring COLUMNS (interior rows r-1..r+1 of gz)
  const bool need_l = cb <= 1;
  const bool need_r = cb <= W - 1 && cb + PX - 1 >= W - 2;
  if (need_l || need_r) {
    float vl[TN], vr[TN];
#pragma unroll
    for (int q = 0; q < TN; ++q) vl[q] = vr[q] = 0.f;
    for (int e = 0; e < 3; ++e) {
      const int rr = r - 1 + e;
      if (rr < 0 || rr >= H) continue;
      if (need_l)
        pixel_dot<T, TN>(vl, gn + (size_t)rr * W * C4o,
                         khat + (e * 3 + 2) * tap_stride, C4o, C4, g0);
      if (need_r)
        pixel_dot<T, TN>(vr, gn + ((size_t)rr * W + W - 1) * C4o,
                         khat + (e * 3 + 0) * tap_stride, C4o, C4, g0);
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int c = cb + j;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const bool sj0 = (((g0 + q) / C) & 1) == 0;
        if (need_l && ((c == 1 && sj0) || (c == 0 && !sj0))) acc[j][q] += vl[q];
        if (need_r && ((c == W - 1 && sj0) || (c == W - 2 && !sj0)))
          acc[j][q] += vr[q];
      }
    }
  }

  // ---- adjoint of the ring ROWS: top from gz row 0 with khat[2, :],
  // bottom from gz row H-1 with khat[0, :], each with its corner columns
  for (int side = 0; side < 2; ++side) {
    const bool top = side == 0;
    if (top ? r > 1 : r < H - 2) continue;
    const int kr = top ? 2 : 0;
    const T* grow = gn + (size_t)(top ? 0 : H - 1) * W * C4o;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int c = cb + j;
      if (c >= W) continue;
      float v[TN];
#pragma unroll
      for (int q = 0; q < TN; ++q) v[q] = 0.f;
      for (int f = 0; f < 3; ++f) {
        const int cc = c - 1 + f;
        if (cc < 0 || cc >= W) continue;
        pixel_dot<T, TN>(v, grow + (size_t)cc * C4o,
                         khat + (kr * 3 + f) * tap_stride, C4o, C4, g0);
      }
      if (c <= 1 || c >= W - 2) {  // corners, scattered by the column rule
        float cl[TN], cr[TN];
#pragma unroll
        for (int q = 0; q < TN; ++q) cl[q] = cr[q] = 0.f;
        if (c <= 1)
          pixel_dot<T, TN>(cl, grow, khat + (kr * 3 + 2) * tap_stride, C4o,
                           C4, g0);
        if (c >= W - 2)
          pixel_dot<T, TN>(cr, grow + (size_t)(W - 1) * C4o,
                           khat + (kr * 3 + 0) * tap_stride, C4o, C4, g0);
#pragma unroll
        for (int q = 0; q < TN; ++q) {
          const bool sj0 = (((g0 + q) / C) & 1) == 0;
          if ((c == 1 && sj0) || (c == 0 && !sj0)) v[q] += cl[q];
          if ((c == W - 1 && sj0) || (c == W - 2 && !sj0)) v[q] += cr[q];
        }
      }
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const bool si0 = ((g0 + q) / C) < 2;
        const bool hit = top ? ((r == 1 && si0) || (r == 0 && !si0))
                             : ((r == H - 1 && si0) || (r == H - 2 && !si0));
        if (hit) acc[j][q] += v[q];
      }
    }
  }

  T* drow = dx + ((size_t)n * H + r) * W * C4;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int c = cb + j;
    if (c >= W) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q)
      if (g0 + q < C4) drow[(size_t)c * C4 + g0 + q] = from_f32<T>(acc[j][q]);
  }
}

template <typename T>
int launch_grad_input(const void* gz, const void* khat, void* dx, int N,
                      int H, int W, int C4o, int C4, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_w * ((H + TH - 1) / TH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gp = static_cast<const T*>(gz);
  const T* kp = static_cast<const T*>(khat);
  T* dp = static_cast<T*>(dx);
  if (C4 <= 2 * CG) {  // the 12-wide dx of an image layer
    dim3 grid(tiles, (C4 + 2 * CG - 1) / (2 * CG), N);
    grad_input_kernel<T, 2><<<grid, THREADS, 0, s>>>(gp, kp, dp, H, W, C4o,
                                                     C4, tiles_w);
  } else {
    dim3 grid(tiles, (C4 + 8 * CG - 1) / (8 * CG), N);
    grad_input_kernel<T, 8><<<grid, THREADS, 0, s>>>(gp, kp, dp, H, W, C4o,
                                                     C4, tiles_w);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- B3
// One block: tap blockIdx.y, the (i, o) tile blockIdx.x, the position
// segment blockIdx.z. Writes its partial sums to dk_part[segment][tap] and,
// for tap 0 and the first i tile, db_part[segment]. 256 threads as a 16 x 16
// grid, each with an RI x RO register tile.
template <typename T, int TI, int TO>
__global__ void __launch_bounds__(256)
    grad_weight_partial(const T* __restrict__ x, const T* __restrict__ rings,
                        const T* __restrict__ gz, float* __restrict__ dk_part,
                        float* __restrict__ db_part, int H, int W, int C4,
                        int C4o, long P, int tiles_o, int seg_len) {
  constexpr int RI = TI / 16;
  constexpr int RO = TO / 16;
  static_assert(256 % TI == 0 && 256 % TO == 0, "a thread stages one channel");
  __shared__ __align__(16) float xs[KP][TI];
  __shared__ __align__(16) float gs[KP][TO];
  // the source row of each chunk position, per sub-column parity of the
  // channel (the reflect ring columns differ by it); null past the segment
  __shared__ const T* src_row[KP][2];

  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_o) * TI;
  const int o0 = (blockIdx.x % tiles_o) * TO;
  const int tap = blockIdx.y;
  const int dr = tap / 3, dc = tap % 3;
  const int seg = blockIdx.z;
  const long p_begin = (long)seg * seg_len;
  const long p_end = p_begin + seg_len < P ? p_begin + seg_len : P;
  const long HW = (long)H * W;
  const bool do_db = tap == 0 && i0 == 0;
  const int ti = tid / 16, to = tid % 16;
  // each thread stages one x channel and one gz channel of every chunk
  const int xi = tid % TI, xk0 = tid / TI;
  const int i = i0 + xi;
  const int parity = i < C4 ? ((i / (C4 / 4)) & 1) : 0;
  const int go = tid % TO, gk0 = tid / TO;

  float acc[RI][RO];
#pragma unroll
  for (int u = 0; u < RI; ++u)
#pragma unroll
    for (int v = 0; v < RO; ++v) acc[u][v] = 0.f;
  float dbacc = 0.f;

  for (long pb = p_begin; pb < p_end; pb += KP) {
    // ---- where the tap's window of the ring-padded x reads, per position
    if (tid < 2 * KP) {
      const int k = tid / 2, par = tid % 2;
      const long p = pb + k;
      const T* row = nullptr;
      if (p < p_end) {
        const int n = (int)(p / HW);
        const int rem = (int)(p % HW);
        const int rg = rem / W + dr - 1;
        const int cg = rem % W + dc - 1;
        int cs = cg;  // sub-column 0 ({0, 2}) is parity 0
        if (cg < 0) cs = par == 0 ? 1 : 0;
        else if (cg == W) cs = par == 0 ? W - 1 : W - 2;
        if (rg < 0) row = rings + ((size_t)n * 2 * W + cs) * C4;
        else if (rg == H) row = rings + (((size_t)n * 2 + 1) * W + cs) * C4;
        else row = x + (((size_t)n * H + rg) * W + cs) * C4;
      }
      src_row[k][par] = row;
    }
    __syncthreads();
    for (int k = xk0; k < KP; k += 256 / TI) {
      const T* row = src_row[k][parity];
      xs[k][xi] = (row != nullptr && i < C4) ? to_f32(row[i]) : 0.f;
    }
    for (int k = gk0; k < KP; k += 256 / TO) {
      const long p = pb + k;
      const int o = o0 + go;
      gs[k][go] = (p < p_end && o < C4o) ? to_f32(gz[(size_t)p * C4o + o])
                                          : 0.f;
    }
    __syncthreads();
    if (do_db && tid < TO) {
#pragma unroll 8
      for (int k = 0; k < KP; ++k) dbacc += gs[k][tid];
    }
#pragma unroll 4
    for (int k = 0; k < KP; ++k) {
      float a[RI], b[RO];
      if constexpr (RI % 4 == 0) {
#pragma unroll
        for (int u = 0; u < RI; u += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&xs[k][ti * RI + u]);
          a[u] = v4.x; a[u + 1] = v4.y; a[u + 2] = v4.z; a[u + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < RI; ++u) a[u] = xs[k][ti * RI + u];
      }
      if constexpr (RO % 4 == 0) {
#pragma unroll
        for (int v = 0; v < RO; v += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&gs[k][to * RO + v]);
          b[v] = v4.x; b[v + 1] = v4.y; b[v + 2] = v4.z; b[v + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int v = 0; v < RO; ++v) b[v] = gs[k][to * RO + v];
      }
#pragma unroll
      for (int u = 0; u < RI; ++u)
#pragma unroll
        for (int v = 0; v < RO; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

  float* out = dk_part + ((size_t)seg * 9 + tap) * C4 * C4o;
#pragma unroll
  for (int u = 0; u < RI; ++u) {
    const int ii = i0 + ti * RI + u;
    if (ii >= C4) continue;
#pragma unroll
    for (int v = 0; v < RO; ++v) {
      const int o = o0 + to * RO + v;
      if (o < C4o) out[(size_t)ii * C4o + o] = acc[u][v];
    }
  }
  if (do_db && tid < TO && o0 + tid < C4o)
    db_part[(size_t)seg * C4o + o0 + tid] = dbacc;
}

// dk[e] = sum over segments s = 0..S-1, in that order, of dk_part[s][e];
// the same for db.
__global__ void grad_weight_reduce(const float* __restrict__ dk_part,
                                   const float* __restrict__ db_part,
                                   float* __restrict__ dk,
                                   float* __restrict__ db, int S, long K,
                                   int C4o) {
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < K + C4o;
       e += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < K) {
      for (int t = 0; t < S; ++t) s += dk_part[(size_t)t * K + e];
      dk[e] = s;
    } else {
      const long o = e - K;
      for (int t = 0; t < S; ++t) s += db_part[(size_t)t * C4o + o];
      db[o] = s;
    }
  }
}

template <typename T, int TI, int TO>
void launch_partial(const T* x, const T* rings, const T* gz, float* dk,
                    float* db, int H, int W, int C4, int C4o, long P, int S,
                    int seg_len, cudaStream_t s) {
  const int tiles_o = (C4o + TO - 1) / TO;
  dim3 grid(((C4 + TI - 1) / TI) * tiles_o, 9, S);
  grad_weight_partial<T, TI, TO><<<grid, 256, 0, s>>>(
      x, rings, gz, dk, db, H, W, C4, C4o, P, tiles_o, seg_len);
}

template <typename T>
int launch_grad_weight(const void* x, const void* rings, const void* gz,
                       void* dk, void* db, void* dk_part, void* db_part,
                       int N, int H, int W, int C4, int C4o, int seg_len,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = (long)N * H * W;
  const int S = (int)((P + seg_len - 1) / seg_len);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(rings);
  const T* gp = static_cast<const T*>(gz);
  // one segment: the partial IS the result
  float* kout = static_cast<float*>(S == 1 ? dk : dk_part);
  float* bout = static_cast<float*>(S == 1 ? db : db_part);
  // tile widths 16 for the 12-wide image sides, 128 otherwise (the wrapper
  // sizes the segments with the same rule)
  if (C4 <= 16 && C4o <= 16)
    launch_partial<T, 16, 16>(xp, rp, gp, kout, bout, H, W, C4, C4o, P, S,
                              seg_len, s);
  else if (C4 <= 16)
    launch_partial<T, 16, 128>(xp, rp, gp, kout, bout, H, W, C4, C4o, P, S,
                               seg_len, s);
  else if (C4o <= 16)
    launch_partial<T, 128, 16>(xp, rp, gp, kout, bout, H, W, C4, C4o, P, S,
                               seg_len, s);
  else
    launch_partial<T, 128, 128>(xp, rp, gp, kout, bout, H, W, C4, C4o, P, S,
                                seg_len, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long K = 9L * C4 * C4o;
  long blocks = (K + C4o + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  grad_weight_reduce<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(db_part),
      static_cast<float*>(dk), static_cast<float*>(db), S, K, C4o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors; `stream` is a cudaStream_t. Each returns the cudaError_t of its
// launches.
//
// B2: gz (N, H, W, C4o), khat (3, 3, C4o, C4), dx (N, H, W, C4), all of T.
extern "C" int rpst_folded_conv_grad_input_f32(const void* gz,
                                               const void* khat, void* dx,
                                               int N, int H, int W, int C4o,
                                               int C4, void* stream) {
  return launch_grad_input<float>(gz, khat, dx, N, H, W, C4o, C4, stream);
}

extern "C" int rpst_folded_conv_grad_input_bf16(const void* gz,
                                                const void* khat, void* dx,
                                                int N, int H, int W, int C4o,
                                                int C4, void* stream) {
  return launch_grad_input<__nv_bfloat16>(gz, khat, dx, N, H, W, C4o, C4,
                                          stream);
}

// B3: x (N, H, W, C4), rings (N, 2, W, C4), gz (N, H, W, C4o) of T; dk
// (3, 3, C4, C4o) and db (C4o,) float. The N*H*W positions are cut into
// S = ceil(N*H*W / seg_len) segments; for S > 1, dk_part (S, 9*C4*C4o) and
// db_part (S, C4o) are float scratch (unused, may be null, for S == 1).
extern "C" int rpst_folded_conv_grad_weight_f32(
    const void* x, const void* rings, const void* gz, void* dk, void* db,
    void* dk_part, void* db_part, int N, int H, int W, int C4, int C4o,
    int seg_len, void* stream) {
  return launch_grad_weight<float>(x, rings, gz, dk, db, dk_part, db_part, N,
                                   H, W, C4, C4o, seg_len, stream);
}

extern "C" int rpst_folded_conv_grad_weight_bf16(
    const void* x, const void* rings, const void* gz, void* dk, void* db,
    void* dk_part, void* db_part, int N, int H, int W, int C4, int C4o,
    int seg_len, void* stream) {
  return launch_grad_weight<__nv_bfloat16>(x, rings, gz, dk, db, dk_part,
                                           db_part, N, H, W, C4, C4o, seg_len,
                                           stream);
}

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
// 128->128 folded layer is 19.3 GFLOP for each of them with a dense folded
// kernel (4.83 GFLOP of it non-zero), against 495 TFLOP/s of TF32 or 67
// TFLOP/s of float32 FMA on an H100 SXM at 700 W (data sheet); the tensors
// they read and write are tens of MB. So they are bound by arithmetic, as
// long as each value staged in shared memory is reused many times.
//
// What the designs do about it.
//   B2 runs on the tensor cores: B1's main loop (folded_mma.cuh) over the
//   zero-padded gz with khat, skipping khat's zero blocks as B1 skips kf's,
//   and the ring adjoint as four more mma row blocks of the same loop (the
//   ring rows above and below, the ring columns left and right, in the
//   tiles that touch them), added to the outputs they land on through
//   shared memory in the epilogue. dx is written once, with no atomics.
//   B3 is a GEMM per tap on the CUDA cores, dk[tap] = window_tap(xpad)^T .
//   gz, reduced over N*H*W positions. A block owns one tap and a TI x TO
//   tile of (i, o) (128 x 128 at the hidden widths) and walks a segment of
//   positions, KP at a time, through shared memory; each thread holds an 8
//   x 8 register tile fed by float4 reads. Per chunk, 2 KP threads first
//   resolve each position's source row (ring row or x row, reflect column
//   by channel parity), so that staging is a plain indexed load per value.
//   Segments split the reduction so that the narrow layers still fill the
//   card. The reduction is deterministic: each block writes its partial
//   once, and a second small kernel sums the partials in a fixed order (no
//   float atomicAdd). db is summed in the same pass by the blocks of tap 0
//   and the first i tile. No tensor cores (wgmma) and no TMA for B3 yet.

#include "folded_mma.cuh"

namespace {

constexpr int KP = 32;       // B3: positions per shared-memory chunk

using folded::to_f32;

// B2: bf16 two blocks per SM, two cp.async stages, as B1; float32 one block
// per SM (the ring blocks' accumulators beside the split operands take ~190
// registers), three stages
template <typename T>
int launch_grad_input(const void* gz, const void* khat, void* wp, void* bits,
                      void* dx, int N, int H, int W, int C4o, int C4,
                      void* stream) {
  folded::Args<T> a{};
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
// B2: gz (N, H, W, C4o) and dx (N, H, W, C4) of T; khat (3, 3, C4o, C4) of
// T; wp scratch of 9 * ceil(C4o / KE) * C4 * KE T (KE = 8 float or 16 bf16)
// and bits scratch of 9 uint32, filled by the launch with khat packed
// K-major and its non-zero block table. cudaErrorInvalidValue for a shape
// it refuses (H, W >= 2, channels multiples of 4).
extern "C" int rpst_folded_conv_grad_input_f32(const void* gz,
                                               const void* khat, void* wp,
                                               void* bits, void* dx, int N,
                                               int H, int W, int C4o, int C4,
                                               void* stream) {
  return launch_grad_input<float>(gz, khat, wp, bits, dx, N, H, W, C4o, C4,
                                  stream);
}

extern "C" int rpst_folded_conv_grad_input_bf16(const void* gz,
                                                const void* khat, void* wp,
                                                void* bits, void* dx, int N,
                                                int H, int W, int C4o,
                                                int C4, void* stream) {
  return launch_grad_input<__nv_bfloat16>(gz, khat, wp, bits, dx, N, H, W,
                                          C4o, C4, stream);
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

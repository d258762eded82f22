// B1 on Hopper: reflect-ring pad + 3x3 folded conv + bias + leaky ReLU, on
// the tensor cores.
//
// Replaces the TPU kernel `fused_folded_conv` in
// src/rpst/ops/pallas/folded_conv.py (wrapper :650, body `_make_kernel` :40).
// It computes, on the folded (space-to-depth) NHWC tensor,
//
//   y = lrelu_alpha(conv3x3(reflect_pad1(x)) + b)
//
// with x (N, Hf, Wf, 4C), the folded kernel k (3, 3, 4C, 4Co) HWIO, the bias
// (4Co,) and y (N, Hf, Wf, 4Co) in x's type (float or bfloat16). The two
// reflect ring ROWS are read from x as rpst_torch.ops.folded._row_ring builds
// them (row -1: the sub-row-0 channel blocks {0, 1} from row 1, {2, 3} from
// row 0; row Hf from Hf-1 and Hf-2), or a caller overrides them with
// `rings` (N, 2, Wf, 4C): row 0 is read as the row above x, row 1 as the
// row below. The reflect
// ring COLUMNS are built here while the halo is staged: folded column -1
// takes its sub-column-0 channel blocks {0, 2} from column 1 and its
// sub-column-1 blocks {1, 3} from column 0; column Wf takes them from Wf-1
// and Wf-2. A channel g lies in a sub-column-0 block when (g / C) % 2 == 0.
// Corners follow from applying the column rule to the ring rows, as
// ops/folded.py's folded_reflect_pad does.
//
// The main loop is folded_mma.cuh's (shared with B2): an implicit GEMM on
// `mma.sync` (bf16 m16n8k16; float32 as three TF32 m16n8k8 products) that
// takes only the listed non-zero blocks of the folded kernel, so a kernel
// made by fold_conv_kernel costs the MACs of the unfolded conv. What bounds
// it and what the design does about it are set out there. Each launch first
// packs the kernel and lists its non-zero blocks on the device (a small
// kernel into scratch the wrapper passes), then runs the main kernel.

#include "folded_mma.cuh"

namespace {

// bf16 and float32 alike: two 85 KB blocks per SM (two cp.async stages)
template <typename T>
int launch(const void* x, const void* rings, const void* k, void* wp,
           void* bits, const void* b, void* y, int N, int H, int W, int C4,
           int C4o, float alpha, void* stream) {
  folded::Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.rings = static_cast<const T*>(rings);
  a.bias = static_cast<const T*>(b);
  a.y = static_cast<T*>(y);
  a.H = H;
  a.W = W;
  a.C4in = C4;
  a.C4out = C4o;
  a.alpha = alpha;
  return folded::launch<T, false, 2, 2>(
      a, static_cast<const T*>(k), static_cast<T*>(wp),
      static_cast<unsigned*>(bits), N, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// tensors; `stream` is a cudaStream_t. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape it refuses: H, W >= 2, 4C and 4Co
// multiples of 4).
//
// x (N, H, W, 4C) of T; rings (N, 2, W, 4C) of T, or null for the reflect
// ring rows of x; k the folded kernel (3, 3,
// 4C, 4Co) HWIO of T; wp scratch of 9 * ceil(4C / KE) * 4Co * KE T (KE = 8
// float or 16 bf16 channels: 32 bytes) and bits scratch of 9 uint32, which
// the launch fills with k packed K-major and its non-zero block table ahead
// of the main kernel; b (4Co,) and y (N, H, W, 4Co) of T.
extern "C" int rpst_folded_conv_f32(const void* x, const void* rings,
                                    const void* k, void* wp, void* bits,
                                    const void* b, void* y, int N, int H,
                                    int W, int C4, int C4o, float alpha,
                                    void* stream) {
  return launch<float>(x, rings, k, wp, bits, b, y, N, H, W, C4, C4o, alpha,
                       stream);
}

extern "C" int rpst_folded_conv_bf16(const void* x, const void* rings,
                                     const void* k, void* wp, void* bits,
                                     const void* b, void* y, int N, int H,
                                     int W, int C4, int C4o, float alpha,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, rings, k, wp, bits, b, y, N, H, W, C4, C4o,
                               alpha, stream);
}

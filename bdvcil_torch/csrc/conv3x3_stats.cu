// 3x3 convolution with an affine+relu prologue and a BatchNorm-statistics
// epilogue, for Hopper: the bottleneck's conv2 in the block-fused schedule.
//
// Replaces both Pallas kernels of bdvcil_tpu/ops/block_fused.py behind
// conv3x3_affine_relu_stats (:227, call :170):
//   _conv3x3_affine_stats_kernel (:110)         nine accumulated tap dots
//   _conv3x3_im2col_affine_stats_kernel (:139)  one K = 9C dot
// They compute one function and differ only in how the TPU's matrix unit is
// tiled; this kernel serves both variant names:
//   xh = bf16(relu(f32(x) * a + b))      x (NT, H, W, C) bf16, a, b (C,) f32
//   y  = conv3x3(pad(xh, 1), w)          stride 1, 'SAME', w (3, 3, C, N) HWIO
//   s1, s2 = per-channel sum(y), sum(y^2) over the rounded bf16 y
// Note the halo: the reference pads xh, not x, so the border reads zero and
// not relu(b).
//
// As an implicit GEMM: M = NT*H*W output pixels, K = 9*C in the order
// (dy, dx, c), which is w.reshape(9*C, N), N = Cout. The A tile is never
// materialized: the Im2colA loader copies each BK-slice (one tap, 2*BK
// contiguous bytes per pixel) from x with cp.async, zero-filled outside the
// image, and the prologue rewrites only the rows inside the image.
//
// Bound: at layer1 (128 x 56 x 56, 64 -> 64) the bytes (x and y once, 102.8
// MB) and the operations (29.6 GFLOP) weigh about the same on the card. x is
// read nine times by the taps, from L2 after the first: neighbouring output
// rows of a tile share most of their source pixels. The tiles, ring and
// epilogue are gemm_stats.cuh's.

#include "gemm_stats.cuh"

extern "C" {

int bdv_conv3x3_stats_block_k() { return BK; }
int bdv_conv3x3_stats_block_n() { return BN; }
int bdv_conv3x3_stats_block_m() { return BM; }

// x (NT, H, W, C), w (9*C, N), y (NT, H, W, N): bf16, contiguous. a, b: (C,)
// f32. part: (2, ceil(NT*H*W / BM), N) f32 scratch. stats: (2, N) f32.
int bdv_conv3x3_affine_relu_stats(const void* x, const void* w, const void* a, const void* b,
                                  void* y, void* part, void* stats, long long NT, int H, int W,
                                  int C, int N, void* stream) {
  if (NT <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || C % BK != 0 || N % BN != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y) || !aligned16(a) || !aligned16(b))
    return (int)cudaErrorMisalignedAddress;
  const long long M = NT * H * W;
  Im2colA loader;
  loader.x = static_cast<const bf16*>(x);
  loader.M = (int64_t)M;
  loader.H = H;
  loader.W = W;
  loader.C = C;
  return (int)launch_gemm_stats<Im2colA, true>(loader, w, a, b, y, part, stats, M, 9 * C, N,
                                               static_cast<cudaStream_t>(stream));
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

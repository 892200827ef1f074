// 1x1 convolution as a GEMM with a BatchNorm-statistics epilogue, for Hopper.
//
// Replaces these Pallas kernels, all the same GEMM over (M, K) x (K, N) with
// M = N*T*H*W rows of an NHWC activation, so a 1x1 conv reads x in place:
//   _kernel4 of bdvcil_tpu/ops/conv1x1_bn.py (:164), called by
//     conv1x1_with_stats -> _conv1x1_with_stats_impl (:190);
//   _kernel of bdvcil_tpu/ops/conv1x1_bn.py (:37), called by gemm_with_stats
//     -> _gemm_with_stats_impl (:59), the 2-D form (M zero-padded to the
//     tile there; masked here);
//   _plain_stats_gemm_kernel of bdvcil_tpu/ops/block_fused.py (:96), the
//     bottleneck's conv1 (block_fused.conv1x1_stats, call :170);
//   _affine_stats_gemm_kernel of bdvcil_tpu/ops/block_fused.py (:73), the
//     bottleneck's conv3: y = bf16(relu(f32(x) * a + b)) @ w, the previous
//     BatchNorm's normalize and relu as a prologue (conv1x1_affine_relu_stats).
//
// Bound: at the ResNet-50 shapes (K, N from 64 to 2048) the product is
// compute-bound for the wide layers and byte-bound for the 64-channel ones.
// The kernel itself (tiles, ring, prologue, deterministic two-pass
// statistics) is gemm_stats.cuh with the RowsA loader.

#include "gemm_stats.cuh"

namespace {

int check_args(const void* x, const void* w, const void* y, long long M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

extern "C" {

int bdv_conv1x1_stats_block_m() { return BM; }
int bdv_conv1x1_stats_block_n() { return BN; }
int bdv_conv1x1_stats_block_k() { return BK; }

// x (M, K), w (K, N), y (M, N): bf16, row-major, contiguous.
// part: (2, ceil(M / BM), N) f32 scratch. stats: (2, N) f32 = [sum y; sum y^2].
int bdv_conv1x1_with_stats(const void* x, const void* w, void* y, void* part, void* stats,
                           long long M, int K, int N, void* stream) {
  if (int bad = check_args(x, w, y, M, K, N)) return bad;
  const RowsA loader{static_cast<const bf16*>(x), (int64_t)M, K};
  return (int)launch_gemm_stats<RowsA, false>(loader, w, nullptr, nullptr, y, part, stats, M, K,
                                              N, static_cast<cudaStream_t>(stream));
}

// The same with the prologue x -> bf16(relu(x * a + b)); a, b: (K,) f32.
int bdv_conv1x1_affine_relu_stats(const void* x, const void* w, const void* a, const void* b,
                                  void* y, void* part, void* stats, long long M, int K, int N,
                                  void* stream) {
  if (int bad = check_args(x, w, y, M, K, N)) return bad;
  if (!aligned16(a) || !aligned16(b)) return (int)cudaErrorMisalignedAddress;
  const RowsA loader{static_cast<const bf16*>(x), (int64_t)M, K};
  return (int)launch_gemm_stats<RowsA, true>(loader, w, a, b, y, part, stats, M, K, N,
                                             static_cast<cudaStream_t>(stream));
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// 1x1 convolution as a GEMM with a BatchNorm-statistics epilogue, for Hopper:
// the bf16 forms (float32 runs in gemm_stats_tf32.cu).
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
// All four run on the persistent wgmma core of gemm_stats_sm90.cuh: x and w
// come by TMA into a multi-stage mbarrier ring, y and the statistics come out
// of the registers, and the statistics finish sums one partial per CTA. The
// prologue variant (#7) applies bf16(relu(x * a + b)) to each A tile in the
// ring stage, in the consumer warpgroups, after the TMA has landed it: the
// previous BatchNorm's normalize rides on the tile already loaded, instead of
// taking a pass of its own over device memory.

#include "gemm_stats_sm90.cuh"

namespace {

using sm90::aligned16;
using sm90::bf16;

// K and N: multiples of 8 (the TMA's 16-byte strides)
int check_args(const void* x, const void* w, const void* y, long long M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (M > (1ll << 31) - sm90::BM) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

sm90::Problem problem(const void* x, void* y, void* part, long long M, int K, int N) {
  sm90::Problem p{};
  p.x = static_cast<const bf16*>(x);
  p.y = static_cast<bf16*>(y);
  p.part = static_cast<float*>(part);
  p.M = (int)M;
  p.K = K;
  p.N = N;
  return p;
}

}  // namespace

extern "C" {

// the plan the wgmma core makes for an (M, K, N) 1x1 on `sms` SMs (the 3x3
// starts from it): out = {block_n, m_tiles, n_tiles, tiles, grid}
int bdv_wgmma_stats_plan(long long M, int K, int N, int sms, int* out) {
  if (M <= 0 || K <= 0 || N <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const sm90::Plan p = sm90::make_plan(M, N, sms, (K + sm90::BK - 1) / sm90::BK);
  out[0] = p.block_n; out[1] = p.m_tiles; out[2] = p.n_tiles; out[3] = p.tiles; out[4] = p.grid;
  return 0;
}

// x (M, K), w (K, N), y (M, N): bf16, row-major, contiguous; K % 8 == 0,
// N % 8 == 0. part: (2, part_rows, N) f32 scratch, one row per persistent
// CTA; the grid has at most part_rows CTAs (pass the device's SM count).
// stats: (2, N) f32 = [sum y; sum y^2].
int bdv_conv1x1_with_stats(const void* x, const void* w, void* y, void* part, int part_rows,
                           void* stats, long long M, int K, int N, void* stream) {
  if (int bad = check_args(x, w, y, M, K, N)) return bad;
  return (int)sm90::launch_wgmma_stats<sm90::ALoad::kRows>(
      problem(x, y, part, M, K, N), part_rows, w, stats, static_cast<cudaStream_t>(stream));
}

// The same with the prologue x -> bf16(relu(x * a + b)); K % 8 == 0, N % 8
// == 0; a, b: (K,) f32, 16-byte aligned.
int bdv_conv1x1_affine_relu_stats(const void* x, const void* w, const void* a, const void* b,
                                  void* y, void* part, int part_rows, void* stats, long long M,
                                  int K, int N, void* stream) {
  if (int bad = check_args(x, w, y, M, K, N)) return bad;
  if (!aligned16(a) || !aligned16(b)) return (int)cudaErrorMisalignedAddress;
  sm90::Problem p = problem(x, y, part, M, K, N);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  return (int)sm90::launch_wgmma_stats<sm90::ALoad::kRowsAffine>(
      p, part_rows, w, stats, static_cast<cudaStream_t>(stream));
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// 1x1 convolution as a GEMM with a BatchNorm-statistics epilogue, for Hopper.
//
// Replaces the Pallas kernel _kernel4 of bdvcil_tpu/ops/conv1x1_bn.py (:164),
// called by conv1x1_with_stats -> _conv1x1_with_stats_impl (:190):
//   y  = x @ w               x (M, K) bf16, w (K, N) bf16, f32 accumulation,
//                            y rounded to bf16
//   s1 = sum_rows(y)         per output channel, f32, over the ROUNDED y
//   s2 = sum_rows(y * y)
// where M = N*T*H*W of an NHWC activation, so a 1x1 conv reads x in place.
//
// Bound: at the ResNet-50 shapes (K, N from 64 to 2048) the product is
// compute-bound for the wide layers and byte-bound for the 64-channel ones.
// This first version is a plain tiled tensor-core GEMM: each CTA computes a
// 128 x 64 tile of y with WMMA bf16 16x16x16 products (mma.sync underneath),
// K streamed through a two-stage cp.async ring in shared memory. TMA and
// wgmma, which the card needs for its full rate, are later work.
//
// What the epilogue keeps out of device memory: the statistics ride along
// while the tile is on chip. The accumulator tile goes to shared memory; each
// value is rounded to bf16, stored to y, and the rounded value is summed per
// column over the tile's valid rows into a per-row-tile partial (grid_m, N).
// Rows past M are never loaded (zero-filled in shared memory), never stored
// and never summed: the ragged edge is masked, not padded. A second small
// kernel sums the partials per column in a fixed order, so the statistics are
// deterministic; there are no float atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 128;            // 4 warps as 2 x 2, each a 64 x 32 sub-tile
constexpr int A_LD = BK + 8;             // padded row pitch (elements) against bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;             // f32 epilogue tile pitch
constexpr int A_STAGE = BM * A_LD;       // elements per stage
constexpr int B_STAGE = BK * B_LD;
constexpr int AB_BYTES = 2 * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int C_BYTES = BM * C_LD * (int)sizeof(float);
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

static_assert(kThreads == 2 * BN, "the column-sum split assumes two threads per column");

struct alignas(16) Pack8 {
  bf16 v[8];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One K-slice of A (BM x BK) and B (BK x BN) into shared memory.
__device__ __forceinline__ void load_stage(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                           bf16* As, bf16* Bs, int64_t m0, int n0, int k0,
                                           int64_t M, int K, int N, int tid) {
#pragma unroll
  for (int it = 0; it < (BM * BK / 8) / kThreads; ++it) {
    const int chunk = tid + it * kThreads;
    const int r = chunk / (BK / 8);
    const int cc = (chunk % (BK / 8)) * 8;
    const int64_t gr = m0 + r;
    const bool ok = gr < M;
    const bf16* src = x + (ok ? gr : 0) * (int64_t)K + k0 + cc;
    cp_async16(As + r * A_LD + cc, src, ok);
  }
#pragma unroll
  for (int it = 0; it < (BK * BN / 8) / kThreads; ++it) {
    const int chunk = tid + it * kThreads;
    const int r = chunk / (BN / 8);
    const int cc = (chunk % (BN / 8)) * 8;
    cp_async16(Bs + r * B_LD + cc, w + (int64_t)(k0 + r) * N + n0 + cc, true);
  }
}

__global__ void __launch_bounds__(kThreads)
conv1x1_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ y, float* __restrict__ part, int64_t M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[2][2][BN];  // [s1 | s2][row half][column]
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int n0 = blockIdx.x * BN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = K / BK;
  load_stage(x, w, As, Bs, m0, n0, 0, M, K, N, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_stage(x, w, As + (cur ^ 1) * A_STAGE, Bs + (cur ^ 1) * B_STAGE, m0, n0,
                 (kt + 1) * BK, M, K, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = As + cur * A_STAGE;
    const bf16* b = Bs + cur * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a + (warp_m * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], b + kk * B_LD + warp_n * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration refills the stage just read
  }

  // Epilogue. The ring is dead (the loop ended on a barrier): reuse it for
  // the f32 tile.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (warp_m * 64 + i * 16) * C_LD + warp_n * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  const int64_t left = M - m0;
  const int rows = left < BM ? (int)left : BM;
  // round to bf16, store y, keep the rounded value for the statistics
  for (int idx = tid; idx < BM * (BN / 8); idx += kThreads) {
    const int r = idx / (BN / 8);
    const int cg = (idx % (BN / 8)) * 8;
    float* c = Cs + r * C_LD + cg;
    Pack8 o;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      o.v[q] = __float2bfloat16_rn(c[q]);
      c[q] = __bfloat162float(o.v[q]);
    }
    if (r < rows) *reinterpret_cast<Pack8*>(y + (m0 + r) * (int64_t)N + n0 + cg) = o;
  }
  __syncthreads();

  // per-column sums over the valid rows, in a fixed order
  const int col = tid % BN;
  const int half = tid / BN;
  float s1 = 0.f, s2 = 0.f;
  for (int r = half; r < rows; r += 2) {
    const float v = Cs[r * C_LD + col];
    s1 += v;
    s2 += v * v;
  }
  red[0][half][col] = s1;
  red[1][half][col] = s2;
  __syncthreads();
  if (half == 0) {
    const int64_t grid_m = gridDim.y;
    part[(int64_t)blockIdx.y * N + n0 + col] = red[0][0][col] + red[0][1][col];
    part[(grid_m + blockIdx.y) * N + n0 + col] = red[1][0][col] + red[1][1][col];
  }
}

// part (2, grid_m, N) -> stats (2, N): one thread per column, rows in order.
__global__ void stats_finish_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                    int grid_m, int N) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  float a = 0.f, b = 0.f;
  for (int g = 0; g < grid_m; ++g) {
    a += part[(int64_t)g * N + col];
    b += part[(int64_t)(grid_m + g) * N + col];
  }
  stats[col] = a;
  stats[N + col] = b;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

int bdv_conv1x1_stats_block_m() { return BM; }
int bdv_conv1x1_stats_block_n() { return BN; }
int bdv_conv1x1_stats_block_k() { return BK; }

// x (M, K), w (K, N), y (M, N): bf16, row-major, contiguous.
// part: (2, ceil(M / BM), N) f32 scratch. stats: (2, N) f32 = [sum y; sum y^2].
int bdv_conv1x1_with_stats(const void* x, const void* w, void* y, void* part, void* stats,
                           long long M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y)) return (int)cudaErrorMisalignedAddress;
  const long long grid_m = (M + BM - 1) / BM;
  if (grid_m > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / BN, (unsigned)grid_m);
  conv1x1_stats_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
      static_cast<float*>(part), (int64_t)M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_finish_kernel<<<(N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                      static_cast<float*>(stats), (int)grid_m, N);
  return (int)cudaGetLastError();
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

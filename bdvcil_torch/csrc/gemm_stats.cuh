// Tiled bf16 GEMM with a prologue and a BatchNorm-statistics epilogue: the
// 1x1 conv1x1_affine_relu_stats (conv1x1_stats.cu). The GEMMs without a
// prologue and the 3x3 run on the wgmma core of gemm_stats_sm90.cuh.
//
//   y  = bf16(relu(x * a + b)) @ w    x (M, K) bf16, w (K, N) bf16, f32
//                                     accumulation, y rounded to bf16
//   s1 = sum_rows(y)         per output channel, f32, over the ROUNDED y
//   s2 = sum_rows(y * y)
//
// A is never a tensor of its own: the loader (RowsA) starts the cp.async
// copies of each BM x BK slice of A straight from the NHWC activation, and
// each slice is rewritten in shared memory as bf16(relu(x * a[k] + b[k]))
// before the tensor cores read it: the previous BatchNorm's normalize and
// relu ride on the tile already loaded, instead of taking a pass of their own
// over device memory.
//
// Each CTA computes a 128 x 64 tile of y with WMMA bf16 16x16x16 products
// (mma.sync underneath), K streamed through a two-stage cp.async ring. TMA
// and wgmma, which the card needs for its full rate, are later work.
//
// Epilogue: the accumulator tile goes to shared memory; each value is rounded
// to bf16, stored to y, and the rounded value is summed per column over the
// tile's valid rows into a per-row-tile partial (grid_m, N). Rows past M are
// never loaded (zero-filled), never stored and never summed: the ragged edge
// is masked, not padded. A second small kernel sums the partials per column
// in a fixed order, so the statistics are deterministic; no float atomics.

#pragma once

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
// 16-byte chunks of one A slice that each thread copies (and rewrites)
constexpr int A_CHUNKS = (BM * BK / 8) / kThreads;

static_assert(kThreads == 2 * BN, "the column-sum split assumes two threads per column");
static_assert(kThreads % (BK / 8) == 0, "a thread's A chunks share one column offset");
static_assert(A_CHUNKS <= 32, "the chunk mask is 32 bits");

struct alignas(16) Pack8 {
  bf16 v[8];
};

// Chunk `it` of thread `tid` within an A slice: its row, and its column
// offset (the same for every chunk of the thread).
__device__ __forceinline__ int a_row(int tid, int it) { return (tid + it * kThreads) / (BK / 8); }
__device__ __forceinline__ int a_col(int tid) { return (tid % (BK / 8)) * 8; }

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

// A = the rows of x (M, K): a 1x1 convolution reads the NHWC activation in place.
struct RowsA {
  const bf16* x;
  int64_t M;
  int K;

  __device__ __forceinline__ void init(int64_t, int) {}

  // Start the copies of the slice at column k0; return the mask of the
  // thread's chunks that hold real data (rows < M).
  __device__ __forceinline__ unsigned load(bf16* As, int k0, int64_t m0, int tid) const {
    unsigned mask = 0;
    const int cc = a_col(tid);
#pragma unroll
    for (int it = 0; it < A_CHUNKS; ++it) {
      const int r = a_row(tid, it);
      const int64_t gr = m0 + r;
      const bool ok = gr < M;
      cp_async16(As + r * A_LD + cc, x + (ok ? gr : 0) * (int64_t)K + k0 + cc, ok);
      mask |= (unsigned)ok << it;
    }
    return mask;
  }

  // the input channel of column k0 (for the prologue's a, b)
  __device__ __forceinline__ int channel(int k0) const { return k0; }
};

// One BK x BN slice of w (K, N) into shared memory.
__device__ __forceinline__ void load_b(const bf16* __restrict__ w, bf16* Bs, int n0, int k0, int N,
                                       int tid) {
#pragma unroll
  for (int it = 0; it < (BK * BN / 8) / kThreads; ++it) {
    const int chunk = tid + it * kThreads;
    const int r = chunk / (BN / 8);
    const int cc = (chunk % (BN / 8)) * 8;
    cp_async16(Bs + r * B_LD + cc, w + (int64_t)(k0 + r) * N + n0 + cc, true);
  }
}

// x -> bf16(relu(x * a + b)) in place, on the chunks this thread copied and
// only where they hold real data: the rows past M stay zero, as
// the reference pads AFTER the prologue. __fmul_rn / __fadd_rn keep nvcc from
// contracting to an FMA, so the value rounded to bf16 is the plain version's
// (a product and a sum, each rounded to f32) bit for bit. The thread's own
// cp.async copies are complete (wait_group) and visible to it, so no barrier
// is needed before; the main loop's barrier follows.
__device__ __forceinline__ void affine_relu(bf16* As, int c0, unsigned mask,
                                            const float* __restrict__ pa,
                                            const float* __restrict__ pb, int tid) {
  const int cc = a_col(tid);
  float av[8], bv[8];
#pragma unroll
  for (int q = 0; q < 8; q += 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(pa + c0 + cc + q);
    const float4 b4 = *reinterpret_cast<const float4*>(pb + c0 + cc + q);
    av[q] = a4.x; av[q + 1] = a4.y; av[q + 2] = a4.z; av[q + 3] = a4.w;
    bv[q] = b4.x; bv[q + 1] = b4.y; bv[q + 2] = b4.z; bv[q + 3] = b4.w;
  }
#pragma unroll
  for (int it = 0; it < A_CHUNKS; ++it) {
    if (!((mask >> it) & 1u)) continue;
    Pack8* p = reinterpret_cast<Pack8*>(As + a_row(tid, it) * A_LD + cc);
    Pack8 v = *p;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float f = __fadd_rn(__fmul_rn(__bfloat162float(v.v[q]), av[q]), bv[q]);
      v.v[q] = __float2bfloat16_rn(f < 0.f ? 0.f : f);  // relu that keeps NaN
    }
    *p = v;
  }
}

template <class Loader>
__global__ void __launch_bounds__(kThreads)
gemm_stats_kernel(Loader loader, const bf16* __restrict__ w, const float* __restrict__ pa,
                  const float* __restrict__ pb, bf16* __restrict__ y, float* __restrict__ part,
                  int64_t M, int K, int N) {
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

  Loader ld = loader;
  ld.init(m0, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = K / BK;
  unsigned mask_next = ld.load(As, 0, m0, tid);
  load_b(w, Bs, n0, 0, N, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const unsigned mask = mask_next;
    if (kt + 1 < ktiles) {
      mask_next = ld.load(As + (cur ^ 1) * A_STAGE, (kt + 1) * BK, m0, tid);
      load_b(w, Bs + (cur ^ 1) * B_STAGE, n0, (kt + 1) * BK, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    affine_relu(As + cur * A_STAGE, ld.channel(kt * BK), mask, pa, pb, tid);
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

// Launch the GEMM and the statistics finish on `stream`; the caller has
// checked the shapes (K % BK == 0, N % BN == 0) and the alignment.
// part: (2, ceil(M / BM), N) f32 scratch; stats: (2, N) f32 = [sum y; sum y^2].
template <class Loader>
cudaError_t launch_gemm_stats(const Loader& loader, const void* w, const void* a, const void* b,
                              void* y, void* part, void* stats, long long M, int K, int N,
                              cudaStream_t stream) {
  const long long grid_m = (M + BM - 1) / BM;
  if (grid_m > 65535) return cudaErrorInvalidConfiguration;  // gridDim.y
  const dim3 grid(N / BN, (unsigned)grid_m);
  gemm_stats_kernel<Loader><<<grid, kThreads, 0, stream>>>(
      loader, static_cast<const bf16*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<bf16*>(y), static_cast<float*>(part),
      (int64_t)M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finish_kernel<<<(N + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(part),
                                                           static_cast<float*>(stats),
                                                           (int)grid_m, N);
  return cudaGetLastError();
}

}  // namespace

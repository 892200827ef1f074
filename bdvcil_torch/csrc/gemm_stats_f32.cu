// Float32 GEMM with a BatchNorm-statistics epilogue, for Hopper (FFMA).
//
// Replaces these Pallas kernels at float32, the dtype the JAX package's
// trainer computes in by default (cil/trainer.py:78, models/builder.py:38):
//   _kernel4 of bdvcil_tpu/ops/conv1x1_bn.py (:164), called by
//     conv1x1_with_stats -> _conv1x1_with_stats_impl (:190);
//   _kernel of bdvcil_tpu/ops/conv1x1_bn.py (:37), called by gemm_with_stats
//     -> _gemm_with_stats_impl (:59), the 2-D form (M zero-padded there).
// The bf16 forms run on the wgmma core (gemm_stats_sm90.cuh, conv1x1_stats.cu).
//
//   y  = x @ w          x (M, K), w (K, N), y (M, N): f32, row-major;
//                       each y[m][n] one f32 FMA chain over k = 0 .. K - 1
//   s1 = sum_rows(y)    per column, over the stored y
//   s2 = sum_rows(y * y)
//
// Full float32, as the plain version computes it (torch.matmul with TF32
// off): no TF32 tensor cores, whose 10-bit mantissa would put y ~1e-3 off.
// Bound on the H100: at the ResNet-50 shapes the product is bound by the f32
// FMA rate (67 TFLOP/s), not by bytes. The design is the classic SIMT tile:
//
// * A CTA of 256 threads owns a 128 x BN output tile (BN 128, or 64 where the
//   last 64 columns of a 128 tile would be empty: N % 128 in 1 .. 64, e.g.
//   N = 64); thread (tx, ty) of a 16 x 16 grid holds rows ty*4 + {0..3} and
//   64 + ty*4 + {0..3}, columns g*64 + tx*4 + {0..3}: an 8 x BN/16 block of
//   accumulators in registers. At most 128 registers a thread, so two CTAs
//   share an SM and one's barrier waits hide behind the other's FMAs.
// * K steps of 16: the next step's x and w slices are loaded into registers
//   (float4 along K and N where K % 4 == 0, N % 4 == 0 and both operands
//   are 16-byte aligned, else one float at a time; masked: rows past M,
//   columns past N and k past K read as zero) while the FMAs run on the
//   current step's slices in shared memory, then stored into the other of two
//   buffers. x's slice is stored transposed (k-major, rows padded by 4
//   floats) so each thread reads its rows as two float4s.
// * Tiles walk N fastest (tile = blockIdx.x), so the CTAs that share a row
//   tile of x run together and read it from L2.
// * Epilogue: y stored with float4 stores where N % 4 == 0, else per element,
//   masked to M and N; each thread sums its columns over its 8 rows, the 16
//   row groups are summed through shared memory (the operand buffers, reused)
//   in order, and the CTA writes its partial row mt of `part` (2, m_tiles,
//   N). sm90::partials_finish_kernel then sums the m_tiles partials per
//   column in a fixed order. No atomics: a run repeats bit for bit.
// * A first form of this kernel (steps of 8, scalar loads, one CTA an SM at
//   185 registers) took about half as long again on the card (PERF.md §6).

#include "gemm_stats_sm90.cuh"  // sm90::partials_finish_kernel, sm90::aligned16

namespace f32gemm {

constexpr int BM = 128;
constexpr int BK = 16;
constexpr int kThreads = 256;

struct Plan {
  int block_m, block_n, m_tiles, n_tiles, grid;
};

// The tile width: 128, or 64 where a 128-wide last tile would hold 64 empty
// columns or more. m_tiles partial rows; one CTA a tile.
inline Plan make_plan(long long M, int N) {
  const int r = N % 128;
  const int bn = (r == 0 || r > 64) ? 128 : 64;
  const long long m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + bn - 1) / bn;
  return Plan{BM, bn, (int)m_tiles, n_tiles, (int)(m_tiles * n_tiles)};
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM: at most 128 registers
gemm_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, float* __restrict__ part, int M, int K, int N,
                      int n_tiles, int m_tiles) {
  constexpr int G = BN / 64;                // column groups of 4 a thread
  constexpr int AS = BM + 4;                // a row of the transposed x slice, padded
  constexpr int A_FLOATS = 2 * BK * AS;
  constexpr int B_FLOATS = 2 * BK * BN;
  constexpr int SMEM = A_FLOATS + B_FLOATS > 2 * 16 * BN ? A_FLOATS + B_FLOATS : 2 * 16 * BN;
  // vector loads: float4 along K for x, along N for w
  constexpr int A_LOADS = VEC ? BM * BK / 4 / kThreads : BM * BK / kThreads;
  constexpr int B_LOADS = VEC ? BK * BN / 4 / kThreads : BK * BN / kThreads;
  constexpr int A_W = VEC ? 4 : 1;
  __shared__ __align__(16) float smem[SMEM];
  float (*As)[BK][AS] = reinterpret_cast<float (*)[BK][AS]>(smem);
  float (*Bs)[BK][BN] = reinterpret_cast<float (*)[BK][BN]>(smem + A_FLOATS);
  float (*red)[16][BN] = reinterpret_cast<float (*)[16][BN]>(smem);  // after the k loop

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int mt = blockIdx.x / n_tiles;
  const int nt = blockIdx.x - mt * n_tiles;
  const long long m0 = (long long)mt * BM;
  const int n0 = nt * BN;

  float acc[8][4 * G];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;

  float ra[A_LOADS][A_W], rb[B_LOADS][A_W];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = t + i * kThreads;
      const long long row = m0 + e / (BK / A_W);
      const int k = k0 + (e % (BK / A_W)) * A_W;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < M && k < K) v = *reinterpret_cast<const float4*>(x + row * K + k);
        ra[i][0] = v.x; ra[i][1] = v.y; ra[i][2] = v.z; ra[i][3] = v.w;
      } else {
        ra[i][0] = (row < M && k < K) ? x[row * K + k] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = t + i * kThreads;
      const int k = k0 + e / (BN / A_W);
      const int col = n0 + (e % (BN / A_W)) * A_W;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < K && col < N) v = *reinterpret_cast<const float4*>(w + (long long)k * N + col);
        rb[i][0] = v.x; rb[i][1] = v.y; rb[i][2] = v.z; rb[i][3] = v.w;
      } else {
        rb[i][0] = (k < K && col < N) ? w[(long long)k * N + col] : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = t + i * kThreads;
#pragma unroll
      for (int j = 0; j < A_W; ++j) As[buf][(e % (BK / A_W)) * A_W + j][e / (BK / A_W)] = ra[i][j];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = t + i * kThreads;
      float* dst = &Bs[buf][e / (BN / A_W)][(e % (BN / A_W)) * A_W];
      if constexpr (VEC)
        *reinterpret_cast<float4*>(dst) = make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
      else
        dst[0] = rb[i][0];
    }
  };

  const int ktiles = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) load((kt + 1) * BK);
#pragma unroll 1  // rolled: unrolled, the fragment loads run ahead and spill more
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4 * G];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 bg = *reinterpret_cast<const float4*>(&Bs[buf][kk][g * 64 + tx * 4]);
        b[4 * g] = bg.x; b[4 * g + 1] = bg.y; b[4 * g + 2] = bg.z; b[4 * g + 3] = bg.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * G; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

  // ---- epilogue: y, then this tile's column sums ----
  const bool vec = N % 4 == 0;
  float s1[4 * G], s2[4 * G];
#pragma unroll
  for (int j = 0; j < 4 * G; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      float* dst = y + row * N + col;
      const float* v = &acc[i][4 * g];
      if (vec && col + 3 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) dst[j] = v[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s1[4 * g + j] += v[j];
        s2[4 * g + j] += v[j] * v[j];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][g * 64 + tx * 4 + j] = s1[4 * g + j];
      red[1][ty][g * 64 + tx * 4 + j] = s2[4 * g + j];
    }
  __syncthreads();
  if (t < BN && n0 + t < N) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      a1 += red[0][r][t];
      a2 += red[1][r][t];
    }
    part[(long long)mt * N + n0 + t] = a1;
    part[((long long)m_tiles + mt) * N + n0 + t] = a2;
  }
}

}  // namespace f32gemm

extern "C" {

// out = {block_m, block_n, m_tiles, n_tiles, grid} of an (M, ., N) product
int bdv_gemm_stats_f32_plan(long long M, int N, int* out) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const f32gemm::Plan p = f32gemm::make_plan(M, N);
  out[0] = p.block_m; out[1] = p.block_n; out[2] = p.m_tiles; out[3] = p.n_tiles; out[4] = p.grid;
  return 0;
}

// x (M, K), w (K, N), y (M, N): f32, row-major, contiguous; any M, K, N >= 1;
// y 16-byte aligned. part: (2, part_rows, N) f32 scratch with part_rows ==
// m_tiles (bdv_gemm_stats_f32_plan). stats: (2, N) f32 = [sum y; sum y^2].
int bdv_gemm_stats_f32(const void* x, const void* w, void* y, void* part, int part_rows,
                       void* stats, long long M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || M > (1ll << 31) - f32gemm::BM)
    return (int)cudaErrorInvalidValue;
  if (!sm90::aligned16(y)) return (int)cudaErrorMisalignedAddress;
  const f32gemm::Plan p = f32gemm::make_plan(M, N);
  if (part_rows != p.m_tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  const bool vec = K % 4 == 0 && N % 4 == 0 && sm90::aligned16(x) && sm90::aligned16(w);
  if (p.block_n == 128) {
    if (vec)
      f32gemm::gemm_stats_f32_kernel<128, true><<<p.grid, f32gemm::kThreads, 0, s>>>(
          xf, wf, yf, pf, (int)M, K, N, p.n_tiles, part_rows);
    else
      f32gemm::gemm_stats_f32_kernel<128, false><<<p.grid, f32gemm::kThreads, 0, s>>>(
          xf, wf, yf, pf, (int)M, K, N, p.n_tiles, part_rows);
  } else {
    if (vec)
      f32gemm::gemm_stats_f32_kernel<64, true><<<p.grid, f32gemm::kThreads, 0, s>>>(
          xf, wf, yf, pf, (int)M, K, N, p.n_tiles, part_rows);
    else
      f32gemm::gemm_stats_f32_kernel<64, false><<<p.grid, f32gemm::kThreads, 0, s>>>(
          xf, wf, yf, pf, (int)M, K, N, p.n_tiles, part_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sm90::partials_finish_kernel<<<(N + 31) / 32, 256, 0, s>>>(pf, static_cast<float*>(stats),
                                                             part_rows, N);
  return (int)cudaGetLastError();
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Float32 GEMM with a BatchNorm-statistics epilogue, for Hopper (FFMA): the
// float32 stats kernels with a prologue, as gemm_stats_sm90.cuh is the core of
// the bf16 ones. Two ways of loading A (Load) are one kernel template:
//   kRowsAffine  A = relu(x * a + b), x (M, K)        #7 the block's conv3
//   kIm2col      A = the implicit 'SAME' 3x3 im2col   #8 the block's conv2
//                of relu(x * a + b), x (NT, H, W, C),
//                K = 9 C in (dy, dx, c) order
// The float32 forms without a prologue (#3, #4, #6) run on the tensor cores
// as three TF32 products (gemm_stats_tf32.cu).
//
//   y  = A @ w          w (K, N), y (M, N): f32, row-major; each y[m][n] one
//                       f32 FMA chain over k = 0 .. K - 1
//   s1 = sum_rows(y)    per column, over the stored y
//   s2 = sum_rows(y * y)
//
// Full float32 on the FMA units, as the plain versions compute it
// (torch.matmul with TF32 off). Bound on the H100: at the ResNet-50 shapes
// the f32 FMA rate (67 TFLOP/s), not bytes. The design is the classic SIMT
// tile:
//
// * A CTA of 256 threads owns a 128 x BN output tile (BN 128, or 64 where the
//   last 64 columns of a 128 tile would be empty: N % 128 in 1 .. 64, e.g.
//   N = 64); thread (tx, ty) of a 16 x 16 grid holds rows ty*4 + {0..3} and
//   64 + ty*4 + {0..3}, columns g*64 + tx*4 + {0..3}: an 8 x BN/16 block of
//   accumulators in registers. At most 128 registers a thread, so two CTAs
//   share an SM and one's barrier waits hide behind the other's FMAs.
// * K steps of 16: the next step's A and w slices are loaded into registers
//   (float4 along K and N where K % 4 == 0 (the 3x3: C % 4 == 0), N % 4 == 0
//   and the operands are 16-byte aligned, else one float at a time; masked:
//   rows past M, columns past N and k past K read as zero) while the FMAs
//   run on the current step's slices in shared memory, then stored into the
//   other of two buffers. A's slice is stored transposed (k-major, rows
//   padded by 4 floats) so each thread reads its rows as two float4s.
// * A thread loads the same k (4 k's with float4) of every row it loads in a
//   step. So the 3x3's gather splits k into (tap, c) once a step, and each
//   row adds its tap's shift (dy - 1) W + (dx - 1) pixels, or reads zero in
//   the halo and past M. The prologue relu(x * a + b) (the previous
//   BatchNorm's normalize) runs as the slice is stored into shared memory,
//   __fmul_rn then __fadd_rn (each rounded, as the plain version computes
//   them; nvcc would otherwise contract them into an FMA), relu keeping NaN,
//   and only on the values loaded from x: rows past M, k past K and the halo
//   enter the product as 0, as the reference pads after the prologue.
// * Tiles walk N fastest (tile = blockIdx.x), so the CTAs that share a row
//   tile of A run together and read it from L2.
// * Epilogue: y stored with float4 stores where N % 4 == 0, else per element,
//   masked to M and N; each thread sums its columns over its 8 rows, the 16
//   row groups are summed through shared memory (the operand buffers, reused)
//   in order, and the CTA writes its partial row mt of `part` (2, m_tiles,
//   N). sm90::partials_finish_kernel then sums the m_tiles partials per
//   column in a fixed order. No atomics: a run repeats bit for bit.
// * A first form of this kernel (steps of 8, scalar loads, one CTA an SM at
//   185 registers) took about half as long again on the card (PERF.md §6).
//
// Replaces these Pallas kernels at float32, the dtype the JAX package's
// trainer computes in by default (cil/trainer.py:78, models/builder.py:38):
//   _affine_stats_gemm_kernel of bdvcil_tpu/ops/block_fused.py (:73), the
//     bottleneck's conv3: y = relu(x * a + b) @ w, the previous BatchNorm's
//     normalize and relu as a prologue (block_fused.conv1x1_affine_relu_stats);
//   _conv3x3_affine_stats_kernel (:110) and _conv3x3_im2col_affine_stats_kernel
//     (:139) of bdvcil_tpu/ops/block_fused.py, the bottleneck's conv2 behind
//     conv3x3_affine_relu_stats (:227, call :170): nine accumulated tap dots
//     or one K = 9C dot, one function tiled two ways for the TPU's matrix
//     unit; kIm2col serves both variant names, as conv3x3_stats.cu does in
//     bf16. y = conv3x3(pad(relu(x * a + b), 1), w), stride 1, 'SAME', w
//     (3, 3, C, N) HWIO read as w.reshape(9 C, N); the halo reads zero, not
//     relu(b): the reference pads after the prologue.
// The bf16 forms run on the wgmma core (gemm_stats_sm90.cuh, conv1x1_stats.cu,
// conv3x3_stats.cu).
//
// Bound: at the ResNet-50 shapes the f32 FMA rate (67 TFLOP/s). The prologue
// costs two operations an element of x as its slice enters shared memory,
// against 2 N an element in the product. The 3x3 at layer1 (128 x 56 x 56,
// 64 -> 64): 29.59 GFLOP, 0.442 ms at 67 TFLOP/s (x and y once, 206 MB:
// 0.061 ms). A simple design: x is read nine times a tile (once a tap), from
// L2; the prologue runs once a tap, not once a pixel.

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

enum class Load { kRowsAffine, kIm2col };

// The problem as the kernel sees it; the 3x3 reads H, W, C (K = 9 C).
struct Problem {
  const float* x;
  const float* w;
  const float* a;  // the prologue's scale and shift: (K,) for the 1x1, (C,) for the 3x3
  const float* b;
  float* y;
  float* part;
  int M, K, N;
  int H, W, C;
  int n_tiles, m_tiles;
};

// torch.relu on CUDA: clamp_min(v, 0), which keeps NaN
__device__ __forceinline__ float relu_keep_nan(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

template <int BN, bool VEC, Load kLoad>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM: at most 128 registers
gemm_stats_f32_kernel(const Problem p) {
  constexpr bool kIm2col = kLoad == Load::kIm2col;
  constexpr int G = BN / 64;                // column groups of 4 a thread
  constexpr int AS = BM + 4;                // a row of the transposed A slice, padded
  constexpr int A_FLOATS = 2 * BK * AS;
  constexpr int B_FLOATS = 2 * BK * BN;
  constexpr int SMEM = A_FLOATS + B_FLOATS > 2 * 16 * BN ? A_FLOATS + B_FLOATS : 2 * 16 * BN;
  // vector loads: float4 along K for A, along N for w
  constexpr int A_W = VEC ? 4 : 1;
  constexpr int A_LOADS = BM * BK / A_W / kThreads;  // 2 or 8 rows a thread
  constexpr int B_LOADS = BK * BN / A_W / kThreads;
  constexpr int A_COLS = BK / A_W;                   // threads across a row's k slice
  constexpr int A_ROW_STEP = kThreads / A_COLS;      // between a thread's rows
  __shared__ __align__(16) float smem[SMEM];
  float (*As)[BK][AS] = reinterpret_cast<float (*)[BK][AS]>(smem);
  float (*Bs)[BK][BN] = reinterpret_cast<float (*)[BK][BN]>(smem + A_FLOATS);
  float (*red)[16][BN] = reinterpret_cast<float (*)[16][BN]>(smem);  // after the k loop

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int mt = blockIdx.x / p.n_tiles;
  const int nt = blockIdx.x - mt * p.n_tiles;
  const long long m0 = (long long)mt * BM;
  const int n0 = nt * BN;
  // this thread's k offset in a step, and its first row of the tile (then
  // every A_ROW_STEP-th)
  const int a_col = (t % A_COLS) * A_W;
  const int a_row = t / A_COLS;

  // the 3x3: (h << 16) | w of each of the thread's rows' pixel, -1 past M
  int hw[kIm2col ? A_LOADS : 1];
  if constexpr (kIm2col) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const long long m = m0 + a_row + i * A_ROW_STEP;
      const int q = (int)(m / p.W);
      hw[i] = m < p.M ? ((q % p.H) << 16) | (int)(m - (long long)q * p.W) : -1;
    }
  }

  float acc[8][4 * G];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;

  float ra[A_LOADS][A_W], rb[B_LOADS][A_W];
  unsigned taken = 0;  // the rows whose value was loaded from x
  int ch = 0;          // the channel of a and b for this step's k
  auto load = [&](int k0) {
    const int k = k0 + a_col;
    if constexpr (kIm2col) {
      int tap = 0, c = 0;
      const bool kin = k < p.K;
      if (kin) {
        tap = k / p.C;
        c = k - tap * p.C;
      }
      const int dy = tap / 3 - 1;
      const int dx = tap - (tap / 3) * 3 - 1;
      const long long shift = (long long)dy * p.W + dx;  // in pixels
      ch = c;
      taken = 0;
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const int h = (hw[i] >> 16) + dy;
        const int w = (hw[i] & 0xFFFF) + dx;
        const bool in = kin && hw[i] >= 0 && static_cast<unsigned>(h) < static_cast<unsigned>(p.H) &&
                        static_cast<unsigned>(w) < static_cast<unsigned>(p.W);
        const float* src = p.x + (m0 + a_row + i * A_ROW_STEP + shift) * p.C + c;
        if constexpr (VEC) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) v = *reinterpret_cast<const float4*>(src);
          ra[i][0] = v.x; ra[i][1] = v.y; ra[i][2] = v.z; ra[i][3] = v.w;
        } else {
          ra[i][0] = in ? *src : 0.f;
        }
        taken |= (in ? 1u : 0u) << i;
      }
    } else {
      ch = k;
      taken = 0;
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const long long row = m0 + a_row + i * A_ROW_STEP;
        const bool in = row < p.M && k < p.K;
        if constexpr (VEC) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) v = *reinterpret_cast<const float4*>(p.x + row * p.K + k);
          ra[i][0] = v.x; ra[i][1] = v.y; ra[i][2] = v.z; ra[i][3] = v.w;
        } else {
          ra[i][0] = in ? p.x[row * p.K + k] : 0.f;
        }
        taken |= (in ? 1u : 0u) << i;
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = t + i * kThreads;
      const int kb = k0 + e / (BN / A_W);
      const int col = n0 + (e % (BN / A_W)) * A_W;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb < p.K && col < p.N)
          v = *reinterpret_cast<const float4*>(p.w + (long long)kb * p.N + col);
        rb[i][0] = v.x; rb[i][1] = v.y; rb[i][2] = v.z; rb[i][3] = v.w;
      } else {
        rb[i][0] = (kb < p.K && col < p.N) ? p.w[(long long)kb * p.N + col] : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
    float av[A_W], bv[A_W];
#pragma unroll
    for (int j = 0; j < A_W; ++j) av[j] = bv[j] = 0.f;
    if (taken) {  // some row was loaded, so ch .. ch + A_W - 1 lie below K (C)
      if constexpr (VEC) {
        const float4 a4 = *reinterpret_cast<const float4*>(p.a + ch);
        const float4 b4 = *reinterpret_cast<const float4*>(p.b + ch);
        av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
        bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
      } else {
        av[0] = p.a[ch];
        bv[0] = p.b[ch];
      }
    }
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
#pragma unroll
      for (int j = 0; j < A_W; ++j) {
        As[buf][a_col + j][a_row + i * A_ROW_STEP] =
            (taken >> i) & 1u ? relu_keep_nan(__fadd_rn(__fmul_rn(ra[i][j], av[j]), bv[j])) : 0.f;
      }
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

  const int ktiles = (p.K + BK - 1) / BK;
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
  const bool vec = p.N % 4 == 0;
  float s1[4 * G], s2[4 * G];
#pragma unroll
  for (int j = 0; j < 4 * G; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= p.M) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      float* dst = p.y + row * p.N + col;
      const float* v = &acc[i][4 * g];
      if (vec && col + 3 < p.N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < p.N) dst[j] = v[j];
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
  if (t < BN && n0 + t < p.N) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      a1 += red[0][r][t];
      a2 += red[1][r][t];
    }
    p.part[(long long)mt * p.N + n0 + t] = a1;
    p.part[((long long)p.m_tiles + mt) * p.N + n0 + t] = a2;
  }
}

template <int BN, Load kLoad>
void launch_bn(const Problem& p, bool vec, int grid, cudaStream_t s) {
  if (vec)
    gemm_stats_f32_kernel<BN, true, kLoad><<<grid, kThreads, 0, s>>>(p);
  else
    gemm_stats_f32_kernel<BN, false, kLoad><<<grid, kThreads, 0, s>>>(p);
}

// Launch the GEMM and the statistics finish on `stream`. The caller has
// filled p's pointers and sizes (M, K, N; the 3x3 also H, W, C) and checked
// them. part: (2, part_rows, N) f32 scratch with part_rows == m_tiles
// (make_plan); stats: (2, N) f32 = [sum y; sum y^2]. vec: float4 loads
// (K, N % 4 == 0, the 3x3 C % 4 == 0, every operand 16-byte aligned).
template <Load kLoad>
cudaError_t launch_f32_stats(Problem p, int part_rows, bool vec, void* stats,
                             cudaStream_t stream) {
  if (p.M <= 0 || p.K <= 0 || p.N <= 0 || p.M > (1ll << 31) - BM) return cudaErrorInvalidValue;
  if (!sm90::aligned16(p.y)) return cudaErrorMisalignedAddress;
  const Plan plan = make_plan(p.M, p.N);
  if (part_rows != plan.m_tiles) return cudaErrorInvalidValue;
  p.n_tiles = plan.n_tiles;
  p.m_tiles = plan.m_tiles;
  if (plan.block_n == 128)
    launch_bn<128, kLoad>(p, vec, plan.grid, stream);
  else
    launch_bn<64, kLoad>(p, vec, plan.grid, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sm90::partials_finish_kernel<<<(p.N + 31) / 32, 256, 0, stream>>>(
      p.part, static_cast<float*>(stats), part_rows, p.N);
  return cudaGetLastError();
}

}  // namespace f32gemm

namespace {

f32gemm::Problem problem(const void* x, const void* w, void* y, void* part, long long M, int K,
                         int N) {
  f32gemm::Problem p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.y = static_cast<float*>(y);
  p.part = static_cast<float*>(part);
  p.M = M > (1ll << 31) - f32gemm::BM ? -1 : (int)M;  // launch_f32_stats refuses M <= 0
  p.K = K;
  p.N = N;
  return p;
}

}  // namespace

extern "C" {

// out = {block_m, block_n, m_tiles, n_tiles, grid} of an (M, ., N) product
int bdv_gemm_stats_f32_plan(long long M, int N, int* out) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const f32gemm::Plan p = f32gemm::make_plan(M, N);
  out[0] = p.block_m; out[1] = p.block_n; out[2] = p.m_tiles; out[3] = p.n_tiles; out[4] = p.grid;
  return 0;
}

// x (M, K), w (K, N), y (M, N): f32, row-major, contiguous; any M, K, N >= 1;
// y 16-byte aligned; a, b: (K,) f32. y = relu(x * a + b) @ w, each operation
// rounded to f32. part: (2, part_rows, N) f32 scratch with part_rows ==
// m_tiles (bdv_gemm_stats_f32_plan). stats: (2, N) f32 = [sum y; sum y^2].
int bdv_gemm_affine_relu_stats_f32(const void* x, const void* w, const void* a, const void* b,
                                   void* y, void* part, int part_rows, void* stats, long long M,
                                   int K, int N, void* stream) {
  f32gemm::Problem p = problem(x, w, y, part, M, K, N);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  const bool vec = K % 4 == 0 && N % 4 == 0 && sm90::aligned16(x) && sm90::aligned16(w) &&
                   sm90::aligned16(a) && sm90::aligned16(b);
  return (int)f32gemm::launch_f32_stats<f32gemm::Load::kRowsAffine>(
      p, part_rows, vec, stats, static_cast<cudaStream_t>(stream));
}

// x (NT, H, W, C), w (9*C, N), y (NT, H, W, N): f32, contiguous; a, b: (C,)
// f32; y 16-byte aligned; H < 2^15, W < 2^16. part: (2, part_rows, N) f32
// scratch with part_rows == m_tiles of bdv_gemm_stats_f32_plan(NT*H*W, N).
// stats: (2, N) f32.
int bdv_conv3x3_affine_relu_stats_f32(const void* x, const void* w, const void* a,
                                      const void* b, void* y, void* part, int part_rows,
                                      void* stats, long long NT, int H, int W, int C, int N,
                                      void* stream) {
  if (NT <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || H >= (1 << 15) || W >= (1 << 16) ||
      NT * H * W > (1ll << 31) - f32gemm::BM || 9ll * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  f32gemm::Problem p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.y = static_cast<float*>(y);
  p.part = static_cast<float*>(part);
  p.M = (int)(NT * H * W);
  p.K = 9 * C;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  const bool vec = C % 4 == 0 && N % 4 == 0 && sm90::aligned16(x) && sm90::aligned16(w) &&
                   sm90::aligned16(a) && sm90::aligned16(b);
  return (int)f32gemm::launch_f32_stats<f32gemm::Load::kIm2col>(
      p, part_rows, vec, stats, static_cast<cudaStream_t>(stream));
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

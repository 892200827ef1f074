// Float32 GEMM with a BatchNorm-statistics epilogue on Hopper's tensor cores,
// as three TF32 products (3xTF32), for sm_90a: the float32 forms of
//   #3 conv1x1_with_stats, #4 gemm_with_stats and #6 the block's conv1.
//
//   y  = x @ w          x (M, K), w (K, N), y (M, N): f32, row-major
//   s1 = sum_rows(y)    per column, f32, over the stored y
//   s2 = sum_rows(y * y)
//
// Replaces these Pallas kernels at float32, the dtype the JAX package's
// trainer computes in by default (cil/trainer.py:78, models/builder.py:38):
//   _kernel4 of bdvcil_tpu/ops/conv1x1_bn.py (:164), called by
//     conv1x1_with_stats -> _conv1x1_with_stats_impl (:190);
//   _kernel of bdvcil_tpu/ops/conv1x1_bn.py (:37), called by gemm_with_stats
//     -> _gemm_with_stats_impl (:59), the 2-D form (M zero-padded there,
//     masked here);
//   _plain_stats_gemm_kernel of bdvcil_tpu/ops/block_fused.py (:96, call
//     :170), the bottleneck's conv1 (block_fused.conv1x1_stats).
// The block's conv3 and 3x3 at float32 (with the prologue) stay on the FFMA
// kernel of gemm_stats_f32.cu; the bf16 forms run on gemm_stats_sm90.cuh.
//
// Precision. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product puts y ~1e-3 off the float32 product. Each operand is split into
// big = tf32(v) and small = tf32(v - big) (cvt.rna: to nearest, ties away;
// v - big is exact), and y = small_x big_w + big_x small_w + big_x big_w:
// the dropped small_x small_w term is ~2^-22 of |x w|, below f32's own
// rounding. The tensor cores do not accumulate as IEEE f32 does: inside a
// wgmma the terms are aligned to the largest and truncated, and the sum is
// truncated, a bias toward zero that grows with the number of accumulations
// into one register. So each 32-wide k-step's three products (12 wgmma)
// start a fresh accumulator, which is then added into a second one in
// registers with an IEEE f32 add. Values above TF32's largest
// finite (~3.4025e38) round to inf, so there y is NaN where an f32 product
// may be finite.
//
// Bound on the H100: 3xTF32 runs three products at 495 TFLOP/s; at the
// ResNet-50 shapes the shallow 1x1s (K or N of 64-256, M = 401408) are bound
// by bytes (x read once, y written once: f32 y is most of them), the deep ones
// by the tensor cores. The design:
//
// * Once a call, a small kernel splits w (K, N) into (2, N, K) = [big; small]:
//   TF32 wgmma reads B K-major (PTX has no transpose for 32-bit types), and
//   splitting w once saves every row tile from splitting it again.
// * One CTA per SM at most (persistent, static tile schedule t = blockIdx.x +
//   i * gridDim.x), three warpgroups: a producer (one thread starts every TMA
//   load) and two consumers that each own 64 rows of a 128 x BN output tile.
//   BN in {64, 128} per shape (make_plan, the bf16 core's cost model); 256
//   would need 256 accumulator registers a thread with the second accumulator.
// * BK = 32 f32: one 128-byte swizzled row. A ring of stages (3 at BN = 128,
//   5 at 64) with full and empty mbarriers holds x's 128 x 32 tile and w's
//   big and small BN x 32 tiles, each by TMA (128-byte swizzle, zero fill past
//   M, K and N, so padded rows and columns add nothing and come out zero).
// * A from registers: once a stage has landed, each consumer thread reads its
//   A fragments of the k-step from x's swizzled tile (16 floats: rows g and
//   g + 8, columns t and t + 4 of each k8 step) and splits them there;
//   wgmma.mma_async m64nBNk8 .tf32 takes w's tiles K-major from shared memory
//   (+32 bytes a k8 step): the small products first, then big x big. Two
//   register sets of A alternate, so the next k-step is read and split while
//   the tensor cores run this one. With A in shared memory too, its split
//   written there and the tensor cores' reads of both operands would fill
//   shared memory's 128 bytes a cycle.
// * Epilogue: each consumer warpgroup writes its 64 x BN block of y into a
//   buffer of its own in shared memory (boxes of 64 rows x 32 f32, 128-byte
//   swizzle) and one thread stores it by TMA, which runs on while the
//   warpgroup computes its next tile (the thread waits for the store to have
//   read the buffer before the next tile writes it, and for all of them to
//   be done before the CTA ends); the TMA drops rows and columns past M and
//   N. The same values are summed per column from registers in a fixed
//   order: in the thread (its two rows), across the warp by a shuffle
//   reduce-scatter, across the 8 consumer warps through shared memory, into
//   the CTA's partial row blockIdx.x of `part` in its tile order;
//   sm90::partials_finish_kernel then sums the gridDim.x partials per column
//   in CTA order. No float atomics: a second run repeats bit for bit.

#include "gemm_stats_sm90.cuh"  // mbarrier, TMA, wgmma and epilogue helpers

namespace tf32gemm {

using sm90::BM;                                // 128 rows a tile
using sm90::kConsumers;                        // two warpgroups of 64 rows each
using sm90::kThreads;                          // and the producer's
constexpr int BK = 32;                         // f32: one 128-byte swizzled row
constexpr int A_BYTES = BM * BK * 4;           // 16 KB: x's tile of a stage

// Shared memory, in byte offsets from a 1024-byte aligned base: the ring
// (x's tile, then w's big and small tiles), y's tile, the statistics'
// cross-warp sums, the barriers.
template <int BN>
struct Layout {
  static constexpr int kStages = BN == 128 ? 3 : 5;
  static constexpr int W_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;
  // y's tile for the TMA store: per consumer warpgroup 64 rows, in BN / 32
  // boxes of 64 rows x 32 f32 (128-byte swizzle)
  static constexpr int Y = kStages * STAGE_BYTES;
  static constexpr int Y_WG_BYTES = 64 * BN * 4;
  static constexpr int RED = Y + 2 * Y_WG_BYTES;    // [s1 | s2][warp][BN] f32
  static constexpr int BAR = RED + 2 * 8 * BN * 4;  // full, empty [kStages]
  static constexpr int SMEM = 1024 + BAR + 2 * kStages * 8;  // + alignment slack
};

struct Problem {
  float* part;
  int M, K, N;
  int n_tiles, tiles;
};

// tf32(v): round to nearest, ties away from zero; the low 13 bits zero
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// TMA store of one 2-D box from shared memory, in the warpgroup's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// and have written global memory
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// D (64 x N, f32, registers) (+)= A (64 x 8, TF32 in registers: a[0] row g,
// column t; a[1] row g + 8; a[2] column t + 4; a[3] both, g = lane / 4 + 16
// warp, t = lane % 4) x B (8 x N, TF32, K-major in shared memory); scale_d =
// 0 starts the sum afresh.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// w (K, N) -> out (2, N, K): [tf32(w)^T; tf32(w - tf32(w))^T]. Block: 32 x 8
// threads over a 32 x 32 tile, transposed through shared memory.
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w, float* __restrict__ out, int K, int N) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i;
    const int n = n0 + threadIdx.x;
    tile[i][threadIdx.x] = (k < K && n < N) ? w[static_cast<int64_t>(k) * N + n] : 0.f;
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(N) * K;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i;
    const int k = k0 + threadIdx.x;
    if (n < N && k < K) {
      const float v = tile[threadIdx.x][i];
      const float big = to_tf32(v);
      out[static_cast<int64_t>(n) * K + k] = big;
      out[plane + static_cast<int64_t>(n) * K + k] = to_tf32(__fsub_rn(v, big));
    }
  }
}

// This thread's A fragments of k-step columns 8 kk .. 8 kk + 7 (rows g and
// g + 8 of its warpgroup's 64, columns t and t + 4: the register layout of
// Wgmma), read from x's swizzled tile and split: big = tf32(v), small =
// tf32(v - big). x_rows: the tile's row g; sw = g % 8, the row's swizzle.
__device__ __forceinline__ void load_split(const unsigned char* x_rows, int sw, int t,
                                           uint32_t (&big)[BK / 8][4],
                                           uint32_t (&small)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int chunk = 2 * kk + (e >> 1);  // 16-byte chunk of the 128-byte row
      const float v = *reinterpret_cast<const float*>(x_rows + (e & 1) * 8 * 128 +
                                                      ((chunk ^ sw) << 4) + 4 * t);
      const float b = to_tf32(v);
      big[kk][e] = __float_as_uint(b);
      small[kk][e] = __float_as_uint(to_tf32(__fsub_rn(v, b)));
    }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
tf32_stats_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_wb,
                  const __grid_constant__ CUtensorMap tm_ws, const __grid_constant__ CUtensorMap tm_y,
                  const Problem p) {
  using Lay = Layout<BN>;
  constexpr int S = Lay::kStages;
  constexpr int kProducerRegs = 40;
  constexpr int kConsumerRegs = 232;

  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(smem + Lay::RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BAR);
  uint64_t* empty = full + S;
  auto stage_x = [&](int s) { return smem + s * Lay::STAGE_BYTES; };
  auto stage_wb = [&](int s) { return smem + s * Lay::STAGE_BYTES + A_BYTES; };
  auto stage_ws = [&](int s) { return smem + s * Lay::STAGE_BYTES + A_BYTES + Lay::W_BYTES; };

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);  // the producer's arrive with the TMA transaction bytes
      sm90::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ktiles = (p.K + BK - 1) / BK;  // past K the TMA's zero fill
  const int grid = static_cast<int>(gridDim.x);
  const int my_tiles = (p.tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int total = my_tiles * ktiles;  // this CTA's (tile, k-step) stream

  if (wg == kConsumers) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == 0) {
      int s = 0, kt = 0, tile = blockIdx.x;
      uint32_t ph = 0;
      for (int g = 0; g < total; ++g) {
        const int mt = tile / p.n_tiles;
        const int nt = tile - mt * p.n_tiles;
        sm90::mbar_wait(&empty[s], ph ^ 1);
        sm90::mbar_expect_tx(&full[s], Lay::STAGE_BYTES);
        sm90::tma_load_2d(stage_x(s), &tm_x, &full[s], kt * BK, mt * BM);
        sm90::tma_load_2d(stage_wb(s), &tm_wb, &full[s], kt * BK, nt * BN);
        sm90::tma_load_2d(stage_ws(s), &tm_ws, &full[s], kt * BK, nt * BN);
        if (++kt == ktiles) {
          kt = 0;
          tile += grid;
        }
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 * wg .. 64 * wg + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    float acc[BN / 2];  // one k-step's three products (the tensor cores' sum)
    float sum[BN / 2];  // y: the k-steps' products added in f32
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    const int warp = t / 32;
    const int lane = t % 32;
    const int ct = threadIdx.x;     // 0 .. 255 over both consumer warpgroups
    const int w8 = wg * 4 + warp;   // consumer warp 0 .. 7
    float* red1 = red;
    float* red2 = red + 8 * BN;
    float* part1 = p.part + static_cast<int64_t>(blockIdx.x) * p.N;
    float* part2 = p.part + (static_cast<int64_t>(grid) + blockIdx.x) * p.N;
    // thread ct owns column c of the partials for every c = ct (mod BN)
    if (ct < BN)
      for (int c = ct; c < p.N; c += BN) {
        part1[c] = 0.f;
        part2[c] = 0.f;
      }
    const int t4 = lane & 3;
    const int sw = (lane >> 2) & 7;               // the swizzle of this thread's rows
    const int a_row = wg * 64 + warp * 16 + (lane >> 2);  // its first row of A in a tile

    int s = 0, tile = blockIdx.x;  // s, ph: the next stage to read
    uint32_t ph = 0;
    // wait for the next stage, read and split this thread's A fragments of
    // it; returns the stage
    auto load = [&](uint32_t (&xb)[BK / 8][4], uint32_t (&xs)[BK / 8][4]) {
      const int st = s;
      sm90::mbar_wait(&full[st], ph);
      load_split(stage_x(st) + a_row * 128, sw, t4, xb, xs);
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
      return st;
    };
    // a k-step's 12 products into acc (afresh): the small ones first, w
    // K-major (rows 128 bytes apart, 8-row groups 1024 apart, +32 bytes a
    // k8 step)
    auto products = [&](const uint32_t (&xb)[BK / 8][4], const uint32_t (&xs)[BK / 8][4],
                        int st) {
      const uint32_t wb = sm90::smem_u32(stage_wb(st));
      const uint32_t ws = sm90::smem_u32(stage_ws(st));
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        Wgmma<BN>::mma(acc, xs[kk], sm90::smem_desc(wb + kk * 32, 16, 1024), kk != 0);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        Wgmma<BN>::mma(acc, xb[kk], sm90::smem_desc(ws + kk * 32, 16, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        Wgmma<BN>::mma(acc, xb[kk], sm90::smem_desc(wb + kk * 32, 16, 1024), 1);
      sm90::wgmma_commit();
    };
    // wait for the products, release their stage, add them into y in f32
    auto retire = [&](int st) {
      sm90::fence_acc(acc);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
      if (t == 0) sm90::mbar_arrive(&empty[st]);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sum[j] = __fadd_rn(sum[j], acc[j]);
    };
    for (int i = 0; i < my_tiles; ++i, tile += grid) {
      const int mt = tile / p.n_tiles;
      const int nt = tile - mt * p.n_tiles;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sum[j] = 0.f;
      // Two register sets of A, k-steps alternating between them: the next
      // k-step's fragments are read and split while the tensor cores run
      // this one's products.
      uint32_t xb0[BK / 8][4], xs0[BK / 8][4], xb1[BK / 8][4], xs1[BK / 8][4];
      int st0 = load(xb0, xs0), st1 = -1;
      for (int kt = 0; kt < ktiles; kt += 2) {
        products(xb0, xs0, st0);
        st1 = kt + 1 < ktiles ? load(xb1, xs1) : -1;
        retire(st0);
        if (st1 < 0) break;
        products(xb1, xs1, st1);
        if (kt + 2 < ktiles) st0 = load(xb0, xs0);
        retire(st1);
      }

      // Epilogue. sum[4j + 2i + c] is row 16 * warp + lane / 4 + 8 i, column
      // 8 j + 2 (lane % 4) + c of the warpgroup's 64 x BN block.
      constexpr int J = BN / 8;
      const int q = lane & 3;
      // y's tile goes out by TMA stores from shared memory, which run on while
      // the warpgroup computes its next tile: wait until its last store has
      // read the buffer, then write this tile's rows into it
      unsigned char* y_s = smem + Lay::Y + wg * Lay::Y_WG_BYTES;
      if (t == 0) bulk_wait_read();
      sm90::warpgroup_barrier(wg);
      // this thread's rows r and r + 8 (r % 8 == sw) at column 8 j + 2 q: box
      // j / 4, 16-byte chunk (2 (j % 4) + q / 2) ^ sw, byte 8 (q % 2)
      unsigned char* y_row = y_s + (warp * 16 + (lane >> 2)) * 128 + 8 * (q & 1);
      // the CTA's partials of this tile's columns, loaded now, added at the end
      const bool mine = ct < BN && nt * BN + ct < p.N;
      float old1 = 0.f, old2 = 0.f;
      if (mine) {
        old1 = part1[nt * BN + ct];
        old2 = part2[nt * BN + ct];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float v0 = sum[4 * j], v1 = sum[4 * j + 1];      // row, columns c, c + 1
        const float v2 = sum[4 * j + 2], v3 = sum[4 * j + 3];  // row + 8
        unsigned char* at = y_row + (j / 4) * 64 * 128 + (((2 * (j % 4) + (q >> 1)) ^ sw) << 4);
        *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(at + 8 * 128) = make_float2(v2, v3);
        // acc now holds the two rows' sums: s(c0), s(c1), s2(c0), s2(c1)
        acc[4 * j] = v0 + v2;
        acc[4 * j + 1] = v1 + v3;
        acc[4 * j + 2] = v0 * v0 + v2 * v2;
        acc[4 * j + 3] = v1 * v1 + v3 * v3;
      }
      sm90::fence_proxy_async();  // the generic writes, to the TMA's reads
      sm90::warpgroup_barrier(wg);
      if (t == 0) {  // past M and N the TMA drops the rows and columns
        for (int b = 0; b < BN / 32; ++b)
          tma_store_2d(&tm_y, y_s + b * 64 * 128, nt * BN + 32 * b, mt * BM + wg * 64);
        bulk_commit();
      }
      // sum over the warp's 16 rows: a reduce-scatter over lane bits 4, 3, 2
      sm90::reduce_scatter<J, 16>(acc, lane);
      sm90::reduce_scatter<J / 2, 8>(acc, lane);
      sm90::reduce_scatter<J / 4, 4>(acc, lane);
      const int jb = ((lane & 4) ? J / 8 : 0) + ((lane & 8) ? J / 4 : 0) + ((lane & 16) ? J / 2 : 0);
#pragma unroll
      for (int j = 0; j < J / 8; ++j) {
        const int c = w8 * BN + 8 * (jb + j) + 2 * q;
        red1[c] = acc[4 * j];
        red1[c + 1] = acc[4 * j + 1];
        red2[c] = acc[4 * j + 2];
        red2[c + 1] = acc[4 * j + 3];
      }
      sm90::consumer_barrier();
      if (mine) {
        float a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          a1 += red1[w * BN + ct];
          a2 += red2[w * BN + ct];
        }
        part1[nt * BN + ct] = old1 + a1;
        part2[nt * BN + ct] = old2 + a2;
      }
      sm90::consumer_barrier();  // red is rewritten by the next tile
    }
    if (t == 0) bulk_wait_all();  // y's last stores are out before the CTA ends
  }
}

// ---- host side -------------------------------------------------------------------

struct Plan {
  int block_n, m_tiles, n_tiles, tiles, grid, stages, smem;
};

inline int smem_of(int bn) { return bn == 128 ? Layout<128>::SMEM : Layout<64>::SMEM; }
inline int stages_of(int bn) { return bn == 128 ? Layout<128>::kStages : Layout<64>::kStages; }

// The tile width and persistent grid of an (M, ., N) product on `sms` SMs,
// sm90::make_plan's cost model over this kernel's widths: among 128 and 64
// (those that divide N rounded up to 64), the fewest column-time units on the
// busiest SM, ceil(tiles / SMs) * (BN + 32); a tie goes to the wider tile.
// grid = min(tiles, sms): one partial row a CTA.
inline Plan make_plan(long long M, int N, int sms) {
  Plan best{0, 0, 0, 0, 0, 0, 0};
  long long best_cost = -1;
  const long long m_tiles = (M + BM - 1) / BM;
  const int n64 = (N + 63) / 64 * 64;
  for (int bn : {128, 64}) {
    if (n64 % bn != 0) continue;
    const long long tiles = m_tiles * (n64 / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + sm90::kTileOverhead);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = Plan{bn, (int)m_tiles, n64 / bn, (int)tiles, (int)(tiles < sms ? tiles : sms),
                  stages_of(bn), smem_of(bn)};
    }
  }
  return best;
}

// A row-major f32 matrix (rows of `inner` floats, 16-byte row strides) read in
// boxes of 32 columns (128 bytes: one swizzle row) x box_rows rows, zero-filled
// past its edges.
inline bool encode_f32(CUtensorMap* map, const void* base, uint64_t inner, uint64_t rows,
                       uint32_t box_rows) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {inner * sizeof(float)};
  const cuuint32_t box[2] = {BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_bn(const CUtensorMap& tm_x, const CUtensorMap& tm_wb, const CUtensorMap& tm_ws,
                      const CUtensorMap& tm_y, const Problem& p, int grid, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static_assert(Layout<BN>::SMEM <= sm90::kMaxSmem, "the ring does not fit a CTA");
  auto kernel = tf32_stats_kernel<BN>;
  // allow the kernel the most shared memory once per device, not per launch
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<BN>::SMEM);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  kernel<<<grid, kThreads, Layout<BN>::SMEM, stream>>>(tm_x, tm_wb, tm_ws, tm_y, p);
  return cudaGetLastError();
}

}  // namespace tf32gemm

extern "C" {

// out = {block_n, m_tiles, n_tiles, tiles, grid, stages, smem} of an (M, ., N)
// product on `sms` SMs; grid is the partials' row count.
int bdv_gemm_stats_tf32_plan(long long M, int N, int sms, int* out) {
  if (M <= 0 || N <= 0 || sms <= 0 || M > (1ll << 31) - tf32gemm::BM)
    return (int)cudaErrorInvalidValue;
  const tf32gemm::Plan p = tf32gemm::make_plan(M, N, sms);
  out[0] = p.block_n; out[1] = p.m_tiles; out[2] = p.n_tiles; out[3] = p.tiles; out[4] = p.grid;
  out[5] = p.stages; out[6] = p.smem;
  return 0;
}

// x (M, K), w (K, N), y (M, N): f32, row-major, contiguous; K % 4 == 0 and
// N % 4 == 0 (the TMA's 16-byte strides; the wrapper zero-pads the rest);
// x, y 16-byte aligned. wsplit: (2, N, K) f32 scratch, 16-byte aligned.
// part: (2, part_rows, N) f32 scratch, one row per persistent CTA; the grid
// has at most part_rows CTAs (pass the device's SM count), and the finish
// sums the plan's grid rows (bdv_gemm_stats_tf32_plan with part_rows SMs).
// stats: (2, N) f32 = [sum y; sum y^2].
int bdv_gemm_stats_tf32(const void* x, const void* w, void* wsplit, void* y, void* part,
                        int part_rows, void* stats, long long M, int K, int N, void* stream) {
  using namespace tf32gemm;
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0 || part_rows <= 0 ||
      M > (1ll << 31) - BM || K >= (1 << 21) || N >= (1 << 21))
    return (int)cudaErrorInvalidValue;
  if (!sm90::aligned16(x) || !sm90::aligned16(wsplit) || !sm90::aligned16(y))
    return (int)cudaErrorMisalignedAddress;
  const Plan plan = make_plan(M, N, part_rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wb = static_cast<float*>(wsplit);
  float* ws = wb + static_cast<int64_t>(N) * K;
  split_w_kernel<<<dim3((N + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w), wb, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_x, tm_wb, tm_ws, tm_y;
  if (!encode_f32(&tm_x, x, K, M, BM) || !encode_f32(&tm_wb, wb, K, N, plan.block_n) ||
      !encode_f32(&tm_ws, ws, K, N, plan.block_n) || !encode_f32(&tm_y, y, N, M, 64))
    return (int)cudaErrorInvalidValue;
  Problem p{static_cast<float*>(part), (int)M, K, N, plan.n_tiles, plan.tiles};
  err = plan.block_n == 128 ? launch_bn<128>(tm_x, tm_wb, tm_ws, tm_y, p, plan.grid, s)
                            : launch_bn<64>(tm_x, tm_wb, tm_ws, tm_y, p, plan.grid, s);
  if (err != cudaSuccess) return (int)err;
  sm90::partials_finish_kernel<<<(N + 31) / 32, 256, 0, s>>>(p.part, static_cast<float*>(stats),
                                                             plan.grid, N);
  return (int)cudaGetLastError();
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Float32 GEMM with a BatchNorm-statistics epilogue on Hopper's tensor cores,
// as three TF32 products (3xTF32), for sm_90a: every float32 stats kernel of
// the port. Three ways of loading A (Load) are one kernel template, as
// gemm_stats_sm90.cuh serves the bf16 forms:
//   kRows        A = x, x (M, K)                      #3, #4, #6
//   kRowsAffine  A = relu(x * a + b), x (M, K)        #7 the block's conv3
//   kIm2col      A = the implicit 'SAME' 3x3 im2col   #8 the block's conv2
//                of relu(x * a + b), x (NT, H, W, C),
//                K = 9 C in (dy, dx, c) order
//
//   y  = A @ w          w (K, N), y (M, N): f32, row-major
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
//     :170), the bottleneck's conv1 (block_fused.conv1x1_stats);
//   _affine_stats_gemm_kernel of bdvcil_tpu/ops/block_fused.py (:73), the
//     bottleneck's conv3: y = relu(x * a + b) @ w, the previous BatchNorm's
//     normalize and relu as a prologue (block_fused.conv1x1_affine_relu_stats);
//   _conv3x3_affine_stats_kernel (:110) and _conv3x3_im2col_affine_stats_kernel
//     (:139) of bdvcil_tpu/ops/block_fused.py, the bottleneck's conv2 behind
//     conv3x3_affine_relu_stats (:227, call :170): nine accumulated tap dots
//     or one K = 9 C dot, one function tiled two ways for the TPU's matrix
//     unit; kIm2col serves both variant names. y = conv3x3(pad(relu(x * a +
//     b), 1), w), stride 1, 'SAME', w (3, 3, C, N) HWIO; the halo reads zero,
//     not relu(b): the reference pads after the prologue.
// The bf16 forms run on gemm_stats_sm90.cuh.
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
// may be finite. The prologue relu(x * a + b) is __fmul_rn then __fadd_rn
// (each rounded, as the plain version computes them; nvcc would otherwise
// contract them into an FMA) and a relu that keeps NaN, before the split.
//
// Bound on the H100: 3xTF32 runs three products at 495 TFLOP/s; at the
// ResNet-50 shapes the shallow 1x1s (K or N of 64-256, M = 401408) are bound
// by bytes (x read once, y written once: f32 y is most of them), the deep ones
// and every 3x3 (29.59 GFLOP at each width, 0.179 ms as three products) by
// the tensor cores. The design:
//
// * Once a call, a small kernel splits w into [big; small] K-major: TF32
//   wgmma reads B K-major (PTX has no transpose for 32-bit types), and
//   splitting w once saves every row tile from splitting it again. The 1x1's
//   scratch is (2, N, K); the 3x3's (2, N, 9, C32), C rounded up to 32 with
//   zeros past C, so a 32-channel slice of a tap never reads the next tap's
//   rows.
// * One CTA per SM at most (persistent, static tile schedule t = blockIdx.x +
//   i * gridDim.x), three warpgroups: a producer (one thread starts every TMA
//   load) and two consumers that each own 64 rows of a 128 x BN output tile.
//   BN in {64, 128} per shape (make_plan, the bf16 core's cost model; the
//   3x3 the widest that fits, since each column tile reloads its windows);
//   256 would need 256 accumulator registers a thread with the second
//   accumulator.
// * BK = 32 f32: one 128-byte swizzled row. A ring of stages (up to 3 at
//   BN = 128, 5 at 64) with full and empty mbarriers holds w's big and small
//   BN x 32 tiles and, for the 1x1, x's 128 x 32 tile, each by TMA (128-byte
//   swizzle, zero fill past M, K and N, so padded rows and columns add
//   nothing and come out zero); with the prologue also a and b's 32 channels
//   (zero past K).
// * A from registers: once a stage has landed, each consumer thread reads its
//   A fragments of the k-step from x's swizzled tile (16 floats: rows g and
//   g + 8, columns t and t + 4 of each k8 step), applies the prologue where
//   there is one (rows past M then read 0, not relu(b)), and splits them
//   there; wgmma.mma_async m64nBNk8 .tf32 takes w's tiles K-major from shared
//   memory (+32 bytes a k8 step): the small products first, then big x big.
//   Two register sets of A alternate, so the next k-step is read and split
//   while the tensor cores run this one. With A in shared memory too, its
//   split written there and the tensor cores' reads of both operands would
//   fill shared memory's 128 bytes a cycle.
// * The 3x3's K steps run channel slice by channel slice (32 channels), the
//   9 taps of a slice in a row, and all 9 read one window of x seen as an
//   (M, C) matrix, brought by TMA with a and b's 32 channels, zero-filled
//   where it leaves x, twice buffered (sm90::window_plan, the bf16 3x3's
//   too): rows m0 - W - 1 .. m0 + 128 + W in one to three boxes of at most
//   256 rows, or, where that is more, three bands of 136 rows, band dy + 1
//   from row m0 + dy W - 1, which fit at any W. Both consumer warpgroups
//   apply the prologue to the window once, in place (rows outside x keep the
//   zero fill); then for each tap each thread reads its fragments at rows
//   shifted by dy W + dx, writing zero where the tap leaves the image (the
//   halo) or the row lies past M, and splits them. The 128-byte swizzle keeps these reads free of bank
//   conflicts at any shift: rows g = 0 .. 7 of a warp land on 8 chunks. So
//   x leaves L2 about twice a tile and slice (not nine times) and the
//   prologue runs once a pixel and slice (not once a tap).
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
constexpr int AB_BYTES = 2 * BK * 4;           // a's and b's 32 channels of a k-step
using sm90::Window;                            // the 3x3's window (sm90::window_plan)

// How the kernel gets A: the rows of x, the rows of relu(x * a + b), or the
// implicit 3x3 im2col of relu(x * a + b) built from a window of x.
enum class Load { kRows, kRowsAffine, kIm2col };

// Shared memory, in byte offsets from a 1024-byte aligned base: the ring (x's
// tile, then w's big and small tiles; the 3x3 has no x tile), y's tile, the
// 3x3's two windows, a and b (a k-step's a stage with the prologue, a
// window's for the 3x3), the statistics' cross-warp sums, the barriers.
template <int BN, Load kLoad>
struct Layout {
  static constexpr bool kIm2col = kLoad == Load::kIm2col;
  static constexpr int kMaxStages = BN == 128 ? 3 : 5;
  static constexpr int W_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = (kIm2col ? 0 : A_BYTES) + 2 * W_BYTES;
  // y's tile for the TMA store: per consumer warpgroup 64 rows, in BN / 32
  // boxes of 64 rows x 32 f32 (128-byte swizzle)
  static constexpr int Y_WG_BYTES = 64 * BN * 4;
  int win_bytes, y, win, ab, red, bar, total;
  __host__ __device__ Layout(int stages, int boxes, int box_rows) {
    win_bytes = kIm2col ? (boxes * box_rows * 128 + 1023) / 1024 * 1024 : 0;
    y = stages * STAGE_BYTES;
    win = y + 2 * Y_WG_BYTES;
    ab = win + 2 * win_bytes;
    red = ab + (kIm2col ? 2 : (kLoad == Load::kRowsAffine ? stages : 0)) * AB_BYTES;
    bar = red + 2 * 8 * BN * 4;  // [s1 | s2][warp][BN] f32, then full, empty [stages]
    total = bar + (2 * stages + (kIm2col ? 4 : 0)) * 8;  // and the windows' full, empty [2]
  }
};

struct Problem {
  float* part;
  int M, K, N;
  int H, W, C;        // the 3x3's x (NT, H, W, C), M = NT H W
  int n_tiles, tiles;
  int stages;         // ring stages
  int ktiles;         // k-steps a tile (the 3x3: 9 a channel slice)
  int c_pad;          // the 3x3: w's columns a tap in the split scratch (C rounded up to 32)
  Window win;         // the 3x3's window
};

// tf32(v): round to nearest, ties away from zero; the low 13 bits zero
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// relu(v * a + b) as the plain version computes it: the product and the sum
// each rounded, and a relu that keeps NaN, as torch.relu does (max.NaN: one
// instruction where a test and a select would take three)
__device__ __forceinline__ float affine_relu(float v, float a, float b) {
  const float u = __fadd_rn(__fmul_rn(v, a), b);
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(u));
  return r;
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

// w (taps * C, N), rows (tap, c) -> out (2, N, kw = taps * c_pad): [tf32(w)^T;
// tf32(w - tf32(w))^T], column tap * c_pad + c, zero for c >= C (the 1x1:
// taps = 1, c_pad = C = K). Block: 32 x 8 threads over a 32 x 32 tile,
// transposed through shared memory.
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w, float* __restrict__ out, int C, int c_pad, int kw,
               int N) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i;
    const int tap = k / c_pad;
    const int c = k - tap * c_pad;
    const int n = n0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (k < kw && c < C && n < N) ? w[(static_cast<int64_t>(tap) * C + c) * N + n] : 0.f;
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(N) * kw;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i;
    const int k = k0 + threadIdx.x;
    if (n < N && k < kw) {
      const float v = tile[threadIdx.x][i];
      const float big = to_tf32(v);
      out[static_cast<int64_t>(n) * kw + k] = big;
      out[plane + static_cast<int64_t>(n) * kw + k] = to_tf32(__fsub_rn(v, big));
    }
  }
}

// This thread's A fragments of k-step columns 8 kk .. 8 kk + 7 (rows g and
// g + 8 of its warpgroup's 64, columns t and t + 4: the register layout of
// Wgmma), read from a swizzled tile and split: big = tf32(v), small =
// tf32(v - big). rows: the thread's row g; sw: its swizzle (the row % 8,
// which row g + 8 shares). in0, in1: whether rows g and g + 8 hold A, else
// they read 0 (the rows lie in shared memory either way: the loads run
// unpredicated and a select masks them, which keeps the loop free of
// branches). kPrologue: v = relu(v * a + b), with the k-step's a and b in
// ab[0 .. 31] and ab[32 .. 63].
template <bool kPrologue>
__device__ __forceinline__ void load_split(const unsigned char* rows, int sw, int t, bool in0,
                                           bool in1, const float* ab,
                                           uint32_t (&big)[BK / 8][4],
                                           uint32_t (&small)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int chunk = 2 * kk + (e >> 1);  // 16-byte chunk of the 128-byte row
      float v = *reinterpret_cast<const float*>(rows + (e & 1) * 8 * 128 + ((chunk ^ sw) << 4) +
                                                4 * t);
      if constexpr (kPrologue) v = affine_relu(v, ab[4 * chunk + t], ab[BK + 4 * chunk + t]);
      v = ((e & 1) ? in1 : in0) ? v : 0.f;
      const float b = to_tf32(v);
      big[kk][e] = __float_as_uint(b);
      small[kk][e] = __float_as_uint(to_tf32(__fsub_rn(v, b)));
    }
}

// The 3x3's prologue, once a window, in place on its rows that hold pixels of
// x (rows outside x keep the TMA's zero fill, as the reference pads after
// the prologue): thread ct of the 256 consumer threads takes 16-byte chunk
// ct % 8 (channels 4 (ct % 8) .. + 3 of the slice) of rows ct / 8 + 32 q of
// each box.
__device__ __forceinline__ void window_prologue(unsigned char* win, const float* ab, int m0,
                                                int ct, const Problem& p) {
  const int c = ct % 8;
  const float4 a4 = reinterpret_cast<const float4*>(ab)[c];
  const float4 b4 = reinterpret_cast<const float4*>(ab + BK)[c];
  for (int box = 0; box < p.win.boxes; ++box) {
    const int x0 = m0 - p.W - 1 + box * p.win.box_step;  // the box's first row of x
    unsigned char* rows = win + box * p.win.box_rows * 128;
    for (int j = ct / 8; j < p.win.box_rows; j += 32) {
      if (static_cast<unsigned>(x0 + j) >= static_cast<unsigned>(p.M)) continue;
      float4* q = reinterpret_cast<float4*>(rows + j * 128 + ((c ^ (j & 7)) << 4));
      float4 v = *q;
      v.x = affine_relu(v.x, a4.x, b4.x);
      v.y = affine_relu(v.y, a4.y, b4.y);
      v.z = affine_relu(v.z, a4.z, b4.z);
      v.w = affine_relu(v.w, a4.w, b4.w);
      *q = v;
    }
  }
}

// (h << 16) | w of output pixel m = (n, h, w), or -1 past M
__device__ __forceinline__ int pixel_of(int m, const Problem& p) {
  if (m >= p.M) return -1;
  const int q = m / p.W;
  return ((q % p.H) << 16) | (m - q * p.W);
}

// whether tap (dy, dx) of the pixel lies inside the image
__device__ __forceinline__ bool inside(int hw, int dy, int dx, const Problem& p) {
  const int h = (hw >> 16) + dy;
  const int w = (hw & 0xFFFF) + dx;
  return hw >= 0 && static_cast<unsigned>(h) < static_cast<unsigned>(p.H) &&
         static_cast<unsigned>(w) < static_cast<unsigned>(p.W);
}

template <int BN, Load kLoad>
__global__ void __launch_bounds__(kThreads, 1)
tf32_stats_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_wb,
                  const __grid_constant__ CUtensorMap tm_ws, const __grid_constant__ CUtensorMap tm_y,
                  const __grid_constant__ CUtensorMap tm_ab, const Problem p) {
  using Lay = Layout<BN, kLoad>;
  constexpr bool kIm2col = Lay::kIm2col;
  constexpr bool kAffine = kLoad == Load::kRowsAffine;
  const int S = p.stages;
  const Lay L(S, p.win.boxes, p.win.box_rows);
  constexpr int kProducerRegs = 40;
  constexpr int kConsumerRegs = 232;

  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + S;
  uint64_t* wfull = full + 2 * S;  // the 3x3's windows: loaded
  uint64_t* wempty = wfull + 2;    // and read by every consumer thread
  auto stage_x = [&](int s) { return smem + s * Lay::STAGE_BYTES; };  // the 1x1s only
  auto stage_wb = [&](int s) { return smem + s * Lay::STAGE_BYTES + (kIm2col ? 0 : A_BYTES); };
  auto stage_ws = [&](int s) { return stage_wb(s) + Lay::W_BYTES; };
  auto window = [&](int wi) { return smem + L.win + wi * L.win_bytes; };
  // a and b: a stage's (kRowsAffine) or a window's (kIm2col)
  auto ab_of = [&](int i) { return reinterpret_cast<float*>(smem + L.ab + i * AB_BYTES); };

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);  // the producer's arrive with the TMA transaction bytes
      sm90::mbar_init(&empty[s], kConsumers);
    }
    if constexpr (kIm2col)
      for (int wi = 0; wi < 2; ++wi) {
        sm90::mbar_init(&wfull[wi], 1);
        sm90::mbar_init(&wempty[wi], 128 * kConsumers);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ktiles = p.ktiles;  // past K (the 3x3: past C in each tap) the TMA's zero fill
  const int grid = static_cast<int>(gridDim.x);
  const int my_tiles = (p.tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int total = my_tiles * ktiles;  // this CTA's (tile, k-step) stream

  if (wg == kConsumers) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == 0) {
      int s = 0, kt = 0, tile = blockIdx.x, wi = 0;
      uint32_t ph = 0, wph = 0;
      for (int g = 0; g < total; ++g) {
        const int mt = tile / p.n_tiles;
        const int nt = tile - mt * p.n_tiles;
        int kcol = kt * BK;  // the k-step's columns of x and of w's scratch
        if constexpr (kIm2col) {
          // k-step kt of the 3x3 is channel slice kt / 9 of tap kt % 9; the
          // slice's 9 taps read one window, loaded with a and b's channels
          const int cs = kt / 9;
          const int tap = kt - 9 * cs;
          kcol = tap * p.c_pad + cs * BK;
          if (tap == 0) {
            sm90::mbar_wait(&wempty[wi], wph ^ 1);
            sm90::mbar_expect_tx(&wfull[wi], p.win.boxes * p.win.box_rows * 128 + AB_BYTES);
            for (int r = 0; r < p.win.boxes; ++r)
              sm90::tma_load_2d(window(wi) + r * p.win.box_rows * 128, &tm_x, &wfull[wi],
                                cs * BK, mt * BM - p.W - 1 + r * p.win.box_step);
            sm90::tma_load_2d(ab_of(wi), &tm_ab, &wfull[wi], cs * BK, 0);
            if (++wi == 2) {
              wi = 0;
              wph ^= 1;
            }
          }
        }
        sm90::mbar_wait(&empty[s], ph ^ 1);
        sm90::mbar_expect_tx(&full[s], Lay::STAGE_BYTES + (kAffine ? AB_BYTES : 0));
        if constexpr (!kIm2col) sm90::tma_load_2d(stage_x(s), &tm_x, &full[s], kcol, mt * BM);
        if constexpr (kAffine) sm90::tma_load_2d(ab_of(s), &tm_ab, &full[s], kcol, 0);
        sm90::tma_load_2d(stage_wb(s), &tm_wb, &full[s], kcol, nt * BN);
        sm90::tma_load_2d(stage_ws(s), &tm_ws, &full[s], kcol, nt * BN);
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

    int s = 0, tile = blockIdx.x, wi = 0, tap = 0;  // s, ph: the next stage to read
    uint32_t ph = 0, wph = 0;                       // wi, wph, tap: the 3x3's window
    int m0 = 0;                                     // the tile's first row
    int hw0 = -1, hw1 = -1;                         // the 3x3: rows a_row, + 8 (pixel_of)
    bool in0 = true, in1 = true;                    // the 1x1s: rows a_row, + 8 below M
    // wait for the next stage, read and split this thread's A fragments of
    // it; returns the stage
    auto load = [&](uint32_t (&xb)[BK / 8][4], uint32_t (&xs)[BK / 8][4]) {
      const int st = s;
      if constexpr (kIm2col) {
        if (tap == 0) {  // a new window: its prologue, by both warpgroups
          sm90::mbar_wait(&wfull[wi], wph);
          window_prologue(window(wi), ab_of(wi), m0, ct, p);
          sm90::fence_proxy_async();  // the writes, before the window's next TMA load
          sm90::consumer_barrier();
        }
        const int dy = tap / 3 - 1;
        const int dx = tap - 3 * (tap / 3) - 1;
        const int j = (dy + 1) * p.win.band + 1 + a_row + dx;  // the window row of a_row
        load_split<false>(window(wi) + j * 128, j & 7, t4, inside(hw0, dy, dx, p),
                          inside(hw1, dy, dx, p), nullptr, xb, xs);
        if (++tap == 9) {  // the window's last tap: this thread is done with it
          tap = 0;
          sm90::mbar_arrive(&wempty[wi]);
          if (++wi == 2) {
            wi = 0;
            wph ^= 1;
          }
        }
        sm90::mbar_wait(&full[st], ph);
      } else {
        sm90::mbar_wait(&full[st], ph);
        load_split<kAffine>(stage_x(st) + a_row * 128, sw, t4, in0, in1,
                            kAffine ? ab_of(st) : nullptr, xb, xs);
      }
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
      m0 = mt * BM;
      if constexpr (kIm2col) {
        hw0 = pixel_of(m0 + a_row, p);
        hw1 = pixel_of(m0 + a_row + 8, p);
      }
      if constexpr (kAffine) {  // rows past M read 0 after the prologue, not relu(b)
        in0 = m0 + a_row < p.M;
        in1 = m0 + a_row + 8 < p.M;
      }
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
      unsigned char* y_s = smem + L.y + wg * Lay::Y_WG_BYTES;
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

inline int max_stages(int bn) {
  return bn == 128 ? Layout<128, Load::kRows>::kMaxStages : Layout<64, Load::kRows>::kMaxStages;
}

// Shared memory of one CTA, alignment slack included.
template <Load kLoad>
inline int smem_of(int bn, int stages, const Window& win) {
  return 1024 + (bn == 128 ? Layout<128, kLoad>(stages, win.boxes, win.box_rows).total
                           : Layout<64, kLoad>(stages, win.boxes, win.box_rows).total);
}

// The tile width and persistent grid of an (M, ., N) product on `sms` SMs,
// sm90::make_plan's cost model over this kernel's widths: among 128 and 64
// (those that divide N rounded up to 64), the fewest column-time units on the
// busiest SM, ceil(tiles / SMs) * (BN + 32); a tie goes to the wider tile.
// grid = min(tiles, sms): one partial row a CTA. The 1x1s take the width's
// most ring stages.
template <Load kLoad = Load::kRows>
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
                  max_stages(bn), smem_of<kLoad>(bn, max_stages(bn), Window{0, 0, 0, 0})};
    }
  }
  return best;
}

// The 3x3's plan: the widest tile (128 where it divides N rounded up to 64)
// with the most ring stages (at least 2) that fit two windows into a CTA's
// shared memory; where none fit, the narrower width. Not make_plan's cost
// model: each column tile of a row tile loads the window and runs its
// prologue again, so fewer, wider tiles win (layer4: 196 tiles of 128
// columns against 392 of 64). A banded window (52 KB) fits at 64 columns
// and 2 stages, so every W has a plan. grid = min(tiles, sms).
inline bool conv3x3_plan(long long M, int N, int W, int sms, Plan* out, Window* win) {
  *win = sm90::window_plan(W);
  const long long m_tiles = (M + BM - 1) / BM;
  const int n64 = (N + 63) / 64 * 64;
  for (int bn = n64 % 128 == 0 ? 128 : 64; bn >= 64; bn /= 2)
    for (int st = max_stages(bn); st >= 2; --st) {
      const int smem = smem_of<Load::kIm2col>(bn, st, *win);
      if (smem > sm90::kMaxSmem) continue;
      const long long tiles = m_tiles * (n64 / bn);
      *out = Plan{bn, (int)m_tiles, n64 / bn, (int)tiles, (int)(tiles < sms ? tiles : sms), st,
                  smem};
      return true;
    }
  return false;
}

// A row-major f32 matrix (rows of `inner` floats, 16-byte row strides) read in
// boxes of 32 columns (128 bytes: one swizzle row) x box_rows rows, zero-filled
// past its edges.
inline bool encode_f32(CUtensorMap* map, const void* base, uint64_t inner, uint64_t rows,
                       uint32_t box_rows, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {inner * sizeof(float)};
  const cuuint32_t box[2] = {BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, Load kLoad>
cudaError_t launch_bn(const CUtensorMap (&maps)[5], const Problem& p, int grid, int smem,
                      cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  if (smem > sm90::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = tf32_stats_kernel<BN, kLoad>;
  // allow the kernel the most shared memory once per device, not per launch
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sm90::kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

// Split w into its scratch, encode the tensor maps, launch the GEMM and the
// statistics finish on `stream`. The caller has filled and checked p's
// sizes (M, K, N; the 3x3 also H, W, C) and part. x: (M, K), or the 3x3's
// (M, C); w: (K, N), or (9 C, N); ab: (2, K), or (2, C), with the prologue.
// part_rows caps the persistent grid (the device's SM count).
template <Load kLoad>
cudaError_t run(const void* x, const void* w, const void* ab, void* wsplit, void* y, void* stats,
                Problem p, int part_rows, cudaStream_t s) {
  constexpr bool kIm2col = kLoad == Load::kIm2col;
  const int taps = kIm2col ? 9 : 1;
  const int kc = kIm2col ? p.C : p.K;  // x's columns, w's rows a tap
  p.c_pad = kIm2col ? (p.C + BK - 1) / BK * BK : p.K;
  const int kw = taps * p.c_pad;       // the split scratch's columns
  p.ktiles = taps * ((kc + BK - 1) / BK);
  Plan plan;
  if constexpr (kIm2col) {
    if (!conv3x3_plan(p.M, p.N, p.W, part_rows, &plan, &p.win)) return cudaErrorInvalidValue;
  } else {
    plan = make_plan<kLoad>(p.M, p.N, part_rows);
    p.win = Window{0, 0, 0, 0};
  }
  p.n_tiles = plan.n_tiles;
  p.tiles = plan.tiles;
  p.stages = plan.stages;
  float* wb = static_cast<float*>(wsplit);
  float* ws = wb + static_cast<int64_t>(p.N) * kw;
  split_w_kernel<<<dim3((p.N + 31) / 32, (kw + 31) / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w), wb, kc, p.c_pad, kw, p.N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap maps[5];  // x, w's big and small, y, a and b
  if (!encode_f32(&maps[0], x, kc, p.M, kIm2col ? p.win.box_rows : BM) ||
      !encode_f32(&maps[1], wb, kw, p.N, plan.block_n) ||
      !encode_f32(&maps[2], ws, kw, p.N, plan.block_n) || !encode_f32(&maps[3], y, p.N, p.M, 64))
    return cudaErrorInvalidValue;
  if (kLoad == Load::kRows)
    maps[4] = maps[0];  // unused
  else if (!encode_f32(&maps[4], ab, kc, 2, 2, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  err = plan.block_n == 128 ? launch_bn<128, kLoad>(maps, p, plan.grid, plan.smem, s)
                            : launch_bn<64, kLoad>(maps, p, plan.grid, plan.smem, s);
  if (err != cudaSuccess) return err;
  sm90::partials_finish_kernel<<<(p.N + 31) / 32, 256, 0, s>>>(p.part, static_cast<float*>(stats),
                                                             plan.grid, p.N);
  return cudaGetLastError();
}

// The 1x1s' checks: sizes the int arithmetic and the TMA take, K and N % 4
// (16-byte strides), 16-byte aligned operands.
inline cudaError_t check_1x1(const void* x, const void* ab, const void* wsplit, const void* y,
                             int part_rows, long long M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0 || part_rows <= 0 ||
      M > (1ll << 31) - BM || K >= (1 << 21) || N >= (1 << 21))
    return cudaErrorInvalidValue;
  if (!sm90::aligned16(x) || !sm90::aligned16(wsplit) || !sm90::aligned16(y) ||
      (ab != nullptr && !sm90::aligned16(ab)))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace tf32gemm

extern "C" {

// out = {block_n, m_tiles, n_tiles, tiles, grid, stages, smem} of an (M, ., N)
// product without a prologue on `sms` SMs; grid is the partials' row count.
int bdv_gemm_stats_tf32_plan(long long M, int N, int sms, int* out) {
  if (M <= 0 || N <= 0 || sms <= 0 || M > (1ll << 31) - tf32gemm::BM)
    return (int)cudaErrorInvalidValue;
  const tf32gemm::Plan p = tf32gemm::make_plan(M, N, sms);
  out[0] = p.block_n; out[1] = p.m_tiles; out[2] = p.n_tiles; out[3] = p.tiles; out[4] = p.grid;
  out[5] = p.stages; out[6] = p.smem;
  return 0;
}

// out = {block_n, m_tiles, n_tiles, tiles, grid, stages, boxes, box_rows,
// box_step, band, smem} of the 3x3 over M pixels of width W, N channels out,
// on `sms` SMs.
int bdv_conv3x3_stats_tf32_plan(long long M, int N, int W, int sms, int* out) {
  if (M <= 0 || N <= 0 || W <= 0 || sms <= 0 || M > (1ll << 31) - tf32gemm::BM)
    return (int)cudaErrorInvalidValue;
  tf32gemm::Plan p;
  tf32gemm::Window win;
  if (!tf32gemm::conv3x3_plan(M, N, W, sms, &p, &win)) return (int)cudaErrorInvalidValue;
  const int v[11] = {p.block_n, p.m_tiles, p.n_tiles, p.tiles, p.grid, p.stages,
                     win.boxes, win.box_rows, win.box_step, win.band, p.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
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
  cudaError_t err = check_1x1(x, nullptr, wsplit, y, part_rows, M, K, N);
  if (err != cudaSuccess) return (int)err;
  Problem p{};
  p.part = static_cast<float*>(part);
  p.M = (int)M;
  p.K = K;
  p.N = N;
  return (int)run<Load::kRows>(x, w, nullptr, wsplit, y, stats, p, part_rows,
                               static_cast<cudaStream_t>(stream));
}

// y = relu(x * a + b) @ w, the product and the sum each rounded to f32,
// relu keeping NaN; ab: (2, K) f32 = [a; b], 16-byte aligned. The rest as
// bdv_gemm_stats_tf32.
int bdv_gemm_affine_relu_stats_tf32(const void* x, const void* w, const void* ab, void* wsplit,
                                    void* y, void* part, int part_rows, void* stats, long long M,
                                    int K, int N, void* stream) {
  using namespace tf32gemm;
  cudaError_t err = check_1x1(x, ab, wsplit, y, part_rows, M, K, N);
  if (err != cudaSuccess) return (int)err;
  Problem p{};
  p.part = static_cast<float*>(part);
  p.M = (int)M;
  p.K = K;
  p.N = N;
  return (int)run<Load::kRowsAffine>(x, w, ab, wsplit, y, stats, p, part_rows,
                                     static_cast<cudaStream_t>(stream));
}

// y = conv3x3(pad(relu(x * a + b), 1), w), stride 1, 'SAME', + stats. x (NT,
// H, W, C), w (9 C, N) (HWIO (3, 3, C, N) flat), y (NT, H, W, N): f32,
// contiguous; C % 4 == 0, N % 4 == 0; H < 2^15, W < 2^16; x, y, ab (2, C)
// = [a; b] 16-byte aligned. wsplit: (2, N, 9 C32) f32 scratch, C32 = C
// rounded up to 32, 16-byte aligned. part, part_rows, stats as
// bdv_gemm_stats_tf32 (bdv_conv3x3_stats_tf32_plan's grid).
int bdv_conv3x3_affine_relu_stats_tf32(const void* x, const void* w, const void* ab,
                                       void* wsplit, void* y, void* part, int part_rows,
                                       void* stats, long long NT, int H, int W, int C, int N,
                                       void* stream) {
  using namespace tf32gemm;
  // pixel_of packs (h << 16) | w into an int; a window's rows stay in int
  if (NT <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || C % 4 != 0 || N % 4 != 0 ||
      part_rows <= 0 || H >= (1 << 15) || W >= (1 << 16) || C >= (1 << 17) || N >= (1 << 21) ||
      NT * H * W > (1ll << 31) - BM - 4ll * W - 4 * sm90::kBandRows)
    return (int)cudaErrorInvalidValue;
  if (!sm90::aligned16(x) || !sm90::aligned16(ab) || !sm90::aligned16(wsplit) ||
      !sm90::aligned16(y))
    return (int)cudaErrorMisalignedAddress;
  Problem p{};
  p.part = static_cast<float*>(part);
  p.M = (int)(NT * H * W);
  p.K = 9 * C;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  return (int)run<Load::kIm2col>(x, w, ab, wsplit, y, stats, p, part_rows,
                                 static_cast<cudaStream_t>(stream));
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

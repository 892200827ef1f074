// Persistent warp-specialized bf16 GEMM with a BatchNorm-statistics epilogue
// for Hopper (sm_90a): the core of conv1x1_with_stats (conv1x1_stats.cu,
// A = the rows of x), conv1x1_affine_relu_stats (conv1x1_stats.cu, A = the
// rows of bf16(relu(x * a + b))) and conv3x3_affine_relu_stats
// (conv3x3_stats.cu, A = the implicit 3x3 im2col of bf16(relu(x * a + b))).
// The three ways of loading A (ALoad) are one kernel template.
//
//   y  = A @ w               A (M, K) bf16, w (K, N) bf16, f32 accumulation,
//                            y rounded to bf16
//   s1 = sum_rows(y)         per output channel, f32, over the ROUNDED y
//   s2 = sum_rows(y * y)
//
// Bound on the H100: at the ResNet-50 widths the 1x1 products with K or N of
// 64-256 and M = 401408 are bound by bytes (x read once, y written once), the
// deep ones (K = 512-2048, or 9C for the 3x3) by the tensor cores. The design:
//
// * One CTA per SM at most (persistent), three warpgroups: one producer and
//   two consumers that each own 64 rows of a 128 x BN output tile. A CTA walks
//   tiles t = blockIdx.x + i * gridDim.x (a static schedule), so one tile's
//   epilogue overlaps the next tiles' loads, and neighbouring CTAs share A's
//   row tile in L2.
// * BN in {64, 128, 256} per shape (make_plan), so A is read once per row tile
//   where N <= 256; BK = 64: one 128-byte swizzled row of A per output row.
// * Any K and N that are multiples of 8 (the TMA's 16-byte global strides;
//   the wrappers zero-pad the rest, with a = b = 0 on padded channels): the
//   TMA zero-fills the boxes past K and N as it does past M, so the last
//   k-step adds nothing beyond K, the columns past N come out zero, and the
//   epilogue stores and sums only the columns below N. The prologue forms
//   (#7, #8) read a and b as 0 past K (the 3x3: past C), so a zero-filled
//   channel stays 0 through bf16(relu(0 * 0 + 0)).
// * A ring of stages (Layout) with full and empty mbarriers, and for the 3x3
//   two windows with their own. w, and A for the 1x1, come by TMA (128-byte
//   swizzle; rows past M are zero-filled by the TMA unit). The 3x3 reads w
//   as a 3-D (9, C, N) tensor, one tap's 64-channel slice a box, so a slice
//   past C zero-fills instead of reaching the next tap's rows. The encoder
//   is cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so
//   that nothing links libcuda.
// * The 3x3's A comes by TMA too. Its K steps run channel slice by channel
//   slice (64 channels, the last zero-filled past C), the 9 taps of a slice
//   in a row, and all 9 read one window of x seen as an (M, C) matrix,
//   zero-filled where it leaves x, all its 2-D TMA boxes on one mbarrier
//   (window_plan, which the 3xTF32 kernel shares): rows m0 - W - 1 .. m0 +
//   128 + W in as few boxes of equal rows as the box's 256-row limit allows,
//   or, where that is more than three bands of 136 rows, those bands, band
//   dy + 1 from row m0 + dy W - 1, which fit at any W (51 KB a window).
//   Where two windows and the widest ring do not fit the 227 KB a CTA has,
//   the ring takes fewer stages, then a narrower tile (conv3x3_plan); 64
//   columns and 2 stages always fit. Both consumer warpgroups apply the
//   prologue bf16(relu(x * a + b)) to the window once, in place, box by box
//   (a and b staged once a CTA in shared memory over all of C up to
//   kStagedC channels, every ResNet-50 width; past that a 64-channel slice
//   a window, which the producer brings with the window by a bulk copy, so C
//   has no limit); then, for each tap, each warpgroup copies its
//   64 rows of A from the window (row (dy + 1) * band + 1 + r + dx for output
//   row r) into one of two A buffers in the swizzled layout wgmma reads,
//   writing zero where the tap leaves the image (the halo) or the row is
//   past M, as the reference pads after the prologue. So the prologue runs
//   once per input pixel and slice, not once per tap, and A leaves L2 about
//   twice per tile instead of nine times. (Earlier
//   designs: a cp.async gather moved A at about half the TMA's rate; one
//   TMA box per tap with the prologue on it, per tap, spent most of the 3x3's
//   time in the prologue, whether the producer, the consumers or a fourth
//   warpgroup ran it; the register-A form of wgmma would take the consumers'
//   registers from the accumulators.) __fmul_rn / __fadd_rn keep the product
//   and the sum separately rounded, as the plain version computes them.
// * The 1x1 with a prologue loads A as the plain 1x1 does, one TMA box per
//   stage. Once the stage has landed, each consumer warpgroup rewrites its
//   own 64 rows of it in place as bf16(relu(x * a + b)) (the 3x3's
//   arithmetic; a and b straight from global memory, 8 + 8 floats a thread
//   and k-step, read before the wait), fences the generic writes against the
//   async proxy and syncs its 128 threads before its wgmma reads them. No
//   barrier across warpgroups: each reads only its own rows. Rows past M
//   keep the TMA's zero fill, so they add nothing to the statistics.
// * wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate), w read MN-major
//   (its (K, N) row-major layout as it lies in memory). setmaxnreg moves
//   registers from the producer to the consumers.
// * Deep products. The tensor cores' f32 sum drifts as the accumulator
//   grows (on an H100, against float64: 0.78 of a bf16 ulp of y at K =
//   4608, 1.8 at 18432, 3.8 at 36864; bf16_witness.py), so one accumulator
//   sums at most kWholeSteps k-steps (K = 4608: the deepest ResNet-50
//   product, the 3x3 at Cin 512, which keeps its bits). A deeper product
//   (kDeep) restarts the accumulator every kChunkSteps k-steps and, once a
//   chunk's products are done, adds it into a second register array in
//   IEEE f32 (0.51-0.52 of an ulp at every K). That array needs BN / 2 more
//   registers, so a deep product takes at most 128 columns (make_plan).
// * Epilogue from registers: each accumulator is rounded to bf16 and stored
//   with 16-byte stores (after a 4 x 4 transpose inside each quad of lanes),
//   and the rounded values are summed per column: in the thread (its two
//   rows), across the warp's 8 row groups by a shuffle reduce-scatter, then
//   across the 8 consumer warps through shared memory in warp order, and
//   added into the CTA's partial row blockIdx.x of `part` in its static tile
//   order. A's rows past M are zero (the TMA zero-fill, which the prologues
//   leave alone; the 3x3's halo rule), so their y rows are zero and add
//   nothing; they are not stored. A
//   second small kernel sums the gridDim.x partials per column in CTA order.
//   No float atomics anywhere: the statistics repeat bit for bit.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int kConsumers = 2;                  // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileOverhead = 32;              // make_plan's cost model
constexpr int kWholeSteps = 72;                // k-steps one accumulator sums (K = 4608)
constexpr int kChunkSteps = 8;                 // beyond that, a fresh accumulator each 8
constexpr int A_BYTES = BM * BK * 2;           // 16 KB per stage
constexpr int B_BOX_BYTES = 64 * BK * 2;       // one 64-column TMA box of w

// How the kernel gets A: the rows of x (1x1), the rows of x with the prologue
// bf16(relu(x * a + b)) applied in the ring stage (1x1), or the implicit 3x3
// im2col of the prologue's output, built from a window of x, with a and b
// staged over all of C (C <= kStagedC) or a 64-channel slice a window
// (kIm2colSlices: any C).
enum class ALoad { kRows, kRowsAffine, kIm2col, kIm2colSlices };

constexpr int kMaxBoxRows = 256;  // a TMA box's most rows
constexpr int kBandRows = 136;    // a band of a 3x3 window: 130 rows, rounded up to 8
constexpr int kStagedC = 2048;    // the 3x3 stages a and b over all of C up to here (16 KB)

// A 3x3 window of a tile and channel slice, as the bf16 and the 3xTF32
// kernels read it (one 128-byte row a pixel): `boxes` TMA boxes of box_rows
// rows, box i from row m0 - W - 1 + i * box_step of x; tap (dy, dx) of
// output row r reads window row (dy + 1) * band + 1 + r + dx.
struct Window {
  int boxes, box_rows, box_step, band;
};

// Rows m0 - W - 1 .. m0 + 128 + W (128 + 2 W + 2) in the fewest boxes of
// equal rows: one box of exactly the window where it fits (W <= 63), else
// rows rounded up to 8 so that each box starts on a 1024-byte period of the
// 128-byte swizzle; the bands of dy lie W rows apart. Where that is more
// than three bands of kBandRows, the three bands: rows m0 + dy W - 1 ..
// m0 + dy W + 134 of each dy, at any W (each on a swizzle period: 136 rows
// are 17 periods).
inline Window window_plan(int W) {
  const int rows = BM + 2 * W + 2;
  const int boxes = (rows + kMaxBoxRows - 1) / kMaxBoxRows;
  const int box_rows = boxes == 1 ? rows : ((rows + boxes - 1) / boxes + 7) / 8 * 8;
  if (boxes * box_rows <= 3 * kBandRows) return Window{boxes, box_rows, box_rows, W};
  return Window{3, kBandRows, W, kBandRows};
}

// Shared memory, in byte offsets from a 1024-byte aligned base. The ring
// holds w's slices, and for the 1x1 A's; the 3x3 builds each A tile in
// `abuf` from a window of x that its prologue has been applied to (`win`,
// two buffers of `boxes` TMA boxes of `box_rows` rows each). Then the
// statistics' cross-warp sums, the barriers and, for the 3x3, a and b: over
// C rounded up to 64 channels (zero past C), or (kIm2colSlices) each
// window's 64-channel slice.
template <int BN, ALoad kLoad>
struct Layout {
  static constexpr bool kSlices = kLoad == ALoad::kIm2colSlices;
  static constexpr bool kIm2col = kLoad == ALoad::kIm2col || kSlices;
  // the most ring stages; the 3x3 may take fewer where its windows are large
  static constexpr int kMaxStages =
      kIm2col ? (BN == 256 ? 3 : (BN == 128 ? 4 : 6)) : (BN == 256 ? 4 : (BN == 128 ? 5 : 6));
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = (kIm2col ? 0 : A_BYTES) + B_BYTES;
  int win_bytes, abuf, win, red, bar, ab, total;
  __host__ __device__ Layout(int stages, int boxes, int box_rows, int C) {
    win_bytes = kIm2col ? (boxes * box_rows * 128 + 1023) / 1024 * 1024 : 0;
    abuf = stages * STAGE_BYTES;
    win = abuf + (kIm2col ? 2 * A_BYTES : 0);
    red = win + 2 * win_bytes;                     // [s1 | s2][warp][BN] f32
    bar = red + 2 * 8 * BN * 4;                    // full, empty [stages]; wfull, wempty [2]
    ab = (bar + (2 * stages + 4) * 8 + 15) / 16 * 16;  // 16-byte aligned for float4 reads
    const int ab_floats = kSlices ? 2 * 2 * BK : 2 * ((C + BK - 1) / BK * BK);
    total = ab + (kIm2col ? 4 * ab_floats : 0);
  }
};

// The problem as the kernel sees it. The 1x1 reads M, K, N (and a, b with
// the prologue), the 3x3 all of it.
struct Problem {
  const bf16* x;   // im2col: x (NT, H, W, C)
  const float* a;  // the prologue's scale and shift: (K,) for the 1x1, (C,) for the 3x3
  const float* b;
  bf16* y;
  float* part;
  int M, K, N;
  int H, W, C;
  int n_tiles, tiles;
  int stages;  // the 3x3's ring stages (the 1x1 takes Layout::kMaxStages)
  Window win;  // the 3x3's window
};

// ---- PTX helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with this parity has completed. A wait of more
// than 10 s traps: a broken pipeline fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_barrier() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void warpgroup_barrier(int wg) {  // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each >> 4.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D (64 x N, f32, registers) (+)= A (64 x 16, K-major in shared memory) x
// B (16 x N, MN-major in shared memory: imm-trans-b = 1). scale_d = 0 starts
// the sum afresh.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---- epilogue helpers ------------------------------------------------------------

// 4 x 4 transpose of 32-bit values inside each quad of lanes (lane & 3 = q):
// afterwards v[k] of lane q is what v[q] of lane k was.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool b1 = q & 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b1 ? v[k] : v[k + 2], 2);
    v[k] = b1 ? r : v[k];
    v[k + 2] = b1 ? v[k + 2] : r;
  }
  const bool b0 = q & 1;
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b0 ? v[k] : v[k + 1], 1);
    v[k] = b0 ? r : v[k];
    v[k + 1] = b0 ? v[k + 1] : r;
  }
}

// One step of a reduce-scatter over the lanes that differ in lane bit `kBit`:
// of the first kBlocks blocks of 4 values, a lane keeps the lower half where
// the bit is clear and the upper half where it is set, moved to the front,
// each summed with its partner's copy (mine + partner's, in that order).
template <int kBlocks, int kBit, int R>
__device__ __forceinline__ void reduce_scatter(float (&v)[R], int lane) {
  const bool up = lane & kBit;
#pragma unroll
  for (int i = 0; i < 4 * kBlocks / 2; ++i) {
    const float lo = v[i];
    const float hi = v[i + 4 * kBlocks / 2];
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, kBit);
  }
}

// ---- the prologue x -> bf16(relu(x * a + b)) -------------------------------------

// a[c .. c + 7] and b[c .. c + 7] (16-byte aligned; shared or global
// memory), or zeros where c >= limit (the channels past K: limit % 8 == 0)
__device__ __forceinline__ void load_affine(const float* a, const float* b, int c, int limit,
                                            float (&av)[8], float (&bv)[8]) {
  const bool in = c < limit;
#pragma unroll
  for (int q = 0; q < 8; q += 4) {
    float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = a4;
    if (in) {
      a4 = *reinterpret_cast<const float4*>(a + c + q);
      b4 = *reinterpret_cast<const float4*>(b + c + q);
    }
    av[q] = a4.x; av[q + 1] = a4.y; av[q + 2] = a4.z; av[q + 3] = a4.w;
    bv[q] = b4.x; bv[q + 1] = b4.y; bv[q + 2] = b4.z; bv[q + 3] = b4.w;
  }
}

// The 16-byte chunk at row j, chunk c (8 channels) of a buffer of 128-byte
// rows in the 128-byte swizzle (1024-byte aligned): slot c ^ (j & 7) of row j
__device__ __forceinline__ uint4* swizzled(unsigned char* buf, int j, int c) {
  return reinterpret_cast<uint4*>(buf + j * 128 + ((c ^ (j & 7)) << 4));
}

// The prologue on one chunk of 8 bf16 channels (scale av, shift bv)
__device__ __forceinline__ uint4 affine_relu_chunk(uint4 v, const float (&av)[8],
                                                   const float (&bv)[8]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // a bf16 pair -> two f32 (a bf16 is the upper half of its f32)
    const float lo = __fadd_rn(__fmul_rn(__uint_as_float(w[q] << 16), av[2 * q]), bv[2 * q]);
    const float hi =
        __fadd_rn(__fmul_rn(__uint_as_float(w[q] & 0xFFFF0000u), av[2 * q + 1]), bv[2 * q + 1]);
    // one rounding of the pair to bf16, then relu that keeps NaN (rounding
    // is monotonic and keeps the sign, so relu commutes with it)
    const __nv_bfloat162 o = __hmax2_nan(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f));
    w[q] = *reinterpret_cast<const uint32_t*>(&o);
  }
  return v;
}

// The 1x1's prologue, in place, on the warpgroup's 64 rows of a ring stage
// (rows row0 .. row0 + 63 of x): thread t takes chunk t % 8 of rows t / 8 +
// 16 it, all four loads first. Rows past M keep the TMA's zero fill.
__device__ __forceinline__ void tile_prologue(unsigned char* a_s, int t, int row0, int M,
                                              const float (&av)[8], const float (&bv)[8]) {
  uint4 v[4];
#pragma unroll
  for (int it = 0; it < 4; ++it) v[it] = *swizzled(a_s, t / 8 + 16 * it, t % 8);
#pragma unroll
  for (int it = 0; it < 4; ++it)
    if (row0 + t / 8 + 16 * it < M)
      *swizzled(a_s, t / 8 + 16 * it, t % 8) = affine_relu_chunk(v[it], av, bv);
}

// The 3x3's prologue on `rows` rows of a window from row `row0` of x as an
// (M, C) matrix on, in place where they hold pixels of x (rows outside x
// keep the zero fill, as the reference pads after the prologue): thread ct
// (of the 256 consumer threads) takes chunk ct % 8 of rows ct / 8 + 32 q.
__device__ __forceinline__ void prologue_rows(unsigned char* rows_s, int rows, int row0, int ct,
                                              int M, const float (&av)[8], const float (&bv)[8]) {
  for (int j = ct / 8; j < rows; j += 32) {
    if (static_cast<unsigned>(row0 + j) >= static_cast<unsigned>(M)) continue;
    uint4* q4 = swizzled(rows_s, j, ct % 8);
    *q4 = affine_relu_chunk(*q4, av, bv);
  }
}

// The 3x3's prologue, once per window, on the rows the taps read: boxes end
// to end hold rows m0 - W - 1 .. m0 + 128 + W of x in a row; a band, rows
// m0 + dy W - 1 .. m0 + dy W + 128 of its 136.
__device__ __forceinline__ void window_prologue(unsigned char* win, const Window& wp, int m0,
                                                int W, int ct, int M, const float (&av)[8],
                                                const float (&bv)[8]) {
  if (wp.box_step == wp.box_rows) {
    prologue_rows(win, BM + 2 * W + 2, m0 - W - 1, ct, M, av, bv);
  } else {
    for (int i = 0; i < wp.boxes; ++i)
      prologue_rows(win + i * wp.box_rows * 128, BM + 2, m0 + (i - 1) * W - 1, ct, M, av, bv);
  }
}

// ---- the 3x3's A ---------------------------------------------------------------

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

// One tap's A rows from the window, into `a_s`: row r of the tile is window
// row (dy + 1) * band + 1 + r + dx where the tap lies inside the image, zero
// where it does not (the halo, and the rows past M), as the reference pads
// after the prologue. Thread t of consumer warpgroup wg copies chunk t % 8
// of its rows 64 wg + t / 8 + 16 it; hw: their output pixels (pixel_of).
__device__ __forceinline__ void copy_tap(unsigned char* a_s, const unsigned char* win, int tap,
                                         const int (&hw)[4], int wg, int t, const Problem& p) {
  const int chunk = t % 8;
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;
  const int shift = (dy + 1) * p.win.band + 1 + dx;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = 64 * wg + t / 8 + 16 * it;
    const int j = r + shift;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (inside(hw[it], dy, dx, p))
      v = *reinterpret_cast<const uint4*>(win + j * 128 + ((chunk ^ (j & 7)) << 4));
    *reinterpret_cast<uint4*>(a_s + r * 128 + ((chunk ^ (r & 7)) << 4)) = v;
  }
}

// ---- the kernel ----------------------------------------------------------------

template <int BN, ALoad kLoad, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_stats_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w, const Problem p) {
  using Lay = Layout<BN, kLoad>;
  constexpr bool kIm2col = Lay::kIm2col;
  const int S = kIm2col ? p.stages : Lay::kMaxStages;
  const Lay L(S, p.win.boxes, p.win.box_rows, p.C);
  const int c64 = kIm2col ? (p.C + BK - 1) / BK * BK : 0;
  constexpr bool staged = !Lay::kSlices;  // im2col: a and b over all of C, else a window's slice
  constexpr int kProducerRegs = 40;
  constexpr int kConsumerRegs = 232;

  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + S;
  uint64_t* wfull = full + 2 * S;   // the 3x3's windows: loaded
  uint64_t* wempty = wfull + 2;     // and released by both consumer warpgroups
  // im2col: a then b over C (staged), or window wb's slice at + 2 BK wb
  float* ab = reinterpret_cast<float*>(smem + L.ab);
  auto stage_a = [&](int s) { return smem + s * Lay::STAGE_BYTES; };  // 1x1 only
  auto stage_b = [&](int s) { return smem + s * Lay::STAGE_BYTES + (kIm2col ? 0 : A_BYTES); };
  auto window = [&](int wb) { return smem + L.win + wb * L.win_bytes; };

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive with the TMA transaction bytes
      mbar_init(&empty[s], kConsumers);
    }
    for (int wb = 0; wb < 2; ++wb) {
      mbar_init(&wfull[wb], 1);
      mbar_init(&wempty[wb], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // past K (the 3x3: past C in each tap) the TMA's zero fill
  const int ktiles = kIm2col ? 9 * ((p.C + BK - 1) / BK) : (p.K + BK - 1) / BK;
  const int grid = static_cast<int>(gridDim.x);
  const int my_tiles = (p.tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int total = my_tiles * ktiles;  // this CTA's (tile, k-step) stream

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == 0) {
      int s = 0, kt = 0, tile = blockIdx.x, wb = 0;
      uint32_t ph = 0, wph = 0;
      for (int g = 0; g < total; ++g) {
        const int mt = tile / p.n_tiles;
        const int nt = tile - mt * p.n_tiles;
        int w_row = kt * BK;  // the k-step's rows of w
        if constexpr (kIm2col) {
          // k-step kt of the 3x3 is channel slice kt / 9 of tap kt % 9 (w's
          // box (tap, cs * 64, columns)). Each slice's 9 taps read one window
          // of x as an (M, C) matrix (window_plan's boxes), zero-filled where
          // it leaves x.
          const int cs = kt / 9;
          const int tap = kt - 9 * cs;
          w_row = cs * BK;
          if (tap == 0) {
            // not staged: a and b over the slice's channels below C (% 8)
            const int ab_n = staged ? 0 : (p.C - cs * BK < BK ? p.C - cs * BK : BK);
            mbar_wait(&wempty[wb], wph ^ 1);
            mbar_expect_tx(&wfull[wb], p.win.boxes * p.win.box_rows * 128 + 2 * 4 * ab_n);
            for (int r = 0; r < p.win.boxes; ++r)
              tma_load_2d(window(wb) + r * p.win.box_rows * 128, &tm_a, &wfull[wb], cs * BK,
                          mt * BM - p.W - 1 + r * p.win.box_step);
            if constexpr (!staged) {
              bulk_load(ab + wb * 2 * BK, p.a + cs * BK, 4 * ab_n, &wfull[wb]);
              bulk_load(ab + wb * 2 * BK + BK, p.b + cs * BK, 4 * ab_n, &wfull[wb]);
            }
            if (++wb == 2) {
              wb = 0;
              wph ^= 1;
            }
          }
        }
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], Lay::STAGE_BYTES);
        if constexpr (!kIm2col) tma_load_2d(stage_a(s), &tm_a, &full[s], kt * BK, mt * BM);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          if constexpr (kIm2col)
            tma_load_3d(stage_b(s) + j * B_BOX_BYTES, &tm_w, &full[s], nt * BN + j * 64, w_row,
                        kt % 9);
          else
            tma_load_2d(stage_b(s) + j * B_BOX_BYTES, &tm_w, &full[s], nt * BN + j * 64, w_row);
        }
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
    static_assert(!kDeep || BN <= 128, "a deep product's two arrays need BN <= 128");
    float acc[BN / 2];
    float sum[kDeep ? BN / 2 : 1];  // kDeep: the chunks done so far
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
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

    if constexpr (kIm2col && staged) {
      for (int c = ct; c < c64; c += 128 * kConsumers) {
        ab[c] = c < p.C ? p.a[c] : 0.f;
        ab[c64 + c] = c < p.C ? p.b[c] : 0.f;
      }
      consumer_barrier();
    }

    int s = 0, tile = blockIdx.x, wb = 0;
    uint32_t ph = 0, wph = 0;
    for (int i = 0; i < my_tiles; ++i, tile += grid) {
      const int mt = tile / p.n_tiles;
      const int nt = tile - mt * p.n_tiles;
      // im2col: this thread copies chunk t % 8 of the warpgroup's rows
      // 64 wg + t / 8 + 16 it, it < 4
      int hw[4];
      if constexpr (kIm2col) {
#pragma unroll
        for (int it = 0; it < 4; ++it) hw[it] = pixel_of(mt * BM + 64 * wg + t / 8 + 16 * it, p);
      }
      int prev = 0;
      for (int kt = 0, cs = 0, tap = 0; kt < ktiles; ++kt) {
        uint32_t a_addr;
        if constexpr (kIm2col) {
          if (tap == 0) {  // a new window: its prologue, by both warpgroups
            float av[8], bv[8];  // the slice's a and b, 0 past C
            if constexpr (staged) load_affine(ab, ab + c64, cs * BK + 8 * (ct % 8), c64, av, bv);
            mbar_wait(&wfull[wb], wph);
            if constexpr (!staged)
              load_affine(ab + wb * 2 * BK, ab + wb * 2 * BK + BK, 8 * (ct % 8), p.C - cs * BK,
                          av, bv);
            window_prologue(window(wb), p.win, mt * BM, p.W, ct, p.M, av, bv);
            consumer_barrier();
          }
          // A in one of two buffers: the products of k-step kt - 2 that read
          // this one are done (wgmma_wait<1> below)
          unsigned char* a_s = smem + L.abuf + (kt & 1) * A_BYTES;
          copy_tap(a_s, window(wb), tap, hw, wg, t, p);
          fence_proxy_async();
          warpgroup_barrier(wg);  // the warpgroup's rows are in place
          if (++tap == 9) {  // the window's last tap: release it
            if (t == 0) mbar_arrive(&wempty[wb]);
            if (++wb == 2) {
              wb = 0;
              wph ^= 1;
            }
            tap = 0;
            ++cs;
          }
          a_addr = smem_u32(a_s) + wg * 64 * 128;
          mbar_wait(&full[s], ph);
        } else if constexpr (kLoad == ALoad::kRowsAffine) {
          unsigned char* a_s = stage_a(s) + wg * 64 * 128;
          float av[8], bv[8];
          load_affine(p.a, p.b, kt * BK + 8 * (t % 8), p.K, av, bv);
          mbar_wait(&full[s], ph);
          tile_prologue(a_s, t, mt * BM + 64 * wg, p.M, av, bv);
          fence_proxy_async();
          warpgroup_barrier(wg);  // the warpgroup's rows are in place
          a_addr = smem_u32(a_s);
        } else {
          a_addr = smem_u32(stage_a(s)) + wg * 64 * 128;
          mbar_wait(&full[s], ph);
        }
        const uint32_t b_addr = smem_u32(stage_b(s));
        // the k-step's place in its accumulator's run (kDeep: a chunk)
        const int step = kDeep ? kt % kChunkSteps : kt;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          // A: K-major, rows 128 bytes apart, 8-row groups 1024 apart, +32 bytes per k16.
          // w: MN-major, k rows 128 bytes apart, 8-row groups 1024 apart, 64-column
          //    boxes B_BOX_BYTES apart, +16 rows per k16.
          Wgmma<BN>::mma(acc, smem_desc(a_addr + kk * 32, 16, 1024),
                         smem_desc(b_addr + kk * 16 * 128, B_BOX_BYTES, 1024), (step | kk) != 0);
        wgmma_commit();
        fence_acc(acc);
        if (kDeep && (step == kChunkSteps - 1 || kt == ktiles - 1)) {
          // the chunk's products are done: into the sum, in IEEE f32
          wgmma_wait<0>();
          fence_acc(acc);
          if constexpr (kDeep) {
            if (kt < kChunkSteps) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) sum[i] = acc[i];
            } else {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
            }
          }
        } else {
          wgmma_wait<1>();  // the previous k-step's products are done: release its stage
        }
        fence_acc(acc);
        if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(&empty[prev]);
      if constexpr (kDeep) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i];
      }

      // Epilogue. acc[4j + 2i + c] is row 16 * warp + lane / 4 + 8 i, column
      // 8 j + 2 (lane % 4) + c of the warpgroup's 64 x BN block.
      constexpr int J = BN / 8;
      const int q = lane & 3;
      const int row = mt * BM + wg * 64 + warp * 16 + (lane >> 2);
      const bool store0 = row < p.M;
      const bool store1 = row + 8 < p.M;
      // column block j0 + q of the tile: 8 columns, wholly below N or past it
      const int col0 = nt * BN + 8 * q;
      // lane q stores the 16 bytes of column block j0 + q of its two rows
      bf16* y0 = p.y + static_cast<int64_t>(row) * p.N + nt * BN + 8 * q;
      bf16* y1 = y0 + 8 * static_cast<int64_t>(p.N);
      // the CTA's partials of this tile's columns, loaded now, added at the end
      const bool mine = ct < BN && nt * BN + ct < p.N;
      float old1 = 0.f, old2 = 0.f;
      if (mine) {
        old1 = part1[nt * BN + ct];
        old2 = part2[nt * BN + ct];
      }
#pragma unroll
      for (int j0 = 0; j0 < J; j0 += 4) {
        uint32_t top[4], bot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + k;
          const __nv_bfloat162 t2 = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
          const float2 u = __bfloat1622float2(t2);
          const float2 v = __bfloat1622float2(b2);
          // acc now holds the two rows' sums: s(c0), s(c1), s2(c0), s2(c1)
          acc[4 * j] = u.x + v.x;
          acc[4 * j + 1] = u.y + v.y;
          acc[4 * j + 2] = u.x * u.x + v.x * v.x;
          acc[4 * j + 3] = u.y * u.y + v.y * v.y;
          top[k] = *reinterpret_cast<const uint32_t*>(&t2);
          bot[k] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        quad_transpose(top, q);
        quad_transpose(bot, q);
        const bool in_n = col0 + 8 * j0 < p.N;
        if (store0 && in_n)
          *reinterpret_cast<uint4*>(y0 + 8 * j0) = make_uint4(top[0], top[1], top[2], top[3]);
        if (store1 && in_n)
          *reinterpret_cast<uint4*>(y1 + 8 * j0) = make_uint4(bot[0], bot[1], bot[2], bot[3]);
      }
      // sum over the warp's 16 rows: a reduce-scatter over lane bits 4, 3, 2
      reduce_scatter<J, 16>(acc, lane);
      reduce_scatter<J / 2, 8>(acc, lane);
      reduce_scatter<J / 4, 4>(acc, lane);
      const int jb = ((lane & 4) ? J / 8 : 0) + ((lane & 8) ? J / 4 : 0) + ((lane & 16) ? J / 2 : 0);
#pragma unroll
      for (int j = 0; j < J / 8; ++j) {
        const int c = w8 * BN + 8 * (jb + j) + 2 * q;
        red1[c] = acc[4 * j];
        red1[c + 1] = acc[4 * j + 1];
        red2[c] = acc[4 * j + 2];
        red2[c + 1] = acc[4 * j + 3];
      }
      consumer_barrier();
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
      consumer_barrier();  // red is rewritten by the next tile
    }
  }
}

// part (2, grid, N) -> stats (2, N). Block: 32 columns x 8 warps; warp w sums
// the partials g = w, w + 8, ... in order, then warp 0 adds the 8 in order.
__global__ void __launch_bounds__(256)
partials_finish_kernel(const float* __restrict__ part, float* __restrict__ stats, int grid, int N) {
  __shared__ float sh[2][8][32];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (col < N) {
#pragma unroll 4
    for (int g = w; g < grid; g += 8) {
      a += part[static_cast<int64_t>(g) * N + col];
      b += part[static_cast<int64_t>(grid + g) * N + col];
    }
  }
  sh[0][w][lane] = a;
  sh[1][w][lane] = b;
  __syncthreads();
  if (w == 0 && col < N) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1 += sh[0][i][lane];
      s2 += sh[1][i][lane];
    }
    stats[col] = s1;
    stats[N + col] = s2;
  }
}

// ---- host side -------------------------------------------------------------------

struct Plan {
  int block_n, m_tiles, n_tiles, tiles, grid;
};

// The tile width and persistent grid of an (M, ., N) product of `ksteps`
// k-steps on `sms` SMs: among the widths that divide N rounded up to 64 (N
// itself where N % 64 == 0), at most 128 for a deep product (ksteps >
// kWholeSteps), the fewest column-time units on the busiest SM,
// ceil(tiles / SMs) * (BN + kTileOverhead); a tie goes to the wider tile,
// which reads A fewer times. grid = min(tiles, sms).
inline Plan make_plan(long long M, int N, int sms, int ksteps) {
  Plan best{0, 0, 0, 0, 0};
  long long best_cost = -1;
  const long long m_tiles = (M + BM - 1) / BM;
  const int n64 = (N + 63) / 64 * 64;
  for (int bn : {256, 128, 64}) {
    if (n64 % bn != 0 || (bn > 128 && ksteps > kWholeSteps)) continue;
    const long long tiles = m_tiles * (n64 / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + kTileOverhead);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = Plan{bn, (int)m_tiles, n64 / bn, (int)tiles, (int)(tiles < sms ? tiles : sms)};
    }
  }
  return best;
}

constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may have on sm_90

// Shared memory of one 3x3 CTA, alignment slack included.
template <ALoad kLoad>
inline int conv3x3_smem_of(int bn, int stages, const Window& win, int C) {
  switch (bn) {
    case 256: return 1024 + Layout<256, kLoad>(stages, win.boxes, win.box_rows, C).total;
    case 128: return 1024 + Layout<128, kLoad>(stages, win.boxes, win.box_rows, C).total;
    default: return 1024 + Layout<64, kLoad>(stages, win.boxes, win.box_rows, C).total;
  }
}

inline int conv3x3_smem(int bn, int stages, const Window& win, int C) {
  return C <= kStagedC ? conv3x3_smem_of<ALoad::kIm2col>(bn, stages, win, C)
                       : conv3x3_smem_of<ALoad::kIm2colSlices>(bn, stages, win, C);
}

inline int im2col_max_stages(int bn) {
  return bn == 256 ? Layout<256, ALoad::kIm2col>::kMaxStages
                   : (bn == 128 ? Layout<128, ALoad::kIm2col>::kMaxStages
                                : Layout<64, ALoad::kIm2col>::kMaxStages);
}

struct Conv3x3Plan {
  Plan tiles;
  int stages, smem;
  Window win;
};

// The k-steps of a 3x3 over C input channels: 9 taps of each 64-channel slice
inline int conv3x3_ksteps(int C) { return 9 * ((C + BK - 1) / BK); }

// The 3x3's plan: make_plan's tile width, with the most ring stages (at
// least 2) that fit two windows into a CTA's shared memory; where none fit,
// the next narrower width. A window is at most three bands of kBandRows
// rows (51 KB), so 64 columns and 2 stages fit at any W; false only if that
// ever changed.
inline bool conv3x3_plan(long long M, int N, int W, int C, int sms, Conv3x3Plan* out) {
  out->win = window_plan(W);
  const Plan first = make_plan(M, N, sms, conv3x3_ksteps(C));
  const int n64 = (N + 63) / 64 * 64;
  for (int bn = first.block_n; bn >= 64; bn /= 2) {
    for (int st = im2col_max_stages(bn); st >= 2; --st) {
      const int smem = conv3x3_smem(bn, st, out->win, C);
      if (smem > kMaxSmem) continue;
      const long long m_tiles = (M + BM - 1) / BM;
      const long long tiles = m_tiles * (n64 / bn);
      out->tiles = bn == first.block_n
                       ? first
                       : Plan{bn, (int)m_tiles, n64 / bn, (int)tiles, (int)(tiles < sms ? tiles : sms)};
      out->stages = st;
      out->smem = smem;
      return true;
    }
  }
  return false;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, through the runtime (no libcuda at link time).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(f)
                                                                   : nullptr;
  }();
  return fn;
}

// A row-major bf16 tensor of `rank` dims (dims[0] innermost, 16-byte row
// strides), read in boxes of 64 columns (128 bytes: one swizzle row) x
// box[1] rows (x 1 in the third dim), zero-filled past its edges.
inline bool encode(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                   uint32_t box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t strides[2] = {dims[0] * sizeof(bf16), dims[0] * dims[1] * sizeof(bf16)};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, ALoad kLoad, bool kDeep>
cudaError_t launch_bn(const CUtensorMap& tm_a, const CUtensorMap& tm_w, const Problem& p, int grid,
                      cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  auto kernel = wgmma_stats_kernel<BN, kLoad, kDeep>;
  const int stages = Layout<BN, kLoad>::kIm2col ? p.stages : Layout<BN, kLoad>::kMaxStages;
  const int smem =  // + alignment slack
      1024 + Layout<BN, kLoad>(stages, p.win.boxes, p.win.box_rows, p.C).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // allow the kernel the most shared memory once per device, not per launch
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(tm_a, tm_w, p);
  return cudaGetLastError();
}

// Launch the GEMM and the statistics finish on `stream`. The caller has checked
// K % 8 == 0 and N % 8 == 0 (im2col: C % 8 == 0), the alignment, and filled
// p's pointers and sizes (with a prologue, a and b). part: (2, part_rows, N)
// f32 scratch; the persistent grid is make_plan(M, N, part_rows).grid <=
// part_rows CTAs (the 3x3: conv3x3_plan's), so part_rows is the grid's cap
// (the device's SM count, one CTA per SM). stats: (2, N) f32 = [sum y; sum y^2].
template <ALoad kLoad>
cudaError_t launch_wgmma_stats(Problem p, int part_rows, const void* w, void* stats,
                               cudaStream_t stream) {
  constexpr bool kIm2col = kLoad == ALoad::kIm2col;
  if (part_rows <= 0) return cudaErrorInvalidValue;
  Plan plan;
  CUtensorMap tm_a, tm_w;
  if constexpr (kIm2col) {
    // w as (9, C, N): a tap's channel slice zero-fills past C; x as (M, C)
    // pixels, in the window's boxes
    Conv3x3Plan cp;
    if (!conv3x3_plan(p.M, p.N, p.W, p.C, part_rows, &cp)) return cudaErrorInvalidValue;
    plan = cp.tiles;
    p.stages = cp.stages;
    p.win = cp.win;
    const cuuint64_t w_dims[3] = {(cuuint64_t)p.N, (cuuint64_t)p.C, 9};
    const cuuint64_t x_dims[2] = {(cuuint64_t)p.C, (cuuint64_t)p.M};
    if (!encode(&tm_w, w, 3, w_dims, BK) || !encode(&tm_a, p.x, 2, x_dims, p.win.box_rows))
      return cudaErrorInvalidValue;
  } else {
    // w as (K, N), x as (M, K) rows in 128-row boxes
    plan = make_plan(p.M, p.N, part_rows, (p.K + BK - 1) / BK);
    const cuuint64_t w_dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K};
    const cuuint64_t x_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
    if (!encode(&tm_w, w, 2, w_dims, BK) || !encode(&tm_a, p.x, 2, x_dims, BM))
      return cudaErrorInvalidValue;
  }
  p.n_tiles = plan.n_tiles;
  p.tiles = plan.tiles;
  const bool deep = (kIm2col ? conv3x3_ksteps(p.C) : (p.K + BK - 1) / BK) > kWholeSteps;
  cudaError_t err = cudaErrorInvalidValue;
  if (kIm2col && p.C > kStagedC) {  // a and b a slice a window; so deep, so <= 128 columns
    if constexpr (kIm2col)
      err = plan.block_n == 128
                ? launch_bn<128, ALoad::kIm2colSlices, true>(tm_a, tm_w, p, plan.grid, stream)
                : launch_bn<64, ALoad::kIm2colSlices, true>(tm_a, tm_w, p, plan.grid, stream);
  } else {
    switch (plan.block_n * 2 + (deep ? 1 : 0)) {  // make_plan gives a deep product <= 128
      case 512: err = launch_bn<256, kLoad, false>(tm_a, tm_w, p, plan.grid, stream); break;
      case 256: err = launch_bn<128, kLoad, false>(tm_a, tm_w, p, plan.grid, stream); break;
      case 257: err = launch_bn<128, kLoad, true>(tm_a, tm_w, p, plan.grid, stream); break;
      case 129: err = launch_bn<64, kLoad, true>(tm_a, tm_w, p, plan.grid, stream); break;
      default: err = launch_bn<64, kLoad, false>(tm_a, tm_w, p, plan.grid, stream); break;
    }
  }
  if (err != cudaSuccess) return err;
  partials_finish_kernel<<<(p.N + 31) / 32, 256, 0, stream>>>(p.part, static_cast<float*>(stats),
                                                              plan.grid, p.N);
  return cudaGetLastError();
}

}  // namespace sm90

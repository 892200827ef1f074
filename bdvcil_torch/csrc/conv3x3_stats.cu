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
// (dy, dx, c), which is w.reshape(9*C, N), N = Cout, on the persistent wgmma
// core of gemm_stats_sm90.cuh (its note has the details). The im2col matrix
// is never materialized. The K steps run channel slice by channel slice (64
// channels; w is read as a (9, C, N) tensor, so the last slice of a tap
// zero-fills past C); for each slice of a 128-row tile the TMA brings a
// window of x seen as (M, C), zero-filled where it leaves x, in boxes on one
// barrier (sm90::window_plan): rows m0 - W - 1 .. m0 + 128 + W in one box
// where W <= 63 and in boxes of at most 256 rows beyond, or, where that is
// more, three bands of 136 rows, band dy + 1 from row m0 + dy W - 1 (51 KB
// a window at any W). The two consumer warpgroups apply the prologue to the
// window once, in place (a and b, 0 past C, staged in shared memory over all
// of C up to 2048 channels, past that a 64-channel slice brought with each
// window), then copy each of the 9 taps' A rows from it, shifted by one image
// row and column per dy and dx, into the swizzled layout wgmma reads,
// writing zero where the tap leaves the image (the halo) or the row is past
// M. Past Cin 512 (K > 4608) the accumulator restarts every 8 k-steps and
// is added up in IEEE f32 (the tensor cores' own sum drifts past a bf16 ulp
// of y at such depths). Any NT, H < 2^15, W < 2^16 (pixel_of's packing) and
// M within int rows, any C and N that are multiples of 8 (the TMA's 16-byte
// strides; the wrapper zero-pads the rest).
//
// Bound: at layer1 (128 x 56 x 56, 64 -> 64) the bytes (x and y once, 102.8
// MB) bound it at 0.031 ms; at layer2-4 (K = 1152-4608) the operations (29.6
// GFLOP at every width, 0.030 ms). What the design does about it: x leaves
// L2 about twice per tile and slice instead of nine times (the window
// instead of one gather per tap), the prologue runs once per pixel and slice
// instead of once per tap, the tile width is picked per shape (64-256), so
// that for N <= 256 the window is read for one column tile only, and the
// 2-6 stage ring of w overlaps the loads with the products.

#include "gemm_stats_sm90.cuh"

using sm90::aligned16;

extern "C" {

// out = {block_n, m_tiles, n_tiles, tiles, grid, stages, boxes, box_rows,
// box_step, band, smem} of the 3x3 over NT*H*W = M pixels of width W, C (%
// 8) channels in and N (% 8) out, on `sms` SMs.
int bdv_conv3x3_stats_plan(long long M, int N, int W, int C, int sms, int* out) {
  if (M <= 0 || N <= 0 || W <= 0 || C <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  sm90::Conv3x3Plan p;
  if (!sm90::conv3x3_plan(M, N, W, C, sms, &p)) return (int)cudaErrorInvalidValue;
  const int v[11] = {p.tiles.block_n, p.tiles.m_tiles, p.tiles.n_tiles, p.tiles.tiles,
                     p.tiles.grid,    p.stages,        p.win.boxes,     p.win.box_rows,
                     p.win.box_step,  p.win.band,      p.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// x (NT, H, W, C), w (9*C, N), y (NT, H, W, N): bf16, contiguous; C % 8 ==
// 0, N % 8 == 0, H < 2^15, W < 2^16. a, b: (C,) f32, 16-byte aligned.
// part: (2, part_rows, N) f32 scratch, one row per persistent CTA; the grid
// has at most part_rows CTAs (pass the device's SM count). stats: (2, N) f32.
int bdv_conv3x3_affine_relu_stats(const void* x, const void* w, const void* a, const void* b,
                                  void* y, void* part, int part_rows, void* stats, long long NT,
                                  int H, int W, int C, int N, void* stream) {
  if (NT <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || C % 8 != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  // pixel_of packs (h << 16) | w into an int; a window's rows stay in int
  if (H >= (1 << 15) || W >= (1 << 16) ||
      NT * H * W > (1ll << 31) - sm90::BM - 4ll * W - 4 * sm90::kBandRows)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y) || !aligned16(a) || !aligned16(b))
    return (int)cudaErrorMisalignedAddress;
  sm90::Problem p{};
  p.x = static_cast<const sm90::bf16*>(x);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.y = static_cast<sm90::bf16*>(y);
  p.part = static_cast<float*>(part);
  p.M = (int)(NT * H * W);
  p.K = 9 * C;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  return (int)sm90::launch_wgmma_stats<sm90::ALoad::kIm2col>(p, part_rows, w, stats,
                                                             static_cast<cudaStream_t>(stream));
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused block epilogue of ResNet-TSM (shift_mode='fused_block') for Hopper.
//
// Replaces the Pallas kernels of bdvcil_tpu/ops/tsm_shift.py:
//   forward  _fused_fwd_kernel (:131), called by fused_residual_relu_shift
//            -> _fused_fwd (:179):
//              out     = relu(h + identity)
//              shifted = temporal_shift(out)
//   backward _fused_bwd_kernel (:140), called by _fused_bwd_rule (:212):
//              g_in    = (out > 0) * (g_out + unshift(g_shifted))
//   plain    _shift_kernel (:235) and the reverse kernel (:280) of
//            temporal_shift_pallas (:248, call :291; its VJP _shift_bwd :315):
//              out     = temporal_shift(x) or its transpose, one kernel with
//                        a direction argument
//
// Layout: (N, T, H*W, C) contiguous, i.e. the (N*T, H, W, C) activations
// with time folded into the batch. The shift moves channel fold [0, C/div)
// one frame earlier (frame t reads t+1) and fold [C/div, 2C/div) one frame
// later (frame t reads t-1); boundary frames read zero; the rest is copied.
//
// Bound: bytes. Each launch reads two tensors and writes two, with a few
// flops per element, so it sits far below the card's ridge point. The TPU
// kernel staged (T, hw_tile, C) blocks in VMEM to form the shift from a
// neighbouring frame of its own block. On Hopper there is nothing to reuse:
// each thread owns 16 bytes of one output position, and for the shifted
// output reads its source frame t+1, t-1 or t directly and recomputes
// relu(h + id) there instead of reading a neighbour's output. Loads and
// stores are 16 bytes a thread, neighbouring threads on neighbouring
// addresses. The add is done in f32 and rounded once, which is what a bf16
// add does in PyTorch and in XLA, so the kernel is bit-exact against its
// plain version. The plain shift reads one tensor and writes one, with the
// same layout of threads; where C/div is not a multiple of the pack, the
// packs that straddle a fold boundary are copied element by element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename E> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <typename E, int VEC>
struct alignas(sizeof(E) * VEC) Pack {
  E v[VEC];
};

// relu that keeps NaN, as torch.relu does
__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

template <typename E, int VEC>
__device__ __forceinline__ Pack<E, VEC> add_relu(const Pack<E, VEC>& a, const Pack<E, VEC>& b) {
  Pack<E, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    o.v[k] = Cvt<E>::store(relu_f(Cvt<E>::load(a.v[k]) + Cvt<E>::load(b.v[k])));
  return o;
}

template <typename E, int VEC>
__device__ __forceinline__ Pack<E, VEC> zero_pack() {
  Pack<E, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = Cvt<E>::store(0.f);
  return o;
}

// i: pack index. frame_packs: packs per frame (H*W*C / VEC). Returns the
// frame index t of pack i and its channel.
__device__ __forceinline__ void position(int64_t i, int64_t frame_packs, int segs,
                                         int c_packs, int vec, int* t, int* ch) {
  *t = (int)((i / frame_packs) % segs);
  *ch = (int)(i % c_packs) * vec;
}

template <typename E, int VEC>
__global__ void fused_fwd_kernel(const Pack<E, VEC>* __restrict__ h,
                                 const Pack<E, VEC>* __restrict__ id,
                                 Pack<E, VEC>* __restrict__ out,
                                 Pack<E, VEC>* __restrict__ shifted,
                                 int64_t n_packs, int64_t frame_packs, int segs,
                                 int c_packs, int fold) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_packs; i += stride) {
    int t, ch;
    position(i, frame_packs, segs, c_packs, VEC, &t, &ch);
    const Pack<E, VEC> o = add_relu<E, VEC>(h[i], id[i]);
    out[i] = o;
    Pack<E, VEC> s;
    if (ch < fold) {  // frame t reads frame t + 1
      s = (t + 1 < segs) ? add_relu<E, VEC>(h[i + frame_packs], id[i + frame_packs])
                         : zero_pack<E, VEC>();
    } else if (ch < 2 * fold) {  // frame t reads frame t - 1
      s = (t > 0) ? add_relu<E, VEC>(h[i - frame_packs], id[i - frame_packs])
                  : zero_pack<E, VEC>();
    } else {
      s = o;
    }
    shifted[i] = s;
  }
}

template <typename E, int VEC>
__global__ void fused_bwd_kernel(const Pack<E, VEC>* __restrict__ out,
                                 const Pack<E, VEC>* __restrict__ g_out,
                                 const Pack<E, VEC>* __restrict__ g_shifted,
                                 Pack<E, VEC>* __restrict__ g_in,
                                 int64_t n_packs, int64_t frame_packs, int segs,
                                 int c_packs, int fold) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_packs; i += stride) {
    int t, ch;
    position(i, frame_packs, segs, c_packs, VEC, &t, &ch);
    // unshift: the transpose of the shift
    int64_t src = i;
    bool has_src = true;
    if (ch < fold) {  // fold 0 of frame t went to frame t - 1
      has_src = t > 0;
      src = i - frame_packs;
    } else if (ch < 2 * fold) {  // fold 1 of frame t went to frame t + 1
      has_src = t + 1 < segs;
      src = i + frame_packs;
    }
    const Pack<E, VEC> o = out[i];
    const Pack<E, VEC> go = g_out[i];
    Pack<E, VEC> gs;
    if (has_src) gs = g_shifted[src];
    Pack<E, VEC> r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float g = Cvt<E>::load(go.v[k]);
      if (has_src) g = g + Cvt<E>::load(gs.v[k]);
      r.v[k] = Cvt<E>::store(Cvt<E>::load(o.v[k]) > 0.f ? g : 0.f);
    }
    g_in[i] = r;
  }
}

// The frame offset that channel ch reads: fold 0 reads frame t + 1, fold 1
// frame t - 1, the rest frame t; the reverse shift (the transpose) swaps the
// two folds' directions.
__device__ __forceinline__ int shift_step(int ch, int fold, int reverse) {
  const int d = ch < fold ? 1 : (ch < 2 * fold ? -1 : 0);
  return reverse ? -d : d;
}

// Plain temporal shift (or its reverse): out[t, ., c] = x[t + step(c), ., c],
// zero where t + step falls outside [0, segs). A pure index copy, so it is
// bit-exact in any dtype.
template <typename E, int VEC>
__global__ void shift_kernel(const E* __restrict__ x, E* __restrict__ out, int64_t n_packs,
                             int64_t frame_packs, int segs, int c_packs, int fold, int reverse) {
  using P = Pack<E, VEC>;
  const P* xp = reinterpret_cast<const P*>(x);
  P* op = reinterpret_cast<P*>(out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_packs; i += stride) {
    int t, ch;
    position(i, frame_packs, segs, c_packs, VEC, &t, &ch);
    const int d = shift_step(ch, fold, reverse);
    P v;
    if (d == shift_step(ch + VEC - 1, fold, reverse)) {  // one pack, one source frame
      v = (t + d >= 0 && t + d < segs) ? xp[i + d * frame_packs] : zero_pack<E, VEC>();
    } else {  // the pack straddles a fold boundary: element by element
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int dk = shift_step(ch + k, fold, reverse);
        v.v[k] = (t + dk >= 0 && t + dk < segs) ? x[(i + dk * frame_packs) * VEC + k]
                                                 : Cvt<E>::store(0.f);
      }
    }
    op[i] = v;
  }
}

constexpr int kThreads = 256;

inline int grid_for(int64_t n_packs) {
  int64_t blocks = (n_packs + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // enough blocks to fill every SM many times
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename E, int VEC>
cudaError_t launch_fwd(const void* h, const void* id, void* out, void* shifted, int64_t numel,
                       int segs, int64_t hw, int c, int fold, cudaStream_t stream) {
  using P = Pack<E, VEC>;
  const int64_t n_packs = numel / VEC;
  fused_fwd_kernel<E, VEC><<<grid_for(n_packs), kThreads, 0, stream>>>(
      static_cast<const P*>(h), static_cast<const P*>(id), static_cast<P*>(out),
      static_cast<P*>(shifted), n_packs, hw * c / VEC, segs, c / VEC, fold);
  return cudaGetLastError();
}

template <typename E, int VEC>
cudaError_t launch_bwd(const void* out, const void* g_out, const void* g_shifted, void* g_in,
                       int64_t numel, int segs, int64_t hw, int c, int fold,
                       cudaStream_t stream) {
  using P = Pack<E, VEC>;
  const int64_t n_packs = numel / VEC;
  fused_bwd_kernel<E, VEC><<<grid_for(n_packs), kThreads, 0, stream>>>(
      static_cast<const P*>(out), static_cast<const P*>(g_out), static_cast<const P*>(g_shifted),
      static_cast<P*>(g_in), n_packs, hw * c / VEC, segs, c / VEC, fold);
  return cudaGetLastError();
}

// 16-byte packs when every pointer is 16-byte aligned and a pack never
// straddles a fold boundary; else one element a thread.
inline bool wide_ok(int vec, int c, int fold, const void* a, const void* b, const void* d,
                    const void* e) {
  return c % vec == 0 && fold % vec == 0 && aligned16(a) && aligned16(b) && aligned16(d) &&
         aligned16(e);
}

template <typename E>
cudaError_t launch_shift(const void* x, void* out, int64_t numel, int segs, int64_t hw, int c,
                         int fold, int reverse, cudaStream_t stream) {
  // 16-byte packs wherever a row of C splits into whole packs; a pack that
  // straddles a fold boundary is copied element by element inside the kernel
  constexpr int V = 16 / sizeof(E);
  if (c % V == 0 && aligned16(x) && aligned16(out)) {
    const int64_t n_packs = numel / V;
    shift_kernel<E, V><<<grid_for(n_packs), kThreads, 0, stream>>>(
        static_cast<const E*>(x), static_cast<E*>(out), n_packs, hw * c / V, segs, c / V, fold,
        reverse);
  } else {
    shift_kernel<E, 1><<<grid_for(numel), kThreads, 0, stream>>>(
        static_cast<const E*>(x), static_cast<E*>(out), numel, hw * c, segs, c, fold, reverse);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Shapes: numel = N * segs * hw * c.
int bdv_fused_residual_relu_shift_fwd(const void* h, const void* id, void* out, void* shifted,
                                      long long numel, int segs, long long hw, int c, int fold,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (numel <= 0 || segs <= 0 || c <= 0 || numel % ((long long)segs * hw * c) != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (wide_ok(8, c, fold, h, id, out, shifted))
      return (int)launch_fwd<__nv_bfloat16, 8>(h, id, out, shifted, numel, segs, hw, c, fold, s);
    return (int)launch_fwd<__nv_bfloat16, 1>(h, id, out, shifted, numel, segs, hw, c, fold, s);
  }
  if (dtype == 0) {
    if (wide_ok(4, c, fold, h, id, out, shifted))
      return (int)launch_fwd<float, 4>(h, id, out, shifted, numel, segs, hw, c, fold, s);
    return (int)launch_fwd<float, 1>(h, id, out, shifted, numel, segs, hw, c, fold, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bdv_fused_residual_relu_shift_bwd(const void* out, const void* g_out, const void* g_shifted,
                                      void* g_in, long long numel, int segs, long long hw, int c,
                                      int fold, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (numel <= 0 || segs <= 0 || c <= 0 || numel % ((long long)segs * hw * c) != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (wide_ok(8, c, fold, out, g_out, g_shifted, g_in))
      return (int)launch_bwd<__nv_bfloat16, 8>(out, g_out, g_shifted, g_in, numel, segs, hw, c,
                                               fold, s);
    return (int)launch_bwd<__nv_bfloat16, 1>(out, g_out, g_shifted, g_in, numel, segs, hw, c,
                                             fold, s);
  }
  if (dtype == 0) {
    if (wide_ok(4, c, fold, out, g_out, g_shifted, g_in))
      return (int)launch_bwd<float, 4>(out, g_out, g_shifted, g_in, numel, segs, hw, c, fold, s);
    return (int)launch_bwd<float, 1>(out, g_out, g_shifted, g_in, numel, segs, hw, c, fold, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The plain temporal shift (reverse = 0) or its transpose (reverse = 1), the
// forward and backward of temporal_shift_pallas. dtype: 0 = float32,
// 1 = bfloat16; numel = N * segs * hw * c.
int bdv_temporal_shift(const void* x, void* out, long long numel, int segs, long long hw, int c,
                       int fold, int dtype, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (numel <= 0 || segs <= 0 || c <= 0 || fold < 0 || 2LL * fold > c ||
      numel % ((long long)segs * hw * c) != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_shift<float>(x, out, numel, segs, hw, c, fold, reverse, s);
  if (dtype == 1)
    return (int)launch_shift<__nv_bfloat16>(x, out, numel, segs, hw, c, fold, reverse, s);
  return (int)cudaErrorInvalidValue;
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

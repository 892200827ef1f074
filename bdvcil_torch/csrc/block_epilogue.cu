// The whole-block fused bottleneck's tail, for Hopper: what runs between and
// after its three statistics kernels (ops/block_fused.py).
//
// Replaces the XLA half of fused_bottleneck_fwd in
// bdvcil_tpu/ops/block_fused.py (:269), which XLA fuses around the Pallas
// kernels and which eager PyTorch runs as some 46 small launches a block:
//   bn_finalize           _finalize (:262) and the (mean, var) of mv (:294),
//                         one launch a BatchNorm:
//                           mean = s / count
//                           var  = q / count - mean * mean
//                           a    = gamma / sqrt(var + eps)
//                           b    = beta - mean * a
//                         written as one (4, C) f32 array: rows a, b, mean, var;
//   affine_residual_relu  the block's last pass (:290), over NHWC bf16 or
//                         f32 (the dtype of x, as JAX's astype(x.dtype)):
//                           out = T(relu(f32(y) * a + b + f32(x)))
//                         with a, b per channel (the last BatchNorm's affine).
//
// Both are bound by bytes. bn_finalize moves 32 bytes a channel (C <= 2048
// in ResNet-50) and its time is the launch; its point is one launch where
// the eager expression takes thirteen. affine_residual_relu reads y and x
// and writes out, each once (3 x 205.5 MB at TSM-R50 layer1, 128 x 56 x 56
// x 256, in bf16; 3 x 411 MB in f32), with four f32 operations an element,
// far below the card's ridge point. Its design keeps the HBM busy:
//   - each thread owns 16-byte packs (8 bf16 or 4 f32), neighbouring threads
//     on neighbouring addresses, so every load and store is one full sector
//     run; where C is not a whole number of packs, or an operand does not
//     start on a 16-byte boundary, a per-element form of the same loop;
//   - a and b are staged once per CTA in shared memory where 2 x C x 4
//     bytes fit in 48 KB (C <= 6144, every ResNet-50 width), so the
//     per-element lookup never reaches device memory; past that (any C, as
//     the JAX op takes) they are read through the read-only cache (__ldg):
//     neighbouring threads read neighbouring channels;
//   - a grid-stride loop over chunks of kThreads x kUnroll packs with a few
//     CTAs per SM; each thread issues all of its kUnroll pairs of loads
//     before its first store, 128 bytes in flight a thread, enough to cover
//     the HBM's latency at half occupancy;
//   - a 32-bit index where the tensor allows it (a 64-bit modulo per pack
//     costs more than the pack's arithmetic).
// It writes a fresh output; it does not write over y.
//
// Rounding. Both kernels are bit-exact against the eager PyTorch expressions
// they replace (the plain versions in ops/block_fused.py), so every operation
// rounds once, in the order eager PyTorch applies it, with the _rn
// intrinsics: nvcc would otherwise contract x * y + z into one FMA, which
// rounds once where eager PyTorch rounds twice. On CUDA, `t / python_float`
// is not a division: ATen (div_true_kernel_cuda) multiplies by the f32
// reciprocal of the scalar, so bn_finalize does the same. relu is ATen's
// clamp_min(v, 0): NaN stays NaN, else fmaxf(v, 0).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // packs in flight a thread
constexpr int kCtasPerSm = 4;  // 1024 threads an SM
constexpr int kStagedChannels = 48 * 1024 / (2 * sizeof(float));  // a, b in 48 KB of shared

template <typename T>
constexpr int kPack = 16 / sizeof(T);  // elements a 16-byte pack: 8 bf16, 4 f32

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// torch.relu on CUDA: clamp_min(v, 0), which keeps NaN
__device__ __forceinline__ float relu_keep_nan(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// relu(((y * a) + b) + x), each operation rounded to f32 on its own
__device__ __forceinline__ float affine_residual(float y, float a, float b, float x) {
  return relu_keep_nan(__fadd_rn(__fadd_rn(__fmul_rn(y, a), b), x));
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// a[0 .. 3] (16-byte aligned) and a[0]: from shared memory where a and b are
// staged, else through the read-only cache
template <bool kStaged>
__device__ __forceinline__ float4 load4(const float* a) {
  if constexpr (kStaged) return *reinterpret_cast<const float4*>(a);
  else return __ldg(reinterpret_cast<const float4*>(a));
}
template <bool kStaged>
__device__ __forceinline__ float load1(const float* a) {
  if constexpr (kStaged) return *a;
  else return __ldg(a);
}

// one pack of 8 bf16 (a, b: 8 floats, 16-byte aligned)
template <bool kStaged>
__device__ __forceinline__ uint4 pack_epilogue(const uint4& yv, const uint4& xv, const float* a,
                                               const float* b, bf16) {
  const float4 a0 = load4<kStaged>(a);
  const float4 a1 = load4<kStaged>(a + 4);
  const float4 b0 = load4<kStaged>(b);
  const float4 b1 = load4<kStaged>(b + 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  uint4 o;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 yf = __bfloat1622float2(y2[j]);
    const float2 xf = __bfloat1622float2(x2[j]);
    o2[j] = __floats2bfloat162_rn(affine_residual(yf.x, av[2 * j], bv[2 * j], xf.x),
                                  affine_residual(yf.y, av[2 * j + 1], bv[2 * j + 1], xf.y));
  }
  return o;
}

// one pack of 4 f32 (a, b: 4 floats, 16-byte aligned)
template <bool kStaged>
__device__ __forceinline__ uint4 pack_epilogue(const uint4& yv, const uint4& xv, const float* a,
                                               const float* b, float) {
  const float4 av = load4<kStaged>(a);
  const float4 bv = load4<kStaged>(b);
  const float4 yf = *reinterpret_cast<const float4*>(&yv);
  const float4 xf = *reinterpret_cast<const float4*>(&xv);
  const float4 o = make_float4(affine_residual(yf.x, av.x, bv.x, xf.x),
                               affine_residual(yf.y, av.y, bv.y, xf.y),
                               affine_residual(yf.z, av.z, bv.z, xf.z),
                               affine_residual(yf.w, av.w, bv.w, xf.w));
  return *reinterpret_cast<const uint4*>(&o);
}

// The 16-byte pack form: C % kPack<T> == 0, every operand 16-byte aligned.
// kStaged: a and b staged in shared memory (C <= kStagedChannels).
template <typename T, typename Index, bool kStaged>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
affine_residual_relu_kernel(const uint4* __restrict__ y, const uint4* __restrict__ x,
                            const float* __restrict__ a, const float* __restrict__ b,
                            uint4* __restrict__ out, Index n_packs, int c) {
  constexpr int kN = kPack<T>;
  extern __shared__ float4 smem[];  // kStaged: a, then b, c floats each
  const float* sa = a;
  const float* sb = b;
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < c / 4; i += kThreads) {
      smem[i] = reinterpret_cast<const float4*>(a)[i];
      smem[c / 4 + i] = reinterpret_cast<const float4*>(b)[i];
    }
    __syncthreads();
    sa = reinterpret_cast<const float*>(smem);
    sb = sa + c;
  }
  const Index c_packs = (Index)(c / kN);
  const Index chunk = (Index)kThreads * kUnroll;
  for (Index base = (Index)blockIdx.x * chunk + threadIdx.x; base < n_packs;
       base += (Index)gridDim.x * chunk) {
    uint4 yv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const Index i = base + (Index)k * kThreads;
      if (i < n_packs) {
        yv[k] = __ldg(y + i);
        xv[k] = __ldg(x + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const Index i = base + (Index)k * kThreads;
      if (i < n_packs) {
        const int ch = (int)(i % c_packs) * kN;
        out[i] = pack_epilogue<kStaged>(yv[k], xv[k], sa + ch, sb + ch, T());
      }
    }
  }
}

// The per-element form: any C, any alignment (the JAX op takes any C).
template <typename T, typename Index, bool kStaged>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
affine_residual_relu_elem_kernel(const T* __restrict__ y, const T* __restrict__ x,
                                 const float* __restrict__ a, const float* __restrict__ b,
                                 T* __restrict__ out, Index n, int c) {
  extern __shared__ float4 smem[];  // kStaged: a, then b, c floats each
  const float* sa = a;
  const float* sb = b;
  if constexpr (kStaged) {
    float* s = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < c; i += kThreads) {
      s[i] = a[i];
      s[c + i] = b[i];
    }
    __syncthreads();
    sa = s;
    sb = s + c;
  }
  for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (Index)gridDim.x * kThreads) {
    const int ch = (int)(i % (Index)c);
    out[i] = from_f32<T>(affine_residual(to_f32(y[i]), load1<kStaged>(sa + ch),
                                         load1<kStaged>(sb + ch), to_f32(x[i])));
  }
}

__global__ void bn_finalize_kernel(const float* __restrict__ s, const float* __restrict__ q,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ out, int c,
                                   float count, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const float inv_count = __fdiv_rn(1.f, count);  // ATen's t / scalar: t * (1 / scalar)
  const float mean = __fmul_rn(s[i], inv_count);
  const float var = __fsub_rn(__fmul_rn(q[i], inv_count), __fmul_rn(mean, mean));
  const float a = __fdiv_rn(gamma[i], __fsqrt_rn(__fadd_rn(var, eps)));
  out[i] = a;
  out[c + i] = __fsub_rn(beta[i], __fmul_rn(mean, a));
  out[2 * c + i] = mean;
  out[3 * c + i] = var;
}

template <typename T, typename Index, bool kStaged>
cudaError_t launch_epilogue(const void* y, const void* x, const void* a, const void* b,
                            void* out, long long n_packs, int c, int sms, cudaStream_t stream) {
  const long long chunks = (n_packs + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long cap = (long long)sms * kCtasPerSm;
  const int grid = (int)(chunks < cap ? chunks : cap);
  const size_t smem = kStaged ? 2 * c * sizeof(float) : 0;
  affine_residual_relu_kernel<T, Index, kStaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<uint4*>(out), (Index)n_packs, c);
  return cudaGetLastError();
}

template <typename T, typename Index, bool kStaged>
cudaError_t launch_epilogue_elem(const void* y, const void* x, const void* a, const void* b,
                                 void* out, long long n, int c, int sms, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kCtasPerSm;
  const int grid = (int)(blocks < cap ? blocks : cap);
  const size_t smem = kStaged ? 2 * c * sizeof(float) : 0;
  affine_residual_relu_elem_kernel<T, Index, kStaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(out), (Index)n, c);
  return cudaGetLastError();
}

template <typename T, bool kStaged>
cudaError_t launch_affine_residual_relu(const void* y, const void* x, const void* a, const void* b,
                                        void* out, long long numel, int c, int sms,
                                        cudaStream_t st) {
  const bool packs = c % kPack<T> == 0 && aligned16(y) && aligned16(x) && aligned16(a) &&
                     aligned16(b) && aligned16(out);
  // a 32-bit index while base + one grid stride stays below 2^32
  const long long stride = (long long)sms * kCtasPerSm * kThreads * (packs ? kUnroll : 1);
  if (packs) {
    const long long n_packs = numel / kPack<T>;
    if (n_packs + stride < (1ll << 32))
      return launch_epilogue<T, uint32_t, kStaged>(y, x, a, b, out, n_packs, c, sms, st);
    return launch_epilogue<T, int64_t, kStaged>(y, x, a, b, out, n_packs, c, sms, st);
  }
  if (numel + stride < (1ll << 32))
    return launch_epilogue_elem<T, uint32_t, kStaged>(y, x, a, b, out, numel, c, sms, st);
  return launch_epilogue_elem<T, int64_t, kStaged>(y, x, a, b, out, numel, c, sms, st);
}

template <typename T>
cudaError_t affine_residual_relu(const void* y, const void* x, const void* a, const void* b,
                                 void* out, long long numel, int c, int sms, cudaStream_t st) {
  if (c <= kStagedChannels)
    return launch_affine_residual_relu<T, true>(y, x, a, b, out, numel, c, sms, st);
  return launch_affine_residual_relu<T, false>(y, x, a, b, out, numel, c, sms, st);
}

}  // namespace

extern "C" {

// (s, q, gamma, beta) f32 (c,) -> out f32 (4, c): a, b, mean, var
int bdv_bn_finalize(const void* s, const void* q, const void* gamma, const void* beta, void* out,
                    int c, float count, float eps, void* stream) {
  if (c <= 0) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  bn_finalize_kernel<<<(c + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(q),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(out), c, count, eps);
  return (int)cudaGetLastError();
}

// y, x, out (numel / c, c) contiguous, bf16 (elem_bytes 2) or f32 (4); a, b
// f32 (c,), any c. 16-byte packs where c is a whole number of them and every
// pointer is 16-byte aligned, else one element a thread and step.
int bdv_affine_residual_relu(const void* y, const void* x, const void* a, const void* b,
                             void* out, long long numel, int c, int elem_bytes, int sms,
                             void* stream) {
  if (numel <= 0 || c <= 0 || numel % c != 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return (int)affine_residual_relu<bf16>(y, x, a, b, out, numel, c, sms, st);
  if (elem_bytes == 4) return (int)affine_residual_relu<float>(y, x, a, b, out, numel, c, sms, st);
  return (int)cudaErrorInvalidValue;
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

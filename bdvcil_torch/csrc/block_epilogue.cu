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
//   affine_residual_relu  the block's last pass (:290), over NHWC bf16:
//                           out = bf16(relu(f32(y) * a + b + f32(x)))
//                         with a, b per channel (the last BatchNorm's affine).
//
// Both are bound by bytes. bn_finalize moves 32 bytes a channel (C <= 2048)
// and its time is the launch; its point is one launch where the eager
// expression takes thirteen. affine_residual_relu reads y and x and writes out, each
// once (3 x 205.5 MB at TSM-R50 layer1, 128 x 56 x 56 x 256), with four f32
// operations an element, far below the card's ridge point. Its design keeps
// the HBM busy:
//   - each thread owns 16-byte packs (8 bf16), neighbouring threads on
//     neighbouring addresses, so every load and store is one full sector run;
//   - a and b are staged once per CTA in shared memory (2 x C x 4 bytes, at
//     most 48 KB), so the per-element lookup never reaches device memory;
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

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // packs in flight a thread
constexpr int kCtasPerSm = 4;  // 1024 threads an SM
constexpr int kPack = 8;       // bf16 a 16-byte pack
constexpr int kMaxChannels = 48 * 1024 / (2 * sizeof(float));  // a, b in 48 KB of shared memory

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// torch.relu on CUDA: clamp_min(v, 0), which keeps NaN
__device__ __forceinline__ float relu_keep_nan(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// relu(((y * a) + b) + x), each operation rounded to f32 on its own
__device__ __forceinline__ float affine_residual(float y, float a, float b, float x) {
  return relu_keep_nan(__fadd_rn(__fadd_rn(__fmul_rn(y, a), b), x));
}

__device__ __forceinline__ uint4 pack_epilogue(const uint4& yv, const uint4& xv, const float* a,
                                               const float* b) {
  const float4 a0 = reinterpret_cast<const float4*>(a)[0];
  const float4 a1 = reinterpret_cast<const float4*>(a)[1];
  const float4 b0 = reinterpret_cast<const float4*>(b)[0];
  const float4 b1 = reinterpret_cast<const float4*>(b)[1];
  const float av[kPack] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[kPack] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  uint4 o;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < kPack / 2; ++j) {
    const float2 yf = __bfloat1622float2(y2[j]);
    const float2 xf = __bfloat1622float2(x2[j]);
    o2[j] = __floats2bfloat162_rn(affine_residual(yf.x, av[2 * j], bv[2 * j], xf.x),
                                  affine_residual(yf.y, av[2 * j + 1], bv[2 * j + 1], xf.y));
  }
  return o;
}

template <typename Index>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
affine_residual_relu_kernel(const uint4* __restrict__ y, const uint4* __restrict__ x,
                            const float* __restrict__ a, const float* __restrict__ b,
                            uint4* __restrict__ out, Index n_packs, int c) {
  extern __shared__ float4 smem[];  // a, then b: c floats each
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + c;
  for (int i = threadIdx.x; i < c / 4; i += kThreads) {
    smem[i] = reinterpret_cast<const float4*>(a)[i];
    smem[c / 4 + i] = reinterpret_cast<const float4*>(b)[i];
  }
  __syncthreads();
  const Index c_packs = (Index)(c / kPack);
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
        const int ch = (int)(i % c_packs) * kPack;
        out[i] = pack_epilogue(yv[k], xv[k], sa + ch, sb + ch);
      }
    }
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

template <typename Index>
cudaError_t launch_epilogue(const void* y, const void* x, const void* a, const void* b,
                            void* out, long long n_packs, int c, int sms, cudaStream_t stream) {
  const long long chunks = (n_packs + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long cap = (long long)sms * kCtasPerSm;
  const int grid = (int)(chunks < cap ? chunks : cap);
  affine_residual_relu_kernel<Index><<<grid, kThreads, 2 * c * sizeof(float), stream>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<uint4*>(out), (Index)n_packs, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bdv_block_epilogue_max_channels() { return kMaxChannels; }

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

// y, x, out bf16 (numel / c, c) contiguous; a, b f32 (c,); every pointer
// 16-byte aligned, c % 8 == 0, c <= bdv_block_epilogue_max_channels()
int bdv_affine_residual_relu(const void* y, const void* x, const void* a, const void* b,
                             void* out, long long numel, int c, int sms, void* stream) {
  if (numel <= 0 || c <= 0 || c % kPack != 0 || c > kMaxChannels || numel % c != 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(y) || !aligned16(x) || !aligned16(a) || !aligned16(b) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_packs = numel / kPack;
  // a 32-bit index while base + one grid stride stays below 2^32
  if (n_packs + (long long)sms * kCtasPerSm * kThreads * kUnroll < (1ll << 32))
    return (int)launch_epilogue<uint32_t>(y, x, a, b, out, n_packs, c, sms, st);
  return (int)launch_epilogue<int64_t>(y, x, a, b, out, n_packs, c, sms, st);
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

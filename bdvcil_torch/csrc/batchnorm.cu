// Train-mode BatchNorm, forward and backward, for Hopper (ops/batchnorm.py).
//
// Replaces the eager flax BatchNorm of models/norm.py (some 20 full-tensor
// f32 passes a layer forward and as many again in autograd's backward) and
// the normalize half of ops/conv1x1_bn.py. Five kernels, every one bound by
// bytes:
//   stats       per-channel f32 sum and sum of squares of x (M, C): one read;
//   finalize    per channel: mean, var, the running statistics updated in
//               place with flax's momentum, and the (5, C) f32 coefficients
//               the other kernels read (rows below);
//   apply       out = T_out(((x - mean) * mul) + bias), optionally relu'd:
//               one read, one write;
//   bwd_reduce  per-channel f32 sums of g and g * xhat, xhat = (x - mean) * r,
//               g masked where the relu'd output was <= 0: one read of g and x;
//   bwd_dx      dx = T_in(k * ((g - sum g / n) - xhat * (sum g xhat / n))):
//               one read of g and x, one write.
// x is the rows of a channels_last (N, C, H, W) tensor, or of an NHWC one:
// (M, C) row-major, C the fastest dimension.
//
// Two modes share the kernels. kSums = false is models/norm.BatchNorm:
//   mean = s1 / n, var = max(0, s2 / n - mean^2), r = rsqrt(var + eps),
//   k = mul = r * weight, out = T(((x - mean) * mul) + bias)
// and kSums = true is ops/conv1x1_bn.conv1x1_bn's normalize of a GEMM output
// y whose sums the GEMM's epilogue gave:
//   mean = s1 / n, var = s2 / n - mean^2, k = inv = weight / sqrt(var + eps),
//   r = 1 / sqrt(var + eps), shift = bias - mean * inv,
//   out = T(T(T(y) * T(inv)) + T(shift))
// with T the output (norm) dtype. The coefficient rows are
//   0 mean, 1 r, 2 k, 3 a, 4 b
// with (a, b) = (mul, bias) in the first mode and (T(inv), T(shift)) in the
// second: apply (and the backward's recomputed relu mask) reads a and b.
//
// Rounding. The forward is bit-exact against the eager PyTorch expressions it
// replaces (the plain versions in ops/batchnorm.py), given the same sums:
// every f32 operation rounds once, in eager PyTorch's order, with the _rn
// intrinsics (nvcc would otherwise contract x * y + z into one FMA). s1 / n
// is a true division, as ATen's tensor / tensor. rsqrtf is what ATen's
// torch.rsqrt calls. relu is ATen's clamp_min: NaN stays NaN. The sums
// themselves are f32 in another order than ATen's reduction; the backward is
// the analytic BatchNorm gradient in f32, not autograd's replay.
//
// Design. stats and bwd_reduce run a persistent grid of at most one CTA per
// SM. Each thread owns one column of 16-byte packs (8 bf16 or 4 f32
// channels; one element where C or an operand's alignment rules packs out)
// and walks rows, 4 of them in flight (2 in the backward); a CTA's threads cover
// kThreads / packs-per-row neighbouring rows at a time, so a CTA reads one
// contiguous stretch per step. The per-thread sums are added across the
// CTA's rows in shared memory in a fixed order, written as the CTA's partial
// row, and the last CTA to finish (an integer ticket, no float atomics) adds
// the partial rows in CTA order: a call repeats its bits. apply and bwd_dx
// walk the same way, so each thread keeps its channels' coefficients in
// registers and never indexes by channel inside the loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;     // rows in flight a thread: stats, apply
constexpr int kUnrollBwd = 2;  // the backward's, with two operands and more coefficients

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
// v rounded to T and read back as f32
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32(from_f32<T>(v)); }

// torch.relu on CUDA: clamp_min(v, 0), which keeps NaN
__device__ __forceinline__ float relu_keep_nan(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

template <int kV>
__device__ __forceinline__ Vec<float, kV> ldcg_vec(const float* p) {
  Vec<float, kV> v;
  if constexpr (kV == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v.v[0] = q.x, v.v[1] = q.y, v.v[2] = q.z, v.v[3] = q.w;
  } else {
    v.v[0] = __ldcg(p);
  }
  return v;
}

// The forward's output before the relu, as a float holding a T_out value.
template <typename Tout, bool kSums>
__device__ __forceinline__ float normalize(float x, float mean, float a, float b) {
  if constexpr (kSums) {
    const float t = rnd<Tout>(__fmul_rn(rnd<Tout>(x), a));
    return rnd<Tout>(__fadd_rn(t, b));
  } else {
    return rnd<Tout>(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), a), b));
  }
}

// A thread's place in the column walk: `cols` pack columns at a time, R rows
// of them a CTA step; this thread is row r, column q of that tile.
struct Walk {
  int cols, R, r, q;
  __device__ explicit Walk(int packs) {
    cols = packs < kThreads ? packs : kThreads;
    R = kThreads / cols;
    r = threadIdx.x / cols;
    q = threadIdx.x % cols;
  }
};

// Adds each thread's kVec sums over the CTA's R rows in row order and writes
// them to out[p0 * kVec ...], channels below c. red holds R x cols x kVec floats.
template <int kVec>
__device__ __forceinline__ void cta_sum(const float (&acc)[kVec], float* red, const Walk& w,
                                        bool active, int p0, int c, float* __restrict__ out) {
  const int width = w.cols * kVec;
  if (w.R == 1) {
    if (active) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[p0 * kVec + w.q * kVec + j] = acc[j];
    }
    return;
  }
  __syncthreads();  // red is free
  if (active) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[w.r * width + w.q * kVec + j] = acc[j];
  }
  __syncthreads();
  for (int s = threadIdx.x; s < width && p0 * kVec + s < c; s += kThreads) {
    float v = red[s];
    for (int i = 1; i < w.R; ++i) v = __fadd_rn(v, red[i * width + s]);
    out[p0 * kVec + s] = v;
  }
}

// Adds the g partial rows of the (2, g, c) partials, in row order, into
// sums[(2, c)]: kV channels a thread (one 16-byte load a row where 4), the
// loads of 8 rows in flight. From L2, not L1: other CTAs wrote them.
template <int kV>
__device__ __forceinline__ void sum_partials(const float* part, float* __restrict__ sums, int c,
                                             int g) {
  using V = Vec<float, kV>;
  const int cv = c / kV;
  for (int i = threadIdx.x; i < 2 * cv; i += kThreads) {
    const int h = i / cv, ch = (i - h * cv) * kV;
    const float* col = part + (size_t)h * g * c + ch;
    V v = ldcg_vec<kV>(col);
    int k = 1;
    for (; k + 8 <= g; k += 8) {
      V t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = ldcg_vec<kV>(col + (size_t)(k + u) * c);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int j = 0; j < kV; ++j) v.v[j] = __fadd_rn(v.v[j], t[u].v[j]);
      }
    }
    for (; k < g; ++k) {
      const V t = ldcg_vec<kV>(col + (size_t)k * c);
#pragma unroll
      for (int j = 0; j < kV; ++j) v.v[j] = __fadd_rn(v.v[j], t.v[j]);
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) sums[h * c + ch + j] = v.v[j];
  }
}

// After every CTA wrote its two partial rows part[h][blockIdx.x][:c]: the
// last CTA to arrive adds the partial rows in CTA order into sums[h][:c] and
// resets the ticket for the next launch on the stream.
__device__ __forceinline__ void finish_partials(const float* part, float* __restrict__ sums,
                                                int c, unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (c % 4 == 0) sum_partials<4>(part, sums, c, gridDim.x);
  else sum_partials<1>(part, sums, c, gridDim.x);
  if (threadIdx.x == 0) *ticket = 0u;
}

// ---- stats: s1 = sum x, s2 = sum x^2 per channel ----------------------------

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
stats_kernel(const T* __restrict__ x, long long m, int c, float* part, float* __restrict__ sums,
             unsigned* ticket) {
  __shared__ float red[kThreads * kVec];
  const int packs = c / kVec;
  const Walk w(packs);
  const long long step = (long long)gridDim.x * w.R;
  float* part1 = part + (size_t)blockIdx.x * c;
  float* part2 = part + ((size_t)gridDim.x + blockIdx.x) * c;
  for (int p0 = 0; p0 < packs; p0 += w.cols) {
    const int p = p0 + w.q;
    const bool active = w.r < w.R && p < packs;
    float s1[kVec], s2[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
    if (active) {
      const T* base = x + (size_t)p * kVec;
      for (long long row = (long long)blockIdx.x * w.R + w.r; row < m; row += kUnroll * step) {
        Vec<T, kVec> v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long ru = row + u * step;
          if (ru < m) v[u] = *reinterpret_cast<const Vec<T, kVec>*>(base + (size_t)ru * c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (row + u * step < m) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float f = to_f32(v[u].v[j]);
              s1[j] = __fadd_rn(s1[j], f);
              s2[j] = __fmaf_rn(f, f, s2[j]);
            }
          }
        }
      }
    }
    cta_sum<kVec>(s1, red, w, active, p0, c, part1);
    cta_sum<kVec>(s2, red, w, active, p0, c, part2);
  }
  finish_partials(part, sums, c, ticket);
}

// ---- finalize: the statistics, the running statistics, the coefficients ----

template <bool kSums, typename Tnorm>
__global__ void finalize_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                                const float* __restrict__ count_ptr, float count,
                                const float* __restrict__ weight, const float* __restrict__ bias,
                                float* __restrict__ running_mean, float* __restrict__ running_var,
                                float* __restrict__ coef, int c, float momentum,
                                float one_minus_momentum, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const float n = count_ptr ? *count_ptr : count;
  const float mean = __fdiv_rn(s1[i], n);
  const float t = __fsub_rn(__fdiv_rn(s2[i], n), __fmul_rn(mean, mean));
  float var, r, k, a, b;
  if constexpr (kSums) {
    var = t;
    const float sd = __fsqrt_rn(__fadd_rn(var, eps));
    k = __fdiv_rn(weight[i], sd);
    r = __fdiv_rn(1.f, sd);
    a = rnd<Tnorm>(k);
    b = rnd<Tnorm>(__fsub_rn(bias[i], __fmul_rn(mean, k)));
  } else {
    var = isnan(t) ? t : fmaxf(t, 0.f);  // torch.clamp(min=0)
    r = rsqrtf(__fadd_rn(var, eps));
    k = __fmul_rn(r, weight[i]);
    a = k;
    b = bias[i];
  }
  running_mean[i] = __fadd_rn(__fmul_rn(momentum, running_mean[i]),
                              __fmul_rn(one_minus_momentum, mean));
  running_var[i] = __fadd_rn(__fmul_rn(momentum, running_var[i]),
                             __fmul_rn(one_minus_momentum, var));
  coef[i] = mean;
  coef[c + i] = r;
  coef[2 * c + i] = k;
  coef[3 * c + i] = a;
  coef[4 * c + i] = b;
}

// ---- apply: out = normalize(x), optionally relu'd ---------------------------

template <typename Tin, typename Tout, int kVec, bool kSums, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1)
apply_kernel(const Tin* __restrict__ x, const float* __restrict__ coef, Tout* __restrict__ out,
             long long m, int c) {
  const int packs = c / kVec;
  const Walk w(packs);
  const long long step = (long long)gridDim.x * w.R;
  for (int p0 = 0; p0 < packs; p0 += w.cols) {
    const int p = p0 + w.q;
    if (!(w.r < w.R && p < packs)) continue;
    float mean[kVec], a[kVec], b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int ch = p * kVec + j;
      mean[j] = coef[ch];
      a[j] = coef[3 * c + ch];
      b[j] = coef[4 * c + ch];
    }
    const Tin* src = x + (size_t)p * kVec;
    Tout* dst = out + (size_t)p * kVec;
    for (long long row = (long long)blockIdx.x * w.R + w.r; row < m; row += kUnroll * step) {
      Vec<Tin, kVec> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = row + u * step;
        if (ru < m) v[u] = *reinterpret_cast<const Vec<Tin, kVec>*>(src + (size_t)ru * c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = row + u * step;
        if (ru < m) {
          Vec<Tout, kVec> o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            float y = normalize<Tout, kSums>(to_f32(v[u].v[j]), mean[j], a[j], b[j]);
            if constexpr (kRelu) y = relu_keep_nan(y);
            o.v[j] = from_f32<Tout>(y);
          }
          *reinterpret_cast<Vec<Tout, kVec>*>(dst + (size_t)ru * c) = o;
        }
      }
    }
  }
}

// ---- backward: the two sums, then dx ----------------------------------------

// g where the forward's relu passed it (autograd's threshold_backward: zero
// where the output is <= 0), as f32
template <typename Tout, bool kSums, bool kRelu>
__device__ __forceinline__ float masked_g(float g, float x, float mean, float a, float b) {
  if constexpr (kRelu) {
    if (normalize<Tout, kSums>(x, mean, a, b) <= 0.f) return 0.f;
  }
  return g;
}

template <typename Tin, typename Tout, int kVec, bool kSums, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1)
bwd_reduce_kernel(const Tout* __restrict__ g, const Tin* __restrict__ x,
                  const float* __restrict__ coef, long long m, int c, float* part,
                  float* __restrict__ sums, unsigned* ticket) {
  __shared__ float red[kThreads * kVec];
  const int packs = c / kVec;
  const Walk w(packs);
  const long long step = (long long)gridDim.x * w.R;
  float* part1 = part + (size_t)blockIdx.x * c;
  float* part2 = part + ((size_t)gridDim.x + blockIdx.x) * c;
  for (int p0 = 0; p0 < packs; p0 += w.cols) {
    const int p = p0 + w.q;
    const bool active = w.r < w.R && p < packs;
    float sg[kVec], sgx[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) sg[j] = sgx[j] = 0.f;
    if (active) {
      float mean[kVec], r[kVec], a[kVec], b[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int ch = p * kVec + j;
        mean[j] = coef[ch];
        r[j] = coef[c + ch];
        a[j] = kRelu ? coef[3 * c + ch] : 0.f;
        b[j] = kRelu ? coef[4 * c + ch] : 0.f;
      }
      const Tout* gb = g + (size_t)p * kVec;
      const Tin* xb = x + (size_t)p * kVec;
      for (long long row = (long long)blockIdx.x * w.R + w.r; row < m; row += kUnrollBwd * step) {
        Vec<Tout, kVec> gv[kUnrollBwd];
        Vec<Tin, kVec> xv[kUnrollBwd];
#pragma unroll
        for (int u = 0; u < kUnrollBwd; ++u) {
          const long long ru = row + u * step;
          if (ru < m) {
            gv[u] = *reinterpret_cast<const Vec<Tout, kVec>*>(gb + (size_t)ru * c);
            xv[u] = *reinterpret_cast<const Vec<Tin, kVec>*>(xb + (size_t)ru * c);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnrollBwd; ++u) {
          if (row + u * step < m) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float xf = to_f32(xv[u].v[j]);
              const float gf =
                  masked_g<Tout, kSums, kRelu>(to_f32(gv[u].v[j]), xf, mean[j], a[j], b[j]);
              sg[j] = __fadd_rn(sg[j], gf);
              sgx[j] = __fmaf_rn(gf, __fmul_rn(__fsub_rn(xf, mean[j]), r[j]), sgx[j]);
            }
          }
        }
      }
    }
    cta_sum<kVec>(sg, red, w, active, p0, c, part1);
    cta_sum<kVec>(sgx, red, w, active, p0, c, part2);
  }
  finish_partials(part, sums, c, ticket);
}

template <typename Tin, typename Tout, int kVec, bool kSums, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dx_kernel(const Tout* __restrict__ g, const Tin* __restrict__ x,
              const float* __restrict__ coef, const float* __restrict__ sg_all,
              const float* __restrict__ sgx_all, const float* __restrict__ count_ptr,
              float count, Tin* __restrict__ dx, long long m, int c) {
  const int packs = c / kVec;
  const Walk w(packs);
  const long long step = (long long)gridDim.x * w.R;
  const float n = count_ptr ? *count_ptr : count;
  for (int p0 = 0; p0 < packs; p0 += w.cols) {
    const int p = p0 + w.q;
    if (!(w.r < w.R && p < packs)) continue;
    float mean[kVec], r[kVec], k[kVec], c0[kVec], c1[kVec], a[kVec], b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int ch = p * kVec + j;
      mean[j] = coef[ch];
      r[j] = coef[c + ch];
      k[j] = coef[2 * c + ch];
      a[j] = kRelu ? coef[3 * c + ch] : 0.f;
      b[j] = kRelu ? coef[4 * c + ch] : 0.f;
      c0[j] = __fdiv_rn(sg_all[ch], n);
      c1[j] = __fdiv_rn(sgx_all[ch], n);
    }
    const Tout* gb = g + (size_t)p * kVec;
    const Tin* xb = x + (size_t)p * kVec;
    Tin* db = dx + (size_t)p * kVec;
    for (long long row = (long long)blockIdx.x * w.R + w.r; row < m; row += kUnrollBwd * step) {
      Vec<Tout, kVec> gv[kUnrollBwd];
      Vec<Tin, kVec> xv[kUnrollBwd];
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        const long long ru = row + u * step;
        if (ru < m) {
          gv[u] = *reinterpret_cast<const Vec<Tout, kVec>*>(gb + (size_t)ru * c);
          xv[u] = *reinterpret_cast<const Vec<Tin, kVec>*>(xb + (size_t)ru * c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        const long long ru = row + u * step;
        if (ru < m) {
          Vec<Tin, kVec> o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float xf = to_f32(xv[u].v[j]);
            const float gf =
                masked_g<Tout, kSums, kRelu>(to_f32(gv[u].v[j]), xf, mean[j], a[j], b[j]);
            const float xhat = __fmul_rn(__fsub_rn(xf, mean[j]), r[j]);
            const float t = __fsub_rn(__fsub_rn(gf, c0[j]), __fmul_rn(xhat, c1[j]));
            o.v[j] = from_f32<Tin>(__fmul_rn(k[j], t));
          }
          *reinterpret_cast<Vec<Tin, kVec>*>(db + (size_t)ru * c) = o;
        }
      }
    }
  }
}

// ---- launch helpers -----------------------------------------------------------

inline bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// The pack width in elements of T_in: 16 bytes where C holds whole packs and
// every operand starts on its pack's boundary, else 1.
template <typename Tin, typename Tout>
int pack_width(int c, const void* in, const void* other) {
  constexpr int kVec = 16 / sizeof(Tin);
  return c % kVec == 0 && aligned(in, 16) && aligned(other, kVec * sizeof(Tout)) ? kVec : 1;
}

// At most one CTA an SM, and no more than the rows give work to.
inline int walk_grid(long long m, int c, int vec, int sms) {
  const int packs = c / vec;
  const int cols = packs < kThreads ? packs : kThreads;
  const long long rows_per_cta = kThreads / cols;
  const long long want = (m + rows_per_cta - 1) / rows_per_cta;
  return (int)(want < sms ? want : sms);
}

template <typename T>
cudaError_t launch_stats(const void* x, long long m, int c, void* part, void* sums,
                         void* ticket, int sms, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool packs = c % kVec == 0 && aligned(x, 16);
  const int grid = walk_grid(m, c, packs ? kVec : 1, sms);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), m, c, static_cast<float*>(part),
                                      static_cast<float*>(sums), static_cast<unsigned*>(ticket));
  };
  if (packs) args(stats_kernel<T, kVec>);
  else args(stats_kernel<T, 1>);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool kSums, bool kRelu>
cudaError_t launch_apply(const void* x, const void* coef, void* out, long long m, int c, int sms,
                         cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(Tin);
  const int vec = pack_width<Tin, Tout>(c, x, out);
  const int grid = walk_grid(m, c, vec, sms);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const Tin*>(x), static_cast<const float*>(coef),
                                      static_cast<Tout*>(out), m, c);
  };
  if (vec == kVec) args(apply_kernel<Tin, Tout, kVec, kSums, kRelu>);
  else args(apply_kernel<Tin, Tout, 1, kSums, kRelu>);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool kSums, bool kRelu>
cudaError_t launch_bwd_reduce(const void* g, const void* x, const void* coef, long long m, int c,
                              void* part, void* sums, void* ticket, int sms, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(Tin);
  const int vec = pack_width<Tin, Tout>(c, x, g);
  const int grid = walk_grid(m, c, vec, sms);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const Tout*>(g), static_cast<const Tin*>(x),
                                      static_cast<const float*>(coef), m, c,
                                      static_cast<float*>(part), static_cast<float*>(sums),
                                      static_cast<unsigned*>(ticket));
  };
  if (vec == kVec) args(bwd_reduce_kernel<Tin, Tout, kVec, kSums, kRelu>);
  else args(bwd_reduce_kernel<Tin, Tout, 1, kSums, kRelu>);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool kSums, bool kRelu>
cudaError_t launch_bwd_dx(const void* g, const void* x, const void* coef, const void* sg,
                          const void* sgx, const void* count_ptr, float count, void* dx,
                          long long m, int c, int sms, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(Tin);
  const int vec = pack_width<Tin, Tout>(c, x, g) == kVec && aligned(dx, 16) ? kVec : 1;
  const int grid = walk_grid(m, c, vec, sms);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const Tout*>(g), static_cast<const Tin*>(x), static_cast<const float*>(coef),
        static_cast<const float*>(sg), static_cast<const float*>(sgx),
        static_cast<const float*>(count_ptr), count, static_cast<Tin*>(dx), m, c);
  };
  if (vec == kVec) args(bwd_dx_kernel<Tin, Tout, kVec, kSums, kRelu>);
  else args(bwd_dx_kernel<Tin, Tout, 1, kSums, kRelu>);
  return cudaGetLastError();
}

// Calls f.template run<Tin, Tout, kSums, kRelu>() for the runtime choice, or
// returns cudaErrorInvalidValue for a dtype the kernels do not take.
template <typename F>
cudaError_t by_types(int in_bytes, int out_bytes, int sums, int relu, const F& f) {
  auto modes = [&](auto tin, auto tout) -> cudaError_t {
    using Tin = decltype(tin);
    using Tout = decltype(tout);
    if (sums) {
      if (relu) return f.template run<Tin, Tout, true, true>();
      return f.template run<Tin, Tout, true, false>();
    }
    if (relu) return f.template run<Tin, Tout, false, true>();
    return f.template run<Tin, Tout, false, false>();
  };
  if (in_bytes == 2 && out_bytes == 2) return modes(bf16(), bf16());
  if (in_bytes == 2 && out_bytes == 4) return modes(bf16(), float());
  if (in_bytes == 4 && out_bytes == 2) return modes(float(), bf16());
  if (in_bytes == 4 && out_bytes == 4) return modes(float(), float());
  return cudaErrorInvalidValue;
}

struct ApplyCall {
  const void *x, *coef;
  void* out;
  long long m;
  int c, sms;
  cudaStream_t st;
  template <typename Tin, typename Tout, bool kSums, bool kRelu>
  cudaError_t run() const {
    return launch_apply<Tin, Tout, kSums, kRelu>(x, coef, out, m, c, sms, st);
  }
};

struct ReduceCall {
  const void *g, *x, *coef;
  long long m;
  int c;
  void *part, *sums, *ticket;
  int sms;
  cudaStream_t st;
  template <typename Tin, typename Tout, bool kSums, bool kRelu>
  cudaError_t run() const {
    return launch_bwd_reduce<Tin, Tout, kSums, kRelu>(g, x, coef, m, c, part, sums, ticket, sms,
                                                      st);
  }
};

struct DxCall {
  const void *g, *x, *coef, *sg, *sgx, *count_ptr;
  float count;
  void* dx;
  long long m;
  int c, sms;
  cudaStream_t st;
  template <typename Tin, typename Tout, bool kSums, bool kRelu>
  cudaError_t run() const {
    return launch_bwd_dx<Tin, Tout, kSums, kRelu>(g, x, coef, sg, sgx, count_ptr, count, dx, m,
                                                  c, sms, st);
  }
};

bool bad_shape(long long m, int c, int sms) { return m <= 0 || c <= 0 || sms <= 0; }

}  // namespace

extern "C" {

// x (m, c) bf16 (elem_bytes 2) or f32 (4) -> sums f32 (2, c): sum x, sum x^2.
// part: f32 (2, sms, c) scratch; ticket: a zeroed unsigned, left zeroed.
int bdv_batchnorm_stats(const void* x, long long m, int c, int elem_bytes, void* part, void* sums,
                        void* ticket, int sms, void* stream) {
  if (bad_shape(m, c, sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return (int)launch_stats<bf16>(x, m, c, part, sums, ticket, sms, st);
  if (elem_bytes == 4) return (int)launch_stats<float>(x, m, c, part, sums, ticket, sms, st);
  return (int)cudaErrorInvalidValue;
}

// (s1, s2) f32 (c,) over n rows (*count_ptr when given, else count) ->
// coef f32 (5, c); running_mean and running_var updated in place. sums 0:
// models/norm.BatchNorm; 1: conv1x1_bn's normalize, rounding a and b to the
// norm dtype (norm_bytes 2: bf16, 4: f32).
int bdv_batchnorm_finalize(const void* s1, const void* s2, const void* count_ptr, float count,
                           const void* weight, const void* bias, void* running_mean,
                           void* running_var, void* coef, int c, float momentum,
                           float one_minus_momentum, float eps, int sums, int norm_bytes,
                           void* stream) {
  if (c <= 0) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  const int blocks = (c + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(s1), static_cast<const float*>(s2),
        static_cast<const float*>(count_ptr), count, static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(running_mean),
        static_cast<float*>(running_var), static_cast<float*>(coef), c, momentum,
        one_minus_momentum, eps);
  };
  if (!sums) args(finalize_kernel<false, float>);
  else if (norm_bytes == 2) args(finalize_kernel<true, bf16>);
  else if (norm_bytes == 4) args(finalize_kernel<true, float>);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x (m, c) in_bytes, coef (5, c) -> out (m, c) out_bytes.
int bdv_batchnorm_apply(const void* x, const void* coef, void* out, long long m, int c,
                        int in_bytes, int out_bytes, int sums, int relu, int sms, void* stream) {
  if (bad_shape(m, c, sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_types(in_bytes, out_bytes, sums, relu,
                       ApplyCall{x, coef, out, m, c, sms, st});
}

// g (m, c) out_bytes, x (m, c) in_bytes, coef (5, c) -> sums f32 (2, c):
// sum g, sum g * xhat (g masked by the relu). part and ticket as for stats.
int bdv_batchnorm_bwd_reduce(const void* g, const void* x, const void* coef, long long m, int c,
                             int in_bytes, int out_bytes, int sums, int relu, void* part,
                             void* out_sums, void* ticket, int sms, void* stream) {
  if (bad_shape(m, c, sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_types(in_bytes, out_bytes, sums, relu,
                       ReduceCall{g, x, coef, m, c, part, out_sums, ticket, sms, st});
}

// dx (m, c) in_bytes from g, x, coef and the sums (sg, sgx) over n rows.
int bdv_batchnorm_bwd_dx(const void* g, const void* x, const void* coef, const void* sg,
                         const void* sgx, const void* count_ptr, float count, void* dx,
                         long long m, int c, int in_bytes, int out_bytes, int sums, int relu,
                         int sms, void* stream) {
  if (bad_shape(m, c, sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_types(in_bytes, out_bytes, sums, relu,
                       DxCall{g, x, coef, sg, sgx, count_ptr, count, dx, m, c, sms, st});
}

const char* bdv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

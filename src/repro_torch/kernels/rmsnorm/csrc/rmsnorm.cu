// RMSNorm over the last axis, alone or fused with the residual add in
// front of it, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// kernels/rmsnorm/rmsnorm.py:_rmsnorm_kernel (wrapper rmsnorm_pallas), which
// normalises a (256 x d) tile of rows per grid step in VMEM.  The fused
// form also takes the residual add `x + y` that the reference's decoder
// stack runs before every norm but the first (models/transformer.py:122,
// :173, and before the final norm), so the stream is read and written once
// per norm instead of twice.
//
// Contracts: ref.py::rmsnorm_reference and ref.py::add_rmsnorm_reference,
//   s = x + delta          (fp32 add, rounded to x's dtype as torch rounds it)
//   h = (s * (1 / sqrt(mean(s^2) + eps))) * gain      (fp32 arithmetic)
// with h cast back to x's dtype (fp32 or bf16, round to nearest even).
// Without delta, s is x.  The inverse root is 1.0f / sqrtf(...), both
// correctly rounded, rather than rsqrtf, which may be 2 ulp off; that keeps
// it close to jax.lax.rsqrt on the reference's side.
//
// Summation order of the sum of squares, the same in every path below, so
// that add_rmsnorm's h is bit for bit rmsnorm(x + delta):
//   - kThreads = 256 threads, one CTA, per row;
//   - the row is cut into groups of 4 consecutive elements, and group g
//     belongs to thread g % kThreads;
//   - each thread adds the squares of its elements in index order, by
//     fmaf, starting from 0;
//   - each warp joins its 32 sums by the xor butterfly (offsets 16, 8, 4,
//     2, 1), so every lane holds the warp's sum;
//   - after one __syncthreads every thread adds the warps' sums in warp
//     order, starting from warp 0's.
//
// What bounds it: bytes at prefill (168 rows x 4096 or 8192), latency at
// decode (4 rows: the launch and one dependent memory round trip).  A
// handful of flops per element is far under the fp32 rate.  The design:
// each thread starts all its loads first (x, delta and gain, as 16-byte
// float4s for fp32 or 8-byte vectors of 4 bf16), keeps the values in
// registers, reduces with a single barrier, then scales what it holds and
// stores it.  The row is read from memory once and the gain once per CTA;
// the fused form stores s before the barrier.  The register path needs
// d = 4 * kThreads * NV for NV in {4, 8}, a compile-time count (d = 4096
// and 8192, the widths of llama3-8b and jamba), and aligned pointers;
// other d and unaligned views take the generic path, which keeps the same
// order but reads the row twice (once to sum, once to scale).  256 threads
// a row at both widths: tools/rmsnorm_probe.py times a variant source
// (another kThreads, say) in turns with this one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kGroup = 4;          // elements per vector load and per group

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_float(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// x + delta as torch computes it: the fp32 sum, rounded to T.
template <typename T>
__device__ __forceinline__ T add_rounded(T a, T b) {
  return from_float(to_float(a) + to_float(b), static_cast<T*>(nullptr));
}

template <typename T>
struct alignas(sizeof(T) * kGroup) Vec {
  T v[kGroup];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The row's sum from each thread's sum, in the order stated at the top; one
// barrier, after which every thread holds the total.
__device__ __forceinline__ float row_sum(float v) {
  __shared__ float partial[kWarps];
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) partial[threadIdx.x / kWarp] = v;
  __syncthreads();
  float total = partial[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total += partial[w];
  return total;
}

__device__ __forceinline__ float inverse_rms(float total, int d, float eps) {
  return 1.0f / sqrtf(total / static_cast<float>(d) + eps);
}

// Register path: kNV groups per thread, all loaded before any is used.
template <typename T, int kNV, bool kDelta>
__global__ void __launch_bounds__(kThreads) rmsnorm_regs(
    const T* __restrict__ x,         // (rows, d)
    const T* __restrict__ delta,     // (rows, d) or unused
    const float* __restrict__ gain,  // (d,)
    T* __restrict__ s,               // (rows, d) or unused
    T* __restrict__ h,               // (rows, d)
    int d, float eps) {
  using V = Vec<T>;
  using G = Vec<float>;
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const V* xr = reinterpret_cast<const V*>(x + base);
  const G* g = reinterpret_cast<const G*>(gain);

  V xv[kNV];
  V dv[kNV];
  G gv[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int k = i * kThreads + t;
    xv[i] = xr[k];
    if constexpr (kDelta) dv[i] = reinterpret_cast<const V*>(delta + base)[k];
    gv[i] = g[k];
  }

  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if constexpr (kDelta) xv[i].v[j] = add_rounded(xv[i].v[j], dv[i].v[j]);
      const float f = to_float(xv[i].v[j]);
      ss = fmaf(f, f, ss);
    }
    if constexpr (kDelta) reinterpret_cast<V*>(s + base)[i * kThreads + t] = xv[i];
  }

  const float inv = inverse_rms(row_sum(ss), d, eps);
  V* hr = reinterpret_cast<V*>(h + base);
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    V ov;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      ov.v[j] = from_float(to_float(xv[i].v[j]) * inv * gv[i].v[j], static_cast<T*>(nullptr));
    }
    hr[i * kThreads + t] = ov;
  }
}

// Generic path: any d, any alignment; the same order, the row read twice.
template <typename T, bool kDelta>
__global__ void __launch_bounds__(kThreads) rmsnorm_any(
    const T* __restrict__ x, const T* __restrict__ delta, const float* __restrict__ gain,
    T* __restrict__ s, T* __restrict__ h, int d, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const int groups = (d + kGroup - 1) / kGroup;
  float ss = 0.0f;
  for (int k = threadIdx.x; k < groups; k += kThreads) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int c = k * kGroup + j;
      if (c < d) {
        T v = x[base + c];
        if constexpr (kDelta) {
          v = add_rounded(v, delta[base + c]);
          s[base + c] = v;
        }
        const float f = to_float(v);
        ss = fmaf(f, f, ss);
      }
    }
  }

  const float inv = inverse_rms(row_sum(ss), d, eps);
  for (int k = threadIdx.x; k < groups; k += kThreads) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int c = k * kGroup + j;
      if (c < d) {
        T v = x[base + c];
        if constexpr (kDelta) v = add_rounded(v, delta[base + c]);
        h[base + c] = from_float(to_float(v) * inv * gain[c], static_cast<T*>(nullptr));
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Args {
  const void* x;
  const void* delta;
  const void* gain;
  void* s;
  void* h;
  int rows;
  int d;
  float eps;
};

// The register path where it applies, else the generic path.
template <typename T, bool kDelta>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const T* delta = static_cast<const T*>(a.delta);
  const float* gain = static_cast<const float*>(a.gain);
  T* s = static_cast<T*>(a.s);
  T* h = static_cast<T*>(a.h);
  const size_t vec = sizeof(T) * kGroup;
  const bool fits = a.d % (kGroup * kThreads) == 0 && aligned(a.x, vec) && aligned(a.h, vec)
      && aligned(a.gain, sizeof(float) * kGroup)
      && (!kDelta || (aligned(a.delta, vec) && aligned(a.s, vec)));
  const dim3 grid(a.rows), block(kThreads);
  switch (fits ? a.d / (kGroup * kThreads) : 0) {
    case 4:
      rmsnorm_regs<T, 4, kDelta><<<grid, block, 0, stream>>>(x, delta, gain, s, h, a.d, a.eps);
      break;
    case 8:
      rmsnorm_regs<T, 8, kDelta><<<grid, block, 0, stream>>>(x, delta, gain, s, h, a.d, a.eps);
      break;
    default:
      rmsnorm_any<T, kDelta><<<grid, block, 0, stream>>>(x, delta, gain, s, h, a.d, a.eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Args& a, cudaStream_t stream) {
  return a.delta ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

// h = rmsnorm(s) with s = x + delta (delta and s may be null: s is then x
// and is not written).  dtype: 0 = float32, 1 = bfloat16 (x, delta, s and
// h); gain is float32.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int rmsnorm_launch(const void* x, const void* delta, const void* gain, void* s,
                              void* h, int rows, int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if ((delta == nullptr) != (s == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, delta, gain, s, h, rows, d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_dtype<float>(a, st));
  if (dtype == 1) return static_cast<int>(launch_dtype<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// RMSNorm over the last axis, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// kernels/rmsnorm/rmsnorm.py:_rmsnorm_kernel (wrapper rmsnorm_pallas), which
// normalises a (256 x d) tile of rows per grid step in VMEM.  Here each row
// is one thread block, so any row count works without padding.
//
// Contract: ref.py::rmsnorm_reference,
//   out = (x * 1 / sqrt(mean(x^2) + eps)) * gain      (fp32 arithmetic)
// with the output cast back to x's dtype (fp32 or bf16, round to nearest
// even).  The inverse root is 1.0f / sqrtf(...), both correctly rounded,
// rather than rsqrtf, which may be 2 ulp off; that keeps it close to
// jax.lax.rsqrt on the reference's side.
//
// What bounds it: bytes.  Each element is read, squared and summed, then
// read again (from L1/L2: a 4096-wide fp32 row is 16 KB) and written once;
// a handful of flops per element is far under the fp32 rate.  The design
// loads 16 bytes (fp32) or 8 bytes (bf16) per thread per step where d and
// the pointers allow (d % 4 == 0, aligned), and reduces the sum of squares
// in a fixed order (per-thread strided sums, a butterfly warp shuffle, then
// the warps' partials in warp order), so results are the same from run to
// run.  At the serving path's shapes (one to a few hundred rows) the launch
// itself dominates; fusing the norm into its neighbours is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_float(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x,         // (rows, d)
    const float* __restrict__ gain,  // (d,)
    T* __restrict__ out,             // (rows, d)
    int d, float eps) {
  using V = Vec<T, kVec>;
  using G = Vec<float, kVec>;
  const int64_t row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  V* outr = reinterpret_cast<V*>(out + row * d);
  const G* g = reinterpret_cast<const G*>(gain);
  const int n = d / kVec;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const V xv = xr[i];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(xv.v[j]);
      ss = fmaf(f, f, ss);
    }
  }

  __shared__ float partial[kWarps];
  __shared__ float inv_rms;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? partial[lane] : 0.0f;
    v = warp_sum(v);
    if (lane == 0) inv_rms = 1.0f / sqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const V xv = xr[i];
    const G gv = g[i];
    V ov;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      ov.v[j] = from_float(to_float(xv.v[j]) * inv * gv.v[j], static_cast<T*>(nullptr));
    }
    outr[i] = ov;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gain, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  const bool vec = d % 4 == 0
      && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0
      && reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0
      && reinterpret_cast<uintptr_t>(gain) % (4 * sizeof(float)) == 0;
  if (vec) {
    rmsnorm_kernel<T, 4><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gain), static_cast<T*>(out), d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gain), static_cast<T*>(out), d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); gain is float32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* gain, void* out, int rows,
                              int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, gain, out, rows, d, eps, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, gain, out, rows, d, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

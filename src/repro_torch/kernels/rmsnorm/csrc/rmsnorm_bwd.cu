// Backward of RMSNorm over the last axis, alone or after the residual add
// in front of it, for NVIDIA Hopper (sm_90a).
//
// The reference package has no Pallas backward: its models differentiate
// the plain-jnp rms_norm (models/common.py:154) with jax.grad, and its
// Pallas forward (kernels/rmsnorm/rmsnorm.py:_rmsnorm_kernel) is an
// inference drop-in.  On the card the port's forward always runs the
// forward kernel (rmsnorm.cu), so training needs this kernel for the
// gradients of x (or of the residual sum) and of the gain.
//
// Contract: ref.py::rmsnorm_backward_reference and
// ref.py::add_rmsnorm_backward_reference.  Per row of x (the norm's input:
// s = x + delta for the fused form), with dy the gradient of the norm's
// output, all in fp32:
//   inv = 1 / sqrt(mean(x^2) + eps)                   (recomputed from x)
//   dn  = inv * (gain * dy) - x * inv^3 * mean(x * gain * dy)
//   dx  = dn rounded to x's dtype; the fused form adds the gradient that
//         reaches s directly (dres), as torch adds two gradients of one
//         tensor: the fp32 sum of the two rounded terms, rounded again;
//   dgain = sum over rows of dy * (x * inv), fp32.
//
// Determinism: no atomics.  Pass 1 gives each block a fixed run of rows
// (the split depends on the row count only) and each block adds its rows'
// dy * x * inv per column into a partial row of its own, in row order;
// pass 2 sums the partial rows per column in block order.  Two runs give
// the same bits.
//
// What bounds it: bytes (x, dy, dres read, dx written, a handful of flops
// per element).  This first version is the simple one: one block of 256
// threads walks its rows, each row read twice (once for the two row sums,
// once for dx), the sums joined by warp shuffles and one barrier, the
// gain partial kept in device memory (the block's own row, thread-owned
// columns, so it stays in cache).  Any d, fp32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
// Most blocks of pass 1: two per SM of an H100, fixed so that the split of
// rows over blocks, and with it the summation order of the gain, does not
// depend on the card.
constexpr int kMaxBlocks = 264;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_float(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T rounded(float v) {
  return from_float(v, static_cast<T*>(nullptr));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Two row sums from each thread's pair, in a fixed order (xor butterfly
// within each warp, then the warps in order); every thread gets both.  The
// closing barrier lets the next row reuse the shared slots.
__device__ __forceinline__ float2 row_sums(float a, float b) {
  __shared__ float pa[kWarps];
  __shared__ float pb[kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x % kWarp == 0) {
    pa[threadIdx.x / kWarp] = a;
    pb[threadIdx.x / kWarp] = b;
  }
  __syncthreads();
  float2 total = make_float2(pa[0], pb[0]);
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    total.x += pa[w];
    total.y += pb[w];
  }
  __syncthreads();
  return total;
}

// Pass 1: the rows [blockIdx.x * per_block, ...) of dx, and this block's
// partial gain row.
template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads) rmsnorm_bwd_rows(
    const T* __restrict__ x,         // (rows, d): the norm's input
    const T* __restrict__ dy,        // (rows, d): gradient of its output
    const T* __restrict__ dres,      // (rows, d) or unused: gradient reaching x directly
    const float* __restrict__ gain,  // (d,)
    T* __restrict__ dx,              // (rows, d)
    float* __restrict__ partial,     // (gridDim.x, d)
    int rows, int d, int per_block, float eps) {
  float* acc = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) acc[c] = 0.0f;
  const int first = blockIdx.x * per_block;
  const int last = min(rows, first + per_block);
  for (int r = first; r < last; ++r) {
    const int64_t base = static_cast<int64_t>(r) * d;
    float ss = 0.0f;
    float sd = 0.0f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xv = to_float(x[base + c]);
      ss = fmaf(xv, xv, ss);
      sd = fmaf(xv, gain[c] * to_float(dy[base + c]), sd);
    }
    const float2 total = row_sums(ss, sd);
    const float inv = 1.0f / sqrtf(total.x / static_cast<float>(d) + eps);
    const float coef = inv * inv * inv * (total.y / static_cast<float>(d));
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xv = to_float(x[base + c]);
      const float g = to_float(dy[base + c]);
      const float dn = inv * (gain[c] * g) - xv * coef;
      T out = rounded<T>(dn);
      if constexpr (kRes) out = rounded<T>(to_float(out) + to_float(dres[base + c]));
      dx[base + c] = out;
      acc[c] = fmaf(g, xv * inv, acc[c]);
    }
  }
}

// Pass 2: dgain[c] = the blocks' partials of column c, added in block order.
__global__ void __launch_bounds__(kThreads) rmsnorm_bwd_gain(
    const float* __restrict__ partial, float* __restrict__ dgain, int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float total = 0.0f;
  for (int b = 0; b < blocks; ++b) total += partial[static_cast<int64_t>(b) * d + c];
  dgain[c] = total;
}

int blocks_for(int rows) { return rows < kMaxBlocks ? rows : kMaxBlocks; }

template <typename T>
cudaError_t launch(const void* x, const void* dy, const void* dres, const float* gain, void* dx,
                   float* partial, float* dgain, int rows, int d, float eps,
                   cudaStream_t stream) {
  const int blocks = blocks_for(rows);
  const int per_block = (rows + blocks - 1) / blocks;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* rt = static_cast<const T*>(dres);
  T* dxt = static_cast<T*>(dx);
  if (dres) {
    rmsnorm_bwd_rows<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, dyt, rt, gain, dxt, partial, rows, d, per_block, eps);
  } else {
    rmsnorm_bwd_rows<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, dyt, rt, gain, dxt, partial, rows, d, per_block, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_gain<<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dgain, blocks, d);
  return cudaGetLastError();
}

}  // namespace

// Rows of the partial gain buffer that rmsnorm_bwd_launch needs for `rows`
// rows: the caller allocates (rmsnorm_bwd_blocks(rows), d) floats.
extern "C" int rmsnorm_bwd_blocks(int rows) { return rows > 0 ? blocks_for(rows) : 0; }

// dx (and dgain) of h = rmsnorm(x) given dy = dL/dh; with dres non-null,
// dx also takes dres, the gradient reaching x directly (the fused form's
// residual sum).  dtype: 0 = float32, 1 = bfloat16 (x, dy, dres, dx); gain,
// partial and dgain are float32.  Returns the CUDA error of the launches
// (0 on success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy, const void* dres,
                                  const void* gain, void* dx, void* partial, void* dgain,
                                  int rows, int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gain);
  float* p = static_cast<float*>(partial);
  float* dg = static_cast<float*>(dgain);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(x, dy, dres, g, dx, p, dg, rows, d, eps, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(x, dy, dres, g, dx, p, dg, rows, d, eps, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

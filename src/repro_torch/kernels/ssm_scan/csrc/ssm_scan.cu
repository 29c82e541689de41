// Mamba selective scan, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// kernels/ssm_scan/ssm_scan.py:_ssm_kernel (wrapper ssm_scan_pallas), which
// keeps a (block_d x N) state in VMEM scratch and carries it from one
// sequence chunk to the next along a sequential grid axis.  On the card,
// blocks run in parallel and in no order, so nothing is carried between
// blocks: one block owns 128 channels of one batch row for the whole
// sequence and walks it in a loop, each thread holding its channel's N-wide
// state in registers.  Any S >= 0 and any D work; the last block masks its
// tail, so the Pallas wrapper's padding is not needed.
//
// Contract: ref.py::ssm_scan_reference, per step t
//   h   <- exp(dt_t * A) * h + (dt_t * x_t) * B_t
//   y_t  = sum_n h[n] * C_t[n]
// in fp32, with fp32 outputs; bf16 inputs are converted on load, as the
// Pallas kernel's .astype(float32) does.  Each product and sum is rounded on
// its own (__fmul_rn / __fadd_rn keep nvcc from fusing them into FMAs), as
// the plain version's separate tensor operations round them; the sum over n
// runs in the fixed order n = 0 .. N-1; exp is expf, never __expf.
//
// What bounds it: bytes.  dt and x are read once and y written once
// (3 x 4 bytes per (b, t, channel)), plus A, h0 and hT once and the small
// B_t, C_t rows: 36,197,376 bytes at Jamba's prefill (1, 168, 16384, 16),
// 10.8 us at 3.35 TB/s, and 10.2 MB (3.0 us) at decode (4, 1, 16384, 16).
// Its 44 M expf at that prefill are about 10.5 us of the SFUs.  The state
// never leaves registers between steps.  Per range of 32 steps the block
// stages dt and x (each thread its own channel, coalesced across the warp)
// and the B_t, C_t rows shared by all channels in shared memory, so a
// range's loads are in flight together rather than one step's at a time.
// What it does not do: the steps of one channel run one after another, so
// at B = 1 the card has 16,384 threads (128 blocks of 128 on 132 SMs) to
// hide each step's dependent expf and multiply-add chain.  A chunked
// parallel scan across steps is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block, one per thread
constexpr int kSteps = 32;      // sequence steps staged per range

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const T* __restrict__ dt,         // (B, S, D) contiguous
    const T* __restrict__ x,          // (B, S, D) contiguous
    const T* __restrict__ bm,         // (B, S, N), strides (bm_sb, bm_ss, 1)
    const T* __restrict__ cm,         // (B, S, N), strides (cm_sb, cm_ss, 1)
    const float* __restrict__ a,      // (D, N) contiguous
    const float* __restrict__ h0,     // (B, D, N) contiguous
    float* __restrict__ y,            // (B, S, D)
    float* __restrict__ hT,           // (B, D, N)
    int S, int D, int N,
    int64_t bm_sb, int64_t bm_ss, int64_t cm_sb, int64_t cm_ss) {
  __shared__ float s_dt[kSteps][kThreads];
  __shared__ float s_x[kSteps][kThreads];
  __shared__ float s_b[kSteps][NMAX];
  __shared__ float s_c[kSteps][NMAX];

  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < D;
  const int64_t state = (b * D + d) * N;   // this channel's (b, d, 0)

  float h[NMAX], A[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool on = live && n < N;
    h[n] = on ? h0[state + n] : 0.0f;
    A[n] = on ? a[static_cast<int64_t>(d) * N + n] : 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = min(kSteps, S - t0);
    __syncthreads();   // every thread is done with the previous range
    for (int i = tid; i < steps * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      s_b[t][n] = to_float(bm[b * bm_sb + (t0 + t) * bm_ss + n]);
      s_c[t][n] = to_float(cm[b * cm_sb + (t0 + t) * cm_ss + n]);
    }
    if (live) {
#pragma unroll 8
      for (int t = 0; t < steps; ++t) {
        const int64_t idx = (b * S + t0 + t) * D + d;
        s_dt[t][tid] = to_float(dt[idx]);
        s_x[t][tid] = to_float(x[idx]);
      }
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < steps; ++t) {
        const float dtv = s_dt[t][tid];
        const float dx = __fmul_rn(dtv, s_x[t][tid]);
        float yv = 0.0f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            const float an = expf(__fmul_rn(dtv, A[n]));
            h[n] = __fadd_rn(__fmul_rn(an, h[n]), __fmul_rn(dx, s_b[t][n]));
            yv = __fadd_rn(yv, __fmul_rn(h[n], s_c[t][n]));
          }
        }
        y[(b * S + t0 + t) * D + d] = yv;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) hT[state + n] = h[n];
    }
  }
}

template <typename T, int NMAX>
cudaError_t launch(const void* dt, const void* x, const void* bm, const void* cm,
                   const void* a, const void* h0, void* y, void* hT, int B, int S,
                   int D, int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb,
                   int64_t cm_ss, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T, NMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT),
      S, D, N, bm_sb, bm_ss, cm_sb, cm_ss);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* dt, const void* x, const void* bm, const void* cm,
                     const void* a, const void* h0, void* y, void* hT, int B, int S,
                     int D, int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb,
                     int64_t cm_ss, cudaStream_t stream) {
  if (N <= 4) {
    return launch<T, 4>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 8) {
    return launch<T, 8>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 16) {
    return launch<T, 16>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dt, x, bm, cm); a, h0, y and hT are
// float32.  bm and cm take their batch and step strides in elements; their
// last stride is 1.  1 <= N <= 16, 1 <= B <= 65535.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* bm,
                               const void* cm, const void* a, const void* h0, void* y,
                               void* hT, int B, int S, int D, int N, long long bm_sb,
                               long long bm_ss, long long cm_sb, long long cm_ss,
                               int dtype, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (N < 1 || B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_n<float>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N,
                                            bm_sb, bm_ss, cm_sb, cm_ss, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_n<__nv_bfloat16>(dt, x, bm, cm, a, h0, y, hT, B, S, D,
                                                    N, bm_sb, bm_ss, cm_sb, cm_ss, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

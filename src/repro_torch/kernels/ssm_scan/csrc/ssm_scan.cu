// Mamba selective scan, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// kernels/ssm_scan/ssm_scan.py:_ssm_kernel (wrapper ssm_scan_pallas), which
// keeps a (block_d x N) state in VMEM scratch and carries it from one
// sequence chunk to the next along a sequential grid axis.  On the card,
// blocks run in parallel and in no order, so nothing is carried between
// blocks: one block owns 32 channels of one batch row for the whole
// sequence and walks it in a loop, the state in registers.  Any S >= 0 and
// any D work; the last block masks its tail, so the Pallas wrapper's
// padding is not needed.
//
// Contract: ref.py::ssm_scan_reference, per step t
//   h   <- exp(dt_t * A) * h + (dt_t * x_t) * B_t
//   y_t  = sum_n h[n] * C_t[n]
// in fp32, with fp32 outputs; bf16 inputs are converted on load, as the
// Pallas kernel's .astype(float32) does.  Each product and sum of the
// recurrence is rounded on its own (__fmul_rn / __fadd_rn keep nvcc from
// fusing them into FMAs), as the plain version's separate tensor
// operations round them, and exp is expf, never __expf: so hT is bit for
// bit the plain version's.  y sums its N terms in a fixed order (each lane
// its own states in order, then the four lanes as (l0 + l1) + (l2 + l3)),
// so it is the same from run to run and within float tolerance of the
// plain version's sum.
//
// What bounds it: bytes.  dt and x are read once and y written once
// (3 x 4 bytes per (b, t, channel)), plus A, h0 and hT once and the small
// B_t, C_t rows: 36,197,376 bytes at Jamba's prefill (1, 168, 16384, 16),
// 10.8 us at 3.35 TB/s, and 10.2 MB (3.0 us) at decode (4, 1, 16384, 16).
// Its 44 M expf at that prefill are about 10.5 us of the SFUs.  The steps of
// one channel depend on each other (expf, multiply, add per state), so
// the time is the latency of that chain unless enough of them run side by
// side.  The design:
//
// * Four lanes per channel, each with N / 4 of its states: at B = 1 and
//   D = 16,384 that is 65,536 threads (512 blocks of 128, about 16 warps
//   per SM) where one thread per channel gave 16,384.
// * A lane's slice of h0, hT and A is one 16-byte access when N = 16 (the
//   four lanes of a channel read its 64 contiguous bytes, a warp 512), not
//   N separate floats 64 bytes apart between neighbouring threads.
// * dt and x are staged once per channel for a range of 32 steps (each
//   step's 32 channels one 128-byte row) and shared by the channel's four
//   lanes; the B_t and C_t rows, shared by all channels, are staged beside
//   them; y is gathered per range in shared memory and written in rows.
// * y's lane sums meet in two __shfl_xor_sync steps; all lanes take part
//   (a channel past D computes on zeros), so no shuffle is divergent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                     // lanes per channel
constexpr int kThreads = 128;                 // threads per block
constexpr int kChannels = kThreads / kLanes;  // 32 channels per block
constexpr int kSteps = 32;                    // sequence steps staged per range
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// kVec: N == NMAX == 16 and h0, hT and a 16-byte aligned, so each lane
// moves its four states as one float4.
template <typename T, int NMAX, bool kVec>
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
  constexpr int kPer = NMAX / kLanes;   // states per lane
  __shared__ float s_dt[kSteps][kChannels];
  __shared__ float s_x[kSteps][kChannels];
  __shared__ float s_y[kSteps][kChannels];
  __shared__ float s_b[kSteps][NMAX];
  __shared__ float s_c[kSteps][NMAX];

  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ch = tid / kLanes;
  const int lane = tid % kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int channels = min(kChannels, D - d0);
  const int d = d0 + ch;
  const bool live = ch < channels;
  const int n0 = lane * kPer;
  const int64_t state = (b * D + d) * N + n0;   // this lane's (b, d, n0)

  float h[kPer], A[kPer];
  if constexpr (kVec) {
    const float4 hv = live ? *reinterpret_cast<const float4*>(h0 + state) : float4{0, 0, 0, 0};
    const float4 av = live ? *reinterpret_cast<const float4*>(a + static_cast<int64_t>(d) * N + n0)
                           : float4{0, 0, 0, 0};
    h[0] = hv.x; h[1] = hv.y; h[2] = hv.z; h[3] = hv.w;
    A[0] = av.x; A[1] = av.y; A[2] = av.z; A[3] = av.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool on = live && n0 + j < N;
      h[j] = on ? h0[state + j] : 0.0f;
      A[j] = on ? a[static_cast<int64_t>(d) * N + n0 + j] : 0.0f;
    }
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
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int c = i - t * kChannels;
      const int64_t idx = (b * S + t0 + t) * D + d0 + c;
      s_dt[t][c] = c < channels ? to_float(dt[idx]) : 0.0f;
      s_x[t][c] = c < channels ? to_float(x[idx]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = s_dt[t][ch];
      const float dx = __fmul_rn(dtv, s_x[t][ch]);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int n = n0 + j;
        if (kVec || n < N) {
          const float an = expf(__fmul_rn(dtv, A[j]));
          h[j] = __fadd_rn(__fmul_rn(an, h[j]), __fmul_rn(dx, s_b[t][n]));
          part = __fadd_rn(part, __fmul_rn(h[j], s_c[t][n]));
        }
      }
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, 1));
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, 2));
      if (lane == 0) s_y[t][ch] = part;
    }
    __syncthreads();
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int c = i - t * kChannels;
      if (c < channels) y[(b * S + t0 + t) * D + d0 + c] = s_y[t][c];
    }
  }
  if (live) {
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(hT + state) = float4{h[0], h[1], h[2], h[3]};
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (n0 + j < N) hT[state + j] = h[j];
      }
    }
  }
}

template <typename T, int NMAX, bool kVec>
cudaError_t launch(const void* dt, const void* x, const void* bm, const void* cm,
                   const void* a, const void* h0, void* y, void* hT, int B, int S,
                   int D, int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb,
                   int64_t cm_ss, cudaStream_t stream) {
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T, NMAX, kVec><<<grid, kThreads, 0, stream>>>(
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
    return launch<T, 4, false>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 8) {
    return launch<T, 8, false>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 16) {
    const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0
        && reinterpret_cast<uintptr_t>(h0) % 16 == 0 && reinterpret_cast<uintptr_t>(hT) % 16 == 0;
    if (N == 16 && aligned) {
      return launch<T, 16, true>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
    }
    return launch<T, 16, false>(dt, x, bm, cm, a, h0, y, hT, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
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

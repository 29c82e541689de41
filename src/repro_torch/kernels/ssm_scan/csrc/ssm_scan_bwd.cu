// Backward of the Mamba selective scan, for NVIDIA Hopper (sm_90a).
//
// The reference package has no Pallas backward: its Mamba block runs a
// chunked jnp scan (models/ssm.py) that jax.grad differentiates, and its
// Pallas kernel (kernels/ssm_scan/ssm_scan.py:_ssm_kernel) is an inference
// drop-in.  On the card the port's forward always runs the forward kernel
// (ssm_scan.cu), so training needs this kernel for the gradients of dt, x,
// B, C, A and h0.
//
// Contract: ref.py::ssm_scan_backward_reference.  Forward, per step t:
//   a_t = exp(dt_t A),  h_t = a_t h_(t-1) + (dt_t x_t) B_t,  y_t = sum_n h_t C_t.
// Backward, from g = dhT (0 without one), for t from S - 1 down to 0:
//   g     += dy_t C_t                        (the gradient of h_t)
//   dC_t  = sum_d dy_t h_t                   (over channels)
//   dB_t  = sum_d g dt_t x_t                 (over channels)
//   gB    = sum_n g B_t
//   e     = g h_(t-1) a_t                    (the gradient of dt_t A)
//   dx_t  = dt_t gB
//   ddt_t = sum_n e A + x_t gB
//   dA   += e dt_t                           (over t and b)
//   g     = g a_t                            (the gradient of h_(t-1))
// and dh0 = g.  All in fp32; ddt, dx, dB and dC come back in the inputs'
// dtype, dA and dh0 in fp32.
//
// The serving kernel is left as it is and nothing is saved from it: one
// block owns 32 channels of one batch row (four lanes a channel, N / 4
// states each, as in the forward) and walks the sequence forward once,
// storing its state at the start of every range of 32 steps in a
// workspace.  It then walks the ranges in reverse: it recomputes a range's
// states from its start, bit for bit as the forward kernel computes them
// (the same __fmul_rn / __fadd_rn order and expf), keeping each step's
// h_(t-1) in shared memory, and runs the recurrence above backward through
// the range, the state's gradient g in registers.
//
// Sums that span blocks are finished by a second kernel, in a fixed order,
// with no atomics (as rmsnorm_bwd.cu's finish):
//   - dB_t and dC_t sum over channels: within a warp by an xor butterfly
//     over its 8 channels, the block's 4 warps in warp order, written as the
//     block's partial row; the finish adds the blocks' partials in block
//     order;
//   - dA sums over t (in registers, in reverse step order) and over b: each
//     batch row's partial is written, and the finish adds them in row order.
// So two runs give the same bits.
//
// What bounds it: the chain of dependent steps.  The bytes are dt, x and
// dy read (dt and x twice: the checkpoint walk and the range recompute),
// ddt and dx written, B and C read and the partials written and read back:
// at jamba's training shape (4, 256, 16384, 16) about 0.27 GB, 80 us at
// 3.35 TB/s; the 3 x 268 M expf (a_t in the walk, the recompute and the
// backward step) about 0.2 ms of the SFUs.  A block holds 64 KB of state
// history (32 steps x 128 threads x 4 states) beside 40 KB of staged rows,
// so two blocks of 4 warps share an SM, and each step's chain (expf,
// products, two shuffle butterflies) is exposed.  A first kernel that is
// right; chip_smoke.py times it beside its bound and its plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                     // lanes per channel
constexpr int kThreads = 128;                 // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = kThreads / kLanes;  // 32 channels per block
constexpr int kSteps = 32;                    // steps per range
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ int ranges(int S) { return (S + kSteps - 1) / kSteps; }

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(
    const T* __restrict__ dt,         // (B, S, D) contiguous
    const T* __restrict__ x,          // (B, S, D) contiguous
    const T* __restrict__ bm,         // (B, S, N), strides (bm_sb, bm_ss, 1)
    const T* __restrict__ cm,         // (B, S, N), strides (cm_sb, cm_ss, 1)
    const float* __restrict__ a,      // (D, N) contiguous
    const float* __restrict__ h0,     // (B, D, N) contiguous
    const float* __restrict__ dy,     // (B, S, D) contiguous
    const float* __restrict__ dhT,    // (B, D, N) contiguous, or null
    T* __restrict__ ddt,              // (B, S, D)
    T* __restrict__ dx,               // (B, S, D)
    float* __restrict__ dh0,          // (B, D, N)
    float* __restrict__ da_part,      // (B, D, N): each batch row's dA
    float* __restrict__ db_part,      // (B, blocks, S, N): each block's dB
    float* __restrict__ dc_part,      // (B, blocks, S, N): each block's dC
    float* __restrict__ ckpt,         // (B, R, D, N): the state at each range's start
    int S, int D, int N,
    int64_t bm_sb, int64_t bm_ss, int64_t cm_sb, int64_t cm_ss) {
  constexpr int kPer = NMAX / kLanes;   // states per lane
  extern __shared__ float hist[];       // (kSteps, kPer, kThreads): h_(t-1) of each step
  __shared__ float s_dt[kSteps][kChannels];
  __shared__ float s_x[kSteps][kChannels];
  __shared__ float s_dy[kSteps][kChannels];
  __shared__ float s_ddt[kSteps][kChannels];
  __shared__ float s_dx[kSteps][kChannels];
  __shared__ float s_b[kSteps][NMAX];
  __shared__ float s_c[kSteps][NMAX];
  __shared__ float s_db[kWarps][kSteps][NMAX];
  __shared__ float s_dc[kWarps][kSteps][NMAX];

  const int64_t b = blockIdx.y;
  const int blocks = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int ch = tid / kLanes;
  const int lane = tid % kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int channels = min(kChannels, D - d0);
  const int d = d0 + ch;
  const bool live = ch < channels;
  const int n0 = lane * kPer;
  const int R = ranges(S);
  const int64_t state = (b * D + d) * N + n0;   // this lane's (b, d, n0)

  bool on[kPer];
  float A[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    on[j] = live && n0 + j < N;
    A[j] = on[j] ? a[static_cast<int64_t>(d) * N + n0 + j] : 0.0f;
    h[j] = on[j] ? h0[state + j] : 0.0f;
  }
  // this lane's states at the start of range r
  auto ckpt_at = [&](int r) { return ckpt + ((b * R + r) * D + d) * N + n0; };

  // Stage steps [t0, t0 + steps) of dt and x (and dy), B (and C); zeros
  // past the channels and the state width.
  auto stage = [&](int t0, int steps, bool backward) {
    for (int i = tid; i < steps * NMAX; i += kThreads) {
      const int t = i / NMAX;
      const int n = i - t * NMAX;
      s_b[t][n] = n < N ? to_float(bm[b * bm_sb + (t0 + t) * bm_ss + n]) : 0.0f;
      if (backward) s_c[t][n] = n < N ? to_float(cm[b * cm_sb + (t0 + t) * cm_ss + n]) : 0.0f;
    }
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int c = i - t * kChannels;
      const int64_t idx = (b * S + t0 + t) * D + d0 + c;
      const bool in = c < channels;
      s_dt[t][c] = in ? to_float(dt[idx]) : 0.0f;
      s_x[t][c] = in ? to_float(x[idx]) : 0.0f;
      if (backward) s_dy[t][c] = in ? dy[idx] : 0.0f;
    }
  };

  // The forward step, as ssm_scan.cu computes it.
  auto step = [&](int t) {
    const float dtv = s_dt[t][ch];
    const float dxv = __fmul_rn(dtv, s_x[t][ch]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (on[j]) {
        const float an = expf(__fmul_rn(dtv, A[j]));
        h[j] = __fadd_rn(__fmul_rn(an, h[j]), __fmul_rn(dxv, s_b[t][n0 + j]));
      }
    }
  };

  // Walk 1, forward: the state at the start of every range.
  for (int r = 0; r < R; ++r) {
    const int t0 = r * kSteps;
    const int steps = min(kSteps, S - t0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (on[j]) ckpt_at(r)[j] = h[j];
    }
    __syncthreads();   // every thread is done with the previous range's rows
    stage(t0, steps, false);
    __syncthreads();
    for (int t = 0; t < steps; ++t) step(t);
  }

  // Walk 2, the ranges in reverse.
  float g[kPer], dA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    g[j] = (on[j] && dhT != nullptr) ? dhT[state + j] : 0.0f;
    dA[j] = 0.0f;
  }
  for (int r = R - 1; r >= 0; --r) {
    const int t0 = r * kSteps;
    const int steps = min(kSteps, S - t0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) h[j] = on[j] ? ckpt_at(r)[j] : 0.0f;
    __syncthreads();   // every thread is done with the previous range's rows and partials
    stage(t0, steps, true);
    __syncthreads();
    // recompute the range's states; each thread keeps and reads back its own
    for (int t = 0; t < steps; ++t) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) hist[(t * kPer + j) * kThreads + tid] = h[j];
      step(t);
    }
    for (int t = steps - 1; t >= 0; --t) {
      const float dtv = s_dt[t][ch];
      const float xv = s_x[t][ch];
      const float dyv = s_dy[t][ch];
      const float dxv = __fmul_rn(dtv, xv);
      float gb = 0.0f, ga = 0.0f, db[kPer], dc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        db[j] = dc[j] = 0.0f;
        if (on[j]) {
          const int n = n0 + j;
          const float hp = hist[(t * kPer + j) * kThreads + tid];
          const float an = expf(__fmul_rn(dtv, A[j]));
          const float ht = __fadd_rn(__fmul_rn(an, hp), __fmul_rn(dxv, s_b[t][n]));
          g[j] = fmaf(dyv, s_c[t][n], g[j]);
          dc[j] = dyv * ht;
          db[j] = g[j] * dxv;
          gb = fmaf(g[j], s_b[t][n], gb);
          const float e = g[j] * hp * an;
          dA[j] = fmaf(e, dtv, dA[j]);
          ga = fmaf(e, A[j], ga);
          g[j] = g[j] * an;
        }
      }
      // the channel's four lanes (every lane of the warp takes part)
      gb += __shfl_xor_sync(kFull, gb, 1);
      gb += __shfl_xor_sync(kFull, gb, 2);
      ga += __shfl_xor_sync(kFull, ga, 1);
      ga += __shfl_xor_sync(kFull, ga, 2);
      if (lane == 0) {
        s_dx[t][ch] = dtv * gb;
        s_ddt[t][ch] = fmaf(xv, gb, ga);
      }
      // the warp's 8 channels, per state: lanes 0-3 of the warp end with
      // the sums of states 4 lane .. 4 lane + 3 (NMAX 16; kPer a lane)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        db[j] += __shfl_xor_sync(kFull, db[j], 4);
        db[j] += __shfl_xor_sync(kFull, db[j], 8);
        db[j] += __shfl_xor_sync(kFull, db[j], 16);
        dc[j] += __shfl_xor_sync(kFull, dc[j], 4);
        dc[j] += __shfl_xor_sync(kFull, dc[j], 8);
        dc[j] += __shfl_xor_sync(kFull, dc[j], 16);
      }
      if ((tid & 31) < kLanes) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s_db[warp][t][n0 + j] = db[j];
          s_dc[warp][t][n0 + j] = dc[j];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int c = i - t * kChannels;
      if (c < channels) {
        const int64_t idx = (b * S + t0 + t) * D + d0 + c;
        store(ddt + idx, s_ddt[t][c]);
        store(dx + idx, s_dx[t][c]);
      }
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      float sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += s_db[w][t][n];
        sc += s_dc[w][t][n];
      }
      const int64_t row = ((b * blocks + blockIdx.x) * S + t0 + t) * N + n;
      db_part[row] = sb;
      dc_part[row] = sc;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (on[j]) {
      dh0[state + j] = g[j];
      da_part[state + j] = dA[j];
    }
  }
}

// dA = the batch rows' partials in row order; dB and dC = the blocks'
// partials in block order.  One thread per output.
template <typename T>
__global__ void ssm_scan_bwd_finish(const float* __restrict__ da_part,
                                    const float* __restrict__ db_part,
                                    const float* __restrict__ dc_part, float* __restrict__ dA,
                                    T* __restrict__ dB, T* __restrict__ dC, int B, int S, int D,
                                    int N, int blocks) {
  const int64_t DN = static_cast<int64_t>(D) * N;
  const int64_t SN = static_cast<int64_t>(S) * N;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < DN) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += da_part[b * DN + i];
    dA[i] = acc;
    return;
  }
  i -= DN;
  if (i >= 2 * B * SN) return;
  const bool is_c = i >= B * SN;
  if (is_c) i -= B * SN;
  const int64_t b = i / SN, rem = i - b * SN;
  const float* part = (is_c ? dc_part : db_part) + b * blocks * SN + rem;
  float acc = 0.0f;
  for (int k = 0; k < blocks; ++k) acc += part[k * SN];
  store((is_c ? dC : dB) + i, acc);
}

int channel_blocks(int D) { return (D + kChannels - 1) / kChannels; }

template <typename T, int NMAX>
cudaError_t launch(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
                   const void* h0, const void* dy, const void* dhT, void* ddt, void* dx,
                   void* dB, void* dC, void* dA, void* dh0, float* work, int B, int S, int D,
                   int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb, int64_t cm_ss,
                   cudaStream_t stream) {
  const int blocks = channel_blocks(D);
  const int64_t DN = static_cast<int64_t>(D) * N;
  const int64_t part = static_cast<int64_t>(B) * blocks * S * N;
  float* da_part = work;
  float* db_part = da_part + B * DN;
  float* dc_part = db_part + part;
  float* ckpt = dc_part + part;
  const size_t smem = sizeof(float) * kSteps * (NMAX / kLanes) * kThreads;
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<T, NMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<T, NMAX><<<dim3(blocks, B), kThreads, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dhT), static_cast<T*>(ddt),
      static_cast<T*>(dx), static_cast<float*>(dh0), da_part, db_part, dc_part, ckpt, S, D, N,
      bm_sb, bm_ss, cm_sb, cm_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t outputs = DN + 2 * static_cast<int64_t>(B) * S * N;
  const int threads = 256;
  ssm_scan_bwd_finish<T><<<static_cast<unsigned>((outputs + threads - 1) / threads), threads, 0,
                           stream>>>(da_part, db_part, dc_part, static_cast<float*>(dA),
                                     static_cast<T*>(dB), static_cast<T*>(dC), B, S, D, N,
                                     blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* dt, const void* x, const void* bm, const void* cm,
                     const void* a, const void* h0, const void* dy, const void* dhT, void* ddt,
                     void* dx, void* dB, void* dC, void* dA, void* dh0, float* work, int B,
                     int S, int D, int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb,
                     int64_t cm_ss, cudaStream_t stream) {
  if (N <= 4) {
    return launch<T, 4>(dt, x, bm, cm, a, h0, dy, dhT, ddt, dx, dB, dC, dA, dh0, work, B, S, D, N,
                        bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 8) {
    return launch<T, 8>(dt, x, bm, cm, a, h0, dy, dhT, ddt, dx, dB, dC, dA, dh0, work, B, S, D, N,
                        bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 16) {
    return launch<T, 16>(dt, x, bm, cm, a, h0, dy, dhT, ddt, dx, dB, dC, dA, dh0, work, B, S, D,
                         N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of fp32 scratch a call needs: each batch row's dA, each block's
// dB and dC rows, and the state at each range's start.
extern "C" long long ssm_scan_bwd_workspace(int B, int S, int D, int N) {
  const long long DN = static_cast<long long>(D) * N;
  const long long part = static_cast<long long>(B) * channel_blocks(D) * S * N;
  return B * DN + 2 * part + static_cast<long long>(B) * ranges(S) * DN;
}

// dtype: 0 = float32, 1 = bfloat16 (dt, x, bm, cm, ddt, dx, dB, dC); a, h0,
// dy, dhT, dA and dh0 are float32, dhT may be null.  bm and cm take their
// batch and step strides in elements, their last stride 1; every other
// tensor is contiguous, dB and dC (B, S, N).  work holds
// ssm_scan_bwd_workspace floats.  1 <= N <= 16, 1 <= B <= 65535.  Returns
// the CUDA error of the launches (0 on success).
extern "C" int ssm_scan_bwd_launch(const void* dt, const void* x, const void* bm,
                                   const void* cm, const void* a, const void* h0,
                                   const void* dy, const void* dhT, void* ddt, void* dx,
                                   void* dB, void* dC, void* dA, void* dh0, void* work, int B,
                                   int S, int D, int N, long long bm_sb, long long bm_ss,
                                   long long cm_sb, long long cm_ss, int dtype, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (N < 1 || B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == 0) {
    return static_cast<int>(launch_n<float>(dt, x, bm, cm, a, h0, dy, dhT, ddt, dx, dB, dC, dA,
                                            dh0, w, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_n<__nv_bfloat16>(dt, x, bm, cm, a, h0, dy, dhT, ddt, dx, dB,
                                                    dC, dA, dh0, w, B, S, D, N, bm_sb, bm_ss,
                                                    cm_sb, cm_ss, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

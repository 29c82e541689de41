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
// One block owns 32 channels of one batch row (four lanes a channel, N / 4
// states each, as in the forward) and walks the sequence's ranges of 8
// steps in reverse.  For each range it recomputes the states from the
// range's start, bit for bit as the forward kernel computes them (the same
// __fmul_rn / __fadd_rn order and expf), keeping each step's h_(t-1) and a_t
// in shared memory, then runs the recurrence above backward through the
// range, the state's gradient g in registers.  The range-start states come
// from the forward, which stores them under grad (ssm_scan_ckpt_launch;
// the wrapper runs that launch first when a caller has none), so no walk
// here finds them.
//
// What bounds it: the bytes are dt, x and dy read, ddt and dx written, B and
// C read and dB, dC written: at jamba's training shape (4, 256, 16384, 16)
// about 0.35 GB, 0.103 ms at 3.35 TB/s, plus the range-start states read
// (0.13 GB).  The work is about 32 instructions per (b, t, channel, state)
// (one expf, in the recompute; the backward step reads its a_t), so the
// issue rate of the SMs bounds it next, and each step's chain of dependent
// operations when too few warps run side by side.  The design:
//
// * Shared memory is 43.1 KB a block at N = 16 (the history, 9 + 8 steps x
//   4 states x 128 threads; the staged rows), so five 4-warp blocks (20
//   warps) share an SM, where a block holding 32 steps of history (104 KB)
//   left two.  A thread's four states of a step sit in one 16-byte slot.
// * The backward step keeps on its chain only the recurrence in g (one fma
//   and one multiply a state), and a_t comes from the history: no expf.  gB
//   and sum_n e A meet over the channel's four lanes in two xor shuffles
//   each, off that chain.
// * The channel sums of dB_t and dC_t leave the per-step stream: each step
//   writes its g over the a_t it consumed, and after the range the block's
//   128 threads take (step, channel group of 8, lane) each: four states' dt
//   x g and dy h_t (the history's next step) summed over the group's
//   channels in order, the four groups then joined by two xor shuffles in a
//   fixed order, into the block's partial row (the step pitch keeps a
//   quarter warp's reads on 32 banks).
// * A range's rows of dt, x, dy, B and C are read into registers while the
//   range before it computes, and stored into the staged rows after.
// * Sums that span blocks are finished by a second kernel, in a fixed
//   order, with no atomics (as rmsnorm_bwd.cu's finish): dB and dC add the
//   blocks' partial rows (eight warps over the blocks, joined in warp
//   order); dA sums over t in registers (in reverse step order) and over b
//   in the finish, in row order.  So two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                     // lanes per channel
constexpr int kThreads = 128;                 // threads per block
constexpr int kChannels = kThreads / kLanes;  // 32 channels per block
constexpr int kSteps = 8;                     // steps per range (one checkpoint each)
constexpr int kQuarters = kThreads / (kSteps * kLanes);   // channel groups of the range-end sums
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQuarters == 4, "the range-end sums join four channel groups");
static_assert(kSteps * kChannels % kThreads == 0, "a range's rows split evenly over the threads");

// The history holds a thread's kPer states of a step contiguously (one
// 16-byte access at N = 16); a step's pitch is 16 (mod 32) floats past its
// threads' slots, so the range-end sums' reads of a quarter warp (two steps
// or two channel groups) fall on 32 banks.
template <int kPer>
__host__ __device__ constexpr int step_pitch() { return kThreads * kPer + 16; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// kPer consecutive floats (16-, 8- or 4-byte aligned) in one access.
template <int kPer>
__device__ __forceinline__ void ld(const float* p, float (&v)[kPer]) {
  if constexpr (kPer == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (kPer == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}
template <int kPer>
__device__ __forceinline__ void st(float* p, const float (&v)[kPer]) {
  if constexpr (kPer == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kPer == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__host__ __device__ __forceinline__ int ranges(int S) { return (S + kSteps - 1) / kSteps; }

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads, 5) ssm_scan_bwd_kernel(
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
    const float* __restrict__ ckpt,   // (B, R, D, N): the state at each range's start
    int S, int D, int N,
    int64_t bm_sb, int64_t bm_ss, int64_t cm_sb, int64_t cm_ss) {
  constexpr int kPer = NMAX / kLanes;   // states per lane
  constexpr int TP = step_pitch<kPer>();
  // h_(t-1) of step t of the range (t = 0 .. steps; t = steps: the state
  // after the range): thread i's states at t TP + i kPer
  __shared__ __align__(16) float hist_h[(kSteps + 1) * TP];
  // a_t of step t from the recompute, then g of step t from the backward
  // step
  __shared__ __align__(16) float hist_ag[kSteps * TP];
  __shared__ float s_dt[kSteps][kChannels];
  __shared__ float s_x[kSteps][kChannels];
  __shared__ float s_dy[kSteps][kChannels];
  __shared__ float s_dxv[kSteps][kChannels];
  __shared__ float s_ddt[kSteps][kChannels];
  __shared__ float s_dx[kSteps][kChannels];
  __shared__ __align__(16) float s_b[kSteps][NMAX];
  __shared__ __align__(16) float s_c[kSteps][NMAX];

  const int64_t b = blockIdx.y;
  const int blocks = gridDim.x;
  const int tid = threadIdx.x;
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

  // A range's rows move in two halves: fetch reads a thread's share of
  // steps [t0, t0 + steps) of dt, x, dy (rows of kChannels) and B, C (rows
  // of NMAX) into registers, zeros past the channels and the state width;
  // put stores them in the staged rows after the previous range's readers
  // are done, so the reads of one range are in flight while the one before
  // it computes.
  constexpr int kRowShare = kSteps * kChannels / kThreads;   // dt, x, dy values a thread
  constexpr int kBCShare = (kSteps * NMAX + kThreads - 1) / kThreads;
  struct Rows {
    float dt[kRowShare], x[kRowShare], dy[kRowShare], b[kBCShare], c[kBCShare];
  };
  auto fetch = [&](Rows& rows, int t0, int steps) {
#pragma unroll
    for (int k = 0; k < kRowShare; ++k) {
      const int i = tid + k * kThreads;
      const int t = i / kChannels, c = i - t * kChannels;
      const bool in = t < steps && c < channels;
      const int64_t idx = (b * S + t0 + t) * D + d0 + c;
      rows.dt[k] = in ? to_float(dt[idx]) : 0.0f;
      rows.x[k] = in ? to_float(x[idx]) : 0.0f;
      rows.dy[k] = in ? dy[idx] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBCShare; ++k) {
      const int i = tid + k * kThreads;
      const int t = i / NMAX, n = i - t * NMAX;
      const bool in = t < steps && n < N;
      rows.b[k] = in ? to_float(bm[b * bm_sb + (t0 + t) * bm_ss + n]) : 0.0f;
      rows.c[k] = in ? to_float(cm[b * cm_sb + (t0 + t) * cm_ss + n]) : 0.0f;
    }
  };
  auto put = [&](const Rows& rows) {
#pragma unroll
    for (int k = 0; k < kRowShare; ++k) {
      const int i = tid + k * kThreads;
      (&s_dt[0][0])[i] = rows.dt[k];
      (&s_x[0][0])[i] = rows.x[k];
      (&s_dy[0][0])[i] = rows.dy[k];
    }
#pragma unroll
    for (int k = 0; k < kBCShare; ++k) {
      const int i = tid + k * kThreads;
      if (i < kSteps * NMAX) {
        (&s_b[0][0])[i] = rows.b[k];
        (&s_c[0][0])[i] = rows.c[k];
      }
    }
  };
  // The ranges in reverse.
  float g[kPer], dA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    g[j] = (on[j] && dhT != nullptr) ? dhT[state + j] : 0.0f;
    dA[j] = 0.0f;
  }
  float* my_h = hist_h + tid * kPer;
  float* my_ag = hist_ag + tid * kPer;
  Rows next;
  if (R > 0) fetch(next, (R - 1) * kSteps, min(kSteps, S - (R - 1) * kSteps));
  for (int r = R - 1; r >= 0; --r) {
    const int t0 = r * kSteps;
    const int steps = min(kSteps, S - t0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) h[j] = on[j] ? ckpt_at(r)[j] : 0.0f;
    __syncthreads();   // every thread is done with the previous range's rows and history
    put(next);
    if (r > 0) fetch(next, t0 - kSteps, kSteps);
    __syncthreads();
    // recompute the range's states; each thread writes and reads back only
    // its own history slots
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = s_dt[t][ch];
      const float dxv = __fmul_rn(dtv, s_x[t][ch]);
      float bv[kPer], an[kPer];
      ld<kPer>(&s_b[t][n0], bv);
      st<kPer>(my_h + t * TP, h);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        an[j] = on[j] ? expf(__fmul_rn(dtv, A[j])) : 0.0f;
        if (on[j]) h[j] = __fadd_rn(__fmul_rn(an[j], h[j]), __fmul_rn(dxv, bv[j]));
      }
      st<kPer>(my_ag + t * TP, an);
    }
    st<kPer>(my_h + steps * TP, h);
    // backward through the range: on the chain only g = (g + dy C) a
#pragma unroll 4
    for (int t = steps - 1; t >= 0; --t) {
      const float dtv = s_dt[t][ch];
      const float xv = s_x[t][ch];
      const float dyv = s_dy[t][ch];
      float an[kPer], hp[kPer], bv[kPer], cv[kPer], gt[kPer];
      ld<kPer>(my_ag + t * TP, an);
      ld<kPer>(my_h + t * TP, hp);
      ld<kPer>(&s_b[t][n0], bv);
      ld<kPer>(&s_c[t][n0], cv);
      float gb = 0.0f, ga = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        gt[j] = 0.0f;
        if (on[j]) {
          g[j] = fmaf(dyv, cv[j], g[j]);
          gt[j] = g[j];
          gb = fmaf(g[j], bv[j], gb);
          const float gn = g[j] * an[j];
          const float e = gn * hp[j];
          dA[j] = fmaf(e, dtv, dA[j]);
          ga = fmaf(e, A[j], ga);
          g[j] = gn;
        }
      }
      st<kPer>(my_ag + t * TP, gt);   // g of step t over the a_t it consumed
      // the channel's four lanes (every lane of the warp takes part)
      gb += __shfl_xor_sync(kFull, gb, 1);
      gb += __shfl_xor_sync(kFull, gb, 2);
      ga += __shfl_xor_sync(kFull, ga, 1);
      ga += __shfl_xor_sync(kFull, ga, 2);
      if (lane == 0) {
        s_dx[t][ch] = dtv * gb;
        s_ddt[t][ch] = fmaf(xv, gb, ga);
        s_dxv[t][ch] = dtv * xv;
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
    // dB_t and dC_t over the block's 32 channels: thread (t, channel group
    // q, lane ln) sums channels 4i + q (i = 0 .. 7, in order) for the
    // states of lane ln, g of step t and h_t (the history's step t + 1);
    // the four groups then meet in two xor shuffles, ((q0 + q1) + (q2 + q3)).
    {
      const int ln = tid % kLanes;
      const int q = (tid / kLanes) % kQuarters;
      const int t = tid / (kLanes * kQuarters);
      float sb[kPer], sc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) sb[j] = sc[j] = 0.0f;
      if (t < steps) {
#pragma unroll
        for (int i = 0; i < kChannels / kQuarters; ++i) {
          const int c = kQuarters * i + q;
          float gv[kPer], hv[kPer];
          ld<kPer>(hist_ag + t * TP + (c * kLanes + ln) * kPer, gv);
          ld<kPer>(hist_h + (t + 1) * TP + (c * kLanes + ln) * kPer, hv);
          const float dxv = s_dxv[t][c], dyv = s_dy[t][c];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            sb[j] = fmaf(dxv, gv[j], sb[j]);
            sc[j] = fmaf(dyv, hv[j], sc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        sb[j] += __shfl_xor_sync(kFull, sb[j], kLanes);
        sb[j] += __shfl_xor_sync(kFull, sb[j], 2 * kLanes);
        sc[j] += __shfl_xor_sync(kFull, sc[j], kLanes);
        sc[j] += __shfl_xor_sync(kFull, sc[j], 2 * kLanes);
      }
      if (q == 0 && t < steps) {
        const int64_t row = ((b * blocks + blockIdx.x) * S + t0 + t) * N;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int n = ln * kPer + j;
          if (n < N) {
            db_part[row + n] = sb[j];
            dc_part[row + n] = sc[j];
          }
        }
      }
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

// The finish, in a fixed order: dA = the batch rows' partials in row order,
// one thread an output (the first da_blocks blocks); dB and dC = the
// channel blocks' partial rows, 32 consecutive outputs a block: warp w sums
// the partials of blocks w, w + 8, w + 16, ... in order, then the eight
// warps' sums meet in warp order.
constexpr int kFinishThreads = 256;
constexpr int kFinishWarps = kFinishThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kFinishThreads) ssm_scan_bwd_finish(
    const float* __restrict__ da_part, const float* __restrict__ db_part,
    const float* __restrict__ dc_part, float* __restrict__ dA, T* __restrict__ dB,
    T* __restrict__ dC, int B, int S, int D, int N, int blocks, int da_blocks) {
  __shared__ float sums[kFinishWarps][32];
  const int64_t DN = static_cast<int64_t>(D) * N;
  const int64_t SN = static_cast<int64_t>(S) * N;
  if (static_cast<int>(blockIdx.x) < da_blocks) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
    if (i < DN) {
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc += da_part[b * DN + i];
      dA[i] = acc;
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t i = (static_cast<int64_t>(blockIdx.x) - da_blocks) * 32 + lane;   // of 2 B S N
  const bool in = i < 2 * B * SN;
  const bool is_c = in && i >= B * SN;
  const int64_t j = is_c ? i - B * SN : i;
  const int64_t b = j / SN, rem = j - b * SN;
  float acc = 0.0f;
  if (in) {
    const float* part = (is_c ? dc_part : db_part) + b * blocks * SN + rem;
    for (int k = warp; k < blocks; k += kFinishWarps) acc += part[k * SN];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && in) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kFinishWarps; ++w) total += sums[w][lane];
    store((is_c ? dC : dB) + j, total);
  }
}

int channel_blocks(int D) { return (D + kChannels - 1) / kChannels; }

// Floats of the partial sums a call needs: each batch row's dA and each
// block's dB and dC rows.
long long partial_floats(int B, int S, int D, int N) {
  return static_cast<long long>(B) * D * N
      + 2LL * B * channel_blocks(D) * static_cast<long long>(S) * N;
}

template <typename T, int NMAX>
cudaError_t launch(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
                   const void* h0, const void* dy, const void* dhT, const float* ckpt, void* ddt,
                   void* dx, void* dB, void* dC, void* dA, void* dh0, float* work, int B, int S,
                   int D, int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb, int64_t cm_ss,
                   cudaStream_t stream) {
  const int blocks = channel_blocks(D);
  const int64_t DN = static_cast<int64_t>(D) * N;
  const int64_t part = static_cast<int64_t>(B) * blocks * S * N;
  float* da_part = work;
  float* db_part = da_part + B * DN;
  float* dc_part = db_part + part;
  // all of the SM's unified memory as shared memory, so the most blocks fit
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<T, NMAX>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<T, NMAX><<<dim3(blocks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dhT), static_cast<T*>(ddt),
      static_cast<T*>(dx), static_cast<float*>(dh0), da_part, db_part, dc_part, ckpt, S, D, N,
      bm_sb, bm_ss, cm_sb, cm_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t da_blocks = (DN + kFinishThreads - 1) / kFinishThreads;
  const int64_t bc_blocks = (2 * static_cast<int64_t>(B) * S * N + 31) / 32;
  ssm_scan_bwd_finish<T><<<static_cast<unsigned>(da_blocks + bc_blocks), kFinishThreads, 0,
                           stream>>>(da_part, db_part, dc_part, static_cast<float*>(dA),
                                     static_cast<T*>(dB), static_cast<T*>(dC), B, S, D, N,
                                     blocks, static_cast<int>(da_blocks));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* dt, const void* x, const void* bm, const void* cm,
                     const void* a, const void* h0, const void* dy, const void* dhT,
                     const float* ckpt,
                     void* ddt, void* dx, void* dB, void* dC, void* dA, void* dh0, float* work,
                     int B, int S, int D, int N, int64_t bm_sb, int64_t bm_ss, int64_t cm_sb,
                     int64_t cm_ss, cudaStream_t stream) {
  if (N <= 4) {
    return launch<T, 4>(dt, x, bm, cm, a, h0, dy, dhT, ckpt, ddt, dx, dB, dC, dA, dh0,
                               work, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 8) {
    return launch<T, 8>(dt, x, bm, cm, a, h0, dy, dhT, ckpt, ddt, dx, dB, dC, dA, dh0,
                               work, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  if (N <= 16) {
    return launch<T, 16>(dt, x, bm, cm, a, h0, dy, dhT, ckpt, ddt, dx, dB, dC, dA, dh0,
                                work, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, stream);
  }
  return cudaErrorInvalidValue;
}

int launch_dtype(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
                 const void* h0, const void* dy, const void* dhT, const float* ckpt, void* ddt,
                 void* dx, void* dB, void* dC, void* dA, void* dh0, float* work, int B, int S,
                 int D, int N, long long bm_sb, long long bm_ss, long long cm_sb,
                 long long cm_ss, int dtype, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (N < 1 || B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_n<float>(dt, x, bm, cm, a, h0, dy, dhT, ckpt, ddt, dx,
                                                   dB, dC, dA, dh0, work, B, S, D, N, bm_sb,
                                                   bm_ss, cm_sb, cm_ss, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_n<__nv_bfloat16>(dt, x, bm, cm, a, h0, dy, dhT, ckpt,
                                                           ddt, dx, dB, dC, dA, dh0, work, B, S,
                                                           D, N, bm_sb, bm_ss, cm_sb, cm_ss, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Floats of fp32 scratch a call needs: each batch row's dA and each
// block's dB and dC rows.
extern "C" long long ssm_scan_bwd_workspace(int B, int S, int D, int N) {
  return partial_floats(B, S, D, N);
}

// Steps of a range: ckpt holds the states at steps 0, ssm_scan_bwd_range_steps(),
// 2 ssm_scan_bwd_range_steps(), ... (ssm_scan_ckpt_steps() of the forward).
extern "C" int ssm_scan_bwd_range_steps() { return kSteps; }

// Blocks of the scan backward kernel (fp32, N = 16) that fit one SM, or -1
// on a CUDA error.
extern "C" int ssm_scan_bwd_blocks_per_sm() {
  int blocks = -1;
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<float, 16>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return -1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssm_scan_bwd_kernel<float, 16>,
                                                      kThreads, 0);
  return err == cudaSuccess ? blocks : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (dt, x, bm, cm, ddt, dx, dB, dC); a, h0,
// dy, dhT, ckpt, dA and dh0 are float32, dhT may be null.  ckpt: (B,
// ceil(S / ssm_scan_bwd_range_steps()), D, N), the state at the start of
// each range, as ssm_scan_ckpt_launch (the forward under grad) stores it.
// bm and cm take their batch and step strides in elements, their last
// stride 1; every other tensor is contiguous, dB and dC (B, S, N).  work
// holds ssm_scan_bwd_workspace floats.  1 <= N <= 16, 1 <= B <= 65535.
// Returns the CUDA error of the launches (0 on success).
extern "C" int ssm_scan_bwd_launch(const void* dt, const void* x, const void* bm,
                                   const void* cm, const void* a, const void* h0,
                                   const void* dy, const void* dhT, const void* ckpt, void* ddt,
                                   void* dx, void* dB, void* dC, void* dA, void* dh0, void* work,
                                   int B, int S, int D, int N, long long bm_sb, long long bm_ss,
                                   long long cm_sb, long long cm_ss, int dtype, void* stream) {
  return launch_dtype(dt, x, bm, cm, a, h0, dy, dhT, static_cast<const float*>(ckpt), ddt, dx,
                      dB, dC, dA, dh0, static_cast<float*>(work), B, S, D, N, bm_sb, bm_ss,
                      cm_sb, cm_ss, dtype, stream);
}

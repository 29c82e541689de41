// Sparse flow step of the stream simulator's tick, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernels
// kernels/stream_flow/stream_flow.py:_demand_kernel and :_flow_kernel
// (wrapper stream_flow_pallas).  Those express gather and scatter as one-hot
// matmuls for the TPU's matrix unit and carry sums across a sequential grid
// over edge blocks.  Here the gathers are plain loads and each batch row is
// one thread block that does the whole step, both passes and the throttle
// between them, in one launch.
//
// Contract: ref.py::stream_flow_ell_reference, i.e. the grouping the
// simulator's sparse tick runs (reference streams/simulator.py l. 732-742):
// per-instance sums over the ELL rows, then per-container sums of those.
//
//   pass 1   orig_i = sum_{e in ell_src[i]} qout[src[e]] * share[e]
//            arr_i  = sum_{e in ell_dst[i]} qout[src[e]] * share[e] * remote[e]
//   throttle s_k = min(1, budget[k] / max(sum_{i in k} orig_i + arr_i, 1e-9))
//   pass 2   f[e] = qout[src[e]] * share[e] * min(s[sc[e]], remote[e] ? s[dc[e]] : 1)
//            delivered_i = sum_{ell_src[i]} f,  arrivals_i = sum_{ell_dst[i]} f
//            trav_k = sum_{i in k} delivered_i + sum_{i in k} sum_{ell_dst[i]} f * remote
//
// ELL ids >= E are row padding and count as zero.
//
// What bounds it: bytes.  Each edge does a handful of flops, so the step is
// a gather/reduce over memory: the ELL rows (I x (D_out + D_in) int32) and
// the per-edge arrays (src, share, remote, src/dst container), each walked
// twice, once per pass.  The design keeps everything else on chip: the row's
// qout, the per-instance partial sums, the container throttles and the
// instance->container map live in shared memory (4 I + K words), and
// f_want is recomputed in pass 2 instead of being written out and read back.
// One warp walks one ELL row, so the row's ids are read as contiguous
// 128-byte lines.  Sums use a fixed order (lane-strided, then a butterfly
// shuffle, then instance order per container) and no atomics, so results
// are the same from run to run.  One block per batch row leaves most SMs
// idle at small batch; spreading a row over a cluster is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) stream_flow_ell_kernel(
    const float* __restrict__ qout,            // (B, I)
    const int32_t* __restrict__ edge_src,      // (B, E)
    const float* __restrict__ edge_share,      // (B, E)
    const float* __restrict__ edge_remote,     // (B, E)
    const int32_t* __restrict__ edge_src_cont, // (B, E)
    const int32_t* __restrict__ edge_dst_cont, // (B, E)
    const int32_t* __restrict__ ell_src,       // (B, I, D_out)
    const int32_t* __restrict__ ell_dst,       // (B, I, D_in)
    const int32_t* __restrict__ cont_of,       // (B, I)
    const float* __restrict__ sm_budget,       // (B, K)
    float* __restrict__ delivered,             // (B, I)
    float* __restrict__ arrivals,              // (B, I)
    float* __restrict__ trav_c,                // (B, K)
    int I, int K, int E, int D_out, int D_in) {
  extern __shared__ float smem[];
  float* s_q = smem;               // (I) this row's qout
  float* s_a = s_q + I;            // (I) per-instance partial sums
  float* s_b = s_a + I;            // (I) per-instance partial sums
  float* s_s = s_b + I;            // (K) container throttle s_k
  int* s_cont = reinterpret_cast<int*>(s_s + K);  // (I) container of each instance

  const int64_t b = blockIdx.x;
  qout += b * I;
  cont_of += b * I;
  edge_src += b * E;
  edge_share += b * E;
  edge_remote += b * E;
  edge_src_cont += b * E;
  edge_dst_cont += b * E;
  ell_src += b * I * D_out;
  ell_dst += b * I * D_in;
  sm_budget += b * K;
  delivered += b * I;
  arrivals += b * I;
  trav_c += b * K;

  for (int i = threadIdx.x; i < I; i += blockDim.x) {
    s_q[i] = qout[i];
    s_cont[i] = cont_of[i];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;

  // pass 1: per-instance origin demand (by source) and remote arrivals (by
  // destination)
  for (int i = warp; i < I; i += n_warps) {
    const int32_t* row = ell_src + (int64_t)i * D_out;
    float orig = 0.f;
#pragma unroll 4
    for (int d = lane; d < D_out; d += kWarp) {
      const int e = row[d];
      if (e < E) orig += __fmul_rn(s_q[edge_src[e]], edge_share[e]);
    }
    row = ell_dst + (int64_t)i * D_in;
    float arr = 0.f;
#pragma unroll 4
    for (int d = lane; d < D_in; d += kWarp) {
      const int e = row[d];
      if (e < E) {
        arr += __fmul_rn(__fmul_rn(s_q[edge_src[e]], edge_share[e]), edge_remote[e]);
      }
    }
    orig = warp_sum(orig);
    arr = warp_sum(arr);
    if (lane == 0) {
      s_a[i] = orig;
      s_b[i] = arr;
    }
  }
  __syncthreads();

  // throttle: one thread per container sums its instances in instance order
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float orig = 0.f, arr = 0.f;
    for (int i = 0; i < I; ++i) {
      if (s_cont[i] == k) {
        orig += s_a[i];
        arr += s_b[i];
      }
    }
    s_s[k] = fminf(1.f, __fdiv_rn(sm_budget[k], fmaxf(orig + arr, 1e-9f)));
  }
  __syncthreads();

  // pass 2: throttled flow, summed by source and by destination instance
  for (int i = warp; i < I; i += n_warps) {
    const int32_t* row = ell_src + (int64_t)i * D_out;
    float deliv = 0.f;
#pragma unroll 4
    for (int d = lane; d < D_out; d += kWarp) {
      const int e = row[d];
      if (e < E) {
        const float f_want = __fmul_rn(s_q[edge_src[e]], edge_share[e]);
        const float s_src = s_s[edge_src_cont[e]];
        const float eff = edge_remote[e] > 0.f ? fminf(s_src, s_s[edge_dst_cont[e]])
                                               : fminf(s_src, 1.f);
        deliv += __fmul_rn(f_want, eff);
      }
    }
    row = ell_dst + (int64_t)i * D_in;
    float arriv = 0.f, remote_in = 0.f;
#pragma unroll 4
    for (int d = lane; d < D_in; d += kWarp) {
      const int e = row[d];
      if (e < E) {
        const float f_want = __fmul_rn(s_q[edge_src[e]], edge_share[e]);
        const float s_src = s_s[edge_src_cont[e]];
        const float remote = edge_remote[e];
        const float eff = remote > 0.f ? fminf(s_src, s_s[edge_dst_cont[e]])
                                       : fminf(s_src, 1.f);
        const float f = __fmul_rn(f_want, eff);
        arriv += f;
        remote_in += __fmul_rn(f, remote);
      }
    }
    deliv = warp_sum(deliv);
    arriv = warp_sum(arriv);
    remote_in = warp_sum(remote_in);
    if (lane == 0) {
      delivered[i] = deliv;
      arrivals[i] = arriv;
      s_a[i] = deliv;
      s_b[i] = remote_in;
    }
  }
  __syncthreads();

  // stream-manager traversals: originated copies plus remote arrivals
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float out = 0.f, in = 0.f;
    for (int i = 0; i < I; ++i) {
      if (s_cont[i] == k) {
        out += s_a[i];
        in += s_b[i];
      }
    }
    trav_c[k] = out + in;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a row of I instances and K containers.
size_t stream_flow_ell_smem_bytes(int I, int K) {
  return (size_t)(4 * I + K) * sizeof(float);
}

// Launches the flow step for B rows on `stream`; returns cudaGetLastError().
int stream_flow_ell_launch(
    const void* qout, const void* edge_src, const void* edge_share,
    const void* edge_remote, const void* edge_src_cont, const void* edge_dst_cont,
    const void* ell_src, const void* ell_dst, const void* cont_of,
    const void* sm_budget, void* delivered, void* arrivals, void* trav_c,
    int B, int I, int K, int E, int D_out, int D_in, void* stream) {
  const size_t smem = stream_flow_ell_smem_bytes(I, K);
  stream_flow_ell_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qout), static_cast<const int32_t*>(edge_src),
      static_cast<const float*>(edge_share), static_cast<const float*>(edge_remote),
      static_cast<const int32_t*>(edge_src_cont),
      static_cast<const int32_t*>(edge_dst_cont),
      static_cast<const int32_t*>(ell_src), static_cast<const int32_t*>(ell_dst),
      static_cast<const int32_t*>(cont_of), static_cast<const float*>(sm_budget),
      static_cast<float*>(delivered), static_cast<float*>(arrivals),
      static_cast<float*>(trav_c), I, K, E, D_out, D_in);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Sparse flow step of the stream simulator's tick, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernels
// kernels/stream_flow/stream_flow.py:_demand_kernel and :_flow_kernel
// (wrapper stream_flow_pallas).  Those express gather and scatter as one-hot
// matmuls for the TPU's matrix unit and carry sums across a sequential grid
// over edge blocks.  Here the gathers are plain loads, and each batch row is
// one thread-block cluster that does the whole step, both passes and the
// throttle between them, in one launch.
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
// ELL ids >= E are row padding and count as zero.  Each ELL row lists its
// real ids first (ref.py::ell_rows), so the first padding id ends the row.
//
// What bounds it: bytes.  Each edge does a handful of flops, so the step is
// a gather/reduce over memory: the real slots of the ELL rows and the
// per-edge arrays they index (src, share, remote, src/dst container).  The
// design:
//
// * One cluster of n CTAs per batch row (the wrapper picks n from B and I,
//   up to 16), so a small batch still spreads over many SMs.  CTA r owns a
//   contiguous slice of the row's instances; one warp walks one ELL row.
// * Every CTA holds the whole row's qout, per-instance partial sums, the K
//   container throttles and the container member lists in its own shared
//   memory (4 I + 2 K + 1 words).  After each pass a CTA copies the partials
//   of the instances its peers own out of their shared memory
//   (distributed shared memory, between cluster barriers), so the
//   per-container sums read local memory only.
// * No walk over ELL padding: a warp loads 32 slots of its row at a time and
//   stops after the first chunk that holds a padding id, so a padded
//   instance costs one 128-byte line.
// * Per-container sums walk each container's member list (cont_ptr,
//   cont_members: the instances sorted stably by container), not all I
//   instances per container.
// * f_want is recomputed in pass 2 instead of being written out and read
//   back.
//
// Sums use a fixed order: lane l takes slots l, l+32, ... of a row, then a
// butterfly shuffle; then instance order within each container; no atomics.
// So the results are the same from run to run and bit for bit the same for
// any batch, any I/K/E/D padding and any cluster size.
//
// A second entry point, container_sum, is the simulator's other per-
// container sum (container CPU demand on both ticks, and the dense tick's
// flow sums), in the same instance order; see its note below.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSumThreads = 256;      // container_sum's block
constexpr int kSumAhead = 16;         // loads container_sum keeps ahead of its adds
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// Returned by the launch when no cluster of the asked size can be placed.
constexpr int kClusterNotPlaceable = -1;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// Copies, into this CTA's a and b, the entries of the instances the other
// CTAs of the cluster own (instance j belongs to rank j / slice).
__device__ __forceinline__ void gather_peer_partials(
    const cg::cluster_group& cluster, float* a, float* b, int I, int slice,
    int rank) {
  for (int j = threadIdx.x; j < I; j += blockDim.x) {
    const int owner = j / slice;
    if (owner != rank) {
      a[j] = cluster.map_shared_rank(a, owner)[j];
      b[j] = cluster.map_shared_rank(b, owner)[j];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) stream_flow_ell_kernel(
    const float* __restrict__ qout,            // (B, I)
    const int32_t* __restrict__ edge_src,      // (B, E)
    const float* __restrict__ edge_share,      // (B, E)
    const float* __restrict__ edge_remote,     // (B, E)
    const int32_t* __restrict__ edge_src_cont, // (B, E)
    const int32_t* __restrict__ edge_dst_cont, // (B, E)
    const int32_t* __restrict__ ell_src,       // (B, I, D_out)
    const int32_t* __restrict__ ell_dst,       // (B, I, D_in)
    const int32_t* __restrict__ cont_ptr,      // (B, K + 1)
    const int32_t* __restrict__ cont_members,  // (B, I)
    const float* __restrict__ sm_budget,       // (B, K)
    float* __restrict__ delivered,             // (B, I)
    float* __restrict__ arrivals,              // (B, I)
    float* __restrict__ trav_c,                // (B, K)
    int I, int K, int E, int D_out, int D_in) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());

  extern __shared__ float smem[];
  float* s_q = smem;               // (I) this row's qout
  float* s_a = s_q + I;            // (I) per-instance partial sums
  float* s_b = s_a + I;            // (I) per-instance partial sums
  float* s_s = s_b + I;            // (K) container throttle s_k
  int* s_ptr = reinterpret_cast<int*>(s_s + K);  // (K + 1) member-list offsets
  int* s_mem = s_ptr + K + 1;      // (I) instances sorted by container

  const int64_t b = blockIdx.y;
  qout += b * I;
  edge_src += b * E;
  edge_share += b * E;
  edge_remote += b * E;
  edge_src_cont += b * E;
  edge_dst_cont += b * E;
  ell_src += b * I * D_out;
  ell_dst += b * I * D_in;
  cont_ptr += b * (K + 1);
  cont_members += b * I;
  sm_budget += b * K;
  delivered += b * I;
  arrivals += b * I;
  trav_c += b * K;

  for (int i = threadIdx.x; i < I; i += blockDim.x) {
    s_q[i] = qout[i];
    s_mem[i] = cont_members[i];
  }
  for (int k = threadIdx.x; k <= K; k += blockDim.x) s_ptr[k] = cont_ptr[k];
  __syncthreads();

  const int slice = (I + n - 1) / n;
  const int lo = rank * slice;
  const int hi = min(I, lo + slice);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;

  // pass 1: per-instance origin demand (by source) and remote arrivals (by
  // destination).  The two rows are walked side by side, 32 slots a step,
  // until each has shown a padding id.
  for (int i = lo + warp; i < hi; i += n_warps) {
    const int32_t* row_out = ell_src + static_cast<int64_t>(i) * D_out;
    const int32_t* row_in = ell_dst + static_cast<int64_t>(i) * D_in;
    float orig = 0.f, arr = 0.f;
    bool more_out = D_out > 0, more_in = D_in > 0;
    for (int c = 0; more_out || more_in; c += kWarp) {
      const int d = c + lane;
      const int eo = more_out && d < D_out ? row_out[d] : E;
      const int ei = more_in && d < D_in ? row_in[d] : E;
      if (eo < E) orig += __fmul_rn(s_q[edge_src[eo]], edge_share[eo]);
      if (ei < E) {
        arr += __fmul_rn(__fmul_rn(s_q[edge_src[ei]], edge_share[ei]), edge_remote[ei]);
      }
      more_out = more_out && __ballot_sync(kFull, eo < E) == kFull && c + kWarp < D_out;
      more_in = more_in && __ballot_sync(kFull, ei < E) == kFull && c + kWarp < D_in;
    }
    orig = warp_sum(orig);
    arr = warp_sum(arr);
    if (lane == 0) {
      s_a[i] = orig;
      s_b[i] = arr;
    }
  }
  cluster.sync();
  gather_peer_partials(cluster, s_a, s_b, I, slice, rank);
  // peers have read this CTA's slice before pass 2 overwrites it
  cluster.sync();

  // throttle: every CTA computes all K (pass 2 reads any of them); one
  // thread per container sums its members in instance order
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float orig = 0.f, arr = 0.f;
    const int end = s_ptr[k + 1];
    for (int m = s_ptr[k]; m < end; ++m) {
      const int i = s_mem[m];
      orig += s_a[i];
      arr += s_b[i];
    }
    s_s[k] = fminf(1.f, __fdiv_rn(sm_budget[k], fmaxf(orig + arr, 1e-9f)));
  }
  __syncthreads();

  // pass 2: throttled flow, summed by source and by destination instance
  for (int i = lo + warp; i < hi; i += n_warps) {
    const int32_t* row_out = ell_src + static_cast<int64_t>(i) * D_out;
    const int32_t* row_in = ell_dst + static_cast<int64_t>(i) * D_in;
    float deliv = 0.f, arriv = 0.f, remote_in = 0.f;
    bool more_out = D_out > 0, more_in = D_in > 0;
    for (int c = 0; more_out || more_in; c += kWarp) {
      const int d = c + lane;
      const int eo = more_out && d < D_out ? row_out[d] : E;
      const int ei = more_in && d < D_in ? row_in[d] : E;
      if (eo < E) {
        const float f_want = __fmul_rn(s_q[edge_src[eo]], edge_share[eo]);
        const float s_src = s_s[edge_src_cont[eo]];
        const float eff = edge_remote[eo] > 0.f ? fminf(s_src, s_s[edge_dst_cont[eo]])
                                                : fminf(s_src, 1.f);
        deliv += __fmul_rn(f_want, eff);
      }
      if (ei < E) {
        const float f_want = __fmul_rn(s_q[edge_src[ei]], edge_share[ei]);
        const float s_src = s_s[edge_src_cont[ei]];
        const float remote = edge_remote[ei];
        const float eff = remote > 0.f ? fminf(s_src, s_s[edge_dst_cont[ei]])
                                       : fminf(s_src, 1.f);
        const float f = __fmul_rn(f_want, eff);
        arriv += f;
        remote_in += __fmul_rn(f, remote);
      }
      more_out = more_out && __ballot_sync(kFull, eo < E) == kFull && c + kWarp < D_out;
      more_in = more_in && __ballot_sync(kFull, ei < E) == kFull && c + kWarp < D_in;
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
  cluster.sync();
  gather_peer_partials(cluster, s_a, s_b, I, slice, rank);
  // the last read of a peer's shared memory: no CTA exits before it
  cluster.sync();

  // stream-manager traversals of this CTA's slice of the containers:
  // originated copies plus remote arrivals
  const int k_slice = (K + n - 1) / n;
  const int k_hi = min(K, (rank + 1) * k_slice);
  for (int k = rank * k_slice + threadIdx.x; k < k_hi; k += blockDim.x) {
    float out = 0.f, in = 0.f;
    const int end = s_ptr[k + 1];
    for (int m = s_ptr[k]; m < end; ++m) {
      const int i = s_mem[m];
      out += s_a[i];
      in += s_b[i];
    }
    trav_c[k] = out + in;
  }
}

// Per-container sums of per-instance values, for the simulator's container
// CPU demand (both ticks) and its dense tick's flow sums: the plain
// version is ref.py::container_sum_reference.  It stands in for the
// reference simulator's one-hot products `x @ C` (streams/simulator.py),
// which are plain jnp, not a Pallas kernel.  Each container adds its
// members in instance order from 0, as the flow kernel's throttle does
// above, so the sums do not depend on the padding of I or K and equal the
// plain version bit for bit.  Bound by bytes (vals and one member id per
// instance read once, the sums written once), but a container's sum is
// a chain of dependent adds, and the last container also holds every
// padded instance.  So one block per row first gathers the row's values in
// member order into shared memory (coalesced on the member list), and then
// one thread per container adds its contiguous slice from there, 16
// loads in flight ahead of the adds.
__global__ void __launch_bounds__(kSumThreads) container_sum_kernel(
    const float* __restrict__ vals,            // (B, I)
    const int32_t* __restrict__ cont_ptr,      // (B, K + 1)
    const int32_t* __restrict__ cont_members,  // (B, I)
    float* __restrict__ out,                   // (B, K)
    int I, int K) {
  extern __shared__ float s_sorted[];          // (I) this row's values in member order
  const int64_t b = blockIdx.x;
  vals += b * I;
  cont_members += b * I;
  cont_ptr += b * (K + 1);
  out += b * K;
  for (int m = threadIdx.x; m < I; m += blockDim.x) s_sorted[m] = vals[cont_members[m]];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int end = cont_ptr[k + 1];
    int m = cont_ptr[k];
    float acc = 0.f;
    for (; m + kSumAhead <= end; m += kSumAhead) {
      float a[kSumAhead];
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) a[u] = s_sorted[m + u];
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) acc = __fadd_rn(acc, a[u]);
    }
    for (; m < end; ++m) acc = __fadd_rn(acc, s_sorted[m]);
    out[k] = acc;
  }
}

// Function attributes are per device: the largest dynamic shared memory
// opted in so far, and whether clusters over 8 CTAs are allowed.  Launch
// shapes already checked for placement are remembered, so the occupancy
// query runs once per shape.
struct Placed {
  int device, cluster, threads;
  size_t smem;
};
std::mutex g_mutex;
std::vector<size_t> g_smem_opted;
std::vector<bool> g_nonportable;
std::vector<Placed> g_placed;

// Opts the kernel in to `smem` bytes and to a cluster of `cluster` CTAs on
// the current device and checks that such a cluster can be placed there.
int prepare(const cudaLaunchConfig_t& cfg, int cluster, int threads, size_t smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(g_mutex);
  for (const Placed& p : g_placed) {
    if (p.device == device && p.cluster == cluster && p.threads == threads && p.smem == smem) {
      return 0;
    }
  }
  if (g_smem_opted.size() <= static_cast<size_t>(device)) {
    g_smem_opted.resize(device + 1, 0);
    g_nonportable.resize(device + 1, false);
  }
  if (smem > g_smem_opted[device]) {
    err = cudaFuncSetAttribute(stream_flow_ell_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_opted[device] = smem;
  }
  if (cluster > 8 && !g_nonportable[device]) {
    err = cudaFuncSetAttribute(stream_flow_ell_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_nonportable[device] = true;
  }
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(stream_flow_ell_kernel), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return kClusterNotPlaceable;
  g_placed.push_back(Placed{device, cluster, threads, smem});
  return 0;
}

}  // namespace

extern "C" {

// Shared memory each CTA needs for a row of I instances and K containers:
// the same at every cluster size, since every CTA holds whole-row copies.
size_t stream_flow_ell_smem_bytes(int I, int K) {
  return (size_t)(4 * I + 2 * K + 1) * sizeof(float);
}

// What a nonzero return of stream_flow_ell_launch means.
const char* stream_flow_ell_error_string(int code) {
  if (code == kClusterNotPlaceable) {
    return "no cluster of this size, block size and shared memory fits on the device";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the flow step for B rows on `stream`, one cluster of `cluster`
// CTAs of `threads` threads per row; returns 0, a CUDA error code, or
// kClusterNotPlaceable.
int stream_flow_ell_launch(
    const void* qout, const void* edge_src, const void* edge_share,
    const void* edge_remote, const void* edge_src_cont, const void* edge_dst_cont,
    const void* ell_src, const void* ell_dst, const void* cont_ptr,
    const void* cont_members, const void* sm_budget, void* delivered,
    void* arrivals, void* trav_c, int B, int I, int K, int E, int D_out,
    int D_in, int cluster, int threads, void* stream) {
  const size_t smem = stream_flow_ell_smem_bytes(I, K);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = prepare(cfg, cluster, threads, smem);
  if (rc != 0) return rc;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stream_flow_ell_kernel,
      static_cast<const float*>(qout), static_cast<const int32_t*>(edge_src),
      static_cast<const float*>(edge_share), static_cast<const float*>(edge_remote),
      static_cast<const int32_t*>(edge_src_cont),
      static_cast<const int32_t*>(edge_dst_cont),
      static_cast<const int32_t*>(ell_src), static_cast<const int32_t*>(ell_dst),
      static_cast<const int32_t*>(cont_ptr), static_cast<const int32_t*>(cont_members),
      static_cast<const float*>(sm_budget), static_cast<float*>(delivered),
      static_cast<float*>(arrivals), static_cast<float*>(trav_c), I, K, E, D_out, D_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory container_sum's block takes for a row of I instances.
size_t container_sum_smem_bytes(int I) { return (size_t)I * sizeof(float); }

// Launches the per-container sums for B rows of I instances and K
// containers on `stream`, one block per row; returns 0 or a CUDA error code.
int container_sum_launch(const void* vals, const void* cont_ptr, const void* cont_members,
                         void* out, int B, int I, int K, void* stream) {
  if (B == 0 || K == 0) return 0;
  const size_t smem = container_sum_smem_bytes(I);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        container_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  container_sum_kernel<<<B, kSumThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cont_ptr),
      static_cast<const int32_t*>(cont_members), static_cast<float*>(out), I, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

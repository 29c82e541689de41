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
// What bounds it: bytes.  x, dy (and dres) are read and dx written once,
// a handful of flops per element; at (4, 256, 2048) fp32 that is 24 MiB,
// 7.5 us at 3.35 TB/s.  Reading a row twice, or the gain's partial row
// from device memory once per row, would add about as many bytes again,
// and a chain of load, reduce, load per row leaves the memory idle, so:
//
// - Column ownership.  A row is cut into groups of kVec consecutive
//   elements, one 16-byte vector (4 fp32 or 8 bf16; 4 bf16, 8 bytes, when
//   d is not a multiple of 8), and group k belongs to thread k % threads in
//   every row.  Each thread holds its columns' gain in registers (read
//   once per CTA) and its columns' share of dgain in registers across all
//   of the CTA's rows, written once at the end into the CTA's partial row.
// - One read of each row.  x, dy (and dres) arrive in a shared-memory
//   ring by cp.async, each thread copying and reading back only its own
//   vectors, so no barrier guards the ring; the next kStages - 1 rows are
//   in flight while the current row reduces (kStages = 3 with one vector a
//   thread, 2 with two).  The row's two sums (sum x^2 and sum x * gain *
//   dy) go through one barrier; dx is computed from registers and stored.
// - Width.  threads = the groups of a row (one vector a thread) up to
//   1,024, else two vectors a thread over ceil(groups / 2) threads, rounded
//   up to whole warps, the vectors past the row predicated off: every
//   width the port's models normalise (256 to 8192; 2732 is 683 groups on
//   704 threads) takes this register path, with two CTAs of up to 512
//   threads on an SM (32 warps) at 2048.  Odd widths, unaligned views and
//   rows past 2,048 groups take the generic path, which keeps the same
//   grouping and every sum in the same order (so an unaligned view gives
//   an aligned copy's bits) but reads the row twice and keeps the partial
//   in its device-memory row.
// - A wide finish.  dgain[c] = the CTAs' partials of column c; one CTA of
//   32 warps per 32 columns, warp w adding a fixed run of partial rows in
//   row order, then the warps' sums added in warp order.  It is launched
//   as the rows pass's programmatic dependent, so its launch overlaps the
//   rows pass's tail.
//
// Measured in turns by tools/rmsnorm_probe.py (CUDA-graph replay, inputs
// from HBM) on an H100 80GB HBM3 at 700 W, at (4, 256, 2048) fp32: the
// rows pass 9.7 us and the finish 2.0 us (the norm alone; 12.3 and 2.0
// fused); the programmatic launch took the pair from 0.0125 to 0.0114-
// 0.0118 ms; a 4-row ring was slower (0.0134 ms: more shared memory a
// CTA, no more bytes in flight that helped), a 2-row ring faster at 2048
// (0.0108-0.0112) but slower at 2732 (0.0166 against 0.0157 ms), the
// width most of xlstm-1.3b's norm backward launches run at.  What bounds
// it now: at 2048 the rows pass runs at about 2.5-2.7 TB/s, and the finish
// and the step between the two kernels are about a sixth of the time.
//
// Summation order, fixed:
//   - row sums: each thread adds its groups' elements in index order, by
//     fmaf from 0; each warp joins its 32 sums by the xor butterfly
//     (offsets 16, 8, 4, 2, 1); after one barrier each warp reads the
//     warps' sums (warp w's at lane w, 0 past the last warp) and joins them
//     by the same butterfly, so every thread holds the same total;
//   - dgain: each thread's partial, fmaf in row order from 0; then the
//     finish above.
// Determinism: no atomics.  The split of rows over CTAs (contiguous runs,
// at most kMaxBlocks CTAs) depends on the row count only, never on the
// card, so two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
// Most CTAs of the rows pass: two per SM of an H100, fixed so that the
// split of rows, and with it the gain's summation order, does not depend
// on the card.
constexpr int kMaxBlocks = 264;
// Vector groups a row may have for one vector a thread; the register path
// takes two a thread up to twice this.
constexpr int kOneVecGroups = kMaxThreads;
constexpr int kRegVecs = 2;
constexpr int kFinishWarps = 32;

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

// dx from the norm's fp32 gradient dn: rounded to T and, in the fused form,
// added to the residual gradient as torch adds two gradients of one tensor.
template <typename T, bool kRes>
__device__ __forceinline__ T dx_value(float dn, T res) {
  T out = rounded<T>(dn);
  if constexpr (kRes) out = rounded<T>(to_float(out) + to_float(res));
  return out;
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The row's two sums from each thread's pair, in the order stated at the
// top; one barrier.  `slot` alternates between two buffers from one row to
// the next, so a warp writing the next row's sums never meets a slower
// warp still reading this row's.
__device__ __forceinline__ float2 row_sums(float a, float b, float2* slot) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) slot[threadIdx.x / kWarp] = make_float2(a, b);
  __syncthreads();
  const bool filled = lane < static_cast<int>(blockDim.x) / kWarp;
  const float2 w = filled ? slot[lane] : make_float2(0.0f, 0.0f);
  return make_float2(warp_sum(w.x), warp_sum(w.y));
}

// Asynchronous copy of one vector from device memory into shared memory
// (16 bytes bypassing L1, else 4 or 8 through it); complete at the wait.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(addr), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(addr), "l"(src), "n"(kBytes) : "memory");
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Programmatic dependent launch: the rows pass lets the finish launch once
// every CTA of it has started, and the finish waits at its top until the
// rows pass has completed and its partial rows are visible.
__device__ __forceinline__ void release_finish() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_rows() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int kNV>
__host__ __device__ constexpr int stages() { return kNV == 1 ? 3 : 2; }

// Register path: rows [blockIdx.x * per_block, ...) of dx and the CTA's
// partial gain row; kNV vectors of kVec elements a thread, d = kVec *
// groups, every pointer aligned to its vector.
template <typename T, int kVec, int kNV, bool kRes>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_bwd_regs(
    const T* __restrict__ x,         // (rows, d): the norm's input
    const T* __restrict__ dy,        // (rows, d): gradient of its output
    const T* __restrict__ dres,      // (rows, d) or unused: gradient reaching x directly
    const float* __restrict__ gain,  // (d,)
    T* __restrict__ dx,              // (rows, d)
    float* __restrict__ partial,     // (gridDim.x, d)
    int rows, int d, int per_block, float eps) {
  using V = Vec<T, kVec>;
  constexpr int kTensors = kRes ? 3 : 2;
  constexpr int kStages = stages<kNV>();
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  __shared__ float2 sums[2][kWarp];
  V* ring = reinterpret_cast<V*>(ring_bytes);
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int groups = d / kVec;
  const int first = blockIdx.x * per_block;
  const int last = min(rows, first + per_block);

  bool own[kNV];
  float g[kNV][kVec];
  float acc[kNV][kVec];
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int k = i * nt + t;
    own[i] = k < groups;
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 g4 = own[i] ? reinterpret_cast<const float4*>(gain + k * kVec)[q]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      g[i][4 * q] = g4.x;
      g[i][4 * q + 1] = g4.y;
      g[i][4 * q + 2] = g4.z;
      g[i][4 * q + 3] = g4.w;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[i][j] = 0.0f;
  }

  // Slot (stage, tensor, i) of thread t; one commit group per row, empty
  // past the CTA's last row, so the wait below always leaves the same
  // number of later rows in flight.
  auto slot = [&](int stage, int tensor, int i) {
    return ring + ((stage * kTensors + tensor) * kNV + i) * nt + t;
  };
  auto fetch = [&](int r, int stage) {
    if (r < last) {
      const int64_t base = static_cast<int64_t>(r) * groups;
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        if (own[i]) {
          const int64_t k = base + i * nt + t;
          copy_async<sizeof(V)>(slot(stage, 0, i), reinterpret_cast<const V*>(x) + k);
          copy_async<sizeof(V)>(slot(stage, 1, i), reinterpret_cast<const V*>(dy) + k);
          if constexpr (kRes) {
            copy_async<sizeof(V)>(slot(stage, 2, i), reinterpret_cast<const V*>(dres) + k);
          }
        }
      }
    }
    copy_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(first + s, s);
  release_finish();
  int stage = 0;
  for (int r = first; r < last; ++r) {
    fetch(r + kStages - 1, stage == 0 ? kStages - 1 : stage - 1);
    copy_wait<kStages - 1>();

    float xv[kNV][kVec];
    float gy[kNV][kVec];
    V res[kNV];
    float ss = 0.0f;
    float sd = 0.0f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      if (own[i]) {
        const V xs = *slot(stage, 0, i);
        const V ds = *slot(stage, 1, i);
        if constexpr (kRes) res[i] = *slot(stage, 2, i);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          xv[i][j] = to_float(xs.v[j]);
          gy[i][j] = to_float(ds.v[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          xv[i][j] = 0.0f;
          gy[i][j] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ss = fmaf(xv[i][j], xv[i][j], ss);
        sd = fmaf(xv[i][j], g[i][j] * gy[i][j], sd);
      }
    }

    const float2 total = row_sums(ss, sd, sums[(r - first) & 1]);
    const float inv = 1.0f / sqrtf(total.x / static_cast<float>(d) + eps);
    const float coef = inv * inv * inv * (total.y / static_cast<float>(d));
    V* out = reinterpret_cast<V*>(dx) + static_cast<int64_t>(r) * groups;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      if (own[i]) {
        V o;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float dn = fmaf(-xv[i][j], coef, inv * (g[i][j] * gy[i][j]));
          T r_in = rounded<T>(0.0f);
          if constexpr (kRes) r_in = res[i].v[j];
          o.v[j] = dx_value<T, kRes>(dn, r_in);
          acc[i][j] = fmaf(gy[i][j], xv[i][j] * inv, acc[i][j]);
        }
        out[i * nt + t] = o;
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }

  float* mine = partial + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    if (own[i]) {
      float4* p4 = reinterpret_cast<float4*>(mine + (i * nt + t) * kVec);
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        p4[q] = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                            acc[i][4 * q + 3]);
      }
    }
  }
}

// Generic path: any d, any alignment; groups of `vec` elements as on the
// register path and the same order, the row read twice (once for the
// sums, once for dx), the partial kept in the CTA's device-memory row.
template <typename T, bool kRes>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_bwd_any(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ dres,
    const float* __restrict__ gain, T* __restrict__ dx, float* __restrict__ partial,
    int rows, int d, int vec, int per_block, float eps) {
  __shared__ float2 sums[2][kWarp];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int groups = (d + vec - 1) / vec;
  const int first = blockIdx.x * per_block;
  const int last = min(rows, first + per_block);
  float* acc = partial + static_cast<int64_t>(blockIdx.x) * d;
  release_finish();
  for (int r = first; r < last; ++r) {
    const int64_t base = static_cast<int64_t>(r) * d;
    float ss = 0.0f;
    float sd = 0.0f;
    for (int k = t; k < groups; k += nt) {
      for (int j = 0; j < vec; ++j) {
        const int c = k * vec + j;
        if (c < d) {
          const float xv = to_float(x[base + c]);
          ss = fmaf(xv, xv, ss);
          sd = fmaf(xv, gain[c] * to_float(dy[base + c]), sd);
        }
      }
    }
    const float2 total = row_sums(ss, sd, sums[(r - first) & 1]);
    const float inv = 1.0f / sqrtf(total.x / static_cast<float>(d) + eps);
    const float coef = inv * inv * inv * (total.y / static_cast<float>(d));
    for (int k = t; k < groups; k += nt) {
      for (int j = 0; j < vec; ++j) {
        const int c = k * vec + j;
        if (c < d) {
          const float xv = to_float(x[base + c]);
          const float gy = to_float(dy[base + c]);
          const float dn = fmaf(-xv, coef, inv * (gain[c] * gy));
          T r_in = rounded<T>(0.0f);
          if constexpr (kRes) r_in = dres[base + c];
          dx[base + c] = dx_value<T, kRes>(dn, r_in);
          acc[c] = fmaf(gy, xv * inv, r == first ? 0.0f : acc[c]);
        }
      }
    }
  }
}

// dgain[c]: the partial rows of column c added in a fixed order.  One CTA
// of kFinishWarps warps per 32 columns, lane l on column 32 * blockIdx.x +
// l; warp w adds the rows [w * per, (w + 1) * per) in row order, then warp
// 0 adds the warps' sums in warp order.
__global__ void __launch_bounds__(kFinishWarps * kWarp) rmsnorm_bwd_finish(
    const float* __restrict__ partial, float* __restrict__ dgain, int blocks, int d) {
  __shared__ float warp_sums[kFinishWarps][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int c = blockIdx.x * kWarp + lane;
  const int per = (blocks + kFinishWarps - 1) / kFinishWarps;
  const int lo = w * per;
  const int hi = min(blocks, lo + per);
  wait_for_rows();
  float s = 0.0f;
  if (c < d) {
#pragma unroll 8
    for (int b = lo; b < hi; ++b) s += partial[static_cast<int64_t>(b) * d + c];
  }
  warp_sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < d) {
    float total = warp_sums[0][lane];
#pragma unroll
    for (int k = 1; k < kFinishWarps; ++k) total += warp_sums[k][lane];
    dgain[c] = total;
  }
}

// Contiguous runs of rows, at most kMaxBlocks of them, none empty.
struct Split {
  int blocks;
  int per_block;
};

Split split_rows(int rows) {
  const int cap = rows < kMaxBlocks ? rows : kMaxBlocks;
  const int per = (rows + cap - 1) / cap;
  return {(rows + per - 1) / per, per};
}

// The grouping of a row: vec elements a group (16 bytes, or 4 elements
// when d is not a multiple of the 16-byte count), nv groups a thread.
struct Plan {
  int vec;
  int nv;
  int threads;
};

Plan plan_for(int d, int elem_bytes) {
  int vec = 16 / elem_bytes;
  if (d % vec != 0) vec = 4;
  const int groups = (d + vec - 1) / vec;
  const int nv = groups <= kOneVecGroups ? 1 : (groups + kMaxThreads - 1) / kMaxThreads;
  const int per_thread = (groups + nv - 1) / nv;
  return {vec, nv, (per_thread + kWarp - 1) / kWarp * kWarp};
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Args {
  const void* x;
  const void* dy;
  const void* dres;
  const float* gain;
  void* dx;
  float* partial;
  float* dgain;
  int rows;
  int d;
  float eps;
};

template <typename T, int kVec, int kNV, bool kRes>
cudaError_t launch_regs(const Args& a, const Plan& p, const Split& s, cudaStream_t stream) {
  constexpr int kTensors = kRes ? 3 : 2;
  const size_t smem = static_cast<size_t>(stages<kNV>()) * kTensors * kNV * p.threads
                      * sizeof(Vec<T, kVec>);
  // Past 48 KiB of shared memory in all (the ring and the row sums' 512
  // bytes), a CTA needs the opt-in.
  if (smem + sizeof(float2) * 2 * kWarp > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(rmsnorm_bwd_regs<T, kVec, kNV, kRes>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_regs<T, kVec, kNV, kRes><<<s.blocks, p.threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<const T*>(a.dres),
      a.gain, static_cast<T*>(a.dx), a.partial, a.rows, a.d, s.per_block, a.eps);
  return cudaGetLastError();
}

template <typename T, int kVec, bool kRes>
cudaError_t launch_vec(const Args& a, const Plan& p, const Split& s, cudaStream_t stream) {
  return p.nv == 1 ? launch_regs<T, kVec, 1, kRes>(a, p, s, stream)
                   : launch_regs<T, kVec, 2, kRes>(a, p, s, stream);
}

// The rows pass on the register path where it applies, else the generic
// path; then the finish.
template <typename T, bool kRes>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);      // elements of a 16-byte vector
  const Plan p = plan_for(a.d, sizeof(T));
  const Split s = split_rows(a.rows);
  const size_t vec_bytes = sizeof(T) * p.vec;
  const bool regs = p.nv <= kRegVecs && a.d % p.vec == 0 && aligned(a.x, vec_bytes)
      && aligned(a.dy, vec_bytes) && aligned(a.dx, vec_bytes) && aligned(a.gain, 16)
      && (!kRes || aligned(a.dres, vec_bytes));
  cudaError_t err;
  if (!regs) {
    rmsnorm_bwd_any<T, kRes><<<s.blocks, p.threads, 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<const T*>(a.dres),
        a.gain, static_cast<T*>(a.dx), a.partial, a.rows, a.d, p.vec, s.per_block, a.eps);
    err = cudaGetLastError();
  } else if (p.vec == kWide) {
    err = launch_vec<T, kWide, kRes>(a, p, s, stream);
  } else {
    err = launch_vec<T, 4, kRes>(a, p, s, stream);
  }
  if (err != cudaSuccess) return err;
  // The finish as the rows pass's programmatic dependent: its launch and
  // start overlap the rows pass's tail.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.d + kWarp - 1) / kWarp);
  cfg.blockDim = dim3(kFinishWarps * kWarp);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rmsnorm_bwd_finish, static_cast<const float*>(a.partial),
                            a.dgain, s.blocks, a.d);
}

template <typename T>
cudaError_t launch_dtype(const Args& a, cudaStream_t stream) {
  return a.dres ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

// Floats of scratch that rmsnorm_bwd_launch needs for `rows` rows of width
// d: one partial gain row per CTA of the rows pass.
extern "C" long long rmsnorm_bwd_scratch(int rows, int d) {
  if (rows <= 0 || d <= 0) return 0;
  return static_cast<long long>(split_rows(rows).blocks) * d;
}

// dx (and dgain) of h = rmsnorm(x) given dy = dL/dh; with dres non-null,
// dx also takes dres, the gradient reaching x directly (the fused form's
// residual sum).  dtype: 0 = float32, 1 = bfloat16 (x, dy, dres, dx); gain,
// scratch (rmsnorm_bwd_scratch(rows, d) floats) and dgain are float32.
// Two kernels on `stream`, the rows pass and the finish; returns the CUDA
// error of the launches (0 on success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy, const void* dres,
                                  const void* gain, void* dx, void* scratch, void* dgain,
                                  int rows, int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const Args a{x, dy, dres, static_cast<const float*>(gain), dx, static_cast<float*>(scratch),
               static_cast<float*>(dgain), rows, d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_dtype<float>(a, st));
  if (dtype == 1) return static_cast<int>(launch_dtype<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

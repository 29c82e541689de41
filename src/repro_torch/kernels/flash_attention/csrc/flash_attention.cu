// Blocked online-softmax (flash) attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// kernels/flash_attention/flash_attention.py:_flash_kernel (wrapper
// flash_attention_pallas, model-layout wrapper ops.py:flash_attention).  The
// TPU kernel walks K/V tiles along a sequential grid axis and keeps m, l and
// the accumulator in VMEM scratch across grid steps.  Here one thread block
// owns one (batch, head, 32-query tile) and walks the K/V tiles in a loop,
// keeping m, l and the accumulator in registers.
//
// Contract: ref.py::attention_reference in the model layout (B, S, H, hd):
// causal and/or sliding-window masking (key t is seen by query s when
// t <= s if causal, and t > s - window if a window is given), GQA with
// kv head = h / (H / KV), softmax(scale * q.k) v in fp32, output in q's dtype.
// Keys at index >= S are always masked: S is the real sequence length, never
// a padded one (the reference wrapper passes the padded length, which lets
// padded keys into non-causal rows).
//
// What bounds it: at prefill lengths of a few hundred tokens, fp32
// operations on CUDA cores (2 hd flops per score for q.k and 2 hd per score
// for p.v, about 512 per score at hd 128); the bytes (q, k, v read once, the
// output written once) are a smaller term.  This first version does the
// products with fp32 FMAs on CUDA cores from shared memory (no tensor cores,
// no TMA): each thread owns a 2 x 4 block of scores and a 2 x 8 block of
// the output, so each shared-memory load feeds 1.6-5 FMAs; eight warps per
// block keep more loads and FMAs in flight than wider per-thread blocks
// would at these small grids.  At these sizes a
// block spends much of its time waiting on device memory, so where head_dim
// is a multiple of 4 the tiles arrive 16 bytes per copy: fp32 tiles through
// cp.async, every copy of a tile in flight at once and no registers held;
// bf16 tiles through registers, four loads in flight per thread.  q.k then
// reads shared memory 16 bytes at a time (rows padded to hd + 4 words,
// which keeps those reads free of bank conflicts).  Tiles that the causal or window mask fully hides are
// skipped.  Sums run in a fixed order, so results are the same from run to
// run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 32;          // queries per block
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes
constexpr int kLanes = 16;       // column lanes sharing a query row
constexpr int kRows = kBQ / (kThreads / kLanes);  // 2 query rows per thread
constexpr int kCols = kBK / kLanes;               // 4 score columns per thread
constexpr int kMaxHd = 128;
constexpr int kOutCols = kMaxHd / kLanes;         // 8 output columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Reductions over the 16 lanes that share a query row (a half warp).
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__host__ __device__ constexpr int round_up16(int n) { return (n + 15) / 16 * 16; }

// Row pitch of the q and k tiles, in floats.  Scalar reads: hd + 1, so the
// 16 lanes reading 16 different rows hit 16 different banks.  16-byte reads
// (kVec): hd + 4, which keeps rows 16-byte aligned, and each quarter warp's
// eight rows start in eight different groups of four banks when hd / 4 is
// odd (hd = 16, 64, 120, 128).
__host__ __device__ constexpr int qk_pitch(int hd, bool vec) { return vec ? hd + 4 : hd + 1; }

// Shared memory, in floats: the q and k tiles, the v tile with rows padded
// to a multiple of 16 columns (zero-filled), and the tile of probabilities.
__host__ __device__ constexpr int smem_floats(int hd, bool vec) {
  return (kBQ + kBK) * qk_pitch(hd, vec) + kBK * round_up16(hd) + kBQ * (kBK + 1);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Copy rows [row0, row0 + n_rows) of a (S, hd) slice whose rows are
// `step` elements apart into shared memory rows of `pitch` floats; rows at
// or past S are zero.  Each thread keeps four loads in flight.
template <typename T, bool kVec>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int pitch,
                                          const T* __restrict__ src, int64_t step,
                                          int row0, int n_rows, int S, int hd) {
  constexpr int kW = kVec ? 4 : 1;         // elements per load
  constexpr int kInFlight = 4;
  const int per_row = hd / kW;
  const int total = n_rows * per_row;
  for (int base = threadIdx.x; base < total; base += kInFlight * kThreads) {
    Vec<T, kW> x[kInFlight];
    bool in[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * kThreads;
      const int r = i / per_row, e = (i % per_row) * kW;
      in[u] = i < total && row0 + r < S;
      if (in[u]) x[u] = *reinterpret_cast<const Vec<T, kW>*>(src + (row0 + r) * step + e);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * kThreads;
      if (i >= total) break;
      const int r = i / per_row, e = (i % per_row) * kW;
#pragma unroll
      for (int j = 0; j < kW; ++j) dst[r * pitch + e + j] = in[u] ? to_float(x[u].v[j]) : 0.0f;
    }
  }
}

// 16-byte asynchronous copy from device memory into shared memory; with
// `valid` false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// load_rows for fp32 rows of a multiple of 4 floats, through cp.async; the
// copies complete at the next cp_async_wait_all.
__device__ __forceinline__ void load_rows_async(float* __restrict__ dst, int pitch,
                                                const float* __restrict__ src, int64_t step,
                                                int row0, int n_rows, int S, int hd) {
  const int per_row = hd / 4;
  const int total = n_rows * per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / per_row, e = (i % per_row) * 4;
    const bool in = row0 + r < S;
    cp_async16(dst + r * pitch + e, in ? src + (row0 + r) * step + e : src, in);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,   // (B, S, H, hd)
    const T* __restrict__ k,   // (B, S, KV, hd)
    const T* __restrict__ v,   // (B, S, KV, hd)
    T* __restrict__ out,       // (B, S, H, hd)
    int S, int H, int KV, int hd, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int hdq = qk_pitch(hd, kVec);
  const int hdv = round_up16(hd);
  float* qs = smem;
  float* ks = qs + kBQ * hdq;
  float* vs = ks + kBK * hdq;
  float* ps = vs + kBK * hdv;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;

  const int64_t q_step = static_cast<int64_t>(H) * hd;    // between positions
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * hd;
  T* ob = out + (static_cast<int64_t>(b) * S * H + h) * hd;

  constexpr bool kAsync = kVec && std::is_same<T, float>::value;
  if constexpr (kAsync) {
    load_rows_async(qs, hdq, qb, q_step, q0, kBQ, S, hd);   // waited on with the first tile
  } else {
    load_rows<T, kVec>(qs, hdq, qb, q_step, q0, kBQ, S, hd);
  }
  // v's padding columns [hd, hdv) stay zero: tile loads never write them
  const int tail = hdv - hd;
  for (int i = tid; i < kBK * tail; i += kThreads) {
    vs[(i / tail) * hdv + hd + i % tail] = 0.0f;
  }

  // Keys this tile of queries can see: from the window's lower edge (whole
  // K/V tiles) up to the last query when causal, else to the end.
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = k_begin / kBK * kBK;
  const int k_end = causal ? q_last + 1 : S;

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    if constexpr (kAsync) {
      load_rows_async(ks, hdq, kb, kv_step, k0, kBK, S, hd);
      load_rows_async(vs, hdv, vb, kv_step, k0, kBK, S, hd);
      cp_async_wait_all();
    } else {
      load_rows<T, kVec>(ks, hdq, kb, kv_step, k0, kBK, S, hd);
      load_rows<T, kVec>(vs, hdv, vb, kv_step, k0, kBK, S, hd);
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    }
    if constexpr (kVec) {
      for (int e = 0; e < hd; e += 4) {
        float4 qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(&qs[(ty * kRows + i) * hdq + e]);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + kLanes * j) * hdq + e]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
        }
      }
    } else {
      for (int e = 0; e < hd; ++e) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * hdq + e];
#pragma unroll
        for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kLanes * j) * hdq + e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      bool ok[kCols];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = k0 + tx + kLanes * j;
        ok[j] = t < S && (!causal || t <= qp) && (window <= 0 || t > qp - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      row_max = lanes_max(row_max);
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty * kRows + i) * (kBK + 1) + tx + kLanes * j] = p;
        row_sum += p;
      }
      row_sum = lanes_sum(row_sum);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kOutCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const int col = tx + kLanes * c;
        vv[c] = col < hdv ? vs[kk * hdv + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kOutCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tx + kLanes * c;
      if (col < hd) store(&ob[qp * q_step + col], acc[i][c] / denom);
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int H, int KV, int hd, float scale, int causal, int window,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hd, kVec);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, hd, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int H, int KV, int hd, float scale, int causal, int window,
                   cudaStream_t stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % align == 0
      && reinterpret_cast<uintptr_t>(k) % align == 0
      && reinterpret_cast<uintptr_t>(v) % align == 0;
  if (vec) return launch_as<T, true>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, stream);
  return launch_as<T, false>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, stream);
}

}  // namespace

// The most shared memory a block takes at this head_dim.
extern "C" size_t flash_attention_smem_bytes(int hd) {
  return sizeof(float) * static_cast<size_t>(smem_floats(hd, true));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  window <= 0 means
// no window.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int H, int KV, int hd, float scale,
                                      int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd <= 0 || hd > kMaxHd || KV <= 0 || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

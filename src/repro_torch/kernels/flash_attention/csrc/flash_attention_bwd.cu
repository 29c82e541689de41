// Backward of blocked (flash) attention, for NVIDIA Hopper (sm_90a).
//
// The reference package has no Pallas backward: its models compute
// attention in plain jnp unless use_pallas is set (models/attention.py) and
// differentiate that with jax.grad; its Pallas forward
// (kernels/flash_attention/flash_attention.py:_flash_kernel) is an inference
// drop-in.  On the card the port's forward always runs the forward kernel
// (flash_attention.cu), so training needs this kernel for dq, dk and dv.
//
// Contract: ref.py::flash_attention_backward_reference.  With the masks of
// the forward (key t seen by query s when t < Sk, t <= s if causal, and
// t > s - window if a window is given; S_k != S only in a non-causal call
// without a window), GQA (kv head = h / G, G = H / KV), all in fp32:
//   lse_s = log sum_t exp(scale q_s.k_t)          (recomputed, see below)
//   P_st  = exp(scale q_s.k_t - lse_s), 0 where masked
//   D_s   = sum_d dO_sd O_sd                       (O: the forward's output)
//   dS_st = P_st (dO_s.v_t - D_s)
//   dq_s  = scale sum_t dS_st k_t
//   dk_t  = scale sum_(heads of the group, s) dS_st q_s
//   dv_t  = sum_(heads of the group, s) P_st dO_s
// Gradients come back in the input's dtype; bf16 inputs are converted on
// load and every product and sum runs in fp32.
//
// The forward kernel is left as serving runs it: it emits no row
// statistics, so the first kernel here recomputes each query row's
// log-sum-exp (one pass over its keys, online max and sum) beside D_s, and
// writes both into a (B, H, S) fp32 workspace for the second kernel.
//
// Two kernels, launched in order on one stream:
//   1. dq: a block per (32 query rows, head, batch row).  It walks the
//      visible key tiles twice: once for the statistics, once for dS and
//      dq += dS k.  dq is owned by the block, so it is written once.
//   2. dkdv: a block per (32 keys, kv head, batch row).  It keeps its K and
//      V tile in shared memory and its dk and dv in registers, and walks the
//      group's G query heads in order and, for each, the query tiles that can
//      see its keys in order.  dk and dv of a kv head sum the gradients of
//      its G query heads inside one block, so no two blocks write one row.
// Every sum runs in a fixed order (fmaf chains over the head dimension, key
// tiles and query tiles in index order, heads in index order, the 8 lanes
// of a row joined by one xor butterfly), and nothing is atomic: two runs give
// the same bits.
//
// Arithmetic: fp32 FMAs on the CUDA cores, which hold the fp32 contract
// without the forward's 3xTF32 split.  Tiles are 32 x 32; a thread owns 4
// entries of a score tile (row tid / 8, columns tid % 8 + 8 j) and, for the
// products that accumulate, one row's 4-column groups (4 (tid % 8) + 32 jj).
// Rows are zero-padded to a multiple of 32 columns (at most 128) with a
// pitch of 4 mod 32 floats, so each 16-byte shared-memory read of a quarter
// warp falls on eight different bank groups.  Tiles that the causal or
// window mask fully hides are skipped.
//
// What bounds it: at training's lengths (S = 256), the products.  Per
// scored pair the backward does 2 hd flops each for q.k (twice: the
// statistics and dq recompute it, and dkdv once more), dO.v (twice), dq,
// dk and dv: 14 hd, against the forward's 4 hd; on fp32 CUDA cores (67
// TFLOP/s) that outweighs the bytes (q, k, v, O, dO read and dq, dk, dv
// written once) at every shape the models train.  This first kernel reads
// its tiles from shared memory with no double buffering and no tensor
// cores; chip_smoke.py times it beside its bound and autograd's backward of
// scaled_dot_product_attention.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;                 // query rows per tile
constexpr int kBK = 32;                 // keys per tile
constexpr int kMaxHd = 128;
constexpr int kSP = kBK + 1;            // pitch of a score tile in shared memory
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Padded row width (a multiple of 32 columns) and pitch (4 mod 32 floats).
__host__ __device__ __forceinline__ int padded_hd(int hd) { return (hd + 31) / 32 * 32; }
__host__ __device__ __forceinline__ int row_pitch(int hd) { return padded_hd(hd) + 4; }

// Rows [row0, row0 + kRows) of a (n, hd) slice whose rows are `step`
// elements apart into shared-memory rows of `pitch` floats, columns
// [0, hdp); columns past hd and rows at or past n are zero.
template <typename T, int kRows>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int pitch,
                                          const T* __restrict__ src, int64_t step, int row0,
                                          int n, int hd, int hdp, int tid) {
  for (int i = tid; i < kRows * hdp; i += kThreads) {
    const int r = i / hdp, c = i - r * hdp;
    dst[r * pitch + c] = (row0 + r < n && c < hd) ? to_float(src[(row0 + r) * step + c]) : 0.0f;
  }
}

// s[j] = a_row . b_(c0 + 8 j) over hdp columns, one fmaf chain per entry in
// column order.
__device__ __forceinline__ void dot4(const float* __restrict__ a_row,
                                     const float* __restrict__ b, int pitch, int hdp, int c0,
                                     float (&s)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0.0f;
  for (int d = 0; d < hdp; d += 4) {
    const float4 av = lds4(a_row + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv = lds4(b + (c0 + 8 * j) * pitch + d);
      s[j] = fmaf(av.x, bv.x, s[j]);
      s[j] = fmaf(av.y, bv.y, s[j]);
      s[j] = fmaf(av.z, bv.z, s[j]);
      s[j] = fmaf(av.w, bv.w, s[j]);
    }
  }
}

// The 8 lanes of a row (lanes 8 k .. 8 k + 7 of a warp) joined by an xor
// butterfly: every lane ends with the same value.
__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 4);
  return v;
}
__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  return v;
}

__device__ __forceinline__ bool visible(int qp, int key, int S, int Sk, int causal, int window) {
  return qp < S && key < Sk && (!causal || key <= qp) && (window <= 0 || key > qp - window);
}

// Kernel 1: dq, and each row's lse and D into the workspace.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, T* __restrict__ dq,
    float* __restrict__ lse_ws, float* __restrict__ delta_ws,   // (B, H, S)
    int S, int Sk, int H, int KV, int hd, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int hdp = padded_hd(hd), P = row_pitch(hd);
  float* qs = smem;                 // (kBQ, P)
  float* dos = qs + kBQ * P;        // (kBQ, P)
  float* ks = dos + kBQ * P;        // (kBK, P)
  float* vs = ks + kBK * P;         // (kBK, P)
  float* dss = vs + kBK * P;        // (kBQ, kSP)

  const int tid = threadIdx.x;
  const int r = tid >> 3, c0 = tid & 7;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int qp = q0 + r;
  const int64_t q_step = static_cast<int64_t>(H) * hd;
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;

  load_tile<T, kBQ>(qs, P, q + q_off, q_step, q0, S, hd, hdp, tid);
  load_tile<T, kBQ>(dos, P, dout + q_off, q_step, q0, S, hd, hdp, tid);
  // D of row r: each of its 8 lanes a strided share of the columns
  float delta = 0.0f;
  if (qp < S) {
    const T* orow = out + q_off + qp * q_step;
    const T* drow = dout + q_off + qp * q_step;
    for (int c = c0; c < hd; c += 8) delta = fmaf(to_float(drow[c]), to_float(orow[c]), delta);
  }
  delta = row_sum8(delta);

  // keys the block's rows can see: from the window's lower edge (whole
  // tiles) up to the last row when causal, else to the last key
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = k_begin / kBK * kBK;
  const int k_end = causal ? min(q_last + 1, Sk) : Sk;

  // pass 1: the row's max and normaliser, online over the key tiles
  float m = kNegInf, l = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done (and q is in)
    load_tile<T, kBK>(ks, P, k + kv_off, kv_step, k0, Sk, hd, hdp, tid);
    __syncthreads();
    float s[4];
    dot4(qs + r * P, ks, P, hdp, c0, s);
    bool ok[4];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = visible(qp, k0 + c0 + 8 * j, S, Sk, causal, window);
      s[j] = ok[j] ? s[j] * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, row_max8(tmax));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += ok[j] ? expf(s[j] - m_new) : 0.0f;
    l = l * expf(m - m_new) + row_sum8(sum);
    m = m_new;
  }
  const float lse = l > 0.0f ? m + logf(l) : 0.0f;
  if (c0 == 0 && qp < S) {
    const int64_t row = (static_cast<int64_t>(b) * H + h) * S + qp;
    lse_ws[row] = lse;
    delta_ws[row] = delta;
  }

  // pass 2: dS and dq += dS k; this thread's dq columns 32 jj + 4 c0 .. + 3
  const int nblk = hdp / 32;
  float acc[4][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_tile<T, kBK>(ks, P, k + kv_off, kv_step, k0, Sk, hd, hdp, tid);
    load_tile<T, kBK>(vs, P, v + kv_off, kv_step, k0, Sk, hd, hdp, tid);
    __syncthreads();
    float s[4], dp[4];
    dot4(qs + r * P, ks, P, hdp, c0, s);
    dot4(dos + r * P, vs, P, hdp, c0, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = visible(qp, k0 + c0 + 8 * j, S, Sk, causal, window);
      const float p = ok ? expf(s[j] * scale - lse) : 0.0f;
      dss[r * kSP + c0 + 8 * j] = p * (dp[j] - delta);
    }
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float w = dss[r * kSP + c];
      const float* krow = ks + c * P + 4 * c0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < nblk) {
          const float4 kv4 = lds4(krow + 32 * jj);
          acc[jj][0] = fmaf(w, kv4.x, acc[jj][0]);
          acc[jj][1] = fmaf(w, kv4.y, acc[jj][1]);
          acc[jj][2] = fmaf(w, kv4.z, acc[jj][2]);
          acc[jj][3] = fmaf(w, kv4.w, acc[jj][3]);
        }
      }
    }
  }
  if (qp < S) {
    T* drow = dq + q_off + qp * q_step;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * jj + 4 * c0 + e;
        if (jj < nblk && col < hd) store(drow + col, acc[jj][e] * scale);
      }
    }
  }
}

// Kernel 2: dk and dv of 32 keys of one kv head, over its G query heads.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse_ws,
    const float* __restrict__ delta_ws, T* __restrict__ dk, T* __restrict__ dv,
    int S, int Sk, int H, int KV, int hd, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int hdp = padded_hd(hd), P = row_pitch(hd);
  float* ks = smem;                 // (kBK, P)
  float* vs = ks + kBK * P;         // (kBK, P)
  float* qs = vs + kBK * P;         // (kBQ, P)
  float* dos = qs + kBQ * P;        // (kBQ, P)
  float* ps = dos + kBQ * P;        // (kBQ, kSP): P of the tile
  float* dss = ps + kBQ * kSP;      // (kBQ, kSP): dS of the tile
  float* s_lse = dss + kBQ * kSP;   // (kBQ)
  float* s_delta = s_lse + kBQ;     // (kBQ)

  const int tid = threadIdx.x;
  const int hi = tid >> 3, c0 = tid & 7;   // score tile: query row hi; accumulation: key row hi
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int k0 = blockIdx.x * kBK;
  const int64_t q_step = static_cast<int64_t>(H) * hd;
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;

  load_tile<T, kBK>(ks, P, k + kv_off, kv_step, k0, Sk, hd, hdp, tid);
  load_tile<T, kBK>(vs, P, v + kv_off, kv_step, k0, Sk, hd, hdp, tid);

  // query rows that can see these keys: from the first key on when causal,
  // below the last key + window when windowed
  const int q_begin = causal ? k0 / kBQ * kBQ : 0;
  const int q_end = window > 0 ? min(S, k0 + kBK - 1 + window) : S;

  const int nblk = hdp / 32;
  float adk[4][4], adv[4][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[jj][e] = adv[jj][e] = 0.0f;
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * hd;
    const int64_t stat_off = (static_cast<int64_t>(b) * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, kBQ>(qs, P, q + q_off, q_step, q0, S, hd, hdp, tid);
      load_tile<T, kBQ>(dos, P, dout + q_off, q_step, q0, S, hd, hdp, tid);
      if (tid < kBQ) {
        const bool in = q0 + tid < S;
        s_lse[tid] = in ? lse_ws[stat_off + q0 + tid] : 0.0f;
        s_delta[tid] = in ? delta_ws[stat_off + q0 + tid] : 0.0f;
      }
      __syncthreads();
      {
        const int qp = q0 + hi;
        float s[4], dp[4];
        dot4(qs + hi * P, ks, P, hdp, c0, s);
        dot4(dos + hi * P, vs, P, hdp, c0, dp);
        const float lse = s_lse[hi], delta = s_delta[hi];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 8 * j;
          const bool ok = visible(qp, k0 + c, S, Sk, causal, window);
          const float p = ok ? expf(s[j] * scale - lse) : 0.0f;
          ps[hi * kSP + c] = p;
          dss[hi * kSP + c] = p * (dp[j] - delta);
        }
      }
      __syncthreads();
      // dv[key hi] += sum_r P[r][hi] dO[r]; dk[key hi] += sum_r dS[r][hi] q[r]
      for (int r = 0; r < kBQ; ++r) {
        const float wp = ps[r * kSP + hi], wd = dss[r * kSP + hi];
        const float* dorow = dos + r * P + 4 * c0;
        const float* qrow = qs + r * P + 4 * c0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj < nblk) {
            const float4 o4 = lds4(dorow + 32 * jj), q4 = lds4(qrow + 32 * jj);
            adv[jj][0] = fmaf(wp, o4.x, adv[jj][0]);
            adv[jj][1] = fmaf(wp, o4.y, adv[jj][1]);
            adv[jj][2] = fmaf(wp, o4.z, adv[jj][2]);
            adv[jj][3] = fmaf(wp, o4.w, adv[jj][3]);
            adk[jj][0] = fmaf(wd, q4.x, adk[jj][0]);
            adk[jj][1] = fmaf(wd, q4.y, adk[jj][1]);
            adk[jj][2] = fmaf(wd, q4.z, adk[jj][2]);
            adk[jj][3] = fmaf(wd, q4.w, adk[jj][3]);
          }
        }
      }
    }
  }
  const int key = k0 + hi;
  if (key < Sk) {
    T* krow = dk + kv_off + key * kv_step;
    T* vrow = dv + kv_off + key * kv_step;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * jj + 4 * c0 + e;
        if (jj < nblk && col < hd) {
          store(krow + col, adk[jj][e] * scale);
          store(vrow + col, adv[jj][e]);
        }
      }
    }
  }
}

size_t dq_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(2 * kBQ + 2 * kBK) * row_pitch(hd) + kBQ * kSP);
}
size_t dkdv_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(2 * kBQ + 2 * kBK) * row_pitch(hd)
                          + 2 * kBQ * kSP + 2 * kBQ);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, void* dq, void* dk, void* dv, float* lse_ws,
                   float* delta_ws, int B, int S, int Sk, int H, int KV, int hd, float scale,
                   int causal, int window, cudaStream_t stream) {
  const size_t smem_dq = dq_smem_bytes(hd), smem_kv = dkdv_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), dot, static_cast<T*>(dq), lse_ws, delta_ws, S, Sk,
      H, KV, hd, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T><<<dim3((Sk + kBK - 1) / kBK, KV, B), kThreads, smem_kv, stream>>>(
      qt, kt, vt, dot, lse_ws, delta_ws, static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, KV,
      hd, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// The larger of the two kernels' shared memory at this head_dim, in bytes.
extern "C" size_t flash_attention_bwd_smem_bytes(int hd) {
  const size_t a = dq_smem_bytes(hd), b = dkdv_smem_bytes(hd);
  return a > b ? a : b;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv; every
// tensor contiguous in the model layout).  lse_ws and delta_ws: (B, H, S)
// fp32 scratch, written by the first kernel and read by the second.
// Sk: keys in k and v, S unless the call is non-causal without a window.
// window <= 0 means no window.  Returns the CUDA error of the launches (0
// on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, void* dq, void* dk,
                                          void* dv, void* lse_ws, void* delta_ws, int B, int S,
                                          int Sk, int H, int KV, int hd, float scale,
                                          int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd <= 0 || hd > kMaxHd || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535
      || Sk <= 0 || (Sk != S && (causal || window > 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ws);
  float* delta = static_cast<float*>(delta_ws);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, S, Sk,
                                          H, KV, hd, scale, causal, window, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                                                  S, Sk, H, KV, hd, scale, causal, window, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

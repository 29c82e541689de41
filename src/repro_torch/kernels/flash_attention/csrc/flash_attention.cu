// Blocked online-softmax (flash) attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// kernels/flash_attention/flash_attention.py:_flash_kernel (wrapper
// flash_attention_pallas, model-layout wrapper ops.py:flash_attention).  The
// TPU kernel walks K/V tiles along a sequential grid axis and keeps m, l and
// the accumulator in VMEM scratch across grid steps.  Here each warp walks
// the K/V tiles in a loop for 16 query rows of one head, keeping its m, l
// and accumulator in registers, and the warps that share those rows merge
// their partial results at the end.
//
// Contract: ref.py::attention_reference in the model layout (B, S, H, hd):
// causal and/or sliding-window masking (key t is seen by query s when
// t <= s if causal, and t > s - window if a window is given), GQA with
// kv head = h / (H / KV), softmax(scale * q.k) v in fp32, output in q's dtype.
// Keys at index >= S_k are always masked: S_k is the real key length, never
// a padded one (the reference wrapper passes the padded length, which lets
// padded keys into non-causal rows).  k and v may hold S_k != S keys in a
// non-causal call without a window (the decoder's cross-attention over the
// encoder's frames).  A causal or windowed call takes the keys at positions
// k_off .. k_off + S_k - 1 of the queries' sequence: the whole of it (k_off
// = 0, S_k = S), or one key shard of attention split over the keys (MLA
// where the heads do not divide the tensor-parallel ranks), whose rows
// before the shard see no key: output 0, log-sum-exp -1e30.  The entry
// point refuses anything else.
//
// What bounds it: at prefill lengths of a few hundred tokens the matrix
// products, 2 hd flops per scored pair for q.k and 2 hd for p.v; on fp32
// CUDA cores (67 TFLOP/s) they outweigh the bytes (q, k, v read once, the
// output written once), on the tensor cores they do not.  At these sizes a
// warp's chain of dependent loads and products, not the card's peak, sets
// the time, so the design spreads the work over many warps and keeps each
// warp's instruction count low:
//
// * Both products run on the tensor cores, held to the fp32 contract by
//   3xTF32: each fp32 operand x is split into big (x rounded to tf32) and
//   small = x - big, and big.big + small.big + big.small is accumulated in
//   fp32 with mma.sync.m16n8k8 (small.small, about 2^-22 of a product, is
//   left out).  The tensor cores round each sum toward its largest term,
//   so a long running sum in them drifts; big.big of each 16-dim step of
//   q.k, and each tile's part of o, start from zero there and join their
//   running sums through IEEE adds.  The split is two integer operations and one subtraction;
//   the tensor core reads the top 19 bits of a tf32 operand, so small
//   enters truncated to tf32.  bf16 inputs are exact in tf32 (small = 0).
//   The running max, normaliser, exponentials and masks stay fp32 on the
//   CUDA cores.
// * A block has eight warps and takes 16 query rows of one or two heads of
//   one kv head's group.  With two heads, four warps per head each take 8
//   of every 32-key tile, and both heads share each K/V tile; with one,
//   eight warps each take 8 of every 64-key tile.  Each warp keeps its own
//   m, l and o; at the end a head's warps are merged in a fixed order
//   through shared memory.  The grid is (ceil(S / 16), KV * ceil(G / h), B)
//   with G = H / KV and h heads per block.  At 128 to 170 registers a
//   thread, one or two 256-thread blocks fit an SM, so a grid over the SM
//   count runs in waves.  One head per block when its grid, ceil(S / 16) * H * B, fits
//   in one wave (llama3-8b on 132 SMs: S <= 64, 96 blocks at S = 34, each
//   walking one tile instead of two), else two (176 blocks at S = 168;
//   jamba's H = 64 at every serving length, S >= 34).
// * Fragments load 16 bytes at a time.  q.k may take the head dimension in
//   any order shared by q and k, so a lane's four consecutive dims feed two
//   k-steps; p.v may permute its output columns, so a lane's four
//   consecutive dims of a V row feed four products, and the lane ends up
//   holding 8 consecutive output columns.  The score fragment of q.k is
//   p.v's A operand as it stands (k-slot t holds key 2t, k-slot t + 4 key
//   2t + 1).  q rows are split into big and small once; K and V are split
//   as they are used.  Row pitches (q and k: 16 mod 32 floats; v: 4 mod 32)
//   keep every 16-byte fragment load of a warp free of bank conflicts.  Rows
//   are zero-padded to 128 columns, so any head_dim <= 128 works and the
//   loops over it have a fixed trip count (a smaller head_dim computes on
//   the zeros).
// * K/V tiles are double-buffered: the next tile's cp.async copies (16
//   bytes each, fp32 with head_dim a multiple of 4 and aligned tensors)
//   are in flight while this tile's products run.  Other inputs (bf16,
//   unaligned) are converted through registers into the same fp32 tiles.
// * Tiles that the causal or window mask fully hides are skipped.  Sums run
//   in a fixed order, so results are the same from run to run.
// * Under grad (flash_attention_lse_launch) a second kernel from the same
//   body also writes each row's log-sum-exp, m + log(l) from the warps'
//   merge, for the backward kernel (flash_attention_bwd.cu), which then
//   skips recomputing it; its output is the same bits.  Serving's kernel
//   is compiled as it was without that store: on an H100 the fp32 kernels
//   fit 128 registers a thread (two blocks an SM), and the store left free
//   moves the statistics kernel to 135 (one block an SM), so that kernel
//   is held to two blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;               // per block: kHeads heads x kSplits warps each
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16;                 // query rows (the mma's M)
constexpr int kMaxHd = 128;
constexpr int kMaxQK = kMaxHd / 16;     // 16-dim steps of q.k
constexpr int kMaxOut = kMaxHd / 32;    // 32-column output blocks of p.v
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Every row holds kMaxHd columns, zero past head_dim, so the product
// loops have a fixed trip count and no guards (a smaller head_dim computes
// zeros).  Row pitches in floats: q and k rows 16 (mod 32) apart, v rows
// 4 (mod 32) apart.
constexpr int kQKPitch = kMaxHd + 16;
constexpr int kVPitch = kMaxHd + 4;
// Each warp's partial rows, merged at the end: o's columns, then m and l.
constexpr int kPartPitch = kMaxHd + 2;
// Shared memory in floats for kHeads heads of kSplits warps (keys per
// tile kBK = 8 kSplits): q split in big and small, and two stages of k
// and v; after the loop the same memory holds each warp's partial rows.
constexpr int smem_floats(int heads, int splits) {
  return 2 * heads * kBQ * kQKPitch + 2 * (8 * splits) * (kQKPitch + kVPitch);
}
static_assert(kWarps * kBQ * kPartPitch <= smem_floats(2, 4)
              && kWarps * kBQ * kPartPitch <= smem_floats(1, 8),
              "partial rows fit in the tiles' memory");

// 3xTF32 split: big = x rounded to tf32 (to nearest, ties away from zero),
// small = x - big, exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), fp32 accumulate.
// Not volatile: the compiler may move independent products between
// dependent ones.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte asynchronous copy from device memory into shared memory; with
// `valid` false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Rows [row0, row0 + n_rows) of a (S, hd) slice whose rows are `step`
// elements apart, into shared-memory rows of `pitch` floats, columns
// [0, hd); rows at or past S are zero.  kAsync: fp32 rows of a multiple of
// 4 floats, 16-byte aligned, through cp.async (complete at the next wait);
// else through registers, converted to fp32.
template <typename T, bool kAsync>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int pitch,
                                          const T* __restrict__ src, int64_t step,
                                          int row0, int n_rows, int S, int hd,
                                          int tid, int n_threads) {
  if constexpr (kAsync) {
    const int per_row = hd / 4;
    for (int i = tid; i < n_rows * per_row; i += n_threads) {
      const int r = i / per_row, e = (i - r * per_row) * 4;
      const bool in = row0 + r < S;
      cp_async16(dst + r * pitch + e, in ? src + (row0 + r) * step + e : src, in);
    }
  } else {
    for (int i = tid; i < n_rows * hd; i += n_threads) {
      const int r = i / hd, e = i - r * hd;
      dst[r * pitch + e] = row0 + r < S ? to_float(src[(row0 + r) * step + e]) : 0.0f;
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The kernel's body.  kLse: also write each query row's log-sum-exp of
// its visible scaled scores into lse (B, H, S), for the backward kernel
// (training: flash_attention_lse_kernel); serving runs kLse = false
// (flash_attention_kernel).
template <typename T, bool kAsync, int kHeads, bool kLse>
__device__ __forceinline__ void flash_attention_body(
    const T* __restrict__ q,   // (B, S, H, hd)
    const T* __restrict__ k,   // (B, Sk, KV, hd)
    const T* __restrict__ v,   // (B, Sk, KV, hd)
    T* __restrict__ out,       // (B, S, H, hd)
    float* __restrict__ lse,   // (B, H, S), written when kLse
    int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QP = kQKPitch, VP = kVPitch, OP = kPartPitch;
  constexpr int kSplits = kWarps / kHeads;   // warps per head, each 8 keys of every tile
  constexpr int kBK = 8 * kSplits;           // keys per K/V tile
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // the mma fragments' group and thread in group
  const int hs = warp / kSplits;          // which of the block's heads
  const int split = warp % kSplits;       // which 8 keys of every tile

  const int G = H / KV;
  const int pairs = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / pairs;
  const int head_in_group = (blockIdx.y % pairs) * kHeads + hs;
  const bool head_ok = head_in_group < G;   // false only for a two-head block's second head at odd G
  const int h = kvh * G + (head_ok ? head_in_group : 0);
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;

  float* q_big = smem;                                // (kHeads, kBQ, QP)
  float* q_small = q_big + kHeads * kBQ * QP;         // (kHeads, kBQ, QP)
  float* ks = q_small + kHeads * kBQ * QP;            // (2, kBK, QP)
  float* vs = ks + 2 * kBK * QP;                      // (2, kBK, VP)

  const int64_t q_step = static_cast<int64_t>(H) * hd;    // between positions
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;
  T* ob = out + (static_cast<int64_t>(b) * S * H + h) * hd;

  // Columns [hd, pitch) of every q, k and v row stay zero: no load writes
  // them.
  for (int i = tid; i < (kHeads * kBQ + 2 * kBK) * (QP - hd); i += kThreads) {
    const int r = i / (QP - hd);
    (r < kHeads * kBQ ? q_big + r * QP : ks + (r - kHeads * kBQ) * QP)[hd + i % (QP - hd)] = 0.0f;
  }
  for (int i = tid; i < 2 * kBK * (VP - hd); i += kThreads) {
    vs[(i / (VP - hd)) * VP + hd + i % (VP - hd)] = 0.0f;
  }

  // Keys this block's queries can see: from the window's lower edge (whole
  // tiles) up to the last query when causal, else to the last key.  Key t
  // sits at position k_off + t, so a query at s masks as one at s - k_off;
  // a block whose queries all come before the first key has no tile.
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_begin = window > 0 ? max(0, q0 - k_off - window + 1) : 0;
  k_begin = k_begin / kBK * kBK;
  const int k_end = causal ? min(q_last + 1 - k_off, Sk) : Sk;
  const int n_tiles = max(0, (k_end - k_begin + kBK - 1) / kBK);

  auto load_kv = [&](int stage, int k0) {
    load_rows<T, kAsync>(ks + stage * kBK * QP, QP, kb, kv_step, k0, kBK, Sk, hd, tid, kThreads);
    load_rows<T, kAsync>(vs + stage * kBK * VP, VP, vb, kv_step, k0, kBK, Sk, hd, tid, kThreads);
  };
  // each head's four warps load its q rows
  load_rows<T, kAsync>(q_big + hs * kBQ * QP, QP, qb, q_step, q0, kBQ, S, hd,
                       split * 32 + lane, 32 * kSplits);
  load_kv(0, k_begin);
  cp_async_commit();

  float o[kMaxOut][4][4];
#pragma unroll
  for (int s = 0; s < kMaxOut; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[s][j][0] = o[s][j][1] = o[s][j][2] = o[s][j][3] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, k0 + kBK);   // its stage was last read in tile it - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, at it = 0, the q rows) are in shared memory
    if (it == 0) {     // split q once: big in place, small beside it
      for (int i = tid; i < kHeads * kBQ * QP; i += kThreads) {
        uint32_t big, small;
        split_tf32(q_big[i], big, small);
        q_big[i] = __uint_as_float(big);
        q_small[i] = __uint_as_float(small);
      }
      __syncthreads();
    }
    if (head_ok) {
      // s = q.k^T for 16 queries x this warp's 8 keys: big.big, small.big
      // and big.small in three accumulators.  Lane
      // (g, t) reads dims 16 j + 4t .. 16 j + 4t + 3 of q rows g and g + 8
      // and of key row g: k-step 2 j takes the first two, 2 j + 1 the last.
      const float* qbg = q_big + (hs * kBQ + g) * QP + 4 * t;
      const float* qsg = q_small + (hs * kBQ + g) * QP + 4 * t;
      const float* kt = ks + (it & 1) * kBK * QP + (split * 8 + g) * QP + 4 * t;
      float s_bb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s_sb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float s_bs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kMaxQK; ++j) {
        {
          const float4 qb0 = lds4(qbg + 16 * j), qb1 = lds4(qbg + 8 * QP + 16 * j);
          const float4 qs0 = lds4(qsg + 16 * j), qs1 = lds4(qsg + 8 * QP + 16 * j);
          const float4 k4 = lds4(kt + 16 * j);
          uint32_t kbig[4], ksmall[4];
          split_tf32(k4.x, kbig[0], ksmall[0]);
          split_tf32(k4.y, kbig[1], ksmall[1]);
          split_tf32(k4.z, kbig[2], ksmall[2]);
          split_tf32(k4.w, kbig[3], ksmall[3]);
          const uint32_t a_big0[4] = {__float_as_uint(qb0.x), __float_as_uint(qb1.x),
                                      __float_as_uint(qb0.y), __float_as_uint(qb1.y)};
          const uint32_t a_small0[4] = {__float_as_uint(qs0.x), __float_as_uint(qs1.x),
                                        __float_as_uint(qs0.y), __float_as_uint(qs1.y)};
          const uint32_t a_big1[4] = {__float_as_uint(qb0.z), __float_as_uint(qb1.z),
                                      __float_as_uint(qb0.w), __float_as_uint(qb1.w)};
          const uint32_t a_small1[4] = {__float_as_uint(qs0.z), __float_as_uint(qs1.z),
                                        __float_as_uint(qs0.w), __float_as_uint(qs1.w)};
          const uint32_t b_big0[2] = {kbig[0], kbig[1]}, b_small0[2] = {ksmall[0], ksmall[1]};
          const uint32_t b_big1[2] = {kbig[2], kbig[3]}, b_small1[2] = {ksmall[2], ksmall[3]};
          mma_tf32(s_sb, a_small0, b_big0);
          mma_tf32(s_bs, a_big0, b_small0);
          mma_tf32(s_sb, a_small1, b_big1);
          mma_tf32(s_bs, a_big1, b_small1);
          // big.big of these 16 dims starts from zero and joins the running
          // sum through an IEEE add: the tensor cores round a sum toward
          // its largest term, so a running sum in them drifts one way
          float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(step, a_big0, b_big0);
          mma_tf32(step, a_big1, b_big1);
#pragma unroll
          for (int i = 0; i < 4; ++i) s_bb[i] += step[i];
        }
      }

      // Online softmax over this warp's keys.  The lane holds rows g
      // (i = 0, 1) and g + 8 (i = 2, 3) at keys k0 + 8 split + 2t + (i & 1);
      // the 4 lanes of a group share a row.
      float p[4], row_max[2] = {kNegInf, kNegInf};
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + g + 8 * (i >> 1) - k_off;
        const int key = k0 + split * 8 + 2 * t + (i & 1);
        ok[i] = key < Sk && (!causal || key <= qp) && (window <= 0 || key > qp - window);
        p[i] = ok[i] ? (s_bb[i] + (s_sb[i] + s_bs[i])) * scale : kNegInf;
        row_max[i >> 1] = fmaxf(row_max[i >> 1], p[i]);
      }
      float corr[2], row_sum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(kFull, row_max[r], 1));
        row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(kFull, row_max[r], 2));
        const float m_new = fmaxf(m[r], row_max[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
        p[2 * r] = ok[2 * r] ? expf(p[2 * r] - m_new) : 0.0f;
        p[2 * r + 1] = ok[2 * r + 1] ? expf(p[2 * r + 1] - m_new) : 0.0f;
        row_sum[r] = p[2 * r] + p[2 * r + 1];
        row_sum[r] += __shfl_xor_sync(kFull, row_sum[r], 1);
        row_sum[r] += __shfl_xor_sync(kFull, row_sum[r], 2);
        l[r] = l[r] * corr[r] + row_sum[r];
      }
#pragma unroll
      for (int s = 0; s < kMaxOut; ++s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[s][j][0] *= corr[0];
          o[s][j][1] *= corr[0];
          o[s][j][2] *= corr[1];
          o[s][j][3] *= corr[1];
        }
      }

      // o += p.v over this warp's 8 keys.  The score fragment is the A
      // operand as it stands (k-slot t: key 2t, k-slot t + 4: key 2t + 1);
      // lane (g, t) reads dims 32 s + 4g .. 32 s + 4g + 3 of V rows 2t and
      // 2t + 1, and product j of output block s puts its column g at dim
      // 32 s + 4g + j.
      uint32_t p_big[4], p_small[4];
      split_tf32(p[0], p_big[0], p_small[0]);
      split_tf32(p[2], p_big[1], p_small[1]);
      split_tf32(p[1], p_big[2], p_small[2]);
      split_tf32(p[3], p_big[3], p_small[3]);
      const float* vt = vs + (it & 1) * kBK * VP + (split * 8 + 2 * t) * VP + 4 * g;
#pragma unroll
      for (int s = 0; s < kMaxOut; ++s) {
        {
          const float4 va = lds4(vt + 32 * s), vb4 = lds4(vt + VP + 32 * s);
          const float v0[4] = {va.x, va.y, va.z, va.w}, v1[4] = {vb4.x, vb4.y, vb4.z, vb4.w};
          uint32_t b_big[4][2], b_small[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(v0[j], b_big[j][0], b_small[j][0]);
            split_tf32(v1[j], b_big[j][1], b_small[j][1]);
          }
          // this tile's part of o starts from zero in the tensor cores and
          // joins the running o through IEEE adds (see q.k above)
          float part[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(part[j], p_small, b_big[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(part[j], p_big, b_small[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(part[j], p_big, b_big[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) o[s][j][i] += part[j][i];
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this tile's stage
  }
  if (n_tiles == 0) {  // the q rows and first tile, loaded but never read, land first
    cp_async_wait<0>();
    __syncthreads();
  }

  // Merge the four partial results of each head's rows, in split order.
  // Lane (g, t) of a warp holds, for rows g and g + 8, output dims
  // 32 s + 8t + 4 half + j in o[s][j][2 r + half].
  float* part = smem + warp * kBQ * OP;
  if (head_ok) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* row = part + (g + 8 * r) * OP;
#pragma unroll
      for (int s = 0; s < kMaxOut; ++s) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < 4; ++j) row[32 * s + 8 * t + 4 * half + j] = o[s][j][2 * r + half];
        }
      }
      if (t == 0) {
        row[kMaxHd] = m[r];
        row[kMaxHd + 1] = l[r];
      }
    }
  }
  __syncthreads();
  // Each of a head's kBQ rows gets its kSplits weights exp(m_w - m) / l,
  // computed once, in the m slot of the partial rows.
  if (head_ok && split == 0 && lane < kBQ) {
    float* rows = smem + hs * kSplits * kBQ * OP + lane * OP;   // warp w's row: + w kBQ OP
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplits; ++w) m_all = fmaxf(m_all, rows[w * kBQ * OP + kMaxHd]);
    float f[kSplits], den = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplits; ++w) {
      f[w] = expf(rows[w * kBQ * OP + kMaxHd] - m_all);
      den += rows[w * kBQ * OP + kMaxHd + 1] * f[w];
    }
    den = fmaxf(den, 1e-30f);
#pragma unroll
    for (int w = 0; w < kSplits; ++w) rows[w * kBQ * OP + kMaxHd] = f[w] / den;
    if constexpr (kLse) {
      if (q0 + lane < S) lse[(static_cast<int64_t>(b) * H + h) * S + q0 + lane] = m_all + logf(den);
    }
  }
  __syncthreads();
  if (head_ok) {
    const float* parts = smem + hs * kSplits * kBQ * OP;   // this head's kSplits warps
    for (int i = split * 32 + lane; i < kBQ * hd; i += 32 * kSplits) {
      const int r = i / hd, c = i - r * hd;
      const int qp = q0 + r;
      if (qp >= S) continue;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kSplits; ++w) {
        const float* row = parts + (w * kBQ + r) * OP;
        acc += row[c] * row[kMaxHd];
      }
      store(&ob[qp * q_step + c], acc);
    }
  }
}

template <typename T, bool kAsync, int kHeads>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int Sk, int H, int KV, int hd, float scale, int causal,
    int window, int k_off) {
  flash_attention_body<T, kAsync, kHeads, false>(q, k, v, out, nullptr, S, Sk, H, KV, hd, scale,
                                                 causal, window, k_off);
}

// The same with the row statistics.  Held to two blocks an SM (at most 128
// registers a thread), as serving's fp32 kernel compiles: left free, the
// store of lse moves the register allocation to 135 and one block an SM.
template <typename T, bool kAsync, int kHeads>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_lse_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, int Sk, int H, int KV, int hd,
    float scale, int causal, int window, int k_off) {
  flash_attention_body<T, kAsync, kHeads, true>(q, k, v, out, lse, S, Sk, H, KV, hd, scale,
                                                causal, window, k_off);
}

template <typename T, bool kAsync, int kHeads, bool kLse>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                      int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(kHeads, kWarps / kHeads);
  const int pairs = (H / KV + kHeads - 1) / kHeads;
  const dim3 grid((S + kBQ - 1) / kBQ, KV * pairs, B);
  if constexpr (kLse) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_lse_kernel<T, kAsync, kHeads>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    flash_attention_lse_kernel<T, kAsync, kHeads><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, S, Sk, H, KV, hd, scale, causal, window, k_off);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_kernel<T, kAsync, kHeads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    flash_attention_kernel<T, kAsync, kHeads><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), S, Sk, H, KV, hd, scale, causal, window, k_off);
  }
  return cudaGetLastError();
}

template <typename T, bool kAsync, bool kLse>
cudaError_t launch_heads(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int S, int Sk, int H, int KV, int hd, float scale, int causal,
                         int window, int k_off, int heads, cudaStream_t stream) {
  if (heads == 1) {
    return launch_as<T, kAsync, 1, kLse>(q, k, v, out, lse, B, S, Sk, H, KV, hd, scale, causal,
                                         window, k_off, stream);
  }
  return launch_as<T, kAsync, 2, kLse>(q, k, v, out, lse, B, S, Sk, H, KV, hd, scale, causal,
                                       window, k_off, stream);
}

template <typename T, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off,
                   int heads, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const bool async = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
        && reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
    if (async) {
      return launch_heads<float, true, kLse>(q, k, v, out, lse, B, S, Sk, H, KV, hd, scale,
                                             causal, window, k_off, heads, stream);
    }
  }
  return launch_heads<T, false, kLse>(q, k, v, out, lse, B, S, Sk, H, KV, hd, scale, causal,
                                      window, k_off, heads, stream);
}

// Whether k and v's Sk keys fit the masks: in a causal or windowed call
// they are the keys at positions k_off .. k_off + Sk - 1 of the S queries'
// sequence (k_off = 0 and Sk = S: the whole sequence; a key shard
// otherwise), in any other call all of them, from position 0.
bool keys_ok(int S, int Sk, int causal, int window, int k_off) {
  if (causal || window > 0) return k_off >= 0 && static_cast<int64_t>(k_off) + Sk <= S;
  return k_off == 0;
}

template <bool kLse>
int launch_dtype(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off,
                 int dtype, int heads, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd <= 0 || hd > kMaxHd || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535
      || (heads != 1 && heads != 2) || Sk <= 0 || !keys_ok(S, Sk, causal, window, k_off)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float, kLse>(q, k, v, out, lse, B, S, Sk, H, KV, hd, scale,
                                                causal, window, k_off, heads, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16, kLse>(q, k, v, out, lse, B, S, Sk, H, KV, hd,
                                                        scale, causal, window, k_off, heads, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Query heads per block for this problem on a card of n_sms SMs: one
// (1 head x 8 key splits over 64-key tiles) when a block per (16 query
// rows, head) still fits in one wave, one block per SM, else two (2 heads
// x 4 key splits over 32-key tiles).  One head halves the tiles on a
// block's chain, which shortens a single wave; past one wave it adds a
// wave instead (H100, llama3-8b: 0.00945 against 0.01121 ms at S = 34,
// 0.02055 against 0.01486 at S = 75; chip_smoke.py times both).
extern "C" int flash_attention_heads_per_block(int B, int S, int H, int KV, int n_sms) {
  const long long one_head_blocks = static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
  return one_head_blocks <= n_sms ? 1 : 2;
}

// The most shared memory a block takes at this head_dim.
extern "C" size_t flash_attention_smem_bytes(int hd) {
  constexpr int most = smem_floats(2, 4) > smem_floats(1, 8) ? smem_floats(2, 4) : smem_floats(1, 8);
  return sizeof(float) * static_cast<size_t>(most);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Sk: keys in k and v,
// at positions k_off .. k_off + Sk - 1 (within S) in a causal or windowed
// call, k_off = 0 otherwise.  window <= 0 means no window.  heads: query heads per block, 1 or 2
// (flash_attention_heads_per_block picks it; the results are the same up
// to the order of the key splits' merge).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int Sk, int H, int KV, int hd,
                                      float scale, int causal, int window, int k_off, int dtype,
                                      int heads, void* stream) {
  return launch_dtype<false>(q, k, v, out, nullptr, B, S, Sk, H, KV, hd, scale, causal, window,
                             k_off, dtype, heads, stream);
}

// flash_attention_launch that also writes each query row's log-sum-exp of
// its visible scaled scores, log sum_t exp(scale q.k_t), into lse: (B, H,
// S) fp32, for the backward kernel.  out is the same bits as
// flash_attention_launch's.
extern "C" int flash_attention_lse_launch(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int S, int Sk, int H, int KV, int hd,
                                          float scale, int causal, int window, int k_off, int dtype,
                                          int heads, void* stream) {
  return launch_dtype<true>(q, k, v, out, static_cast<float*>(lse), B, S, Sk, H, KV, hd, scale,
                            causal, window, k_off, dtype, heads, stream);
}

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
// the forward (key t, at position k_off + t, seen by query s when t < Sk,
// k_off + t <= s if causal, and k_off + t > s - window if a window is
// given; S_k != S only in a non-causal call without a window or for a key
// shard, k_off > 0 only for a key shard), GQA (kv head = h / G, G = H /
// KV), all in fp32.  A key shard's lse and O are the whole row's (the
// shards' forwards combined), so its dq is the shard's part of the row's
// and its dk, dv are the shard's keys' whole gradients:
//   lse_s = log sum_t exp(scale q_s.k_t)
//   P_st  = exp(scale q_s.k_t - lse_s), 0 where masked
//   D_s   = sum_d dO_sd O_sd                       (O: the forward's output)
//   dS_st = P_st (dO_s.v_t - D_s)
//   dq_s  = scale sum_t dS_st k_t
//   dk_t  = scale sum_(heads of the group, s) dS_st q_s
//   dv_t  = sum_(heads of the group, s) P_st dO_s
// Gradients come back in the input's dtype; bf16 inputs are converted on
// load and every product and sum runs in fp32.
//
// Two kernels, launched in order on one stream: dq (with each row's D into
// a (B, H, S) fp32 workspace), then dk and dv.  Each row's lse comes from
// the forward, which writes it under grad (flash_attention_lse_launch; the
// wrapper runs that launch first when a caller has none), so no kernel
// here walks a row's keys for its statistics.
//
// What bounds it: the products.  Per scored pair, 2 hd flops each for q.k
// and dO.v (twice: the dq and dk/dv kernels each compute them), dq, dk and
// dv.  The design:
//
// * Every product runs on the tensor cores, held to the fp32 contract by
//   3xTF32 as flash_attention.cu does it: each fp32 operand x is split into
//   big (x rounded to tf32) and small = x - big, and small.big + big.small
//   + big.big goes through mma.sync.m16n8k8 (small.small, about 2^-22 of a
//   product, is left out).  The tensor cores round a sum toward its largest
//   term, so the big.big of each step (16 head dims of a score, one 32-row
//   tile of an accumulation, or 8 rows in the head_dim-128 dk/dv kernel)
//   starts from zero there and joins its running sum through IEEE adds.
//   bf16 inputs are exact in tf32 (small = 0).  The softmax statistics,
//   exponentials, masks and D stay fp32 on the CUDA cores.
// * A warp owns 16 rows (the mma's M) and keeps their scores in registers:
//   the score fragment of q.k (rows g, g + 8 at columns 2t, 2t + 1 of each 8)
//   is the A operand of the next product as it stands (k-slot t column 2t,
//   k-slot t + 4 column 2t + 1), as in the forward's p.v.  The dq kernel's
//   warp owns 16 query rows of one head: per 32-key tile it computes S and
//   P, dP and dS = P (dP - D), and dq += dS k, with nothing through shared
//   memory but the K and V tiles.  A block is 4 warps over 64 rows at
//   head_dim <= 64, else 8 warps over 64 rows of two heads of a kv group
//   (128 rows of one head when G is odd), the heads sharing each K/V tile.
// * dk/dv at head_dim <= 64: a warp owns 16 keys, a block 64 keys of one kv
//   head, and walks the (query head, 32-query tile) pairs of its group that
//   can see its keys: P^T, then dv += P^T dO, then dP^T, dS^T and dk += dS^T
//   q, the four warps sharing each q/dO tile.  At 65-128, where a warp's 16
//   keys of dk and dv would hold 128 accumulators, a block takes 16 keys:
//   per tile two warps compute P^T and two dP^T - D, 16 queries each, into
//   shared memory, then each warp accumulates 32 of the 128 columns of dv
//   and dk.  Either way no two blocks write one row and nothing is atomic.
// * Both grids put the block index that carries the causal work on the
//   slowest axis, heaviest first (the last query rows, the first keys), so
//   the longest blocks start first and the short ones fill the tail; at
//   the jamba pair's training shape on an H100 that took the dk/dv kernel
//   from 0.469 to 0.317 ms.  The dk/dv grid is (KV, B, key blocks): at (4, 256, 64 heads
//   over 8, 128) 512 blocks of 16 keys, about 4 waves of 2 blocks an SM on
//   132 SMs; blocks of a kv group walk its heads in series.
// * Streamed tiles (K/V for dq, q/dO with their lse and D rows for dk/dv)
//   arrive through two cp.async stages, the next tile's copies in flight
//   while this one's products run.  Shared-memory rows are hd_pad floats
//   (64 or 128) with each 16-byte column group stored at an xor-swizzled
//   slot (group u of row r at u ^ swz(r)), so the warps' three fragment
//   patterns (A rows g and g + 8, B rows g, B rows 2t and 2t + 1, 4 dims a
//   lane) are all free of bank conflicts; rows are zero-padded to hd_pad
//   (a smaller head_dim computes on the zeros).  fp32 rows of a multiple of
//   4 floats on 16-byte aligned tensors arrive through cp.async; others
//   (bf16, unaligned) through registers into the same fp32 tiles.
// * Tiles the causal or window mask fully hides are skipped (by the block,
//   and by a warp whose rows or keys they hide).  Every sum runs in a fixed
//   order: two runs give the same bits.
//
// Blocks an SM on an H100 (flash_attention_bwd_blocks_per_sm, fp32): dq 3
// of 4 warps at head_dim 64 (64 KB of shared memory each), 1 of 8 at 128
// (192 KB); dk/dv 3 of 4 warps at 64 (66 KB, held to 168 registers), 2 of 4
// at 128 (88 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 16;              // rows a block owns (the mma's M)
constexpr int kTile = 32;              // rows of a streamed tile
constexpr int kMaxHd = 128;
constexpr int kPP = kTile + 8;         // pitch of the P^T and dP^T - D tiles (8 mod 32 floats)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 lds2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void sts2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// 3xTF32 split: big = x rounded to tf32 (to nearest, ties away from zero),
// small = x - big, exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies from device memory into shared memory: 16 bytes, or
// 4 (the statistics rows); with `valid` false they write zeros and read
// nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// The slot of 16-byte column group u in row r is u ^ swz(r).  A warp reads
// groups (4c + t) of rows g, g + 8 (A), (4c + t) of rows g (B over the head
// dims) and (8s + g) of rows 2t, 2t + 1 (B over the rows), all from tiles
// whose first row is a multiple of 8; with rows of a multiple of 32 floats
// each read's eight lanes of a quarter warp fall on eight different bank
// groups.
__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }

// Rows [row0, row0 + n_rows) of a (n, hd) slice whose rows are `step`
// elements apart, into a swizzled tile of kHd-float rows; columns past hd
// and rows at or past n are zero.  kAsync: fp32 rows of a multiple of 4
// floats, 16-byte aligned, through cp.async (complete at the next wait);
// else through registers, converted to fp32.
template <typename T, bool kAsync, int kHd>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                                          int64_t step, int row0, int n_rows, int n, int hd,
                                          int tid, int n_threads) {
  constexpr int kGroups = kHd / 4;
  if constexpr (kAsync) {
    for (int i = tid; i < n_rows * kGroups; i += n_threads) {
      const int r = i / kGroups, u = i - r * kGroups;
      const bool in = row0 + r < n && 4 * u < hd;
      cp_async16(dst + r * kHd + 4 * (u ^ swz(r)),
                 in ? reinterpret_cast<const float*>(src) + (row0 + r) * step + 4 * u
                    : reinterpret_cast<const float*>(src),
                 in);
    }
  } else {
    for (int i = tid; i < n_rows * kHd; i += n_threads) {
      const int r = i / kHd, c = i - r * kHd;
      dst[r * kHd + 4 * ((c >> 2) ^ swz(r)) + (c & 3)] =
          (row0 + r < n && c < hd) ? to_float(src[(row0 + r) * step + c]) : 0.0f;
    }
  }
}

// The A operand of two k-steps (head dims 16c .. 16c + 15) from rows g and
// g + 8 of a tile: k-step 0 takes dims 4t, 4t + 1 of the lane's group, k-step
// 1 dims 4t + 2, 4t + 3 (the head dims may take any order that q.k's two
// sides share).
template <int kHd>
__device__ __forceinline__ void load_a(const float* __restrict__ tile, int c, int g, int t,
                                       uint32_t (&big)[2][4], uint32_t (&small)[2][4]) {
  const int slot = 4 * ((4 * c + t) ^ swz(g));
  const float4 lo = lds4(tile + g * kHd + slot), hi = lds4(tile + (g + 8) * kHd + slot);
  split_tf32(lo.x, big[0][0], small[0][0]);
  split_tf32(hi.x, big[0][1], small[0][1]);
  split_tf32(lo.y, big[0][2], small[0][2]);
  split_tf32(hi.y, big[0][3], small[0][3]);
  split_tf32(lo.z, big[1][0], small[1][0]);
  split_tf32(hi.z, big[1][1], small[1][1]);
  split_tf32(lo.w, big[1][2], small[1][2]);
  split_tf32(hi.w, big[1][3], small[1][3]);
}

// Scores of the 16 rows of a_tile against kNT groups of 8 rows of b_tile
// from row b0 (a multiple of 8), over kHd dims: lane (g, t) ends with rows g
// (i = 0, 1) and g + 8 (i = 2, 3) at b rows b0 + 8n + 2t + (i & 1) in
// big[n][i] + small[n][i].  big sums each 16 dims' big.big, started from
// zero in the tensor cores, through IEEE adds; small sums the small.big and
// big.small products (about 2^-11 of a score, so their running sum in the
// tensor cores keeps fp32 accuracy).
template <int kHd, int kNT>
__device__ __forceinline__ void scores(const float* __restrict__ a_tile,
                                       const float* __restrict__ b_tile, int b0, int g, int t,
                                       float (&big)[kNT][4], float (&small)[kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) big[n][i] = small[n][i] = 0.0f;
  }
#pragma unroll 2
  for (int c = 0; c < kHd / 16; ++c) {
    uint32_t ab[2][4], as[2][4];
    load_a<kHd>(a_tile, c, g, t, ab, as);
    const int slot = 4 * ((4 * c + t) ^ swz(g));
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float4 b4 = lds4(b_tile + (b0 + 8 * n + g) * kHd + slot);
      uint32_t bb[2][2], bs[2][2];
      split_tf32(b4.x, bb[0][0], bs[0][0]);
      split_tf32(b4.y, bb[0][1], bs[0][1]);
      split_tf32(b4.z, bb[1][0], bs[1][0]);
      split_tf32(b4.w, bb[1][1], bs[1][1]);
      mma_tf32(small[n], as[0], bb[0]);
      mma_tf32(small[n], ab[0], bs[0]);
      mma_tf32(small[n], as[1], bb[1]);
      mma_tf32(small[n], ab[1], bs[1]);
      float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(step, ab[0], bb[0]);
      mma_tf32(step, ab[1], bb[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) big[n][i] += step[i];
    }
  }
}

// One k-step of an accumulation over rows: part += A (16 rows x 8 of the
// tile's rows, split into ab and as) times rows x0 .. x0 + 7 of x_tile (x0
// a multiple of 8), columns 32s .. 32s + 31.  Lane (g, t) reads dims
// 32s + 4g .. + 3 of rows x0 + 2t (k-slot t) and x0 + 2t + 1 (k-slot t + 4);
// product j puts its column g at dim 32s + 4g + j, so the lane ends with
// rows g (e = 0, 1) and g + 8 (e = 2, 3) at dims 32s + 8t + 4 (e & 1) + j
// in part[j][e].  A part starts from zero in the tensor cores and joins its
// running sum through IEEE adds (add_part) after one k-step (dk, dv) or one
// tile's four (dq).
template <int kHd>
__device__ __forceinline__ void mma_rows(float (&part)[4][4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const float* __restrict__ x_tile, int x0, int s,
                                         int g, int t) {
  const int group = 8 * s + g;
  const float4 r0 = lds4(x_tile + (x0 + 2 * t) * kHd + 4 * (group ^ (2 * t)));
  const float4 r1 = lds4(x_tile + (x0 + 2 * t + 1) * kHd + 4 * (group ^ (2 * t) ^ 4));
  const float e0[4] = {r0.x, r0.y, r0.z, r0.w}, e1[4] = {r1.x, r1.y, r1.z, r1.w};
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(e0[j], bb[j][0], bs[j][0]);
    split_tf32(e1[j], bb[j][1], bs[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(part[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(part[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(part[j], ab, bb[j]);
}

__device__ __forceinline__ void zero(float (&part)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
}
__device__ __forceinline__ void add_part(float (&acc)[4][4], const float (&part)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// The A operand of a k-step from four values of a score fragment (rows g,
// g + 8 at columns 2t, 2t + 1 of 8): k-slot t takes column 2t, k-slot t + 4
// column 2t + 1, as flash_attention.cu feeds p.v.
__device__ __forceinline__ void split_frag(const float (&c)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// The A operand of k-step j of an accumulation from a (16, kPP) tile of P
// (and, with `d`, dS = P (dP - D) from the dP - D tile beside it): k-slot t
// is column 8j + 2t, k-slot t + 4 column 8j + 2t + 1.
__device__ __forceinline__ void load_p(const float* __restrict__ p, const float* __restrict__ d,
                                       int j, int g, int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  float2 lo = lds2(p + g * kPP + 8 * j + 2 * t), hi = lds2(p + (g + 8) * kPP + 8 * j + 2 * t);
  if (d != nullptr) {
    const float2 dlo = lds2(d + g * kPP + 8 * j + 2 * t);
    const float2 dhi = lds2(d + (g + 8) * kPP + 8 * j + 2 * t);
    lo = make_float2(lo.x * dlo.x, lo.y * dlo.y);
    hi = make_float2(hi.x * dhi.x, hi.y * dhi.y);
  }
  split_tf32(lo.x, big[0], small[0]);
  split_tf32(hi.x, big[1], small[1]);
  split_tf32(lo.y, big[2], small[2]);
  split_tf32(hi.y, big[3], small[3]);
}

__device__ __forceinline__ bool visible(int qp, int key, int S, int Sk, int causal, int window,
                                        int k_off) {
  return qp < S && key < Sk && (!causal || key <= qp - k_off)
      && (window <= 0 || key > qp - k_off - window);
}

// A warp's 16 rows of 32-column block s (rows g, g + 8; dims 32s + 8t +
// 4 (e & 1) + j), times `factor`, into rows row0.. of a (n, hd) slice whose
// rows are `step` elements apart.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int64_t step, int row0, int n,
                                           int hd, const float (&acc)[4][4], float factor,
                                           int s, int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + g + 8 * (e >> 1);
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * s + 8 * t + 4 * (e & 1) + j;
      if (col < hd) store(dst + row * step + col, acc[j][e] * factor);
    }
  }
}

// Shared memory in floats.  dq: each warp's 16 rows of q and dO, and two
// stages of K and V tiles.  dk/dv: the block's 16 keys of k and v, two
// stages of q and dO tiles, the P^T and dP^T - D tiles and the tiles'
// statistics.
template <int kHd, int kWarps>
constexpr int dq_smem_floats() {
  return 2 * kWarps * 16 * kHd + 4 * kTile * kHd;
}
template <int kHd>
constexpr int dkdv_smem_floats() {
  return kHd <= 64 ? (2 * 4 * kRows + 4 * kTile) * kHd + 4 * kTile
                   : (2 * kRows + 4 * kTile) * kHd + 2 * kRows * kPP + 4 * kTile;
}

// Kernel 1: dq, and each row's lse and D into the workspace.  A block is
// kHeads query heads of one kv group x kGroups warps; warp (head slot hs,
// group rg) owns 16 query rows of its head and keeps its scores, P, dP and
// dS in registers: the score fragments are the A operand of dq += dS k as
// they stand.  The heads of a block share each K/V tile.
template <typename T, int kHd, int kHeads, int kGroups, bool kAsync>
__global__ void __launch_bounds__(32 * kHeads * kGroups) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, T* __restrict__ dq,
    const float* __restrict__ lse_ws, float* __restrict__ delta_ws,   // (B, H, S)
    int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off) {
  constexpr int kWarps = kHeads * kGroups, kThreads = 32 * kWarps;
  constexpr int kBlockRows = 16 * kGroups;   // query rows of each head
  constexpr int kNT = kTile / 8;             // groups of 8 keys a tile
  constexpr int kCols = kHd / 32;            // 32-column blocks of dq
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // (kHeads, kBlockRows, kHd)
  float* dos = qs + kWarps * 16 * kHd;       // (kHeads, kBlockRows, kHd)
  float* ks = dos + kWarps * 16 * kHd;       // (2, kTile, kHd)
  float* vs = ks + 2 * kTile * kHd;          // (2, kTile, kHd)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hs = warp / kGroups, rg = warp % kGroups;
  const int G = H / KV;
  const int slots = G / kHeads;              // blocks over one kv group's heads
  const int kvh = blockIdx.x / slots;
  const int h0 = kvh * G + (blockIdx.x % slots) * kHeads;   // the block's first head
  const int b = blockIdx.y;
  // row blocks on the slowest grid axis, the last rows (the most keys when
  // causal) first, so the longest blocks start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;
  const int r0 = q0 + 16 * rg;               // this warp's first row
  const int64_t q_step = static_cast<int64_t>(H) * hd;
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;
  const int64_t q_off = (static_cast<int64_t>(b) * S * H + h0 + hs) * hd;   // this warp's head
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    const int64_t off = (static_cast<int64_t>(b) * S * H + h0 + i) * hd;
    load_rows<T, kAsync, kHd>(qs + i * kBlockRows * kHd, q + off, q_step, q0, kBlockRows, S, hd,
                              tid, kThreads);
    load_rows<T, kAsync, kHd>(dos + i * kBlockRows * kHd, dout + off, q_step, q0, kBlockRows, S,
                              hd, tid, kThreads);
  }
  const float* qa = qs + warp * 16 * kHd;    // this warp's rows (hs kBlockRows + 16 rg)
  const float* da = dos + warp * 16 * kHd;

  // keys the block's rows can see: from the window's lower edge (whole
  // tiles) up to the last row when causal, else to the last key; and the
  // part of them this warp's rows can see
  const int q_last = min(q0 + kBlockRows, S) - 1;
  int k_begin = window > 0 ? max(0, q0 - k_off - window + 1) : 0;
  k_begin = k_begin / kTile * kTile;
  const int k_end = causal ? min(q_last + 1 - k_off, Sk) : Sk;
  const int n_tiles = max(0, (k_end - k_begin + kTile - 1) / kTile);
  const bool rows = r0 < S;
  const int w_lo = window > 0 ? max(0, r0 - k_off - window + 1) : 0;
  const int w_hi = causal ? min(min(r0 + 15, S - 1) + 1 - k_off, Sk) : Sk;
  auto sees = [&](int k0) { return rows && k0 < w_hi && k0 + kTile > w_lo; };

  // D of the warp's rows: two lanes a row, each half of the columns
  // (strided), joined by one xor shuffle; lane (g, t) then takes rows g and
  // g + 8.
  float delta[2];
  {
    const int rr = lane / 2, half = lane % 2;
    float d = 0.0f;
    if (r0 + rr < S) {
      const T* orow = out + q_off + (r0 + rr) * q_step;
      const T* drow = dout + q_off + (r0 + rr) * q_step;
      for (int c = half; c < hd; c += 2) d = fmaf(to_float(drow[c]), to_float(orow[c]), d);
    }
    d += __shfl_xor_sync(kFull, d, 1);
    delta[0] = __shfl_sync(kFull, d, 2 * g);
    delta[1] = __shfl_sync(kFull, d, 2 * (g + 8));
  }

  // Each row's lse, from the forward; D into the workspace for the dk/dv
  // kernel.
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + g + 8 * r;
    const int64_t row = (static_cast<int64_t>(b) * H + h0 + hs) * S + qp;
    lse[r] = qp < S ? lse_ws[row] : 0.0f;
    if (t == 0 && qp < S) delta_ws[row] = delta[r];
  }

  // P and dS of each tile in registers, then dq += dS k.
  auto load_kv = [&](int stage, int k0) {
    load_rows<T, kAsync, kHd>(ks + stage * kTile * kHd, kb, kv_step, k0, kTile, Sk, hd, tid,
                              kThreads);
    load_rows<T, kAsync, kHd>(vs + stage * kTile * kHd, vb, kv_step, k0, kTile, Sk, hd, tid,
                              kThreads);
  };
  load_kv(0, k_begin);
  cp_async_commit();
  float acc[kCols][4][4];
#pragma unroll
  for (int c = 0; c < kCols; ++c) zero(acc[c]);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kTile;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, k0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (sees(k0)) {
      const float* kt = ks + (it & 1) * kTile * kHd;
      const float* vt = vs + (it & 1) * kTile * kHd;
      float p[kNT][4];
      {
        float sb[kNT][4], ss[kNT][4];
        scores<kHd, kNT>(qa, kt, 0, g, t, sb, ss);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * n + 2 * t + (i & 1);
            const bool ok = visible(r0 + g + 8 * (i >> 1), key, S, Sk, causal, window, k_off);
            p[n][i] = ok ? expf((sb[n][i] + ss[n][i]) * scale - lse[i >> 1]) : 0.0f;
          }
        }
      }
      uint32_t ab[kNT][4], as[kNT][4];   // dS as the A operand of each 8 keys
      {
        float pb[kNT][4], ps[kNT][4];
        scores<kHd, kNT>(da, vt, 0, g, t, pb, ps);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ds[i] = p[n][i] * ((pb[n][i] + ps[n][i]) - delta[i >> 1]);
          split_frag(ds, ab[n], as[n]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float part[4][4];
        zero(part);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma_rows<kHd>(part, ab[n], as[n], kt, 8 * n, c, g, t);
        add_part(acc[c], part);
      }
    }
    __syncthreads();   // every warp is done with this tile's stage
  }
  cp_async_wait<0>();  // nothing in flight when the block ends (no tile: rows before every key)
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    store_rows<T>(dq + q_off, q_step, r0, S, hd, acc[c], scale, c, g, t);
  }
}

// The dk/dv tile loop's common part: the block's query tiles of every
// head of its kv group (heads outer), each with its lse and D rows, through
// two cp.async stages.  For each tile, `body(stage, qt0, q, dO, lse, D)`
// runs between the tile's arrival and the block's sync that releases its
// stage.
template <typename T, bool kAsync, int kHd, int kThreads, typename Body>
__device__ __forceinline__ void for_query_tiles(
    const T* __restrict__ q, const T* __restrict__ dout, const float* __restrict__ lse_ws,
    const float* __restrict__ delta_ws, float* qs, float* dos, float* s_lse, float* s_delta,
    int b, int kvh, int G, int S, int H, int hd, int q_begin, int n_qt, int tid, Body body) {
  const int64_t q_step = static_cast<int64_t>(H) * hd;
  const int items = G * n_qt;   // (query head of the group, query tile), heads outer
  auto load_item = [&](int i, int stage) {
    const int h = kvh * G + i / n_qt;
    const int qt0 = q_begin + (i % n_qt) * kTile;
    const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * hd;
    load_rows<T, kAsync, kHd>(qs + stage * kTile * kHd, q + q_off, q_step, qt0, kTile, S, hd,
                              tid, kThreads);
    load_rows<T, kAsync, kHd>(dos + stage * kTile * kHd, dout + q_off, q_step, qt0, kTile, S,
                              hd, tid, kThreads);
    if (tid < 2 * kTile) {   // lse by the first 32 threads, D by the next 32
      const int r = tid % kTile;
      const int64_t stat = (static_cast<int64_t>(b) * H + h) * S + qt0 + r;
      const bool in = qt0 + r < S;
      const float* src = tid < kTile ? lse_ws : delta_ws;
      cp_async4((tid < kTile ? s_lse : s_delta) + stage * kTile + r, in ? src + stat : src, in);
    }
  };
  if (items > 0) load_item(0, 0);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) {
      load_item(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // item it is in (and, at it = 0, the block's K and V)
    const int stage = it & 1;
    body(stage, q_begin + (it % n_qt) * kTile, qs + stage * kTile * kHd,
         dos + stage * kTile * kHd, s_lse + stage * kTile, s_delta + stage * kTile);
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();   // nothing in flight when the block ends
}

// Kernel 2, head_dim up to 64: dk and dv of 64 keys of one kv head, over its
// G query heads.  Each of four warps owns 16 keys and keeps its P^T and
// dS^T in registers: the score fragments are the A operand of dv += P^T dO
// and dk += dS^T q as they stand; the warps share each q/dO tile.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(128, 3) flash_bwd_dkdv_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse_ws,
    const float* __restrict__ delta_ws, T* __restrict__ dk, T* __restrict__ dv,
    int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off) {
  constexpr int kHd = 64, kWarps = 4, kThreads = 128, kBlockKeys = 16 * kWarps;
  constexpr int kNT = kTile / 8;         // groups of 8 queries a tile
  constexpr int kCols = kHd / 32;        // 32-column blocks of dk and dv
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // (kBlockKeys, kHd)
  float* vs = ks + kBlockKeys * kHd;     // (kBlockKeys, kHd)
  float* qs = vs + kBlockKeys * kHd;     // (2, kTile, kHd)
  float* dos = qs + 2 * kTile * kHd;     // (2, kTile, kHd)
  float* s_lse = dos + 2 * kTile * kHd;  // (2, kTile)
  float* s_delta = s_lse + 2 * kTile;    // (2, kTile)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  // key blocks on the slowest grid axis, the first keys (the most queries
  // when causal) first
  const int k0 = blockIdx.z * kBlockKeys;
  const int kw = k0 + 16 * warp;         // this warp's first key
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;

  load_rows<T, kAsync, kHd>(ks, k + kv_off, kv_step, k0, kBlockKeys, Sk, hd, tid, kThreads);
  load_rows<T, kAsync, kHd>(vs, v + kv_off, kv_step, k0, kBlockKeys, Sk, hd, tid, kThreads);
  const float* ka = ks + warp * 16 * kHd;
  const float* va = vs + warp * 16 * kHd;

  // query rows that can see the block's keys: from its first key on when
  // causal, below its last key + window when windowed; and whether a tile
  // holds a query that sees one of this warp's keys
  const int q_begin = causal ? (k0 + k_off) / kTile * kTile : 0;
  const int q_end = window > 0 ? min(S, k0 + k_off + kBlockKeys - 1 + window) : S;
  const int n_qt = max(0, (q_end - q_begin + kTile - 1) / kTile);
  auto sees = [&](int qt0) {
    return kw < Sk && (!causal || qt0 + kTile - 1 >= kw + k_off)
        && (window <= 0 || qt0 < kw + k_off + 15 + window);
  };

  float adv[kCols][4][4], adk[kCols][4][4];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    zero(adv[c]);
    zero(adk[c]);
  }
  for_query_tiles<T, kAsync, kHd, kThreads>(
      q, dout, lse_ws, delta_ws, qs, dos, s_lse, s_delta, b, kvh, G, S, H, hd, q_begin, n_qt,
      tid, [&](int stage, int qt0, const float* qt, const float* dot, const float* lse,
               const float* delta) {
        if (!sees(qt0)) return;
        // P^T: keys g, g + 8 against queries 8n + 2t (+1) of the tile
        float p[kNT][4];
        {
          float sb[kNT][4], ss[kNT][4];
          scores<kHd, kNT>(ka, qt, 0, g, t, sb, ss);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = 8 * n + 2 * t + (i & 1);
              const bool ok = visible(qt0 + col, kw + g + 8 * (i >> 1), S, Sk, causal, window, k_off);
              p[n][i] = ok ? expf((sb[n][i] + ss[n][i]) * scale - lse[col]) : 0.0f;
            }
          }
        }
        // dv += P^T dO, a part per 32-column block
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float part[4][4];
          zero(part);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            uint32_t ab[4], as[4];
            split_frag(p[n], ab, as);
            mma_rows<kHd>(part, ab, as, dot, 8 * n, c, g, t);
          }
          add_part(adv[c], part);
        }
        // dS^T = P^T (dP^T - D), then dk += dS^T q
        {
          float sb[kNT][4], ss[kNT][4];
          scores<kHd, kNT>(va, dot, 0, g, t, sb, ss);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              p[n][i] *= (sb[n][i] + ss[n][i]) - delta[8 * n + 2 * t + (i & 1)];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float part[4][4];
          zero(part);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            uint32_t ab[4], as[4];
            split_frag(p[n], ab, as);
            mma_rows<kHd>(part, ab, as, qt, 8 * n, c, g, t);
          }
          add_part(adk[c], part);
        }
      });
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    store_rows<T>(dv + kv_off, kv_step, kw, Sk, hd, adv[c], 1.0f, c, g, t);
    store_rows<T>(dk + kv_off, kv_step, kw, Sk, hd, adk[c], scale, c, g, t);
  }
}

// Kernel 2, head_dim 65 to 128: dk and dv of 16 keys of one kv head, over
// its G query heads.  Per tile, the first two warps compute P^T and the
// last two dP^T - D, 16 queries each, into shared memory; then each warp
// accumulates its 32 columns of dv += P^T dO and dk += dS^T q.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse_ws,
    const float* __restrict__ delta_ws, T* __restrict__ dk, T* __restrict__ dv,
    int S, int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off) {
  constexpr int kHd = 128, kThreads = 128;
  constexpr int kPart = kTile / 2;        // queries a warp takes of a tile in the first step
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // (kRows, kHd)
  float* vs = ks + kRows * kHd;           // (kRows, kHd)
  float* qs = vs + kRows * kHd;           // (2, kTile, kHd)
  float* dos = qs + 2 * kTile * kHd;      // (2, kTile, kHd)
  float* ps = dos + 2 * kTile * kHd;      // (kRows, kPP): P^T
  float* dps = ps + kRows * kPP;          // (kRows, kPP): dP^T - D
  float* s_lse = dps + kRows * kPP;       // (2, kTile)
  float* s_delta = s_lse + 2 * kTile;     // (2, kTile)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int k0 = blockIdx.z * kRows;   // the first keys (the most queries when causal) first
  const int64_t kv_step = static_cast<int64_t>(KV) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * hd;

  load_rows<T, kAsync, kHd>(ks, k + kv_off, kv_step, k0, kRows, Sk, hd, tid, kThreads);
  load_rows<T, kAsync, kHd>(vs, v + kv_off, kv_step, k0, kRows, Sk, hd, tid, kThreads);

  const int q_begin = causal ? (k0 + k_off) / kTile * kTile : 0;
  const int q_end = window > 0 ? min(S, k0 + k_off + kRows - 1 + window) : S;
  const int n_qt = max(0, (q_end - q_begin + kTile - 1) / kTile);
  const int part = warp % 2;

  float adk[4][4], adv[4][4];
  zero(adk);
  zero(adv);
  for_query_tiles<T, kAsync, kHd, kThreads>(
      q, dout, lse_ws, delta_ws, qs, dos, s_lse, s_delta, b, kvh, G, S, H, hd, q_begin, n_qt,
      tid, [&](int stage, int qt0, const float* qt, const float* dot, const float* lse,
               const float* delta) {
        float sb[kPart / 8][4], ss[kPart / 8][4];
        if (warp < 2) {
          // P^T: keys g, g + 8 against queries part kPart + 8n + 2t (+1)
          scores<kHd, kPart / 8>(ks, qt, part * kPart, g, t, sb, ss);
#pragma unroll
          for (int n = 0; n < kPart / 8; ++n) {
            const int col = part * kPart + 8 * n + 2 * t;
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const bool ok = visible(qt0 + col + (i & 1), k0 + g + 8 * (i >> 1), S, Sk, causal,
                                      window, k_off);
              p[i] = ok ? expf((sb[n][i] + ss[n][i]) * scale - lse[col + (i & 1)]) : 0.0f;
            }
            sts2(ps + g * kPP + col, p[0], p[1]);
            sts2(ps + (g + 8) * kPP + col, p[2], p[3]);
          }
        } else {
          scores<kHd, kPart / 8>(vs, dot, part * kPart, g, t, sb, ss);
#pragma unroll
          for (int n = 0; n < kPart / 8; ++n) {
            const int col = part * kPart + 8 * n + 2 * t;
            sts2(dps + g * kPP + col, (sb[n][0] + ss[n][0]) - delta[col],
                 (sb[n][1] + ss[n][1]) - delta[col + 1]);
            sts2(dps + (g + 8) * kPP + col, (sb[n][2] + ss[n][2]) - delta[col],
                 (sb[n][3] + ss[n][3]) - delta[col + 1]);
          }
        }
        __syncthreads();
        // dv += P^T dO and dk += dS^T q over the tile's 32 queries, each
        // warp 32 columns, a part per 8 queries
#pragma unroll 1
        for (int j = 0; j < kTile / 8; ++j) {
          uint32_t pb[4], psm[4], db[4], dsm[4];
          load_p(ps, nullptr, j, g, t, pb, psm);
          load_p(ps, dps, j, g, t, db, dsm);
          float part_v[4][4], part_k[4][4];
          zero(part_v);
          zero(part_k);
          mma_rows<kHd>(part_v, pb, psm, dot, 8 * j, warp, g, t);
          mma_rows<kHd>(part_k, db, dsm, qt, 8 * j, warp, g, t);
          add_part(adv, part_v);
          add_part(adk, part_k);
        }
      });
  store_rows<T>(dk + kv_off, kv_step, k0, Sk, hd, adk, scale, warp, g, t);
  store_rows<T>(dv + kv_off, kv_step, k0, Sk, hd, adv, 1.0f, warp, g, t);
}

// A kernel's dynamic shared memory and a carveout of all of the SM's
// unified memory as shared memory, so the most blocks fit.
cudaError_t set_smem(const void* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The dq kernel's block: at head_dim 64, 4 warps over 64 rows of one head;
// at 128, 8 warps over 64 rows of two heads of a kv group when G is even,
// else 128 rows of one head.
template <typename T, int kHd, int kHeads, int kGroups, bool kAsync>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, void* dq, const float* lse_ws, float* delta_ws, int B, int S,
                      int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off,
                      cudaStream_t stream) {
  const auto kernel = flash_bwd_dq_kernel<T, kHd, kHeads, kGroups, kAsync>;
  const size_t smem = sizeof(float) * dq_smem_floats<kHd, kHeads * kGroups>();
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / kHeads, B, (S + 16 * kGroups - 1) / (16 * kGroups));
  kernel<<<grid, 32 * kHeads * kGroups, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<T*>(dq), lse_ws,
      delta_ws, S, Sk, H, KV, hd, scale, causal, window, k_off);
  return cudaGetLastError();
}

template <typename T, int kHd, bool kAsync>
cudaError_t launch_as(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, void* dq, void* dk, void* dv, const float* lse_ws,
                      float* delta_ws, int B, int S, int Sk, int H, int KV, int hd, float scale,
                      int causal, int window, int k_off, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (kHd == 64) {
    err = launch_dq<T, 64, 1, 4, kAsync>(q, k, v, out, dout, dq, lse_ws, delta_ws, B, S,
                                                 Sk, H, KV, hd, scale, causal, window, k_off, stream);
  } else {
    if ((H / KV) % 2 == 0) {
      err = launch_dq<T, kHd, 2, 4, kAsync>(q, k, v, out, dout, dq, lse_ws, delta_ws, B,
                                                    S, Sk, H, KV, hd, scale, causal, window, k_off,
                                                    stream);
    } else {
      err = launch_dq<T, kHd, 1, 8, kAsync>(q, k, v, out, dout, dq, lse_ws, delta_ws, B,
                                                    S, Sk, H, KV, hd, scale, causal, window, k_off,
                                                    stream);
    }
  }
  if (err != cudaSuccess) return err;
  const auto kernel = kHd == 64 ? flash_bwd_dkdv_rows_kernel<T, kAsync>
                                : flash_bwd_dkdv_kernel<T, kAsync>;
  const int block_keys = kHd == 64 ? 64 : kRows;
  const size_t smem = sizeof(float) * dkdv_smem_floats<kHd>();
  err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(KV, B, (Sk + block_keys - 1) / block_keys), 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse_ws, delta_ws, static_cast<T*>(dk), static_cast<T*>(dv),
      S, Sk, H, KV, hd, scale, causal, window, k_off);
  return cudaGetLastError();
}

template <typename T, bool kAsync>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, void* dq, void* dk, void* dv, const float* lse_ws,
                      float* delta_ws, int B, int S, int Sk, int H, int KV, int hd, float scale,
                      int causal, int window, int k_off, cudaStream_t stream) {
  if (hd <= 64) {
    return launch_as<T, 64, kAsync>(q, k, v, out, dout, dq, dk, dv, lse_ws, delta_ws, B,
                                            S, Sk, H, KV, hd, scale, causal, window, k_off, stream);
  }
  return launch_as<T, 128, kAsync>(q, k, v, out, dout, dq, dk, dv, lse_ws, delta_ws, B,
                                           S, Sk, H, KV, hd, scale, causal, window, k_off, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, void* dq, void* dk, void* dv, const float* lse_ws,
                   float* delta_ws, int B, int S, int Sk, int H, int KV, int hd, float scale,
                   int causal, int window, int k_off, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const bool async = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
        && reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0
        && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
    if (async) {
      return launch_hd<float, true>(q, k, v, out, dout, dq, dk, dv, lse_ws, delta_ws, B,
                                            S, Sk, H, KV, hd, scale, causal, window, k_off, stream);
    }
  }
  return launch_hd<T, false>(q, k, v, out, dout, dq, dk, dv, lse_ws, delta_ws, B, S, Sk,
                                     H, KV, hd, scale, causal, window, k_off, stream);
}

// Whether k and v's Sk keys fit the masks: in a causal or windowed call
// they are the keys at positions k_off .. k_off + Sk - 1 of the S queries'
// sequence (k_off = 0 and Sk = S: the whole sequence; a key shard
// otherwise), in any other call all of them, from position 0.
bool keys_ok(int S, int Sk, int causal, int window, int k_off) {
  if (causal || window > 0) return k_off >= 0 && static_cast<int64_t>(k_off) + Sk <= S;
  return k_off == 0;
}

int launch_dtype(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 void* dq, void* dk, void* dv, const void* lse_ws, void* delta_ws, int B, int S,
                 int Sk, int H, int KV, int hd, float scale, int causal, int window, int k_off, int dtype,
                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd <= 0 || hd > kMaxHd || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535
      || S > (1 << 20) || Sk <= 0 || Sk > (1 << 20) || !keys_ok(S, Sk, causal, window, k_off)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse = static_cast<const float*>(lse_ws);
  float* delta = static_cast<float*>(delta_ws);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, S, Sk,
                                          H, KV, hd, scale, causal, window, k_off, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                                                  S, Sk, H, KV, hd, scale, causal, window, k_off, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The larger of the two kernels' shared memory at this head_dim, in bytes.
extern "C" size_t flash_attention_bwd_smem_bytes(int hd) {
  const int a = hd <= 64 ? dq_smem_floats<64, 4>() : dq_smem_floats<128, 8>();
  const int b = hd <= 64 ? dkdv_smem_floats<64>() : dkdv_smem_floats<128>();
  return sizeof(float) * static_cast<size_t>(a > b ? a : b);
}

// Blocks of the dq (which = 0) or dk/dv (which = 1) kernel that fit one SM
// at this head_dim, fp32 through cp.async (the training path; dq with an
// even G), or -1 on a CUDA error.
extern "C" int flash_attention_bwd_blocks_per_sm(int hd, int which) {
  const void* kernel;
  size_t smem;
  int threads;
  if (hd <= 64) {
    kernel = which == 0
        ? reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, 64, 1, 4, true>)
        : reinterpret_cast<const void*>(flash_bwd_dkdv_rows_kernel<float, true>);
    smem = sizeof(float) * (which == 0 ? dq_smem_floats<64, 4>() : dkdv_smem_floats<64>());
    threads = 128;
  } else {
    kernel = which == 0
        ? reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, 128, 2, 4, true>)
        : reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<float, true>);
    smem = sizeof(float) * (which == 0 ? dq_smem_floats<128, 8>() : dkdv_smem_floats<128>());
    threads = which == 0 ? 256 : 128;
  }
  int blocks = -1;
  if (set_smem(kernel, smem) != cudaSuccess) return -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                                        smem);
  return err == cudaSuccess ? blocks : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv; every
// tensor contiguous in the model layout).  lse_ws: (B, H, S) fp32, each
// query row's log-sum-exp of its visible scaled scores, as
// flash_attention_lse_launch (the forward under grad) writes it;
// delta_ws: (B, H, S) fp32 scratch, written by the first kernel and read
// by the second.  Sk: keys in k and v, at positions k_off .. k_off + Sk - 1
// (within S) in a causal or windowed call, k_off = 0 otherwise.  window <=
// 0 means no window.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, void* dq, void* dk,
                                          void* dv, const void* lse_ws, void* delta_ws, int B,
                                          int S, int Sk, int H, int KV, int hd, float scale,
                                          int causal, int window, int k_off, int dtype, void* stream) {
  return launch_dtype(q, k, v, out, dout, dq, dk, dv, lse_ws, delta_ws, B, S, Sk, H, KV, hd,
                      scale, causal, window, k_off, dtype, stream);
}

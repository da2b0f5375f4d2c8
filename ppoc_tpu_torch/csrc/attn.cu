// K7: causal episode-masked flash attention, forward and backward.
//
// Replaces ppoc_tpu/ops/pallas_attn.py: `_fwd` -> `_fwd_kernel` (the
// forward), and `_bwd` -> `_bwd_dq_kernel` and `_bwd_dkv_kernel` (the two
// backward kernels).  On q, k, v folded to [BH, T, hd] (row-major), query t
// of a (batch, head) row attends key s iff
//
//   (rel < 0 || s <= t) && rel <= 0 && ep_k[s] == ep_q[t] && s, t < T
//
// with ep_q, ep_k the [B, T] episode ids of the query and key sides (the
// head's batch row is bh / H).  `rel` is the key block's time relation of
// ring attention: -1 every key precedes every query, 0 one window (the
// causal test), +1 nothing is valid.  The forward writes the softmax
// output and the row logsumexp (lse); a row with no valid key gets out 0
// and lse NEG.  The backward recomputes each weight from lse,
// w = exp(s * scale - lse), and takes dsum = rowsum(dout * out) - g_lse
// from the caller: ds = w (dout . v - dsum) scale, dq = sum_s ds k,
// dk = sum_t ds q, dv = sum_t w dout.
//
// Tile skip and order (both variants).  A block owns a tile of rows of one
// side (queries for the forward and dq, keys for dk/dv) and walks the other
// side's tiles of TILE rows: key tiles from 0 up to the causal bound, or
// query tiles from the block's first key on.  Before a tile is loaded, the
// block compares the tile's [min, max] episode id with its own rows' and
// skips the tile when the two ranges do not meet: no pair in it can be
// valid.  It is a range test, not a use of the ids rising with t: with rel
// -1 the key side comes from another window, and the test holds for any
// ids.  A skipped tile adds exactly nothing (the forward's m2 = m, alpha =
// exp(0) = 1 and p = 0; every backward term adds 0), so the plain
// versions, which visit every tile, compute the same function.  The flags
// are marked a window of tiles at a time into shared memory, each warp
// reducing a tile's ids with __reduce_min/max_sync, so the whole block
// takes or skips a tile together.  `cuda_attn.visited_tiles` is the same
// rule in Python.  Blocks are launched heaviest first: for the forward and
// dq the last query tiles (they see the most keys), for dk/dv the first key
// tiles, each tile of every (batch, head) row before the next lighter tile.
// No atomics: every output element is written by one thread from sums in a
// fixed order, so results are the same bit for bit from call to call.
//
// The f32 variant (`ppoc_flash_*`).  What bounds it on the card: at the
// recall_xl shapes (hd 8, T 1024) the inputs are a few MB, so the bound is
// the FP32 operations over the valid pairs of the causal triangle (about
// 4 hd flops a pair forward, 6 hd for dq, 8 hd for dk/dv); under that,
// latency: a block's walk over the other side's tiles is a chain of loads,
// products and exponentials.  What the design does about it: every product
// runs on the tensor cores as 3xTF32 mma.sync m16n8k8 (mma.cuh: each
// operand split into two tf32 values, a k-step's three mmas formed from
// zero and added in float32), so the products keep float32 accuracy (f32
// means f32; one-term TF32 would not).  A warp owns 16 rows (F32_RG = 2
// row groups: ROWS = 32 own rows a block) and holds S, P and its
// accumulators in registers; the accumulators of one product are the A
// operand of the next without a shuffle: an m16n8k8 accumulator holds
// columns (2t, 2t + 1) where the A operand wants (t, t + 4), so each
// k-step takes its 8 columns in the order 0, 2, 4, 6, 1, 3, 5, 7 and reads
// B's rows in that order too (the sum over k is the same sum).  Staged
// rows are hd + 4 floats apart, so both the score product's B reads (8
// rows, 4 columns) and the reordered reads (rows 2t and 2t + 1) meet 32
// distinct banks.  The key walk (the query walk for dk/dv) is split over
// F32<HD>::KS warp groups: the visited tiles are dealt to them in turn,
// each group double-buffers its own tiles with cp.async (zero-filled past
// T; one buffer at hd 64) behind a named barrier of its own, so the
// heaviest block's walk is KS times shorter; the groups' partial (m, l,
// acc) (the forward) or sums (dq, dk, dv) are merged through shared memory
// in group order.  The forward rescales once per key tile.
//
// The bf16 variant (`ppoc_flash_*_bf16`, pallas_attn.flash_mha with
// compute_dtype=bfloat16).  q, k, v and dout are bf16, every score and sum
// float32 (a bf16 x bf16 product is exact in f32).  The roundings sit where
// the Pallas kernel's casts do: p to bf16 for the P.V product only, l
// summing the unrounded p (pallas_attn.py:151); ds to bf16 for dq = ds.k
// (:245); ds^T and w^T to bf16 for dk = ds^T.q and dv = w^T.dout
// (:296-299); dq, dk and dv written as bf16 from float32 sums (:253,
// :312-313); out, lse and dsum float32 (dsum from the float32 cotangent,
// :326-330, by the caller).  Every rounding is to nearest even.  What
// bounds it on this card: at the recall_xl minibatch (T 1024, BH 16, hd 8)
// the valid pairs are 0.4 us of bf16 tensor-core work and a few hundred KB
// of bytes, so neither FLOPs nor bytes: it is latency and occupancy (256
// blocks of 4 warps on 132 SMs, each a chain of dependent products,
// exponentials and shuffles per key tile).  What the design does about
// it: a warp owns 16 rows (BF16_WARPS warps a block) and computes a whole
// 16 x TILE score tile on the tensor cores: mma.sync m16n8k8 at hd 8 (no
// padding to 16), m16n8k16 k-steps at hd 16-64, operands through ldmatrix
// (.trans where a tile is read as the other operand; rows padded by 8 bf16
// past hd 8 so the 8 rows of an ldmatrix fall on distinct banks).  The
// float32 accumulators of S (or dS, W) are rounded in registers into the A
// fragments of the next product (the flash-attention-2 reuse), so no score
// touches shared memory.  The forward rescales once per key tile (TILE
// keys, tile boundaries fixed in key position from 0: the plain version's
// chunk, cuda_attn.BF16_CHUNK), row max and row sum taken over the quad of
// lanes that hold a row.  The other side's tiles are double-buffered with
// cp.async (zero-filled past T), so the next visited tile loads while this
// one is computed.  dq stays its own kernel, apart from dk/dv.
#include <climits>
#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace ppoc;

constexpr float NEG = -1e9f;   // pallas_attn.NEG
constexpr int TILE = 64;       // rows of the other side per tile
constexpr int WIN = 256;       // tiles a block lists at once (list_visits)
constexpr unsigned FULL = 0xffffffffu;
// f32: row groups of 16 a block (cuda_attn.ROWS = 16 F32_RG own rows)
constexpr int F32_RG = 2;
constexpr int ROWS = 16 * F32_RG;
// bf16: warps of 16 rows a block (4 was faster than 1 or 2 at 7 of the 9
// timed entries, PERF.md); cuda_attn.BF16_ROWS is 16 of them
constexpr int BF16_WARPS = 4;

using bf16 = __nv_bfloat16;

// --- the tile skip -------------------------------------------------------

// [min, max] of e[r0, r1) (at most 64 rows), in every lane of the warp
__device__ __forceinline__ void id_range(const int* __restrict__ e, int r0,
                                         int r1, int& lo, int& hi) {
  const int a = r0 + (threadIdx.x & 31), c = a + 32;
  const int ea = a < r1 ? e[a] : 0, ec = c < r1 ? e[c] : 0;
  lo = __reduce_min_sync(FULL, min(a < r1 ? ea : INT_MAX,
                                   c < r1 ? ec : INT_MAX));
  hi = __reduce_max_sync(FULL, max(a < r1 ? ea : INT_MIN,
                                   c < r1 ? ec : INT_MIN));
}

// Which of the other side's tiles the block visits, a window of them at
// a time.  Tile j covers rows [base + j TILE, base + (j + 1) TILE) of e
// (the other side's ids), cut at T; the block's own rows carry ids in
// [lo, hi].  The visited tiles of the window [j0, j1) are listed in
// rising order into `list` (their count into *count) by every thread of
// the block, between three barriers.  A warp marks every nw-th tile, the
// ids of LB tiles loaded together before their reductions.
__device__ __forceinline__ void list_visits(int* list, unsigned char* flag,
                                            int* count, const int* e, int T,
                                            int base, int j0, int j1, int lo,
                                            int hi) {
  constexpr int LB = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)(blockDim.x >> 5);
  __syncthreads();   // the last window's list is no longer read
  for (int i0 = j0 + warp; i0 < j1; i0 += LB * nw) {
    int id[LB][2];
    bool ok[LB][2];
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int r0 = base + (i0 + u * nw) * TILE, r1 = min(T, r0 + TILE);
      const int a = r0 + lane, c = a + 32;
      const bool in = i0 + u * nw < j1;
      ok[u][0] = in && a < r1;
      ok[u][1] = in && c < r1;
      id[u][0] = ok[u][0] ? e[a] : 0;
      id[u][1] = ok[u][1] ? e[c] : 0;
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int tlo = __reduce_min_sync(
          FULL, min(ok[u][0] ? id[u][0] : INT_MAX,
                    ok[u][1] ? id[u][1] : INT_MAX));
      const int thi = __reduce_max_sync(
          FULL, max(ok[u][0] ? id[u][0] : INT_MIN,
                    ok[u][1] ? id[u][1] : INT_MIN));
      if (lane == 0 && i0 + u * nw < j1)
        flag[i0 + u * nw - j0] = tlo <= hi && thi >= lo;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int b = 0; b < j1 - j0; b += 32) {
      const bool f = b + lane < j1 - j0 && flag[b + lane];
      const unsigned m = __ballot_sync(FULL, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1u))] = j0 + b + lane;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
}

// --- cp.async ------------------------------------------------------------

// cp.async of 16 or 4 bytes into shared memory, zeros where !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but this thread's newest group of copies have landed
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- the f32 variant: 3xTF32 warp tiles on the tensor cores ---------------

// The launch at head dim HD (mirrored by ops/cuda_attn.py `f32_plan`).
template <int HD>
struct F32 {
  static constexpr int LD = HD + 4;                // a staged row, floats
  static constexpr int KD = HD / 8;                // k-steps, n-tiles over hd
  static constexpr int KS = HD <= 16 ? 4 : 2;      // warp groups: key splits
  static constexpr int NSTAGE = HD == 64 ? 1 : 2;  // tile buffers a group
  static constexpr int GT = 32 * F32_RG;           // threads a group
  static constexpr int THREADS = GT * KS;
  // a buffer: two [TILE][LD] tiles, then three TILE-long vectors
  static constexpr int STAGE = 2 * TILE * LD + 3 * TILE;   // floats
  static constexpr int SMEM = 4 * KS * NSTAGE * STAGE;     // dynamic bytes
  // n-tiles of the other side's rows a sub-step of the backward, fewer at
  // hd 64 for registers
  static constexpr int SUB = HD == 64 ? 2 : 4;
};

// The named barrier of warp group `id` (1 + its index) of `n` threads.
__device__ __forceinline__ void group_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Starts copying rows [r0, r0 + TILE) of a [T, HD] float matrix into dst
// ([TILE][LD]), zeros past T: thread `gt` of a group of `n`.
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int T, int gt, int n) {
  constexpr int CH = HD / 4;   // 16-byte pieces a row
  for (int i = gt; i < TILE * CH; i += n) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < T;
    cp16(dst + r * F32<HD>::LD + 4 * c,
         src + (size_t)(ok ? r0 + r : 0) * HD + 4 * c, ok);
  }
}

// Starts copying TILE 4-byte values src[r0 + i] into dst, zeros past T:
// thread `gt` of `n` (the block's, or a warp group's)
template <typename V>
__device__ __forceinline__ void stage_vec(V* dst, const V* __restrict__ src,
                                          int r0, int T, int gt, int n) {
  for (int i = gt; i < TILE; i += n) {
    const bool ok = r0 + i < T;
    cp4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

// Runs body(j, buf) over the tiles list[ks], list[ks + KS], ... (n listed)
// with tile j copied into buffer buf by stage(j, buf): warp group ks alone,
// behind its own barrier; with two buffers the next tile's copy is in
// flight while body runs.
template <int NSTAGE, int KS, typename Stage, typename Body>
__device__ __forceinline__ void group_walk(const int* list, int n, int ks,
                                           int gthreads, Stage stage,
                                           Body body) {
  if constexpr (NSTAGE == 2) {
    int r = ks, buf = 0;
    if (r < n) stage(list[r], 0);
    cp_commit();
    while (r < n) {
      const int rn = r + KS;
      if (rn < n) stage(list[rn], buf ^ 1);
      cp_commit();
      cp_wait_all_but_newest();
      group_bar(1 + ks, gthreads);   // tile r has landed for the group
      body(list[r], buf);
      group_bar(1 + ks, gthreads);   // buf is free for the tile after rn
      buf ^= 1;
      r = rn;
    }
  } else {
    for (int r = ks; r < n; r += KS) {
      stage(list[r], 0);
      cp_commit();
      cp_wait_all();
      group_bar(1 + ks, gthreads);
      body(list[r], 0);
      group_bar(1 + ks, gthreads);
    }
  }
}

// Runs body(j, buf) over the other side's tiles the block visits
// (list_visits, WIN at a time, the block's rows' ids in [lo, hi]), warp
// group ks of KS (gthreads threads) taking every KS-th as group_walk does.
// Every thread of the block calls it.
template <int NSTAGE, int KS, typename Stage, typename Body>
__device__ __forceinline__ void walk_tiles(int* list, unsigned char* flag,
                                           int* count, const int* e, int T,
                                           int base, int n_tiles, int lo,
                                           int hi, int ks, int gthreads,
                                           Stage stage, Body body) {
  for (int j0 = 0; j0 < n_tiles; j0 += WIN) {
    list_visits(list, flag, count, e, T, base, j0, min(n_tiles, j0 + WIN),
                lo, hi);
    group_walk<NSTAGE, KS>(list, *count, ks, gthreads, stage, body);
  }
}

// This lane's A fragments (float) of rows [r, r + 16) of a [T, HD] matrix,
// zeros past T: k-step d holds (g, 8d + t), (g + 8, 8d + t), (g, 8d + t +
// 4), (g + 8, 8d + t + 4), g = lane / 4, t = lane % 4.
template <int HD>
__device__ __forceinline__ void load_frag(float (&a)[HD / 8][4],
                                          const float* __restrict__ x, int r,
                                          int T, int lane) {
  const int r1 = r + (lane >> 2), r2 = r1 + 8, c = lane & 3;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    a[d][0] = r1 < T ? x[(size_t)r1 * HD + 8 * d + c] : 0.0f;
    a[d][1] = r2 < T ? x[(size_t)r2 * HD + 8 * d + c] : 0.0f;
    a[d][2] = r1 < T ? x[(size_t)r1 * HD + 8 * d + c + 4] : 0.0f;
    a[d][3] = r2 < T ? x[(size_t)r2 * HD + 8 * d + c + 4] : 0.0f;
  }
}

// s[n] = A . B^T for NT n-tiles of 8 staged rows from row n0, 3xTF32: A is
// 16 rows by hd in registers (load_frag's layout), B a staged [TILE][LD]
// tile of rows by hd (keys, or queries), read as the col-major B operand:
// lane (g, t) reads row n0 + 8n + g, columns 8d + t and 8d + t + 4.
template <int HD, int NT>
__device__ __forceinline__ void scores_f32(float (&s)[NT][4],
                                           const float (&a)[HD / 8][4],
                                           const float* bs, int n0,
                                           int lane) {
  constexpr int LD = F32<HD>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[d][i], ab[i], as[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* p = bs + (n0 + 8 * n + g) * LD + 8 * d + t;
      uint32_t bb[2], bsm[2];
      split_tf32(p[0], bb[0], bsm[0]);
      split_tf32(p[4], bb[1], bsm[1]);
      mma_3xtf32(s[n], ab, as, bb, bsm);
    }
  }
}

// o[nd] += P . bs[k0, k0 + 8 NT) over the hd / 8 n-tiles of hd columns,
// 3xTF32: P is NT n-tiles of accumulators (16 rows by 8 NT columns), the A
// operand as it lies: an accumulator holds columns (2t, 2t + 1) of its
// n-tile where A's fragment takes (t, t + 4), so k-step c sums its columns
// in the order 0, 2, 4, 6, 1, 3, 5, 7, and lane (g, t) reads B's rows
// k0 + 8c + 2t and + 1 (column 8 nd + g): the same sum over k.
template <int HD, int NT>
__device__ __forceinline__ void accumulate_f32(float (&o)[HD / 8][4],
                                               const float (&p)[NT][4],
                                               const float* bs, int k0,
                                               int lane) {
  constexpr int LD = F32<HD>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    uint32_t ab[4], as[4];
    split_tf32(p[c][0], ab[0], as[0]);   // (g, 2t)          as (g, t)
    split_tf32(p[c][2], ab[1], as[1]);   // (g + 8, 2t)      as (g + 8, t)
    split_tf32(p[c][1], ab[2], as[2]);   // (g, 2t + 1)      as (g, t + 4)
    split_tf32(p[c][3], ab[3], as[3]);   // (g + 8, 2t + 1)  as (g + 8, t + 4)
    const float* r = bs + (k0 + 8 * c + 2 * t) * LD + g;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      uint32_t bb[2], bsm[2];
      split_tf32(r[8 * nd], bb[0], bsm[0]);
      split_tf32(r[LD + 8 * nd], bb[1], bsm[1]);
      mma_3xtf32(o[nd], ab, as, bb, bsm);
    }
  }
}

// out[r] = op over this lane's 16 elements of row r of 8 n-tiles (elements
// 2r and 2r + 1 of each), as a tree
template <typename Op>
__device__ __forceinline__ void row_reduce(float (&out)[2],
                                           const float (&x)[8][4], Op op) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float y[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) y[n] = op(x[n][2 * r], x[n][2 * r + 1]);
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) y[n] = op(y[n], y[n + w]);
    out[r] = y[0];
  }
}

// Writes this lane's part of a warp's 16 x HD float accumulator: row[r]
// takes elements 2r and 2r + 1 of each n-tile (rows past T are not
// written).
template <int HD>
__device__ __forceinline__ void store_f32(float* __restrict__ x,
                                          const float (&o)[HD / 8][4],
                                          const int (&row)[2], int T,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    float* xr = x + (size_t)row[r] * HD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(xr + 8 * n) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// The groups' partial sums merged into group 0's, in group order: every
// warp of the block calls it once the walk is done; groups past 0 write
// their NV floats a lane into the stage buffers, group 0 adds them.
template <int KS, int NV>
__device__ __forceinline__ void merge_sums(float* scratch, float (&x)[NV],
                                           int ks, int rg, int lane) {
  if constexpr (KS > 1) {
    __syncthreads();   // every group is done with its buffers
    if (ks > 0) {
      float* p = scratch + ((ks - 1) * F32_RG + rg) * 32 * NV + lane;
#pragma unroll
      for (int i = 0; i < NV; ++i) p[32 * i] = x[i];
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll 1
      for (int k = 1; k < KS; ++k) {
        const float* p = scratch + ((k - 1) * F32_RG + rg) * 32 * NV + lane;
#pragma unroll
        for (int i = 0; i < NV; ++i) x[i] += p[32 * i];
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(F32<HD>::THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ ep_q,
          const int* __restrict__ ep_k, float* __restrict__ out,
          float* __restrict__ lse, int BH, int H, int T, int rel,
          float scale) {
  using S = F32<HD>;
  constexpr int LD = S::LD, KD = S::KD, KS = S::KS;
  extern __shared__ __align__(16) float fsm[];
  __shared__ int list[WIN];
  __shared__ unsigned char flag[WIN];
  __shared__ int n_list;
  // the last query tiles first: they see the most keys
  const int blk = (T + ROWS - 1) / ROWS - 1 - (int)blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % F32_RG, ks = warp / F32_RG, c2 = 2 * (lane & 3);
  const int gt = threadIdx.x - ks * S::GT;
  const int r0 = blk * ROWS, w0 = r0 + 16 * rg;
  const int t[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};   // my rows
  const size_t base = (size_t)bh * T;
  const int* epq = ep_q + (size_t)b * T;
  const int* epk = ep_k + (size_t)b * T;
  float qf[KD][4];
  load_frag<HD>(qf, q + base * HD, w0, T, lane);
  const int eq[2] = {t[0] < T ? epq[t[0]] : 0, t[1] < T ? epq[t[1]] : 0};
  int lo, hi, w_id, w_hi;
  id_range(epq, r0, min(T, r0 + ROWS), lo, hi);
  id_range(epq, w0, min(T, w0 + 16), w_id, w_hi);   // this warp's rows
  const bool w_one = w_id == w_hi;
  const int n_keys = rel < 0 ? T : rel == 0 ? min(T, r0 + ROWS) : 0;
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  float* gs = fsm + ks * S::NSTAGE * S::STAGE;   // this group's buffers
  float o[KD][4] = {}, m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  walk_tiles<S::NSTAGE, KS>(
      list, flag, &n_list, epk, T, 0, n_tiles, lo, hi, ks,
      S::GT,
      [&](int j, int buf) {
        float* st = gs + buf * S::STAGE;
        stage_f32<HD>(st, k + base * HD, j * TILE, T, gt, S::GT);
        stage_f32<HD>(st + TILE * LD, v + base * HD, j * TILE, T, gt,
                      S::GT);
        stage_vec(reinterpret_cast<int*>(st + 2 * TILE * LD), epk,
                      j * TILE, T, gt, S::GT);
      },
      [&](int j, int buf) {
        const float* st = gs + buf * S::STAGE;
        const int* eks = reinterpret_cast<const int*>(st + 2 * TILE * LD);
        const int k0 = j * TILE;
        // a tile where every pair of the warp's rows is valid (one
        // episode over the keys and the rows, every key before every
        // row, none past T: the path's common case) skips the per-pair
        // test
        const int e0 = eks[lane], e1 = eks[lane + 32];
        const int tlo = __reduce_min_sync(FULL, min(e0, e1));
        const int thi = __reduce_max_sync(FULL, max(e0, e1));
        const bool full = w_one && tlo == w_id && thi == w_id &&
                          k0 + TILE <= T && w0 + 16 <= T &&
                          (rel < 0 || k0 + TILE <= w0 + 1);
        float s[8][4];
        scores_f32<HD, 8>(s, qf, st, 0, lane);
        if (full) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] *= scale;
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int kk = 8 * n + c2;
            const int2 ek = *reinterpret_cast<const int2*>(&eks[kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, sk = k0 + kk + (e & 1);
              const bool valid = t[r] < T && sk < T &&
                                 (rel < 0 || sk <= t[r]) &&
                                 ((e & 1) ? ek.y : ek.x) == eq[r];
              s[n][e] = valid ? s[n][e] * scale : NEG;
            }
          }
        }
        float cmax[2], alpha[2], psum[2];
        row_reduce(cmax, s, [](float x, float y) { return fmaxf(x, y); });
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // the row's max over its quad
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(FULL, cmax[r], 1));
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(FULL, cmax[r], 2));
          const float m2 = fmaxf(m[r], cmax[r]);
          alpha[r] = expf(m[r] - m2);
          m[r] = m2;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // an invalid pair's NEG gives exp(NEG - m2) = 0 once the
            // row has a valid key; before that (m2 still NEG) p is set
            // to 0, or a row with no valid key would get
            // exp(NEG - NEG) = 1 (pallas_attn.py:143-147)
            const float mr = m[e >> 1];
            s[n][e] = mr == NEG ? 0.0f : expf(s[n][e] - mr);
          }
        row_reduce(psum, s, [](float x, float y) { return x + y; });
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
        for (int n = 0; n < KD; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        accumulate_f32<HD, 8>(o, s, st + TILE * LD, 0, lane);
      });
  if constexpr (KS > 1) {
    // the groups' (m, l, o) merged in group order: m the largest, each
    // partial rescaled to it (exp(NEG - NEG) = 1 where no group has a
    // valid key: then every l and o is 0)
    constexpr int NV = 4 + 4 * KD;
    __syncthreads();   // every group is done with its buffers
    if (ks > 0) {
      float* p = fsm + ((ks - 1) * F32_RG + rg) * 32 * NV + lane;
      p[0] = m[0];
      p[32] = m[1];
      p[64] = l[0];
      p[96] = l[1];
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[32 * (4 + 4 * n + e)] = o[n][e];
    }
    __syncthreads();
    if (ks > 0) return;
    float mt[2] = {m[0], m[1]};
#pragma unroll 1
    for (int g = 1; g < KS; ++g) {
      const float* p = fsm + ((g - 1) * F32_RG + rg) * 32 * NV + lane;
      mt[0] = fmaxf(mt[0], p[0]);
      mt[1] = fmaxf(mt[1], p[32]);
    }
    float f[2] = {expf(m[0] - mt[0]), expf(m[1] - mt[1])};
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] *= f[r];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= f[e >> 1];
#pragma unroll 1
    for (int g = 1; g < KS; ++g) {
      const float* p = fsm + ((g - 1) * F32_RG + rg) * 32 * NV + lane;
      f[0] = expf(p[0] - mt[0]);
      f[1] = expf(p[32] - mt[1]);
      l[0] += p[64] * f[0];
      l[1] += p[96] * f[1];
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] += p[32 * (4 + 4 * n + e)] * f[e >> 1];
    }
    m[0] = mt[0];
    m[1] = mt[1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // each lane summed its columns of the row
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (t[r] >= T) continue;
    const float l_safe = l[r] == 0.0f ? 1.0f : l[r];
    float* ob = out + (base + t[r]) * HD + c2;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      *reinterpret_cast<float2*>(ob + 8 * n) =
          make_float2(o[n][2 * r] / l_safe, o[n][2 * r + 1] / l_safe);
    if (c2 == 0) lse[base + t[r]] = m[r] + logf(l_safe);
  }
}

template <int HD>
__global__ void __launch_bounds__(F32<HD>::THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ ep_q,
             const int* __restrict__ ep_k, const float* __restrict__ dout,
             const float* __restrict__ dsum, const float* __restrict__ lse,
             float* __restrict__ dq, int BH, int H, int T, int rel,
             float scale) {
  using S = F32<HD>;
  constexpr int LD = S::LD, KD = S::KD, KS = S::KS, SUB = S::SUB;
  extern __shared__ __align__(16) float fsm[];
  __shared__ int list[WIN];
  __shared__ unsigned char flag[WIN];
  __shared__ int n_list;
  const int blk = (T + ROWS - 1) / ROWS - 1 - (int)blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % F32_RG, ks = warp / F32_RG, c2 = 2 * (lane & 3);
  const int gt = threadIdx.x - ks * S::GT;
  const int r0 = blk * ROWS, w0 = r0 + 16 * rg;
  const int t[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const size_t base = (size_t)bh * T;
  const int* epq = ep_q + (size_t)b * T;
  const int* epk = ep_k + (size_t)b * T;
  float qf[KD][4], df[KD][4];
  load_frag<HD>(qf, q + base * HD, w0, T, lane);
  load_frag<HD>(df, dout + base * HD, w0, T, lane);
  int eq[2];
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = t[r] < T;
    eq[r] = live ? epq[t[r]] : 0;
    lse_r[r] = live ? lse[base + t[r]] : 0.0f;
    dsum_r[r] = live ? dsum[base + t[r]] : 0.0f;
  }
  int lo, hi;
  id_range(epq, r0, min(T, r0 + ROWS), lo, hi);
  const int n_keys = rel < 0 ? T : rel == 0 ? min(T, r0 + ROWS) : 0;
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  float* gs = fsm + ks * S::NSTAGE * S::STAGE;
  float acc[KD][4] = {};
  walk_tiles<S::NSTAGE, KS>(
      list, flag, &n_list, epk, T, 0, n_tiles, lo, hi, ks,
      S::GT,
      [&](int j, int buf) {
        float* st = gs + buf * S::STAGE;
        stage_f32<HD>(st, k + base * HD, j * TILE, T, gt, S::GT);
        stage_f32<HD>(st + TILE * LD, v + base * HD, j * TILE, T, gt,
                      S::GT);
        stage_vec(reinterpret_cast<int*>(st + 2 * TILE * LD), epk,
                      j * TILE, T, gt, S::GT);
      },
      [&](int j, int buf) {
        const float* st = gs + buf * S::STAGE;
        const int* eks = reinterpret_cast<const int*>(st + 2 * TILE * LD);
        const int k0 = j * TILE;
#pragma unroll 1
        for (int h = 0; h < 8 / SUB; ++h) {   // 8 SUB keys at a time
          float s[SUB][4], dp[SUB][4];
          scores_f32<HD, SUB>(s, qf, st, 8 * SUB * h, lane);
          scores_f32<HD, SUB>(dp, df, st + TILE * LD, 8 * SUB * h, lane);
#pragma unroll
          for (int n = 0; n < SUB; ++n) {
            const int kk = 8 * SUB * h + 8 * n + c2;
            const int2 ek = *reinterpret_cast<const int2*>(&eks[kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, sk = k0 + kk + (e & 1);
              const bool valid = t[r] < T && sk < T &&
                                 (rel < 0 || sk <= t[r]) &&
                                 ((e & 1) ? ek.y : ek.x) == eq[r];
              const float w =
                  valid ? expf(s[n][e] * scale - lse_r[r]) : 0.0f;
              s[n][e] = w * (dp[n][e] - dsum_r[r]) * scale;   // ds
            }
          }
          accumulate_f32<HD, SUB>(acc, s, st, 8 * SUB * h, lane);
        }
      });
  float x[4 * KD];
#pragma unroll
  for (int i = 0; i < 4 * KD; ++i) x[i] = acc[i / 4][i % 4];
  merge_sums<KS, 4 * KD>(fsm, x, ks, rg, lane);
  if (ks > 0) return;
#pragma unroll
  for (int i = 0; i < 4 * KD; ++i) acc[i / 4][i % 4] = x[i];
  store_f32<HD>(dq + base * HD, acc, t, T, lane);
}

template <int HD>
__global__ void __launch_bounds__(F32<HD>::THREADS)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ ep_q,
              const int* __restrict__ ep_k, const float* __restrict__ dout,
              const float* __restrict__ dsum, const float* __restrict__ lse,
              float* __restrict__ dk, float* __restrict__ dv, int BH, int H,
              int T, int rel, float scale) {
  using S = F32<HD>;
  constexpr int LD = S::LD, KD = S::KD, KS = S::KS, SUB = S::SUB;
  extern __shared__ __align__(16) float fsm[];
  __shared__ int list[WIN];
  __shared__ unsigned char flag[WIN];
  __shared__ int n_list;
  // the first key tiles first: the most queries see them
  const int blk = (int)blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % F32_RG, ks = warp / F32_RG, c2 = 2 * (lane & 3);
  const int gt = threadIdx.x - ks * S::GT;
  const int r0 = blk * ROWS, w0 = r0 + 16 * rg;
  const int s[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};   // my keys
  const size_t base = (size_t)bh * T;
  const int* epq = ep_q + (size_t)b * T;
  const int* epk = ep_k + (size_t)b * T;
  float kf[KD][4], vf[KD][4];
  load_frag<HD>(kf, k + base * HD, w0, T, lane);
  load_frag<HD>(vf, v + base * HD, w0, T, lane);
  const int ek[2] = {s[0] < T ? epk[s[0]] : 0, s[1] < T ? epk[s[1]] : 0};
  int lo, hi;
  id_range(epk, r0, min(T, r0 + ROWS), lo, hi);
  // every query before the block, the block's first key on, or none
  const int q_start = rel < 0 ? 0 : rel == 0 ? r0 : T;
  const int n_tiles = (T - q_start + TILE - 1) / TILE;
  float* gs = fsm + ks * S::NSTAGE * S::STAGE;
  float dka[KD][4] = {}, dva[KD][4] = {};
  walk_tiles<S::NSTAGE, KS>(
      list, flag, &n_list, epq, T, q_start, n_tiles, lo, hi, ks,
      S::GT,
      [&](int j, int buf) {
        const int q0 = q_start + j * TILE;
        float* st = gs + buf * S::STAGE;
        float* vec = st + 2 * TILE * LD;
        stage_f32<HD>(st, q + base * HD, q0, T, gt, S::GT);
        stage_f32<HD>(st + TILE * LD, dout + base * HD, q0, T, gt, S::GT);
        stage_vec(vec, lse + base, q0, T, gt, S::GT);
        stage_vec(vec + TILE, dsum + base, q0, T, gt, S::GT);
        stage_vec(reinterpret_cast<int*>(vec + 2 * TILE), epq, q0, T,
                      gt, S::GT);
      },
      [&](int j, int buf) {
        const int q0 = q_start + j * TILE;
        const float* st = gs + buf * S::STAGE;
        const float* vec = st + 2 * TILE * LD;
        const int* eqs = reinterpret_cast<const int*>(vec + 2 * TILE);
#pragma unroll 1
        for (int h = 0; h < 8 / SUB; ++h) {   // 8 SUB queries at a time
          float st_[SUB][4], dpt[SUB][4];   // keys x queries
          scores_f32<HD, SUB>(st_, kf, st, 8 * SUB * h, lane);
          scores_f32<HD, SUB>(dpt, vf, st + TILE * LD, 8 * SUB * h, lane);
#pragma unroll
          for (int n = 0; n < SUB; ++n) {
            const int qq = 8 * SUB * h + 8 * n + c2;
            const int2 eqq = *reinterpret_cast<const int2*>(&eqs[qq]);
            const float2 lq = *reinterpret_cast<const float2*>(&vec[qq]);
            const float2 dsq =
                *reinterpret_cast<const float2*>(&vec[TILE + qq]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, tq = q0 + qq + (e & 1);
              const bool valid = s[r] < T && tq < T &&
                                 (rel < 0 || s[r] <= tq) &&
                                 ((e & 1) ? eqq.y : eqq.x) == ek[r];
              const float w =
                  valid ? expf(st_[n][e] * scale - ((e & 1) ? lq.y : lq.x))
                        : 0.0f;
              st_[n][e] = w * (dpt[n][e] - ((e & 1) ? dsq.y : dsq.x)) *
                          scale;   // ds
              dpt[n][e] = w;
            }
          }
          accumulate_f32<HD, SUB>(dka, st_, st, 8 * SUB * h, lane);
          accumulate_f32<HD, SUB>(dva, dpt, st + TILE * LD, 8 * SUB * h,
                                  lane);
        }
      });
  float x[8 * KD];
#pragma unroll
  for (int i = 0; i < 4 * KD; ++i) {
    x[i] = dka[i / 4][i % 4];
    x[4 * KD + i] = dva[i / 4][i % 4];
  }
  merge_sums<KS, 8 * KD>(fsm, x, ks, rg, lane);
  if (ks > 0) return;
#pragma unroll
  for (int i = 0; i < 4 * KD; ++i) {
    dka[i / 4][i % 4] = x[i];
    dva[i / 4][i % 4] = x[4 * KD + i];
  }
  store_f32<HD>(dk + base * HD, dka, s, T, lane);
  store_f32<HD>(dv + base * HD, dva, s, T, lane);
}

// --- the bf16 variant: warp tiles on the tensor cores ---------------------

template <int HD>
struct Bf {
  static constexpr int LD = HD == 8 ? 8 : HD + 8;    // a staged row, bf16
  static constexpr int KD = HD == 8 ? 1 : HD / 16;   // k-steps over hd
  static constexpr int ND = HD / 8;                  // n-tiles of hd columns
  static constexpr int ROWS = 16 * BF16_WARPS;       // own rows a block
  static constexpr int THREADS = 32 * BF16_WARPS;
};

// Starts copying rows [r0, r0 + TILE) of a [T, HD] bf16 matrix into dst
// ([TILE][LD]), zeros past T.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, int T) {
  constexpr int CH = HD / 8;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < TILE * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < T;
    cp16(dst + r * Bf<HD>::LD + c * 8,
         src + (size_t)(ok ? r0 + r : 0) * HD + c * 8, ok);
  }
}

// This lane's A fragments of rows [r, r + 16) of a [T, HD] bf16 matrix
// (zeros past T): at hd 8 the m16n8k8 shape's two registers, else KD
// m16n8k16 k-steps.  Lane l holds rows r + l / 4 and r + l / 4 + 8.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[Bf<HD>::KD][4],
                                       const bf16* __restrict__ x, int r,
                                       int T, int lane) {
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  const int r1 = r + (lane >> 2), r2 = r1 + 8, c = 2 * (lane & 3);
  const auto at = [&](int row, int col) {
    return row < T ? x32[((size_t)row * HD + col) / 2] : 0u;
  };
#pragma unroll
  for (int d = 0; d < Bf<HD>::KD; ++d) {
    a[d][0] = at(r1, 16 * d + c);
    a[d][1] = at(r2, 16 * d + c);
    a[d][2] = HD == 8 ? 0u : at(r1, 16 * d + 8 + c);
    a[d][3] = HD == 8 ? 0u : at(r2, 16 * d + 8 + c);
  }
}

// s[j] = A . B^T for NT n-tiles of 8 rows of bs from row n0: bs is a staged
// [TILE][LD] tile of rows by hd (keys, or queries), read with ldmatrix as
// the col-major B operand; A is 16 rows by hd in registers.  Past hd 16 the
// hd k-steps chain in one sum, which mma.sync rounds toward zero at each
// step: at hd 64 the scores' four steps lean every output a little toward
// zero (chip_smoke.py holds that lean, LEAN_TOL).  Summing each step from
// zero costs dq a block of occupancy at hd 64 (more registers).
template <int HD, int NT>
__device__ __forceinline__ void dot_rows(float (&s)[NT][4],
                                         const uint32_t (&a)[Bf<HD>::KD][4],
                                         const bf16* bs, int n0, int lane) {
  constexpr int LD = Bf<HD>::LD;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  if constexpr (HD == 8) {
#pragma unroll
    for (int c = 0; c < NT / 4; ++c) {
      uint32_t b[4];
      ldsm_x4(b, bs + (n0 + 32 * c + lane) * LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_bf16_k8(s[4 * c + i], a[0][0], a[0][1], b[i]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p)
#pragma unroll
      for (int d = 0; d < Bf<HD>::KD; ++d) {
        uint32_t b[4];
        ldsm_x4(b, bs + (n0 + 16 * p + (lane & 7) + (lane >> 4) * 8) * LD +
                       16 * d + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], a[d], b[0], b[1]);
        mma_bf16(s[2 * p + 1], a[d], b[2], b[3]);
      }
  }
}

// o += A . bs[k0, k0 + 16 KS): bs is a staged tile of rows by hd, read with
// ldmatrix.trans as the row-major B operand (k along its rows); A is 16
// rows by 16 KS in registers.  The KS k-steps are summed from zero and the
// partial is added to o in float32 (round to nearest): mma.sync rounds its
// sums toward zero, so chaining every k-step into the running sum over up
// to T keys would shrink it a little each step, and the bf16 roundings
// downstream would all lean one way.  Within the partial the KS (at most
// 4) steps still chain.
template <int HD, int KS>
__device__ __forceinline__ void acc_rows(float (&o)[Bf<HD>::ND][4],
                                         const uint32_t (&a)[KS][4],
                                         const bf16* bs, int k0, int lane) {
  constexpr int LD = Bf<HD>::LD, ND = Bf<HD>::ND;
  float part[ND][4] = {};
  if constexpr (HD == 8) {
#pragma unroll
    for (int c = 0; c < KS / 2; ++c) {
      uint32_t b[4];
      ldsm_x4_t(b, bs + (k0 + 32 * c + lane) * LD);
      mma_bf16(part[0], a[2 * c], b[0], b[1]);
      mma_bf16(part[0], a[2 * c + 1], b[2], b[3]);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, bs + (k0 + 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             LD + 16 * p + (lane >> 4) * 8);
        mma_bf16(part[2 * p], a[ks], b[0], b[1]);
        mma_bf16(part[2 * p + 1], a[ks], b[2], b[3]);
      }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += part[n][e];
}

// The A fragments (16 rows by 4 NT columns) of NT n-tiles of float32
// accumulators, each rounded to bf16 (nearest even): one product's output
// becomes the next one's operand in registers.
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4],
                                     const float (&x)[NT][4]) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    a[ks][0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    a[ks][1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    a[ks][2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
  }
}

// Writes this lane's part of a warp's 16 x HD accumulator as bf16: row[r]
// takes elements 2r and 2r + 1 of each n-tile (rows past T are not written).
template <int HD>
__device__ __forceinline__ void store_bf16(bf16* __restrict__ x,
                                           const float (&o)[Bf<HD>::ND][4],
                                           const int (&row)[2], int T,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    uint32_t* xr = reinterpret_cast<uint32_t*>(x + (size_t)row[r] * HD +
                                               2 * (lane & 3));
#pragma unroll
    for (int n = 0; n < Bf<HD>::ND; ++n)
      xr[4 * n] = pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(Bf<HD>::THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ ep_q,
               const int* __restrict__ ep_k, float* __restrict__ out,
               float* __restrict__ lse, int BH, int H, int T, int rel,
               float scale) {
  constexpr int LD = Bf<HD>::LD, ND = Bf<HD>::ND, R = Bf<HD>::ROWS;
  __shared__ __align__(16) bf16 ks[2][TILE * LD];
  __shared__ __align__(16) bf16 vs[2][TILE * LD];
  __shared__ __align__(16) int eks[2][TILE];
  __shared__ int list[WIN];
  __shared__ unsigned char flag[WIN];
  __shared__ int n_list;
  // the last query tiles first: they see the most keys
  const int blk = (T + R - 1) / R - 1 - (int)blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / H;
  const int lane = threadIdx.x & 31, c2 = 2 * (lane & 3);
  const int r0 = blk * R, w0 = r0 + 16 * (int)(threadIdx.x >> 5);
  const int t[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};   // my rows
  const size_t base = (size_t)bh * T;
  const int* epq = ep_q + (size_t)b * T;
  const int* epk = ep_k + (size_t)b * T;
  uint32_t qa[Bf<HD>::KD][4];
  load_a<HD>(qa, q + base * HD, w0, T, lane);
  const int eq[2] = {t[0] < T ? epq[t[0]] : 0, t[1] < T ? epq[t[1]] : 0};
  int lo, hi, w_id, w_hi;
  id_range(epq, r0, min(T, r0 + R), lo, hi);
  id_range(epq, w0, min(T, w0 + 16), w_id, w_hi);   // this warp's rows
  const bool w_one = w_id == w_hi;
  const int n_keys = rel < 0 ? T : rel == 0 ? min(T, r0 + R) : 0;
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  float o[ND][4] = {}, m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  walk_tiles<2, 1>(
      list, flag, &n_list, epk, T, 0, n_tiles, lo, hi, 0, blockDim.x,
      [&](int j, int buf) {
        stage_rows<HD>(ks[buf], k + base * HD, j * TILE, T);
        stage_rows<HD>(vs[buf], v + base * HD, j * TILE, T);
        stage_vec(eks[buf], epk, j * TILE, T, threadIdx.x, blockDim.x);
      },
      [&](int j, int buf) {
        const int k0 = j * TILE;
        float s[8][4];
        dot_rows<HD, 8>(s, qa, ks[buf], 0, lane);
        // a tile where every pair of the warp's rows is valid (one episode
        // over the keys and the rows, every key before every row, none past
        // T: the path's common case) skips the per-pair test
        const int e0 = eks[buf][lane], e1 = eks[buf][lane + 32];
        const int tlo = __reduce_min_sync(FULL, min(e0, e1));
        const int thi = __reduce_max_sync(FULL, max(e0, e1));
        const bool full = w_one && tlo == w_id && thi == w_id &&
                          k0 + TILE <= T && w0 + 16 <= T &&
                          (rel < 0 || k0 + TILE <= w0 + 1);
        if (full) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] *= scale;
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int kk = 8 * n + c2;
            const int2 ek = *reinterpret_cast<const int2*>(&eks[buf][kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, sk = k0 + kk + (e & 1);
              const bool valid = t[r] < T && sk < T &&
                                 (rel < 0 || sk <= t[r]) &&
                                 ((e & 1) ? ek.y : ek.x) == eq[r];
              s[n][e] = valid ? s[n][e] * scale : NEG;
            }
          }
        }
        float cmax[2], alpha[2], psum[2];
        row_reduce(cmax, s, [](float x, float y) { return fmaxf(x, y); });
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // the row's max over its quad
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(FULL, cmax[r], 1));
          cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(FULL, cmax[r], 2));
          const float m2 = fmaxf(m[r], cmax[r]);
          alpha[r] = expf(m[r] - m2);
          m[r] = m2;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // an invalid pair's NEG gives exp(NEG - m2) = 0 once the row has
            // a valid key; before that (m2 still NEG) p is set to 0, or a
            // row with no valid key would get exp(NEG - NEG) = 1
            // (pallas_attn.py:143-147)
            const float mr = m[e >> 1];
            s[n][e] = mr == NEG ? 0.0f : expf(s[n][e] - mr);
          }
        row_reduce(psum, s, [](float x, float y) { return x + y; });
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        uint32_t pa[4][4];
        to_a<8>(pa, s);   // p rounded to bf16 for P.V; l took p itself
        acc_rows<HD, 4>(o, pa, vs[buf], 0, lane);
      });
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // each lane summed its columns of the row
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (t[r] >= T) continue;
    const float l_safe = l[r] == 0.0f ? 1.0f : l[r];
    float* ob = out + (base + t[r]) * HD + c2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(ob + 8 * n) =
          make_float2(o[n][2 * r] / l_safe, o[n][2 * r + 1] / l_safe);
    if (c2 == 0) lse[base + t[r]] = m[r] + logf(l_safe);
  }
}

template <int HD>
__global__ void __launch_bounds__(Bf<HD>::THREADS)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ ep_q,
                  const int* __restrict__ ep_k,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ dsum,
                  const float* __restrict__ lse, bf16* __restrict__ dq,
                  int BH, int H, int T, int rel, float scale) {
  constexpr int LD = Bf<HD>::LD, ND = Bf<HD>::ND, R = Bf<HD>::ROWS;
  __shared__ __align__(16) bf16 ks[2][TILE * LD];
  __shared__ __align__(16) bf16 vs[2][TILE * LD];
  __shared__ __align__(16) int eks[2][TILE];
  __shared__ int list[WIN];
  __shared__ unsigned char flag[WIN];
  __shared__ int n_list;
  const int blk = (T + R - 1) / R - 1 - (int)blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / H;
  const int lane = threadIdx.x & 31, c2 = 2 * (lane & 3);
  const int r0 = blk * R, w0 = r0 + 16 * (int)(threadIdx.x >> 5);
  const int t[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const size_t base = (size_t)bh * T;
  const int* epq = ep_q + (size_t)b * T;
  const int* epk = ep_k + (size_t)b * T;
  uint32_t qa[Bf<HD>::KD][4], da[Bf<HD>::KD][4];
  load_a<HD>(qa, q + base * HD, w0, T, lane);
  load_a<HD>(da, dout + base * HD, w0, T, lane);
  int eq[2];
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = t[r] < T;
    eq[r] = live ? epq[t[r]] : 0;
    lse_r[r] = live ? lse[base + t[r]] : 0.0f;
    dsum_r[r] = live ? dsum[base + t[r]] : 0.0f;
  }
  int lo, hi;
  id_range(epq, r0, min(T, r0 + R), lo, hi);
  const int n_keys = rel < 0 ? T : rel == 0 ? min(T, r0 + R) : 0;
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  float acc[ND][4] = {};
  walk_tiles<2, 1>(
      list, flag, &n_list, epk, T, 0, n_tiles, lo, hi, 0, blockDim.x,
      [&](int j, int buf) {
        stage_rows<HD>(ks[buf], k + base * HD, j * TILE, T);
        stage_rows<HD>(vs[buf], v + base * HD, j * TILE, T);
        stage_vec(eks[buf], epk, j * TILE, T, threadIdx.x, blockDim.x);
      },
      [&](int j, int buf) {
        const int k0 = j * TILE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // 32 keys at a time
          float s[4][4], dp[4][4];
          dot_rows<HD, 4>(s, qa, ks[buf], 32 * h, lane);
          dot_rows<HD, 4>(dp, da, vs[buf], 32 * h, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int kk = 32 * h + 8 * n + c2;
            const int2 ek = *reinterpret_cast<const int2*>(&eks[buf][kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, sk = k0 + kk + (e & 1);
              const bool valid = t[r] < T && sk < T &&
                                 (rel < 0 || sk <= t[r]) &&
                                 ((e & 1) ? ek.y : ek.x) == eq[r];
              const float w =
                  valid ? expf(s[n][e] * scale - lse_r[r]) : 0.0f;
              s[n][e] = w * (dp[n][e] - dsum_r[r]) * scale;   // ds
            }
          }
          uint32_t dsa[2][4];
          to_a<4>(dsa, s);   // ds rounded to bf16 for dq = ds.k
          acc_rows<HD, 2>(acc, dsa, ks[buf], 32 * h, lane);
        }
      });
  store_bf16<HD>(dq + base * HD, acc, t, T, lane);
}

template <int HD>
__global__ void __launch_bounds__(Bf<HD>::THREADS)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ ep_q,
                   const int* __restrict__ ep_k,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ dsum,
                   const float* __restrict__ lse, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int BH, int H, int T, int rel,
                   float scale) {
  constexpr int LD = Bf<HD>::LD, ND = Bf<HD>::ND, R = Bf<HD>::ROWS;
  __shared__ __align__(16) bf16 qs[2][TILE * LD];
  __shared__ __align__(16) bf16 dos[2][TILE * LD];
  __shared__ __align__(16) float lses[2][TILE];
  __shared__ __align__(16) float dsums[2][TILE];
  __shared__ __align__(16) int eqs[2][TILE];
  __shared__ int list[WIN];
  __shared__ unsigned char flag[WIN];
  __shared__ int n_list;
  // the first key tiles first: the most queries see them
  const int blk = (int)blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / H;
  const int lane = threadIdx.x & 31, c2 = 2 * (lane & 3);
  const int r0 = blk * R, w0 = r0 + 16 * (int)(threadIdx.x >> 5);
  const int s[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};   // my keys
  const size_t base = (size_t)bh * T;
  const int* epq = ep_q + (size_t)b * T;
  const int* epk = ep_k + (size_t)b * T;
  uint32_t ka[Bf<HD>::KD][4], va[Bf<HD>::KD][4];
  load_a<HD>(ka, k + base * HD, w0, T, lane);
  load_a<HD>(va, v + base * HD, w0, T, lane);
  const int ek[2] = {s[0] < T ? epk[s[0]] : 0, s[1] < T ? epk[s[1]] : 0};
  int lo, hi;
  id_range(epk, r0, min(T, r0 + R), lo, hi);
  // every query before the block, the block's first key on, or none
  const int q_start = rel < 0 ? 0 : rel == 0 ? r0 : T;
  const int n_tiles = (T - q_start + TILE - 1) / TILE;
  float dka[ND][4] = {}, dva[ND][4] = {};
  walk_tiles<2, 1>(
      list, flag, &n_list, epq, T, q_start, n_tiles, lo, hi, 0, blockDim.x,
      [&](int j, int buf) {
        const int q0 = q_start + j * TILE;
        stage_rows<HD>(qs[buf], q + base * HD, q0, T);
        stage_rows<HD>(dos[buf], dout + base * HD, q0, T);
        stage_vec(lses[buf], lse + base, q0, T, threadIdx.x, blockDim.x);
        stage_vec(dsums[buf], dsum + base, q0, T, threadIdx.x, blockDim.x);
        stage_vec(eqs[buf], epq, q0, T, threadIdx.x, blockDim.x);
      },
      [&](int j, int buf) {
        const int q0 = q_start + j * TILE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // 32 queries at a time
          float st[4][4], dpt[4][4], w[4][4];   // keys x queries
          dot_rows<HD, 4>(st, ka, qs[buf], 32 * h, lane);
          dot_rows<HD, 4>(dpt, va, dos[buf], 32 * h, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int qq = 32 * h + 8 * n + c2;
            const int2 eqq = *reinterpret_cast<const int2*>(&eqs[buf][qq]);
            const float2 lq = *reinterpret_cast<const float2*>(&lses[buf][qq]);
            const float2 dsq =
                *reinterpret_cast<const float2*>(&dsums[buf][qq]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, tq = q0 + qq + (e & 1);
              const bool valid = s[r] < T && tq < T &&
                                 (rel < 0 || s[r] <= tq) &&
                                 ((e & 1) ? eqq.y : eqq.x) == ek[r];
              const float wv =
                  valid ? expf(st[n][e] * scale - ((e & 1) ? lq.y : lq.x))
                        : 0.0f;
              st[n][e] = wv * (dpt[n][e] - ((e & 1) ? dsq.y : dsq.x)) *
                         scale;   // ds
              w[n][e] = wv;
            }
          }
          uint32_t dsa[2][4], wa[2][4];
          to_a<4>(dsa, st);   // ds^T and w^T rounded to bf16
          to_a<4>(wa, w);
          acc_rows<HD, 2>(dka, dsa, qs[buf], 32 * h, lane);
          acc_rows<HD, 2>(dva, wa, dos[buf], 32 * h, lane);
        }
      });
  store_bf16<HD>(dk + base * HD, dka, s, T, lane);
  store_bf16<HD>(dv + base * HD, dva, s, T, lane);
}

// --- launches ------------------------------------------------------------

// Blocks of `rows` rows over BH rows of T, or 0 when the grid would not fit
// an int (the entries refuse it).
inline unsigned grid_of(int T, int rows, int BH) {
  const long long n = (long long)((T + rows - 1) / rows) * BH;
  return n > INT_MAX ? 0u : (unsigned)n;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

#define PPOC_HD_SWITCH(hd, CALL)          \
  switch (hd) {                           \
    case 8: CALL(8); break;               \
    case 16: CALL(16); break;             \
    case 32: CALL(32); break;             \
    case 64: CALL(64); break;             \
    default: return (int)cudaErrorInvalidValue; \
  }                                       \
  return (int)cudaGetLastError();

inline bool bad_shape(int BH, int H, int T) {
  return BH < 1 || H < 1 || T < 1 || grid_of(T, 16, BH) == 0u;
}

}  // namespace

// f32 q, k, v, dout and gradients; q, k, v and dout 16-byte aligned
// (cp.async).  The launch: ROWS own rows a block, F32<HD>::THREADS threads,
// F32<HD>::SMEM bytes of dynamic shared memory.
#define PPOC_F32_LAUNCH(KERNEL, HD, ...)                                  \
  {                                                                       \
    const cudaError_t err = cudaFuncSetAttribute(                         \
        KERNEL<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,          \
        F32<HD>::SMEM);                                                   \
    if (err != cudaSuccess) return (int)err;                              \
    KERNEL<HD><<<grid_of(T, ROWS, BH), F32<HD>::THREADS, F32<HD>::SMEM,   \
                 (cudaStream_t)stream>>>(__VA_ARGS__);                    \
  }

extern "C" int ppoc_flash_fwd(const float* q, const float* k, const float* v,
                              const int* ep_q, const int* ep_k, float* out,
                              float* lse, int BH, int H, int T, int hd,
                              int rel, float scale, void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v)))
    return (int)cudaErrorMisalignedAddress;
#define CALL(HD)                                                        \
  PPOC_F32_LAUNCH(flash_fwd, HD, q, k, v, ep_q, ep_k, out, lse, BH, H, T, \
                  rel, scale)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

extern "C" int ppoc_flash_bwd_dq(const float* q, const float* k,
                                 const float* v, const int* ep_q,
                                 const int* ep_k, const float* dout,
                                 const float* dsum, const float* lse,
                                 float* dq, int BH, int H, int T, int hd,
                                 int rel, float scale, void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return (int)cudaErrorMisalignedAddress;
#define CALL(HD)                                                           \
  PPOC_F32_LAUNCH(flash_bwd_dq, HD, q, k, v, ep_q, ep_k, dout, dsum, lse, \
                  dq, BH, H, T, rel, scale)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

extern "C" int ppoc_flash_bwd_dkv(const float* q, const float* k,
                                  const float* v, const int* ep_q,
                                  const int* ep_k, const float* dout,
                                  const float* dsum, const float* lse,
                                  float* dk, float* dv, int BH, int H, int T,
                                  int hd, int rel, float scale,
                                  void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return (int)cudaErrorMisalignedAddress;
#define CALL(HD)                                                            \
  PPOC_F32_LAUNCH(flash_bwd_dkv, HD, q, k, v, ep_q, ep_k, dout, dsum, lse, \
                  dk, dv, BH, H, T, rel, scale)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

// bf16 q, k, v, dout and gradients (out, lse, dsum stay f32); q, k, v and
// dout 16-byte aligned (cp.async)
extern "C" int ppoc_flash_fwd_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, const int* ep_q,
                                   const int* ep_k, float* out, float* lse,
                                   int BH, int H, int T, int hd, int rel,
                                   float scale, void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v)))
    return (int)cudaErrorMisalignedAddress;
#define CALL(HD)                                                        \
  flash_fwd_bf16<HD>                                                    \
      <<<grid_of(T, Bf<HD>::ROWS, BH), Bf<HD>::THREADS, 0,              \
         (cudaStream_t)stream>>>(q, k, v, ep_q, ep_k, out, lse, BH, H, T, \
                                 rel, scale)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

extern "C" int ppoc_flash_bwd_dq_bf16(const bf16* q, const bf16* k,
                                      const bf16* v, const int* ep_q,
                                      const int* ep_k, const bf16* dout,
                                      const float* dsum, const float* lse,
                                      bf16* dq, int BH, int H, int T, int hd,
                                      int rel, float scale, void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return (int)cudaErrorMisalignedAddress;
#define CALL(HD)                                                      \
  flash_bwd_dq_bf16<HD>                                               \
      <<<grid_of(T, Bf<HD>::ROWS, BH), Bf<HD>::THREADS, 0,            \
         (cudaStream_t)stream>>>(q, k, v, ep_q, ep_k, dout, dsum, lse, \
                                 dq, BH, H, T, rel, scale)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

extern "C" int ppoc_flash_bwd_dkv_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, const int* ep_q,
                                       const int* ep_k, const bf16* dout,
                                       const float* dsum, const float* lse,
                                       bf16* dk, bf16* dv, int BH, int H,
                                       int T, int hd, int rel, float scale,
                                       void* stream) {
  if (bad_shape(BH, H, T)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return (int)cudaErrorMisalignedAddress;
#define CALL(HD)                                                      \
  flash_bwd_dkv_bf16<HD>                                              \
      <<<grid_of(T, Bf<HD>::ROWS, BH), Bf<HD>::THREADS, 0,            \
         (cudaStream_t)stream>>>(q, k, v, ep_q, ep_k, dout, dsum, lse, \
                                 dk, dv, BH, H, T, rel, scale)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

// K3 bf16 and K4 bf16: the large-minibatch (throughput) value and Gaussian
// policy phases, every epoch x minibatch step in one cooperative launch.
//
// Replaces ppoc_tpu/ops/pallas_update.py `value_phase_fused(..., bf16=True)`
// -> `_run_value_phase` -> `_value_kernel(..., bf16=True)` (K3 bf16) and
// `policy_phase_fused(..., bf16=True)` -> `_policy_kernel(..., bf16=True)`
// (K4 bf16).  What they compute per step: every product on bf16 operands
// with float32 accumulation (each layer's input and W rounded to bf16); the
// hidden post-activations stored rounded to bf16, the last layer's output
// float32; the loss gradient in float32 as K3/K4 take it; backward with the
// cotangent rounded to bf16 before both dW = a_in^T g and dX = g W^T, the
// activation derivative from the bf16-stored post-activation, db summed from
// the float32 cotangent; float32 gradient sums, then Adam on float32 master
// weights and moments (K4: and log_std's own Adam).
//
// What bounds it on the card: operations.  A step of the reacher regime's
// value phase is 6 x 16384 rows x 68,352 multiply-adds, 6.7 GFLOP, 6.8 us
// at the bf16 tensor cores' 989 TFLOP/s; its parameters are 0.28 MB.  The
// steps are serial through Adam, so each step is spread over the card, and
// what a step costs beyond its products is the gradient's traffic between
// the blocks and the grid's barriers.
//
// What the design does about it: one persistent cooperative grid in
// thread-block clusters (the plan takes, of 16, 8, 4, 2 and 1 blocks, the
// largest cluster whose co-resident grid, by the occupancy query, runs
// every row tile in the fewest rounds with the fewest blocks; a grid that
// does not fit at once is refused, never shrunk).  Each block owns R rows of the minibatch (R =
// 128 where shared memory allows, else 64, 32 or 16) and per step runs,
// out of shared memory, the forward, the loss gradient and the backward of
// its rows:
// - The hidden layers' products are wgmma.mma_async m64nNk16 (wgmma.cuh)
//   from shared memory: two consumer warpgroups of 64 rows each (one where
//   R <= 64), the accumulators of a 256-wide layer one n256 chain.  Every
//   operand lives in the 128-byte-swizzled image wgmma reads: the
//   activations [R][width] (the forward's A, dW's A^T and B, dX's A) and
//   W (the forward's B, dX's B^T through the descriptor's transpose bit).
// - W comes from a bf16 shadow in global memory that Adam rewrites every
//   step in the image of a ring stage (64 rows x up to 256 columns, 32 KB),
//   stage by stage, so a stage is one contiguous cp.async.bulk.  A producer
//   warp keeps the next stage in flight on a two-deep mbarrier ring while
//   the consumers multiply: the forward's stages, then dX's, through one
//   ring.  In a cluster the first block's producer multicasts each stage
//   to every block once all of them have freed its slot, so L2 serves it
//   once a cluster.
// - The head (the last layer, 1 or k <= 8 outputs) multiplies on the
//   tensor cores too (m64n16, its 16 columns in the 32-byte swizzle); the
//   loss gradient runs on the CUDA cores.
// - The block writes its dW/db partial to a global scratch in the
//   parameters' layout, two columns a store (whole 32-byte sectors).
//   After a grid barrier each block sums a slice of the parameters over
//   the blocks' partials in a fixed two-level order (16 groups of
//   ceil(G / 16) blocks in block order, then the groups in order; a
//   warp's load 512 contiguous bytes), runs Adam on it and writes the
//   float32 master and the shadow; a second barrier; the next step.
// The grid barrier is written by hand over a global counter, since the
// producer warp takes no part in it; the cooperative launch proves every
// block co-resident.  No launch happens between steps and every sum is
// taken in a fixed order, so two launches on the same inputs give the
// same bits, and so does a phase split over two launches (t0 carried).
// Everything another block wrote during the launch is read at L2 (__ldcg,
// or a bulk copy after a proxy fence), never through L1 or the read-only
// cache.
#include <cuda_bf16.h>

#include "cluster.cuh"
#include "wgmma.cuh"

using namespace ppoc;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_ROWS = 128;
constexpr int MAX_WIDTH = 512;           // widest layer taken
constexpr int SLICE = 64;                // W rows a ring stage
constexpr int CHUNK = 256;               // W columns a ring stage, at most
constexpr int STAGES = 2;                // the ring's depth
constexpr int GROUPS = 16;               // the partial sum's first level
constexpr int STAT = 16;                 // floats of a block's statistics
constexpr int STATIC_SMEM = 1024;        // static shared memory, rounded up
constexpr int ALIGN = 1024;              // the swizzle's period
constexpr int BAR_CONSUMERS = 1;         // named barriers: all consumers,
constexpr int BAR_WG = 2;                // then warpgroup 0 and 1

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int pad64(int n) { return (n + 63) & ~63; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Layout {
  Net net;
  int rows;                    // R
  int w64[MAX_LAYERS + 1];     // layer l's input width, rounded up to 64
  int act_off[MAX_LAYERS];     // layer l's input image, [R][w64[l]]
  int img_rows[MAX_LAYERS];    // W_l's image rows: pad16(d0), then w64
  long img_off[MAX_LAYERS];    // W_l's image in the shadow, bytes
  long shadow_bytes;
  int ring_off, stage_bytes;   // the ring: STAGES x stage_bytes
  int out_off;                 // the head's output, then g_L: [R][dL] float
  int gl_off;                  // g_L rounded to bf16: [R][16] image (32-byte
                               // swizzle), zero past dL
  int wl_off;                  // W_L rounded to bf16: [w64_{L-1}][16] image
                               // (32-byte swizzle), zero past its widths
  int bias_off;                // the hidden layers' b, each w64 floats
  int hb[MAX_LAYERS];          // b_l's first float there
  int csum_off;                // dX's column sums: [8 warps][64] float
  int sums_off;                // Adam's group sums: [16][64] float4 (the
                               // ring's, where it is large enough)
  int smem;                    // dynamic shared memory, with ALIGN slack
};

// A ring stage of hidden layer l: W_l's rows [64 is, + rs) and columns
// [256 jc, + nc); the stages of a layer lie in the shadow by jc, then is.
struct Stage {
  long off;
  int rs, nc;
};

__host__ __device__ inline Stage stage_of(const Layout& L, int l, int jc,
                                          int is) {
  const int nc = min(CHUNK, L.w64[l + 1] - CHUNK * jc);
  return {L.img_off[l] + (long)jc * L.img_rows[l] * CHUNK * 2 +
              (long)is * SLICE * nc * 2,
          min(SLICE, L.img_rows[l] - SLICE * is), nc};
}

// The layout for R rows; false if the net is out of range.
inline bool make_layout(Layout* L, int n_layers, const int* dims, int rows) {
  if (!make_net(&L->net, n_layers, dims)) return false;
  for (int l = 0; l <= n_layers; ++l)
    if (dims[l] > MAX_WIDTH) return false;
  if (dims[n_layers] > MAX_ACT) return false;   // the head's outputs
  L->rows = rows;
  int off = 0, stage = 0;
  long sh = 0;
  for (int l = 0; l < n_layers; ++l) {
    L->w64[l] = pad64(dims[l]);
    L->act_off[l] = off;
    off += L->w64[l] / 64 * rows * 128;
    L->img_rows[l] = l == 0 ? pad16(dims[0]) : L->w64[l];
  }
  for (int l = 0; l + 1 < n_layers; ++l) {   // the hidden layers' W
    L->img_off[l] = sh;
    sh += (long)L->img_rows[l] * pad64(dims[l + 1]) * 2;
    const int nc = min(CHUNK, pad64(dims[l + 1]));
    stage = max(stage, min(SLICE, L->img_rows[l]) * nc * 2);
  }
  L->w64[n_layers] = pad64(dims[n_layers]);
  L->shadow_bytes = sh;
  off += rows < 64 ? (64 - rows) * 128 : 0;   // a warpgroup reads 64 rows
  L->ring_off = off;
  L->stage_bytes = stage;
  off += STAGES * stage;
  const int dl = dims[n_layers];
  L->gl_off = off;                          // 1024-aligned, as the ring
  off += (rows < 64 ? 64 : rows) * 32;      // a warpgroup reads 64 rows
  L->wl_off = off = (off + 1023) & ~1023;
  off += L->w64[n_layers - 1] * 32;
  L->out_off = off;
  off += rows * dl * 4;
  L->bias_off = off = (off + 15) & ~15;
  for (int l = 0; l + 1 < n_layers; ++l) {
    L->hb[l] = (off - L->bias_off) / 4;
    off += L->w64[l + 1] * 4;
  }
  L->csum_off = off;
  off += 8 * 64 * 4;
  if (STAGES * stage >= GROUPS * 64 * 16) {
    L->sums_off = L->ring_off;
  } else {
    L->sums_off = off = (off + 15) & ~15;
    off += GROUPS * 64 * 16;
  }
  L->smem = off + ALIGN;
  return true;
}

struct Bf16Dev {
  Layout lay;
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p, *m, *v;
  const float *ls_in, *mls_in, *vls_in;
  float *ls, *mls, *vls;
  float *partial, *bstats, *stats;
  bf16* shadow;
  unsigned* barrier;           // the grid barrier's count
  long pstride;                // floats between two blocks' partials
  int activation, n_steps, mb, t0, t0_ls, k_act, rounds, group;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

// --- the products (wgmma.cuh) --------------------------------------------
// Images of R rows: a 64-column block is R x 128 bytes (`blk`).  A
// warpgroup's rows start 64 x 128 bytes into a block.

// acc (64 rows x NC) += A (the 64 rows of image `a` at k columns
// [k0, k0 + rs) of one 64-column block) x the stage (rs rows x NC).
template <int NC>
__device__ __forceinline__ void mma_forward(float (&acc)[NC / 2],
                                            uint32_t a, uint32_t stage,
                                            int rs, bool accumulate) {
  const uint32_t lbo = rs * 128;
#pragma unroll 1
  for (int kk = 0; kk < rs; kk += 16)
    wgmma_nc<NC, 0, 1>(acc, desc(a + kk * 2, 16, 1024),
                       desc(stage + kk * 128, lbo, 1024), (2 * lbo) >> 4,
                       accumulate || kk > 0);
}

// acc (64 rows x 64) += G (image `g`, whose 64-column blocks lie `blk`
// apart, columns [0, nc)) x the stage^T (the stage's 64 rows as N, its nc
// columns as K).
__device__ __forceinline__ void mma_dx(float (&acc)[32], uint32_t g,
                                       int blk, uint32_t stage, int nc,
                                       bool accumulate) {
#pragma unroll 1
  for (int kk = 0; kk < nc; kk += 16)
    Wgmma<64>::run<0, 0, 0>(
        acc, desc(g + (kk >> 6) * blk + (kk & 63) * 2, 16, 1024),
        desc(stage + (kk >> 6) * SLICE * 128 + (kk & 63) * 2, 16, 1024),
        accumulate || kk > 0);
}

// acc (64 x NC) = A^T B over the first kr rows: A one 64-column block of an
// image, B NC columns of another (blocks `blk` apart).
template <int NC>
__device__ __forceinline__ void mma_dw(float (&acc)[NC / 2], uint32_t a,
                                       uint32_t b, int blk, int kr) {
#pragma unroll 1
  for (int r0 = 0; r0 < kr; r0 += 16)
    wgmma_nc<NC, 1, 1>(acc, desc(a + r0 * 128, blk, 1024),
                       desc(b + r0 * 128, blk, 1024), (2 * blk) >> 4,
                       r0 > 0);
}

// The fragment of warpgroup thread t: accumulator 4 j + e sits at row
// 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ int frag_row(int t, int e) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int t, int j, int e) {
  return 8 * j + 2 * (t & 3) + (e & 1);
}

// --- the block's view of shared memory ------------------------------------

// Taken by value: `blk` stays in a register through the loops.
struct Smem {
  unsigned char* base;
  const Layout* L;
  int blk;   // bytes of a 64-column block of an image: R x 128
  __device__ unsigned char* act(int l) const { return base + L->act_off[l]; }
  __device__ unsigned char* stage(int slot) const {
    return base + L->ring_off + slot * L->stage_bytes;
  }
  __device__ float* out() const { return (float*)(base + L->out_off); }
  __device__ unsigned char* gl() const { return base + L->gl_off; }
  __device__ unsigned char* wl() const { return base + L->wl_off; }
  __device__ float* bias() const { return (float*)(base + L->bias_off); }
  __device__ float* csum() const { return (float*)(base + L->csum_off); }
  // element (r, c) of an image of R rows
  __device__ bf16* at(unsigned char* img, int r, int c) const {
    return (bf16*)(img + (c >> 6) * blk + sw128(r, c & 63));
  }
};

// the dynamic shared memory from its first ALIGN-byte boundary
__device__ __forceinline__ unsigned char* aligned(unsigned char* p) {
  return p + ((ALIGN - (smem_addr(p) & (ALIGN - 1))) & (ALIGN - 1));
}

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* cluster_empty;   // the cluster's first block: every block's
                             // producer has found its slot empty
  uint32_t q;   // stages taken so far
  __device__ int slot() const { return q % STAGES; }
  __device__ uint32_t parity() const { return (q / STAGES) & 1; }
};

// this thread's warpgroup, warp-uniform in the compiler's eyes (the
// products are issued by whole warpgroups)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
}

__device__ __forceinline__ void consumers_sync() {
  named_sync(BAR_CONSUMERS, CONSUMERS);
}

// Sum of v over the consumer threads, every one gets it (red: 33 floats).
__device__ float consumers_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  consumers_sync();
  if (lane == 0) red[warp] = v;
  consumers_sync();
  if (warp == 0) {
    float w = lane < CONSUMERS / 32 ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    if (lane == 0) red[32] = w;
  }
  consumers_sync();
  return red[32];
}

// Every consumer of every block arrives before any leaves (the producer
// warps take no part).  Thread 0 of a block counts it in on `count`, which
// only grows: the n-th barrier of the launch is passed once it reads n G
// (`passed`, thread 0's count of barriers, n - 1 before the call).
__device__ void grid_sync(unsigned* count, int G, unsigned& passed) {
  consumers_sync();
  if (threadIdx.x == 0) {
    const unsigned target = ++passed * (unsigned)G;
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      __nanosleep(32);
    }
    __threadfence();
  }
  consumers_sync();
}

// The activation and its derivative from the stored post-activation, the
// kind a template argument: a runtime kind per element puts a branch
// around every element of an epilogue, which then runs one at a time.
template <int ACT>
__device__ __forceinline__ float act_t(float x) {
  if constexpr (ACT == ACT_RELU) return fmaxf(x, 0.0f);
  else if constexpr (ACT == ACT_TANH) return tanhf(x);
  else return x;
}
template <int ACT>
__device__ __forceinline__ float act_grad_t(float h) {
  if constexpr (ACT == ACT_RELU) return h > 0.0f ? 1.0f : 0.0f;
  else if constexpr (ACT == ACT_TANH) return 1.0f - h * h;
  else return 1.0f;
}
// f<ACT>() for the runtime kind `act`
#define WITH_ACT(act, f, ...)                                   \
  do {                                                          \
    if ((act) == ACT_RELU) f<ACT_RELU>(__VA_ARGS__);            \
    else if ((act) == ACT_TANH) f<ACT_TANH>(__VA_ARGS__);       \
    else f<ACT_NONE>(__VA_ARGS__);                              \
  } while (0)

// partial[idx], and [idx + 1] when `two`: written on the block's first row
// tile, added after; two columns in one 8-byte store where aligned.
__device__ __forceinline__ void put2(float* part, long idx, float v0, float v1,
                                     bool two, bool first) {
  if (two && !(idx & 1)) {
    float2* p = reinterpret_cast<float2*>(part + idx);
    float2 o = first ? make_float2(0.0f, 0.0f) : *p;
    *p = make_float2(o.x + v0, o.y + v1);
    return;
  }
  part[idx] = first ? v0 : part[idx] + v0;
  if (two) part[idx + 1] = first ? v1 : part[idx + 1] + v1;
}

// --- the hidden layers -----------------------------------------------------

// The forward's epilogue: bias and activation of warpgroup w's 64 rows x NC
// columns ([256 jc, + NC)), rounded to bf16 into the image `out` (rows past
// R not stored).  Past the layer's width W's columns and b are zero, and
// so is the activation of 0.
template <int ACT, int NA>   // NA = NC / 2 accumulators a thread
__device__ __forceinline__ void forward_epilogue(const float (&acc)[NA],
                                                 Smem sm, unsigned char* out,
                                                 const float* bias, int jc,
                                                 int w, int R) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int c = CHUNK * jc + frag_col(t, j, 0);
    const float2 bb = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w * 64 + frag_row(t, 2 * h);
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(act_t<ACT>(acc[4 * j + 2 * h] + bb.x),
                                act_t<ACT>(acc[4 * j + 2 * h + 1] + bb.y));
      if (r < R) *reinterpret_cast<__nv_bfloat162*>(sm.at(out, r, c)) = v;
    }
  }
}

// Forward of hidden layer l, columns [256 jc, + NC), on warpgroup w's 64
// rows: the stages of W_l's rows in turn from the ring, then bias and
// activation, rounded to bf16 into layer l+1's image (zero past its width).
template <int NC>
__device__ void forward_chunk(const Bf16Dev& a, Smem sm, Ring& ring,
                              int l, int jc, int w) {
  const Layout& L = a.lay;
  const int blk = L.rows * 128;
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
  const uint32_t act = smem_addr(sm.act(l)) + w * 64 * 128;
  const int n_is = cdiv(L.img_rows[l], SLICE);
  for (int is = 0; is < n_is; ++is, ++ring.q) {
    const Stage st = stage_of(L, l, jc, is);
    mbar_wait(&ring.full[ring.slot()], ring.parity());
    fence_acc(acc);
    wgmma_fence();
    mma_forward<NC>(acc, act + is * blk, smem_addr(sm.stage(ring.slot())),
                    st.rs, is > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[ring.slot()]);
  }
  WITH_ACT(a.activation, forward_epilogue, acc, sm, sm.act(l + 1),
           sm.bias() + L.hb[l], jc, w, L.rows);
}

__device__ void forward_layer(const Bf16Dev& a, Smem sm, Ring& ring,
                              int l, int w) {
  const int n_jc = cdiv(a.lay.w64[l + 1], CHUNK);
  for (int jc = 0; jc < n_jc; ++jc) {
    switch (min(CHUNK, a.lay.w64[l + 1] - CHUNK * jc)) {
      case 64: forward_chunk<64>(a, sm, ring, l, jc, w); break;
      case 128: forward_chunk<128>(a, sm, ring, l, jc, w); break;
      case 192: forward_chunk<192>(a, sm, ring, l, jc, w); break;
      default: forward_chunk<256>(a, sm, ring, l, jc, w); break;
    }
  }
  fence_proxy_async_shared();   // the next layer's products read it
  named_sync(BAR_WG + w, 128);
}

// dW_l = a_in^T g over the first kr rows, one 64 x NC tile (input rows
// [64 ib, + 64), output columns [256 jc, + NC)), into the block's partial.
template <int NC>
__device__ void dw_chunk(const Bf16Dev& a, Smem sm, int l, int ib,
                        int jc, int kr, float* part, bool first) {
  const Layout& L = a.lay;
  const int t = threadIdx.x & 127, blk = L.rows * 128;
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  wgmma_fence();
  mma_dw<NC>(acc, smem_addr(sm.act(l)) + ib * blk,
             smem_addr(sm.act(l + 1)) + 4 * jc * blk, blk, kr);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int din = L.net.dim[l], dout = L.net.dim[l + 1];
  float* dw = part + L.net.w_off[l];
  if (first && !(dout & 1) && !(L.net.w_off[l] & 1)) {
    // the common case, branch-free: a column pair is one aligned store
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int c = CHUNK * jc + frag_col(t, j, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 64 * ib + frag_row(t, 2 * h);
        if (c < dout && i < din)
          *reinterpret_cast<float2*>(dw + (long)i * dout + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int c = CHUNK * jc + frag_col(t, j, 0);
    if (c >= dout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 64 * ib + frag_row(t, 2 * h);
      if (i < din)
        put2(part, L.net.w_off[l] + (long)i * dout + c, acc[4 * j + 2 * h],
             acc[4 * j + 2 * h + 1], c + 1 < dout, first);
    }
  }
}

// dW of hidden layer l: its tiles dealt to the two warpgroups in turn.
__device__ void dw_layer(const Bf16Dev& a, Smem sm, int l, int kr,
                         float* part, bool first) {
  const Layout& L = a.lay;
  const int w = warpgroup();
  const int n_ib = L.w64[l] / 64, n_jc = cdiv(L.w64[l + 1], CHUNK);
  for (int tile = w; tile < n_ib * n_jc; tile += 2) {
    const int ib = tile / n_jc, jc = tile % n_jc;
    switch (min(CHUNK, L.w64[l + 1] - CHUNK * jc)) {
      case 64: dw_chunk<64>(a, sm, l, ib, jc, kr, part, first); break;
      case 128: dw_chunk<128>(a, sm, l, ib, jc, kr, part, first); break;
      case 192: dw_chunk<192>(a, sm, l, ib, jc, kr, part, first); break;
      default: dw_chunk<256>(a, sm, l, ib, jc, kr, part, first); break;
    }
  }
}

// dX's epilogue on warpgroup w's 64 rows x the 64 columns [64 is, + 64):
// g = acc * act'(h) over h's image H, in place (bf16; rows past R not
// stored), and the warp's float32 column sums of g into cs[64].
template <int ACT>
__device__ __forceinline__ void dx_epilogue(const float (&acc)[32], Smem sm,
                                            unsigned char* H, int is, int w,
                                            int R, float* cs) {
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31;
  float colsum[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    colsum[j][0] = colsum[j][1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w * 64 + frag_row(t, 2 * h);
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(
          sm.at(H, r, 64 * is + frag_col(t, j, 0)));
      const __nv_bfloat162 hv = *hp;
      const bool in = r < R;
      const float g0 = in ? acc[4 * j + 2 * h] * act_grad_t<ACT>(
                                __low2float(hv)) : 0.0f;
      const float g1 = in ? acc[4 * j + 2 * h + 1] * act_grad_t<ACT>(
                                __high2float(hv)) : 0.0f;
      colsum[j][0] += g0;
      colsum[j][1] += g1;
      if (in) *hp = __floats2bfloat162_rn(g0, g1);
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        colsum[j][e] += __shfl_xor_sync(0xffffffffu, colsum[j][e], o);
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) cs[frag_col(t, j, e)] = colsum[j][e];
}

// g_{l-1} = (g_l W_l^T) * act'(h_{l-1}) over hidden layer l's input columns,
// 64 at a time (a stage's rows), written in place over h_{l-1} (bf16), and
// db_{l-1}, the column sums of the float32 g_{l-1}, into the partial.
// Warpgroups with rows multiply; every consumer joins the column sums.
__device__ void dx_layer(const Bf16Dev& a, Smem sm, Ring& ring, int l,
                         int row_wgs, float* part, bool first) {
  const Layout& L = a.lay;
  const int w = warpgroup();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = L.rows * 128, din = L.net.dim[l], R = L.rows;
  const int act_kind = a.activation;
  const int n_jc = cdiv(L.w64[l + 1], CHUNK);
  unsigned char* H = sm.act(l);
  float* cs = sm.csum();
  for (int is = 0; is < L.w64[l] / 64; ++is) {
    if (w < row_wgs) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      const uint32_t g = smem_addr(sm.act(l + 1)) + w * 64 * 128;
      for (int jc = 0; jc < n_jc; ++jc, ++ring.q) {
        const Stage st = stage_of(L, l, jc, is);
        mbar_wait(&ring.full[ring.slot()], ring.parity());
        fence_acc(acc);
        wgmma_fence();
        mma_dx(acc, g + 4 * jc * blk, blk, smem_addr(sm.stage(ring.slot())),
               st.nc, jc > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&ring.empty[ring.slot()]);
      }
      WITH_ACT(act_kind, dx_epilogue, acc, sm, H, is, w, R, cs + warp * 64);
    }
    consumers_sync();
    if (threadIdx.x < 64) {
      const int c = 64 * is + threadIdx.x;
      float s = 0.0f;
      for (int q = 0; q < 4 * row_wgs; ++q) s += cs[q * 64 + threadIdx.x];
      if (c < din) put2(part, L.net.b_off[l - 1] + c, s, 0.0f, false, first);
    }
    consumers_sync();
  }
  fence_proxy_async_shared();
}

// --- the head ----------------------------------------------------------------

// The head (dL = 1 to 8 outputs) on the tensor cores through two images of
// 16 columns in the 32-byte swizzle (wgmma.cuh): W_L [w64_{L-1}][16] (the
// forward's MN-major B with N = 16, dX's K-major B) and g_L [R][16] (dX's
// K-major A of one k-step, dW's MN-major B with N = 16), both zero past
// their widths.

// out[r][j] = h_{L-1}[r] . W_L[:, j] + b_L[j] (float32) on warpgroup w's
// rows: one m64n16 chain over h_{L-1}'s image.
__device__ void head_forward(const Bf16Dev& a, Smem sm, int w) {
  const Layout& L = a.lay;
  const int nl = L.net.n_layers, k = L.net.dim[nl], R = L.rows;
  const int t = threadIdx.x & 127;
  const uint32_t h = smem_addr(sm.act(nl - 1)) + w * 64 * 128;
  const uint32_t wl = smem_addr(sm.wl());
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll 1
  for (int kk = 0; kk < pad16(L.net.dim[nl - 1]); kk += 16)
    Wgmma<16>::run<0, 1, 0>(
        acc, desc(h + (kk >> 6) * sm.blk + (kk & 63) * 2, 16, 1024),
        desc(wl + kk * 32, 16, 256, 3), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const float* bias = a.p + L.net.b_off[nl - 1];
  float* out = sm.out();
#pragma unroll
  for (int e = 0; e < 8; ++e) {   // accumulator e: group e / 4, place e % 4
    const int r = w * 64 + frag_row(t, e & 3), j = frag_col(t, e >> 2, e);
    if (r < R && j < k) out[r * k + j] = acc[e] + __ldcg(bias + j);
  }
}

// The head's dX on warpgroup w's rows, 64 columns of g_{L-1} (W_L's rows)
// at a time: acc = g_L W_L^T (one k-step), then dx_layer's epilogue and
// column sums into db.
template <int ACT>
__device__ void head_dx(Smem sm, int w, int R, int row_wgs, int din,
                        int cols, float* db, bool first, unsigned char* H) {
  float* cs = sm.csum();
  const int warp = threadIdx.x >> 5;
  const uint64_t g = desc(smem_addr(sm.gl()) + w * 64 * 32, 16, 256, 3);
  for (int is = 0; is < cols / 64; ++is) {
    if (w < row_wgs) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      wgmma_fence();
      Wgmma<64>::run<0, 0, 0>(
          acc, g, desc(smem_addr(sm.wl()) + is * 64 * 32, 16, 256, 3), 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      dx_epilogue<ACT>(acc, sm, H, is, w, R, cs + warp * 64);
    }
    consumers_sync();
    if (threadIdx.x < 64) {
      const int c = 64 * is + threadIdx.x;
      float s = 0.0f;
      for (int p = 0; p < 4 * row_wgs; ++p) s += cs[p * 64 + threadIdx.x];
      if (c < din) db[c] = first ? s : db[c] + s;
    }
    consumers_sync();
  }
}

// The head's backward from g_L (float32 in `out`, bf16 in its image): db_L;
// dW_L = h_{L-1}^T g_L on the tensor cores, its 64-row chunks of h_{L-1}'s
// columns dealt to the two warpgroups; then g_{L-1} = (g_L W_L^T) *
// act'(h_{L-1}) in place over h_{L-1} and db_{L-1} (when there is a hidden
// layer).
__device__ void head_backward(const Bf16Dev& a, Smem sm, float* part,
                              int kr, int row_wgs, bool first) {
  const Layout& L = a.lay;
  const int nl = L.net.n_layers, din = L.net.dim[nl - 1], k = L.net.dim[nl];
  const int R = L.rows, act_kind = a.activation;
  const int w = warpgroup(), t = threadIdx.x & 127;
  unsigned char* H = sm.act(nl - 1);
  const float* g = sm.out();
  if (threadIdx.x < k) {
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) s += g[r * k + threadIdx.x];
    put2(part, L.net.b_off[nl - 1] + threadIdx.x, s, 0.0f, false, first);
  }
  for (int ib = w; ib < L.w64[nl - 1] / 64; ib += 2) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll 1
    for (int r0 = 0; r0 < kr; r0 += 16)
      Wgmma<16>::run<1, 1, 0>(
          acc, desc(smem_addr(H) + ib * sm.blk + r0 * 128, sm.blk, 1024),
          desc(smem_addr(sm.gl()) + r0 * 32, 16, 256, 3), r0 > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 64 * ib + frag_row(t, e & 3), j = frag_col(t, e >> 2, e);
      if (i < din && j < k)
        put2(part, L.net.w_off[nl - 1] + (long)i * k + j, acc[e], 0.0f,
             false, first);
    }
  }
  if (nl == 1) return;
  consumers_sync();   // dW_L has read h_{L-1}
  WITH_ACT(act_kind, head_dx, sm, w, R, row_wgs, din, L.w64[nl - 1],
           part + L.net.b_off[nl - 2], first, H);
  fence_proxy_async_shared();
}

// --- the shadow --------------------------------------------------------------

// The shadow's element of W_l[i][j] (l a hidden layer), in bf16 units.
__device__ long shadow_elem(const Layout& L, int l, int i, int j) {
  const int jc = j / CHUNK, is = i / SLICE;
  const Stage st = stage_of(L, l, jc, is);
  const int jj = j - CHUNK * jc;
  return (st.off + (jj >> 6) * st.rs * 128 + sw128(i - SLICE * is, jj & 63)) /
         2;
}

// The shadow element of flat parameter i, or -1 for a bias or the head.
__device__ long shadow_index(const Layout& L, int i) {
  for (int l = 0; l + 1 < L.net.n_layers; ++l) {
    if (i < L.net.b_off[l]) {
      const int r = i - L.net.w_off[l], dout = L.net.dim[l + 1];
      const int row = r / dout;
      return shadow_elem(L, l, row, r - row * dout);
    }
    if (i < L.net.b_off[l] + L.net.dim[l + 1]) return -1;
  }
  return -1;
}

// --- the producer --------------------------------------------------------------

// One lane of the producer warp: every stage of every step, in the order
// the consumers take them (per row tile the forward's hidden layers, each
// by column chunk then row slice; then dX's layers from the last, each by
// row slice then column chunk), each one bulk copy into the ring.  In a
// cluster of c blocks each block's producer reports its slot empty to the
// first block's, which copies the stage once into every block's slot
// (multicast); each block's own barrier counts the bytes that land in it.
__device__ void produce(const Bf16Dev& a, unsigned char* ring_base,
                        Ring ring, uint64_t* go) {
  const Layout& L = a.lay;
  const int nh = L.net.n_layers - 1;   // hidden layers
  const int c = cluster_size(), rank = cluster_rank();
  const unsigned char* shadow = (const unsigned char*)a.shadow;
  auto issue = [&](int l, int jc, int is) {
    const Stage st = stage_of(L, l, jc, is);
    const uint32_t bytes = (uint32_t)(st.rs * st.nc * 2);
    uint64_t* full = &ring.full[ring.slot()];
    mbar_wait(&ring.empty[ring.slot()], ring.parity() ^ 1);
    mbar_expect_tx(full, bytes);
    unsigned char* dst = ring_base + ring.slot() * L.stage_bytes;
    if (c == 1) {
      bulk_g2s(dst, shadow + st.off, bytes, full);
    } else {
      uint64_t* ce = &ring.cluster_empty[ring.slot()];
      mbar_arrive_cluster(cluster_addr((const float*)ce, 0));
      if (rank == 0) {
        mbar_wait(ce, ring.parity());
        bulk_g2s_multicast(dst, shadow + st.off, bytes, full,
                           (uint16_t)((1u << c) - 1));
      }
    }
    ++ring.q;
  };
  for (int s = 0; s < a.n_steps; ++s) {
    mbar_wait(go, s & 1);   // Adam of the step before has written the shadow
    fence_proxy_async();
    for (int round = 0; round < a.rounds; ++round) {
      for (int l = 0; l < nh; ++l)
        for (int jc = 0; jc < cdiv(L.w64[l + 1], CHUNK); ++jc)
          for (int is = 0; is < cdiv(L.img_rows[l], SLICE); ++is)
            issue(l, jc, is);
      for (int l = nh - 1; l >= 1; --l)
        for (int is = 0; is < L.w64[l] / 64; ++is)
          for (int jc = 0; jc < cdiv(L.w64[l + 1], CHUNK); ++jc)
            issue(l, jc, is);
    }
  }
}

// --- the kernel ----------------------------------------------------------------

template <bool POLICY>
__global__ void __launch_bounds__(THREADS, 1) phase_bf16_kernel(
    const __grid_constant__ Bf16Dev arg) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES],
      cluster_empty[STAGES], go;
  __shared__ float red[33];
  __shared__ float ls_s[MAX_ACT], inv_sigma_s[MAX_ACT];
  // the arguments in shared memory: the device functions take them by
  // reference, and a reference to a kernel parameter is a generic pointer
  // into parameter space, a slow load in every loop that reads it
  __shared__ Bf16Dev a;
  if (threadIdx.x == 0) a = arg;
  __syncthreads();
  const Layout& L = a.lay;
  unsigned char* base = aligned(smem_raw);
  const Smem sm{base, &L, L.rows * 128};
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int P = L.net.n_params, nl = L.net.n_layers;
  const int d0 = L.net.dim[0], R = L.rows, k = L.net.dim[nl];
  const int row_wgs = R > 64 ? 2 : 1;
  const int n_tiles = (a.mb + R - 1) / R;
  float* part = a.partial + (size_t)b * a.pstride;
  // this block's slice of the parameters for Adam, in float4s
  const int nf = (P + 3) / 4;
  const int f0 = (int)((long)nf * b / G), f1 = (int)((long)nf * (b + 1) / G);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * row_wgs);
      mbar_init(&cluster_empty[i], cluster_size());
    }
    mbar_init(&go, 1);
    mbar_init_fence();
  }
  for (int i = 4 * f0 + tid; i < min(4 * f1, P); i += THREADS) {
    a.p[i] = a.p_in[i];
    a.m[i] = a.m_in[i];
    a.v[i] = a.v_in[i];
    const long si = shadow_index(L, i);
    if (si >= 0) a.shadow[si] = __float2bfloat16_rn(a.p_in[i]);
  }
  if (POLICY && b == 0 && tid < k) {
    a.ls[tid] = a.ls_in[tid];
    a.mls[tid] = a.mls_in[tid];
    a.vls[tid] = a.vls_in[tid];
  }
  __threadfence();
  __syncthreads();
  if (cluster_size() > 1) cluster_sync();   // every block's barriers exist
  Ring ring{full, empty, cluster_empty, 0};
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) produce(a, base + L.ring_off, ring, &go);
    return;
  }
  unsigned barriers = 0;   // thread 0: grid barriers passed
  grid_sync(a.barrier, G, barriers);

  const int w = warpgroup();
  const float mbf = (float)a.mb;
  {   // layer 0's image and W_L's: zero once, what they hold written per
      // tile and per step
    uint4* X = reinterpret_cast<uint4*>(sm.act(0));
    for (int e = tid; e < L.w64[0] / 64 * R * 8; e += CONSUMERS)
      X[e] = make_uint4(0u, 0u, 0u, 0u);
    uint4* WL = reinterpret_cast<uint4*>(sm.wl());
    for (int e = tid; e < L.w64[nl - 1] * 2; e += CONSUMERS)
      WL[e] = make_uint4(0u, 0u, 0u, 0u);
    consumers_sync();
  }
  float run_loss = 0.0f, run_ent = 0.0f;   // block 0, thread 0
  for (int s = 0; s < a.n_steps; ++s) {
    if (tid == 0) mbar_arrive(&go);
    const size_t step_row = (size_t)s * a.mb;
    float sum_ls = 0.0f;
    if (POLICY && tid < k) {
      const float l = __ldcg(a.ls + tid);
      ls_s[tid] = l;
      inv_sigma_s[tid] = expf(-l);
    }
    {   // W_L into its image (zero past it), for the head; the hidden
        // layers' b
      const float* wl = a.p + L.net.w_off[nl - 1];
      for (int e = tid; e < L.net.dim[nl - 1] * k; e += CONSUMERS)
        *(bf16*)(sm.wl() + sw32(e / k, e % k)) =
            __float2bfloat16_rn(__ldcg(wl + e));
      for (int l = 0; l + 1 < nl; ++l)
        for (int c = tid; c < L.w64[l + 1]; c += CONSUMERS)
          sm.bias()[L.hb[l] + c] = c < L.net.dim[l + 1]
                                       ? __ldcg(a.p + L.net.b_off[l] + c)
                                       : 0.0f;
    }
    fence_proxy_async_shared();   // the head's products read W_L's image
    consumers_sync();
    if (POLICY)
      for (int j = 0; j < k; ++j) sum_ls += ls_s[j];
    float bst[STAT];   // thread 0: this block's statistics over its tiles
    for (int q = 0; q < STAT; ++q) bst[q] = 0.0f;
    for (int round = 0; round < a.rounds; ++round) {
      const bool first = round == 0;
      const int t = b + round * G;
      const int nrows = t < n_tiles ? min(R, a.mb - t * R) : 0;
      const size_t row0 = step_row + (size_t)t * R;
      {   // the rows into layer 0's image, bf16, zero past them
        unsigned char* X = sm.act(0);
        const int c8 = cdiv(d0, 8);
        for (int e = tid; e < R * c8; e += CONSUMERS) {
          const int r = e / c8, c = (e - r * c8) * 8;
          float v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = r < nrows && c + q < d0 ? __ldg(a.x + (row0 + r) * d0 + c + q)
                                           : 0.0f;
          uint4 u;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
          *reinterpret_cast<uint4*>(sm.at(X, r, c)) = u;
        }
      }
      fence_proxy_async_shared();
      consumers_sync();
      if (w < row_wgs)
        for (int l = 0; l + 1 < nl; ++l) forward_layer(a, sm, ring, l, w);
      consumers_sync();
      if (w < row_wgs) head_forward(a, sm, w);
      consumers_sync();

      // the loss gradient per row, float32 over `out`
      float* out = sm.out();
      float part0 = 0.0f, gls_part[MAX_ACT];
      for (int j = 0; j < MAX_ACT; ++j) gls_part[j] = 0.0f;
      for (int r = tid; r < R; r += CONSUMERS) {
        float gr[MAX_ACT];
        for (int j = 0; j < MAX_ACT; ++j) gr[j] = 0.0f;
        if (r < nrows) {
          const size_t row = row0 + r;
          if (POLICY) {
            float z[MAX_ACT], sumz2 = 0.0f;
            for (int j = 0; j < k; ++j) {
              z[j] = (__ldg(a.act + row * k + j) - out[r * k + j]) *
                     inv_sigma_s[j];
              sumz2 += z[j] * z[j];
            }
            const float logp = a.lp0 - sum_ls - 0.5f * sumz2;
            const float adv = __ldg(a.adv + row);
            const float ratio = expf(logp - __ldg(a.lp_old + row));
            const float clipped = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
            const float ra = ratio * adv, ca = clipped * adv;
            part0 += fminf(ra, ca);
            // only the unclipped branch carries gradient
            const float dlogp = ra <= ca ? -(adv * ratio / mbf) : 0.0f;
            for (int j = 0; j < k; ++j) {
              gls_part[j] += dlogp * (z[j] * z[j] - 1.0f);
              gr[j] = dlogp * z[j] * inv_sigma_s[j];
            }
          } else {
            const float diff = out[r] - __ldg(a.tgt + row);
            part0 += diff * diff;
            gr[0] = a.two_over_mb * diff;
          }
        }
        for (int j = 0; j < k; ++j) out[r * k + j] = gr[j];
        uint4 u[2];   // g_L's image row, bf16, zero past k
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(u);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          h2[q] = __floats2bfloat162_rn(2 * q < MAX_ACT ? gr[2 * q] : 0.0f,
                                        2 * q + 1 < MAX_ACT ? gr[2 * q + 1]
                                                            : 0.0f);
        *reinterpret_cast<uint4*>(sm.gl() + sw32(r, 0)) = u[0];
        *reinterpret_cast<uint4*>(sm.gl() + sw32(r, 8)) = u[1];
      }
      const float tot0 = consumers_sum(part0, red);
      if (tid == 0) bst[0] += tot0;
      if (POLICY)
        for (int j = 0; j < k; ++j) {
          const float tj = consumers_sum(gls_part[j], red);
          if (tid == 0) bst[1 + j] += tj;
        }
      fence_proxy_async_shared();   // the head's products read g_L's image
      consumers_sync();
      const int kr = pad16(nrows);
      head_backward(a, sm, part, kr, row_wgs, first);
      consumers_sync();
      for (int l = nl - 2; l >= 0; --l) {
        dw_layer(a, sm, l, kr, part, first);
        consumers_sync();   // dW has read h_{l-1}, which dX overwrites
        if (l > 0) {
          dx_layer(a, sm, ring, l, row_wgs, part, first);
          consumers_sync();
        }
      }
    }
    if (tid == 0)
      for (int q = 0; q < STAT; ++q) a.bstats[(size_t)b * STAT + q] = bst[q];
    __threadfence();
    grid_sync(a.barrier, G, barriers);

    // Adam on this block's slice: each gradient summed over the blocks'
    // partials, 16 groups of `group` blocks each in block order, then the
    // groups in order.  64 float4s of parameters at a time: warp w sums
    // groups w and w + 8, a lane two float4s (a warp's load 512 contiguous
    // bytes), into `sums`; then a thread a parameter adds the 16 groups and
    // runs its update, its moments and weight loaded first.
    const AdamHyper& hp = a.hyper;
    {
      const float tf = (float)(a.t0 + s + 1);
      const float bc1 = 1.0f - expf(tf * hp.logb1);
      const float bc2 = 1.0f - expf(tf * hp.logb2);
      const float step = hp.lr / bc1;
      const int lane = tid & 31, warp = tid >> 5;
      float4* sums = reinterpret_cast<float4*>(base + L.sums_off);
      for (int fb = f0; fb < f1; fb += 64) {
        const int i = 4 * fb + tid;
        const bool mine = i < min(4 * f1, P);
        float m0 = 0.0f, v0 = 0.0f, p0 = 0.0f;
        if (mine) {
          m0 = __ldcg(a.m + i);
          v0 = __ldcg(a.v + i);
          p0 = __ldcg(a.p + i);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {   // groups warp and warp + 8, 2 x 32
          const int grp = warp + 8 * (h & 1), f = fb + lane + 32 * (h >> 1);
          const int q0 = grp * a.group;
          const int q1 = f < f1 ? min(G, q0 + a.group) : q0;
          float4 gs = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
          for (int q = q0; q < q1; ++q) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                a.partial + (size_t)q * a.pstride + 4 * f));
            gs.x += v.x;
            gs.y += v.y;
            gs.z += v.z;
            gs.w += v.w;
          }
          sums[grp * 64 + lane + 32 * (h >> 1)] = gs;
        }
        consumers_sync();
        if (mine) {
          const float* col = reinterpret_cast<const float*>(sums) + tid;
          float gsum = 0.0f;
          for (int g = 0; g < GROUPS; ++g) gsum += col[g * 256];
          const float m2 = hp.b1 * m0 + hp.omb1 * gsum;
          const float v2 = hp.b2 * v0 + hp.omb2 * (gsum * gsum);
          a.m[i] = m2;
          a.v[i] = v2;
          const float p2 = p0 - step * m2 / (sqrtf(v2 / bc2) + hp.eps);
          a.p[i] = p2;
          const long si = shadow_index(L, i);
          if (si >= 0) a.shadow[si] = __float2bfloat16_rn(p2);
        }
        consumers_sync();
      }
    }
    float tot[1 + MAX_ACT];   // block 0: the statistics over the blocks
    if (b == 0 && tid < 32) {
      // lane l sums blocks l, l + 32, ...; then the lanes in a fixed tree
      const int n_stat = POLICY ? 1 + k : 1;
      for (int j = 0; j < n_stat; ++j) tot[j] = 0.0f;
      for (int q = tid; q < G; q += 32)
        for (int j = 0; j < n_stat; ++j)
          tot[j] += __ldcg(a.bstats + (size_t)q * STAT + j);
      for (int o = 16; o > 0; o >>= 1)
        for (int j = 0; j < n_stat; ++j)
          tot[j] += __shfl_xor_sync(0xffffffffu, tot[j], o);
    }
    if (b == 0 && tid == 0) {
      if (POLICY) {
        // closed-form Gaussian entropy of the step's log_std
        const float ent = a.ent0 + sum_ls;
        run_ent += ent;
        run_loss += -a.ent_coeff * ent;
        run_loss += -tot[0] / mbf;
        // log_std Adam (its own timestep); the entropy bonus adds -ent_coeff
        const float tl = (float)(a.t0_ls + s + 1);
        const float bc1 = 1.0f - expf(tl * hp.logb1);
        const float bc2 = 1.0f - expf(tl * hp.logb2);
        for (int j = 0; j < k; ++j) {
          const float gj = tot[1 + j] - a.ent_coeff;
          const float m2 = hp.b1 * a.mls[j] + hp.omb1 * gj;
          const float v2 = hp.b2 * a.vls[j] + hp.omb2 * (gj * gj);
          a.mls[j] = m2;
          a.vls[j] = v2;
          a.ls[j] = ls_s[j] - (hp.lr / bc1) * m2 / (sqrtf(v2 / bc2) + hp.eps);
        }
      } else {
        run_loss += tot[0];
      }
    }
    __threadfence();
    grid_sync(a.barrier, G, barriers);
  }
  if (b == 0 && tid == 0) {
    a.stats[0] = run_loss;
    if (POLICY) a.stats[1] = run_ent;
  }
}

// --- a product of wgmma.cuh on its own, for the card tests ------------------
// mode 0, the forward's: out [64][N] = A [64][K] W [K][N] (K <= 64);
// mode 1, dX's: out [64][64] = A [64][K] W^T, W [64][K] (K <= 256);
// mode 2, dW's: out [64][N] = A^T B, A [K][64], B [K][N] (K <= 128 rows).
// Every operand rounded to bf16 and laid out as the kernel lays it out: the
// activations an image of R = 64 rows (mode 2: K rows), W one ring stage.
__global__ void __launch_bounds__(128) wgmma_test_kernel(
    int mode, const float* A, const float* B, float* out, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const int t = threadIdx.x;
  const int rows = mode == 2 ? K : 64;           // the images' rows
  const int acols = mode == 2 ? 64 : pad64(K);   // A's image columns
  const int bcols = mode == 1 ? pad64(K) : N;    // B's image columns
  const int brows = mode == 0 ? pad16(K) : mode == 1 ? 64 : K;
  Layout L{};
  L.rows = rows;
  const Smem sm{base, &L, rows * 128};
  unsigned char* a_img = base;
  unsigned char* b_img = base + acols / 64 * rows * 128;
  // A [rows][acols] as an activation image; B as a stage (modes 0 and 1:
  // 64-column blocks of brows x 128 bytes) or an image (mode 2)
  for (int e = t; e < rows * acols; e += 128) {
    const int r = e / acols, c = e % acols;
    const int kc = mode == 2 ? 64 : K;
    *sm.at(a_img, r, c) = __float2bfloat16_rn(c < kc ? A[r * kc + c] : 0.0f);
  }
  for (int e = t; e < brows * bcols; e += 128) {
    const int r = e / bcols, c = e % bcols;
    const int nb = mode == 1 ? K : N;
    const float v = c < nb && (mode != 0 || r < K) ? B[r * nb + c] : 0.0f;
    *(bf16*)(b_img + (c >> 6) * brows * 128 + sw128(r, c & 63)) =
        __float2bfloat16_rn(v);
  }
  fence_proxy_async_shared();
  __syncthreads();
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  wgmma_fence();
  if (mode == 0) {
    float (&d)[128] = acc;
    switch (N) {
      case 64: mma_forward<64>(*reinterpret_cast<float(*)[32]>(d),
                               smem_addr(a_img), smem_addr(b_img), brows, false);
        break;
      case 128: mma_forward<128>(*reinterpret_cast<float(*)[64]>(d),
                                 smem_addr(a_img), smem_addr(b_img), brows, false);
        break;
      case 192: mma_forward<192>(*reinterpret_cast<float(*)[96]>(d),
                                 smem_addr(a_img), smem_addr(b_img), brows, false);
        break;
      default: mma_forward<256>(d, smem_addr(a_img), smem_addr(b_img),
                                brows, false);
    }
  } else if (mode == 1) {
    mma_dx(*reinterpret_cast<float(*)[32]>(acc), smem_addr(a_img),
           rows * 128, smem_addr(b_img), pad16(K), false);
  } else {
    const int blk = rows * 128;
    switch (N) {
      case 64: mma_dw<64>(*reinterpret_cast<float(*)[32]>(acc),
                          smem_addr(a_img), smem_addr(b_img), blk, K);
        break;
      case 128: mma_dw<128>(*reinterpret_cast<float(*)[64]>(acc),
                            smem_addr(a_img), smem_addr(b_img), blk, K);
        break;
      case 192: mma_dw<192>(*reinterpret_cast<float(*)[96]>(acc),
                            smem_addr(a_img), smem_addr(b_img), blk, K);
        break;
      default: mma_dw<256>(acc, smem_addr(a_img), smem_addr(b_img), blk, K);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int n = mode == 1 ? 64 : N;
  for (int j = 0; j < n / 8; ++j)
    for (int e = 0; e < 4; ++e)
      out[frag_row(t, e) * n + frag_col(t, j, e)] = acc[4 * j + e];
}

// The head's products (the 32-byte swizzle), as head_forward,
// head_backward and head_dx run them: mode 3, the forward's: out
// [64][16] = A [64][K] W [K][16] (K <= 64); mode 4, dX's: out [64][N] =
// G [64][16] W^T, W [N][16] (N 64, 128, 192 or 256); mode 5, dW's: out
// [64][16] = A^T G, A [K][64], G [K][16] (K <= 128 rows, a multiple of 16).
__global__ void __launch_bounds__(128) head_test_kernel(
    int mode, const float* A, const float* B, float* out, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const int t = threadIdx.x;
  const int rows = mode == 5 ? K : 64;                  // A's image rows
  const int brows = mode == 3 ? pad16(K) : mode == 4 ? N : K;
  Layout L{};
  L.rows = rows;
  const Smem sm{base, &L, rows * 128};
  unsigned char* a_img = base;            // mode 4: G [64][16], 32-byte
  unsigned char* b_img = base + 64 * 1024;
  for (int e = t; e < rows * 64; e += 128) {
    const int r = e / 64, c = e % 64;
    const int ka = mode == 3 ? K : mode == 4 ? 16 : 64;   // A's columns
    const float v = c < ka ? A[r * ka + c] : 0.0f;
    if (mode == 4) {
      if (c < 16) *(bf16*)(a_img + sw32(r, c)) = __float2bfloat16_rn(v);
    } else {
      *sm.at(a_img, r, c) = __float2bfloat16_rn(v);
    }
  }
  for (int e = t; e < brows * 16; e += 128) {
    const int r = e / 16, c = e % 16;
    const float v = mode == 3 && r >= K ? 0.0f : B[r * 16 + c];
    *(bf16*)(b_img + sw32(r, c)) = __float2bfloat16_rn(v);
  }
  fence_proxy_async_shared();
  __syncthreads();
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  wgmma_fence();
  const uint32_t a = smem_addr(a_img), b = smem_addr(b_img);
  if (mode == 3) {
#pragma unroll 1
    for (int kk = 0; kk < pad16(K); kk += 16)
      Wgmma<16>::run<0, 1, 0>(acc, desc(a + kk * 2, 16, 1024),
                              desc(b + kk * 32, 16, 256, 3), kk > 0);
  } else if (mode == 4) {
    const uint64_t da = desc(a, 16, 256, 3), db = desc(b, 16, 256, 3);
    switch (N) {
      case 64: wgmma_nc<64, 0, 0>(*reinterpret_cast<float(*)[32]>(acc), da,
                                  db, (128 * 32) >> 4, 0); break;
      case 128: wgmma_nc<128, 0, 0>(*reinterpret_cast<float(*)[64]>(acc), da,
                                    db, (128 * 32) >> 4, 0); break;
      case 192: wgmma_nc<192, 0, 0>(*reinterpret_cast<float(*)[96]>(acc), da,
                                    db, (128 * 32) >> 4, 0); break;
      default: wgmma_nc<256, 0, 0>(acc, da, db, (128 * 32) >> 4, 0);
    }
  } else {
#pragma unroll 1
    for (int r0 = 0; r0 < K; r0 += 16)
      Wgmma<16>::run<1, 1, 0>(acc, desc(a + r0 * 128, rows * 128, 1024),
                              desc(b + r0 * 32, 16, 256, 3), r0 > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int n = mode == 4 ? N : 16;
  for (int j = 0; j < n / 8; ++j)
    for (int e = 0; e < 4; ++e)
      out[frag_row(t, e) * n + frag_col(t, j, e)] = acc[4 * j + e];
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_update.py mirrors it
// field for field.  The value phase leaves the policy fields null, the
// policy phase `tgt`.  `scratch` (scratch_bytes, from ppoc_phase_bf16_plan)
// holds the blocks' partial gradients, their step statistics, the bf16
// shadow of W and the grid barrier's counter.
struct Bf16PhaseArgs {
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  void* scratch;
  float* stats;
  const int* dims;   // host array of n_layers + 1 widths
  long scratch_bytes;
  int n_layers, activation, n_steps, mb, t0, t0_ls, k_act;
  int cluster;       // blocks a cluster (0: the rule's; 1-16 forces one)
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

extern "C" int ppoc_phase_bf16_args_size() { return (int)sizeof(Bf16PhaseArgs); }

static void (*bf16_kernel(int policy))(const Bf16Dev) {
  return policy ? phase_bf16_kernel<true> : phase_bf16_kernel<false>;
}

static long align256(long n) { return (n + 255) & ~255L; }

struct Plan {
  Layout lay;
  int grid, cluster, occupancy, sms, rounds, group;
  long pstride, partial_off, bstats_off, shadow_off, barrier_off,
      scratch_bytes;
};

// The launch of `kernel` as `grid` blocks in clusters of c, cooperative
// (every block resident at once, or the launch fails).
static cudaError_t launch_config(void (*kernel)(const Bf16Dev), int c,
                                 int grid, long smem, cudaStream_t stream,
                                 cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* attr) {
  const cudaError_t err =
      configure<THREADS>(kernel, c, smem, stream, cfg, attr);
  cfg->gridDim = dim3(grid);
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg->numAttrs = 2;
  return err;
}

// R: the most rows (128, 64, 32 or 16, and no more than the minibatch
// needs) whose shared memory fits one block.  The cluster: of c in 16, 8,
// 4, 2, 1 the largest whose co-resident grid (the occupancy query's
// clusters x c) runs every row tile in the fewest rounds with the fewest
// blocks; the grid: the fewest whole clusters for that (the blocks take
// `rounds` tiles each).
// The partial sum's groups: ceil(grid / 16) blocks.
static int make_plan(const Bf16PhaseArgs* a, int policy, Plan* pl) {
  if (a->mb < 1 || a->n_steps < 0 || a->cluster < 0 || a->cluster > C_MAX ||
      (a->cluster & (a->cluster - 1)))
    return cudaErrorInvalidValue;
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int rows = MAX_ROWS;
  while (rows > 16 && rows >= 2 * pad16(a->mb)) rows /= 2;
  for (;; rows /= 2) {
    if (!make_layout(&pl->lay, a->n_layers, a->dims, rows))
      return cudaErrorInvalidValue;
    if (pl->lay.smem + STATIC_SMEM <= optin) break;
    if (rows == 16) return cudaErrorInvalidValue;
  }
  auto kernel = bf16_kernel(policy);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl->lay.smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                      pl->lay.smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_tiles = (a->mb + rows - 1) / rows;
  pl->rounds = 0;
  for (int c = C_MAX; c >= 1; c /= 2) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    int clusters = 0;
    if (a->cluster && c != a->cluster) continue;
    err = launch_config(kernel, c, c, pl->lay.smem, 0, &cfg, attr);
    cfg.numAttrs = 1;   // the query takes the cluster alone
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) continue;
    const int rounds = cdiv(n_tiles, clusters * c);
    const int grid = c * cdiv(cdiv(n_tiles, rounds), c);
    if (pl->rounds == 0 || rounds < pl->rounds ||
        (rounds == pl->rounds && grid < pl->grid)) {
      pl->rounds = rounds;
      pl->cluster = c;
      pl->grid = grid;
    }
  }
  if (pl->rounds == 0) return cudaErrorCooperativeLaunchTooLarge;
  pl->group = cdiv(pl->grid, GROUPS);
  pl->occupancy = occ;
  pl->sms = sms;
  const long P = pl->lay.net.n_params;
  pl->pstride = (P + 63) & ~63L;
  pl->partial_off = 0;
  pl->bstats_off = align256(pl->partial_off + 4L * pl->grid * pl->pstride);
  pl->shadow_off = align256(pl->bstats_off + 4L * pl->grid * STAT);
  pl->barrier_off = align256(pl->shadow_off + pl->lay.shadow_bytes);
  pl->scratch_bytes = align256(pl->barrier_off + 8);
  return cudaSuccess;
}

// out: rows per block, grid, threads, dynamic shared memory (bytes),
// scratch bytes, blocks per SM, SMs, tiles a block, the partial sum's
// group, the ring's stages and a stage's bytes, the cluster's blocks.  Returns a CUDA error code
// (0 = ok; cudaErrorInvalidValue for a net or minibatch it does not take).
extern "C" int ppoc_phase_bf16_plan(const Bf16PhaseArgs* a, int policy,
                                    long* out) {
  Plan pl;
  const int err = make_plan(a, policy, &pl);
  if (err != cudaSuccess) return err;
  out[0] = pl.lay.rows;
  out[1] = pl.grid;
  out[2] = THREADS;
  out[3] = pl.lay.smem;
  out[4] = pl.scratch_bytes;
  out[5] = pl.occupancy;
  out[6] = pl.sms;
  out[7] = pl.rounds;
  out[8] = pl.group;
  out[9] = STAGES;
  out[10] = pl.lay.stage_bytes;
  out[11] = pl.cluster;
  return 0;
}

static int launch_bf16(const Bf16PhaseArgs* a, cudaStream_t stream,
                       int policy) {
  Plan pl;
  int err = make_plan(a, policy, &pl);
  if (err != cudaSuccess) return err;
  if (a->scratch_bytes < pl.scratch_bytes) return cudaErrorInvalidValue;
  if (policy ? (a->k_act < 1 || a->k_act > MAX_ACT ||
                pl.lay.net.dim[a->n_layers] != a->k_act)
             : pl.lay.net.dim[a->n_layers] != 1)
    return cudaErrorInvalidValue;
  Bf16Dev d{};
  d.lay = pl.lay;
  d.x = a->x; d.tgt = a->tgt; d.act = a->act; d.lp_old = a->lp_old; d.adv = a->adv;
  d.p_in = a->p_in; d.m_in = a->m_in; d.v_in = a->v_in;
  d.p = a->p_out; d.m = a->m_out; d.v = a->v_out;
  d.ls_in = a->ls_in; d.mls_in = a->mls_in; d.vls_in = a->vls_in;
  d.ls = a->ls_out; d.mls = a->mls_out; d.vls = a->vls_out;
  unsigned char* scratch = (unsigned char*)a->scratch;
  d.partial = (float*)(scratch + pl.partial_off);
  d.bstats = (float*)(scratch + pl.bstats_off);
  d.shadow = (bf16*)(scratch + pl.shadow_off);
  d.barrier = (unsigned*)(scratch + pl.barrier_off);
  d.stats = a->stats;
  d.pstride = pl.pstride;
  d.activation = a->activation; d.n_steps = a->n_steps; d.mb = a->mb;
  d.t0 = a->t0; d.t0_ls = a->t0_ls; d.k_act = a->k_act;
  d.rounds = pl.rounds; d.group = pl.group;
  d.two_over_mb = a->two_over_mb; d.lp0 = a->lp0; d.ent0 = a->ent0;
  d.clip_lo = a->clip_lo; d.clip_hi = a->clip_hi; d.ent_coeff = a->ent_coeff;
  d.hyper = a->hyper;
  // the shadow's padding stays zero; the barrier starts at generation 0
  err = cudaMemsetAsync(scratch + pl.shadow_off, 0,
                        pl.scratch_bytes - pl.shadow_off, stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  err = launch_config(bf16_kernel(policy), pl.cluster, pl.grid, pl.lay.smem,
                      stream, &cfg, attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, bf16_kernel(policy), d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int ppoc_value_phase_bf16(const Bf16PhaseArgs* a,
                                     cudaStream_t stream) {
  return launch_bf16(a, stream, 0);
}

extern "C" int ppoc_policy_phase_bf16(const Bf16PhaseArgs* a,
                                      cudaStream_t stream) {
  return launch_bf16(a, stream, 1);
}

// One product of wgmma.cuh (wgmma_test_kernel's modes 0-2 and
// head_test_kernel's 3-5) on float32 inputs in device memory, for the card
// tests.
extern "C" int ppoc_wgmma_test(int mode, const float* A, const float* B,
                               float* out, int K, int N, cudaStream_t stream) {
  const bool head = mode >= 3;
  if (mode < 0 || mode > 5 || K < 1 || ((mode == 0 || mode == 3) && K > 64) ||
      (mode == 1 && K > 256) ||
      ((mode == 2 || mode == 5) && (K > 128 || K % 16)) ||
      ((mode == 0 || mode == 2 || mode == 4) &&
       (N < 64 || N > 256 || N % 64)))
    return cudaErrorInvalidValue;
  const int smem = 2 * 64 * 1024 + ALIGN;
  auto kernel = head ? head_test_kernel : wgmma_test_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, 128, smem, stream>>>(mode, A, B, out, K, N);
  return cudaGetLastError();
}

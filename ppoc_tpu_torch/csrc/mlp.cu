// K5: the whole MLP, forward and backward, one kernel per direction.
//
// Replaces ppoc_tpu/ops/pallas_mlp.py `mlp_forward` (custom VJP):
// `_forward_padded` -> `_fwd_kernel` and `_backward_padded` -> `_bwd_kernel`.
// Forward: per row tile, every layer's x @ W + b with the activation fused
// (the last layer linear), saving each hidden post-activation for the
// backward.  Backward: dW/db of every layer and optionally dX, with the
// activation derivative taken from the saved post-activation (relu: h > 0,
// tanh: 1 - h^2).
//
// What bounds it on the card: at the throughput shape (8192 rows through
// [3,128,128,1]) the forward is 0.28 GFLOP against ~8.5 MB of saved
// activations, and at the reacher regime's 16384 rows of [10,256,256,1]
// 2.25 GFLOP: operations bound both (4 and 34 us at 67 TFLOP/s FP32); the
// backward does twice the operations.
//
// What the design does about it:
// - The products run on the tensor cores, float32-accurate: each operand is
//   split into two tf32 values and each k-step of eight is
//   a_small b_big + a_big b_small + a_big b_big on mma.sync m16n8k8, formed
//   from zero and added into float32 accumulators (mma.cuh mma_3xtf32).  A
//   warp owns 32 x 32 outputs (2 x 4 fragments).  Every operand's fragment
//   loads are free of bank conflicts: activation tiles and the backward's
//   weights have row strides of 8 mod 16 floats, the forward's weights 4
//   mod 8, and the forward and dX products put k0 + 2t and k0 + 2t + 1 in
//   the mma's k slots t and t + 4, so a lane's A pair is one float2.
// - A row tile of `tile` rows (a multiple of 16), chosen at the launch
//   (ops/cuda_mlp.py tile_for) as the smallest whose grid fits the card's
//   resident blocks in one wave; blocks loop over tiles past that.
// - Two variants, picked by size at the launch.  Variant 0 copies every
//   weight into shared memory once per block with 16-byte cp.async copies,
//   in the layout the fragments read (zero padding to 8 rows and columns).
//   Variant 1 leaves them in global memory (L2-resident) and stages KS = 32
//   k-rows of a product's weight operand at a time into a cp.async double
//   buffer: the forward W[k0:k0+32, :], the dX product W[:, j0:j0+32], each
//   row copied as it lies in memory; a warp holds up to GW = 2 warp tiles
//   across a layer's slices.  Each output is summed over the same k-steps
//   in the same order in both, so the forward and dX are the same bits.
// - The backward's dW/db: per layer, rounds of one dW warp tile a warp
//   over the tile's rows, written to a shared-memory stage, and db as each
//   column's float32 sum over the tile's rows (round to nearest: the
//   tensor cores truncate, which a single cancelling sum shows); the
//   blocks of a thread-block cluster of up to CLUSTER = 16 then sum their
//   stages over distributed shared memory in a fixed pairwise tree over
//   the ranks, each rank a 1/C share, into one row a cluster of the
//   partial scratch (added in tile order where a block runs several
//   tiles); a second kernel sums those rows in the same tree.  No float
//   atomics: the result is the same bit for bit from run to run, with or
//   without dX.
//
// Measured on an H100 80GB HBM3 (PERF.md): a warp's product loop alone
// runs ~600 clocks a 32 x 32 k-step with two warps an SMSP, about 50
// TFLOP/s of float32 work on the card (the tensor pipe half busy; the loop
// is 150 instructions a k-step, 24 of them mma); a launch adds the weight
// staging (~4 us for 70 KB a block, every block reading the same lines),
// the 8-column heads (a quarter of a warp tile), the slices' barriers and,
// in the backward, two cluster barriers a dW round.  The forward at 8192
// rows of [3,128,128,1] takes ~0.023 ms, at 16384 rows of [10,256,256,1]
// ~0.12 ms; the backwards about twice and 2.7 times that.
#include "cluster.cuh"
#include "mma.cuh"

using namespace ppoc;

namespace {

constexpr int THREADS = 256;                 // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int TILE_STEP = 16;                // row tiles: multiples of mma M
constexpr int TILE_MAX = 128;
constexpr int TILE_MIN = TILE_STEP;          // sizes the variants' bytes
constexpr int KS = 32;                       // k rows of a staged weight slice
constexpr int XS_LD = KS + 8;                // row stride of a dX slice
constexpr int GW = 2;                        // warp tiles held across slices
constexpr int STAGE = WARPS * 32 * 32;       // one warp tile a warp of dW
constexpr int DW_GW1 = 2;                    // dW warp tiles a warp a round,
                                             // variant 1 (the slices' room)
constexpr int CLUSTER = 16;                  // most blocks a cluster sums

enum Product { P_FWD = 0, P_DX = 1, P_DW = 2 };

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// activation tiles: the widest layer, 8 mod 16
__host__ __device__ inline int tile_ld(int dmax) { return pad16(dmax) + 8; }
// the forward's W_l rows: 4 mod 8
__host__ __device__ inline int fwd_ld(int dout) { return pad8(dout) + 4; }
// the backward's W_l rows: 8 mod 16
__host__ __device__ inline int bwd_ld(int dout) { return pad16(dout + 8) - 8; }

struct MlpDev {
  Net net;
  const float* params;   // flat W0, b0, W1, b1, ...
  const float* x;        // [B, d0]
  float* out;            // [B, dL]
  float* hidden[MAX_LAYERS];   // [B, d_{l+1}] post-activation of layer l < L-1
  const float* g;        // [B, dL] cotangent of out
  float* dx;             // [B, d0], or null: not wanted
  float* partial;        // [gridDim.x / cluster, n_params]
  int B, act, tile, cluster, dmax, ld;
  int w_off[MAX_LAYERS];   // W_l in shared memory (variant 0)
  int b_off[MAX_LAYERS];   // b_l in shared memory (variant 0, forward)
  int w_floats;            // shared-memory floats of the weights (0: variant 1)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// Shared-memory loads and stores by address (the tiles are reached through
// pointer arrays, where the compiler would fall back to generic accesses)
__device__ __forceinline__ unsigned saddr(const float* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds2(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
// (no "memory" clobber: each stored pair's operands are read first, and the
// loads of the next pair, a bias from global memory, may be issued before)
__device__ __forceinline__ void sts2(unsigned a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y));
}

// f(r, c) for r < rows, c < w, the block's threads taking consecutive
// items of the row-major walk (no division a step).
template <class F>
__device__ __forceinline__ void for_rect(int rows, int w, F f) {
  if (w <= 0) return;
  const int dr = THREADS / w, dc = THREADS - dr * w;
  int r = threadIdx.x / w, c = threadIdx.x - r * w;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// dst[r][c] = src[r][c] for r < rows, c < cols by cp.async (16 bytes a copy
// where the rows allow it); zeros for r < rows, cols <= c < zc and for
// rows <= r < zr, c < zc.  The caller commits.
__device__ void stage_rect(float* dst, int dld, const float* src, int sld,
                           int rows, int cols, int zr, int zc) {
  if (((cols | sld) & 3) == 0 && ((uintptr_t)src & 15) == 0)
    for_rect(rows, cols >> 2, [&](int r, int c) {
      cp_async16(dst + r * dld + 4 * c, src + (size_t)r * sld + 4 * c);
    });
  else
    for_rect(rows, cols, [&](int r, int c) {
      cp_async4(dst + r * dld + c, src + (size_t)r * sld + c);
    });
  for_rect(rows, zc - cols,
           [&](int r, int c) { dst[r * dld + cols + c] = 0.0f; });
  for_rect(zr - rows, zc,
           [&](int r, int c) { dst[(rows + r) * dld + c] = 0.0f; });
}

// dst[r][c] = src[r][c] (global <- shared) for r < rows, c < cols.
__device__ void store_rect(float* dst, int dld, const float* src, int sld,
                           int rows, int cols) {
  if (((cols | dld) & 3) == 0 && ((uintptr_t)dst & 15) == 0)
    for_rect(rows, cols >> 2, [&](int r, int c) {
      *reinterpret_cast<float4*>(dst + (size_t)r * dld + 4 * c) =
          *reinterpret_cast<const float4*>(src + r * sld + 4 * c);
    });
  else
    for_rect(rows, cols, [&](int r, int c) {
      dst[(size_t)r * dld + c] = src[r * sld + c];
    });
}

// One warp's share of a product: acc[i][j] (m16 fragment i, n8 fragment j)
// of the 32 x 32 output tile at (m0, n0), summed over the k-steps k0, k0 +
// 8, ... < k1 in order, each by mma_3xtf32.  P_FWD and P_DX read A [m][k]
// row-major and put k + 2t and k + 2t + 1 in the mma's slots t and t + 4;
// P_FWD's B is W [k][n], P_DX's W [n][k] (a float2 a lane); P_DW's A is the
// transposed input tile [k][m] and its B the cotangent tile [k][n], slots
// in k order.  B's rows start at k = bk (a staged slice's first).  Where the
// tile passes M or N, its outside fragments read the last inside one's
// operands (their sums are never stored), so the loop has no branch and one
// body serves every tile: the kernels stay small enough for the instruction
// cache, and the fragments' mma chains interleave.
template <int P>
__device__ __forceinline__ void product(float (&acc)[2][4][4], const float* A,
                                        int lda, const float* B, int ldb,
                                        int m0, int n0, int M, int N, int k0,
                                        int k1, int bk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // byte offsets of fragment 1 (m) and of fragments 1-3 (n), clamped
  const int mi = M - m0 > 16 ? 1 : 0;
  const int nl = min(3, ((N - n0 + 7) >> 3) - 1);
  unsigned pa, pb;
  int sa, sb, oa, ob;
  if (P == P_DW) {
    pa = saddr(A + (k0 + t) * lda + m0 + g);
    pb = saddr(B + (k0 - bk + t) * ldb + n0 + g);
    sa = 32 * lda;
    sb = 32 * ldb;
    oa = 64;
    ob = 32;
  } else {
    pa = saddr(A + (m0 + g) * lda + k0 + 2 * t);
    sa = 32;
    oa = 64 * lda;
    if (P == P_FWD) {
      pb = saddr(B + (k0 - bk + 2 * t) * ldb + n0 + g);
      sb = 32 * ldb;
      ob = 32;
    } else {
      pb = saddr(B + (n0 + g) * ldb + k0 - bk + 2 * t);
      sb = 32;
      ob = 32 * ldb;
    }
  }
#pragma unroll 1
  for (int k = k0; k < k1; k += 8, pa += sa, pb += sb) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned p = pa + (i < mi ? i : mi) * oa;
      float v[4];
      if (P == P_DW) {
        v[0] = lds(p);
        v[1] = lds(p + 32);
        v[2] = lds(p + 16 * lda);
        v[3] = lds(p + 16 * lda + 32);
      } else {
        const float2 lo = lds2(p), hi = lds2(p + 32 * lda);
        v[0] = lo.x;
        v[1] = hi.x;
        v[2] = lo.y;
        v[3] = hi.y;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(v[q], ab[i][q], as[i][q]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned p = pb + (j < nl ? j : nl) * ob;
      float w0, w1;
      if (P == P_FWD) {
        w0 = lds(p);
        w1 = lds(p + 4 * ldb);
      } else if (P == P_DX) {
        const float2 q = lds2(p);
        w0 = q.x;
        w1 = q.y;
      } else {
        w0 = lds(p);
        w1 = lds(p + 16 * ldb);
      }
      uint32_t bb[2], bs[2];
      split_tf32(w0, bb[0], bs[0]);
      split_tf32(w1, bb[1], bs[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma_3xtf32(acc[i][j], ab[i], as[i], bb, bs);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

// f(r, c, s) for each of the warp tile's outputs (r, c) and (r, c + 1),
// the pair stored at dst[r][c] (shared memory).
template <class F>
__device__ __forceinline__ void epilogue(const float (&acc)[2][4][4],
                                         float* dst, int ld, int m0, int n0,
                                         int M, int N, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned base = saddr(dst);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (m0 + 16 * i >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + 8 * j >= N) continue;
      const int c = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 16 * i + g + 8 * h;
        sts2(base + 4 * (r * ld + c), f(r, c, acc[i][j][2 * h]),
             f(r, c + 1, acc[i][j][2 * h + 1]));
      }
    }
  }
}

// The forward's epilogue: out = act(s + b) (linear on the last layer), 0
// past dout.
struct FwdOut {
  const float* bias;
  int dout, act;
  bool hidden;
  __device__ float operator()(int, int c, float s) const {
    if (c >= dout) return 0.0f;
    const float h = s + bias[c];
    return hidden ? act_fwd(h, act) : h;
  }
};

// The dX product's epilogue, in place over the layer's input tile: the
// cotangent of the layer below, s * act'(h) with h the saved
// post-activation, or (layer 0) dX itself.
struct DxOut {
  const float* in;
  int ld, act;
  bool gate;
  __device__ float operator()(int r, int c, float s) const {
    return gate ? s * act_grad(in[r * ld + c], act) : s;
  }
};

// The warp tiles of an M x N product: 32 x 32 each, row-major over the tile
// grid.
struct Tiles {
  int tn, n;
  __device__ Tiles(int M, int N) : tn((N + 31) >> 5), n(((M + 31) >> 5) * tn) {}
  __device__ int m0(int wt) const { return (wt / tn) * 32; }
  __device__ int n0(int wt) const { return (wt % tn) * 32; }
};

// out = in @ W + b for one layer, variant 0 (W, b in shared memory).
__device__ void fwd_layer_smem(const float* in, float* o, int ld, int T,
                               const float* W, int K, int N, FwdOut f) {
  const Tiles tl(T, N);
  for (int wt = threadIdx.x >> 5; wt < tl.n; wt += WARPS) {
    float acc[2][4][4];
    zero_acc(acc);
    product<P_FWD>(acc, in, ld, W, fwd_ld(f.dout), tl.m0(wt), tl.n0(wt), T,
                   N, 0, K, 0);
    epilogue(acc, o, ld, tl.m0(wt), tl.n0(wt), T, N, f);
  }
}

// The slices of a variant-1 product: `stage_slice(buf, s)` stages slice s
// (k rows s*KS ...) into buf; each round of WARPS * GW warp tiles runs
// every slice through a cp.async double buffer (the next slice's copies
// issued after the barrier that ends the last reads of its buffer), then
// `finish(acc, m0, n0)`.
template <int P, class SS, class Fin>
__device__ void sliced_product(const float* A, int ld, float* sl,
                               int slice_floats, int sld, int M, int N,
                               int K, SS stage_slice, Fin finish) {
  const Tiles tl(M, N);
  const int warp = threadIdx.x >> 5, nsl = (K + KS - 1) / KS;
  float* buf[2] = {sl, sl + slice_floats};
  for (int base = 0; base < tl.n; base += WARPS * GW) {
    float acc[GW][2][4][4];
#pragma unroll
    for (int u = 0; u < GW; ++u) zero_acc(acc[u]);
    stage_slice(buf[0], 0);
    cp_async_commit();
    for (int s = 0; s < nsl; ++s) {
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < nsl) {
        stage_slice(buf[(s + 1) & 1], s + 1);
        cp_async_commit();
      }
      const int k0 = s * KS, k1 = min(K, k0 + KS);
#pragma unroll
      for (int u = 0; u < GW; ++u) {
        const int wt = base + warp + u * WARPS;
        if (wt < tl.n)
          product<P>(acc[u], A, ld, buf[s & 1], sld, tl.m0(wt), tl.n0(wt),
                     M, N, k0, k1, k0);
      }
    }
#pragma unroll
    for (int u = 0; u < GW; ++u) {
      const int wt = base + warp + u * WARPS;
      if (wt < tl.n) finish(acc[u], tl.m0(wt), tl.n0(wt));
    }
    __syncthreads();   // the last slice is read before buf[0] is staged
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1) mlp_fwd_kernel(const MlpDev a) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = a.net;
  const int L = net.n_layers, T = a.tile, ld = a.ld, d0 = net.dim[0];
  float* buf[2] = {smem + a.w_floats, smem + a.w_floats + T * ld};
  float* sl = smem + a.w_floats + 2 * T * ld;   // variant 1's slices
  if (V == 0) {
    for (int l = 0; l < L; ++l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      stage_rect(smem + a.w_off[l], fwd_ld(dout), a.params + net.w_off[l],
                 dout, din, dout, pad8(din), pad8(dout));
      stage_rect(smem + a.b_off[l], pad8(dout), a.params + net.b_off[l],
                 dout, 1, dout, 1, pad8(dout));
    }
    cp_async_commit();
  }
  const int n_tiles = (a.B + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * T, rows = min(T, a.B - r0);
    stage_rect(buf[0], ld, a.x + (size_t)r0 * d0, d0, rows, d0, T, pad8(d0));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      const int K = pad8(din), N = pad8(dout);
      const float* in = buf[l & 1];
      float* o = buf[(l + 1) & 1];
      const bool hidden = l < L - 1;
      const FwdOut f{V == 0 ? smem + a.b_off[l] : a.params + net.b_off[l],
                     dout, a.act, hidden};
      if (V == 0) {
        fwd_layer_smem(in, o, ld, T, smem + a.w_off[l], K, N, f);
      } else {
        const float* Wg = a.params + net.w_off[l];
        const int sld = fwd_ld(dout);
        sliced_product<P_FWD>(
            in, ld, sl, KS * fwd_ld(a.dmax), sld, T, N, K,
            [&](float* dst, int s) {
              const int k0 = s * KS;
              stage_rect(dst, sld, Wg + (size_t)k0 * dout, dout,
                         max(0, min(KS, din - k0)), dout, min(KS, K - k0), N);
            },
            [&](const float (&acc)[2][4][4], int m0, int n0) {
              epilogue(acc, o, ld, m0, n0, T, N, f);
            });
      }
      __syncthreads();
      store_rect((hidden ? a.hidden[l] : a.out) + (size_t)r0 * dout, dout, o,
                 ld, rows, dout);
    }
    __syncthreads();   // the last layer's tile is read before buf[0] is staged
  }
}

// The sum of v[0..C) over a fixed pairwise tree (v[b] = 0 for b >= C, so
// any C up to CLUSTER takes the tree of C).
template <class T>
__device__ __forceinline__ T tree_sum(T (&v)[CLUSTER]) {
#pragma unroll
  for (int step = 1; step < CLUSTER; step *= 2)
#pragma unroll
    for (int i = 0; i < CLUSTER; i += 2 * step) v[i] = v[i] + v[i + step];
  return v[0];
}

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A warp tile's 32 x 32 dW in the stage, row-major, each row's 8-column
// groups permuted by the row (group ^ (row & 3)): the fragments' float2
// stores and the reduction's float4 loads both meet distinct banks.
__device__ __forceinline__ int stage_at(int r, int c) {
  return 32 * r + (c ^ (8 * (r & 3)));
}

__device__ __forceinline__ void stage_tile(const float (&acc)[2][4][4],
                                           float* slot) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned base = saddr(slot);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sts2(base + 4 * stage_at(16 * i + g + 8 * h, 8 * j + 2 * t),
             acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// One round's dW warp tiles (`slots` of them; in round 0 also the db column
// sums `dbs`), summed over the cluster: each rank takes a 1/C share, sums
// the C blocks' over distributed shared memory (tree_sum) and writes (first
// tile) or adds them into the cluster's partial row.
__device__ void reduce_round(const MlpDev& a, const float* stage,
                             const float* dbs, float* row, int l,
                             const Tiles& tl, int round, int slots,
                             bool first) {
  const Net& net = a.net;
  const int din = net.dim[l], dout = net.dim[l + 1], C = a.cluster;
  const int rank = cluster_rank();
  const int per = slots * 256 / C;   // float4s of the stage a rank sums
  for (int q = rank * per + threadIdx.x; q < (rank + 1) * per;
       q += THREADS) {
    const int u = q >> 8, r = (q >> 3) & 31, c4 = q & 7;
    const int wt = round * slots + u;
    if (wt >= tl.n) continue;
    const int m = tl.m0(wt) + r, n = tl.n0(wt) + 4 * c4;
    if (m >= din || n >= dout) continue;
    const float* p = stage + 1024 * u + stage_at(r, 4 * c4);
    float4 v[CLUSTER];
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      v[b] = b < C ? ld_cluster4(cluster_addr(p, b))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 s = tree_sum(v);
    float* dst = row + net.w_off[l] + m * dout + n;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < dout) dst[e] = first ? sv[e] : dst[e] + sv[e];
  }
  if (round != 0) return;
  const int dper = (dout + C - 1) / C;
  for (int j = rank * dper + threadIdx.x; j < min(dout, (rank + 1) * dper);
       j += THREADS) {
    float v[CLUSTER];
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      v[b] = b < C ? ld_cluster(cluster_addr(dbs + j, b)) : 0.0f;
    const float s = tree_sum(v);
    float* dst = row + net.b_off[l] + j;
    *dst = first ? s : *dst + s;
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1) mlp_bwd_kernel(const MlpDev a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DWG = V == 0 ? 1 : DW_GW1;   // dW warp tiles a warp a round
  const Net& net = a.net;
  const int L = net.n_layers, T = a.tile, ld = a.ld, d0 = net.dim[0];
  const int dL = net.dim[L];
  float* bufs[2] = {smem + a.w_floats, smem + a.w_floats + T * ld};
  // variant 0: the stage and db's column sums; variant 1: the dX slices,
  // and those between them
  float* region = smem + a.w_floats + 2 * T * ld;
  float* dbs = region + DWG * STAGE;
  if (V == 0) {
    for (int l = 0; l < L; ++l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      stage_rect(smem + a.w_off[l], bwd_ld(dout), a.params + net.w_off[l],
                 dout, din, dout, pad8(din), pad8(dout));
    }
    cp_async_commit();
  }
  float* row = a.partial + (size_t)(blockIdx.x / a.cluster) * net.n_params;
  const int n_tiles = (a.B + T - 1) / T;
  const int iters = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int warp = threadIdx.x >> 5;
  for (int it = 0; it < iters; ++it) {
    // every block of a cluster runs every round: past the last tile, on
    // zero rows
    const int r0 = (it * gridDim.x + blockIdx.x) * T;
    const int rows = max(0, min(T, a.B - r0));
    float* G = bufs[0];   // the layer's output cotangent
    float* A = bufs[1];   // the layer's input, then the next cotangent
    stage_rect(G, ld, a.g + (size_t)r0 * dL, dL, rows, dL, T, pad8(dL));
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      stage_rect(A, ld, (l ? a.hidden[l - 1] : a.x) + (size_t)r0 * din, din,
                 rows, din, T, pad16(din));
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      // db: each column's sum over the tile's rows, in row order
      for (int j = threadIdx.x; j < dout; j += THREADS) {
        float s = 0.0f;
        for (int r = 0; r < T; ++r) s += G[r * ld + j];
        dbs[j] = s;
      }
      // dW: M = din, N = dout, K = the tile's rows
      const Tiles tl(pad16(din), pad8(dout));
      for (int round = 0; round * WARPS * DWG < tl.n; ++round) {
#pragma unroll
        for (int u = 0; u < DWG; ++u) {
          const int wt = round * WARPS * DWG + u * WARPS + warp;
          if (wt < tl.n) {
            float acc[2][4][4];
            zero_acc(acc);
            product<P_DW>(acc, A, ld, G, ld, tl.m0(wt), tl.n0(wt),
                          pad16(din), pad8(dout), 0, T, 0);
            stage_tile(acc, region + 1024 * (u * WARPS + warp));
          }
        }
        cluster_sync();
        reduce_round(a, region, dbs, row, l, tl, round, WARPS * DWG, it == 0);
        cluster_sync();   // the stage is written again next round
      }
      if (l == 0 && a.dx == nullptr) break;
      // the cotangent of layer l - 1 (or dX), in place over A
      const int K = pad8(dout), N = pad8(din);
      const DxOut f{A, ld, a.act, l > 0};
      if (V == 0) {
        const Tiles tx(T, N);
        for (int wt = warp; wt < tx.n; wt += WARPS) {
          float acc[2][4][4];
          zero_acc(acc);
          product<P_DX>(acc, G, ld, smem + a.w_off[l], bwd_ld(dout),
                        tx.m0(wt), tx.n0(wt), T, N, 0, K, 0);
          epilogue(acc, A, ld, tx.m0(wt), tx.n0(wt), T, N, f);
        }
      } else {
        const float* Wg = a.params + net.w_off[l];
        sliced_product<P_DX>(
            G, ld, region, pad8(a.dmax) * XS_LD, XS_LD, T, N, K,
            [&](float* dst, int s) {
              const int j0 = s * KS;
              stage_rect(dst, XS_LD, Wg + j0, dout, din, min(KS, dout - j0),
                         N, min(KS, K - j0));
            },
            [&](const float (&acc)[2][4][4], int m0, int n0) {
              epilogue(acc, A, ld, m0, n0, T, N, f);
            });
      }
      __syncthreads();
      if (l == 0)
        store_rect(a.dx + (size_t)r0 * d0, d0, A, ld, rows, d0);
      float* tmp = G;
      G = A;
      A = tmp;
    }
    __syncthreads();   // dX is read before the next tile is staged
  }
}

// grads[i] = the sum over rows b of partial[b][i]: tree_sum over each run
// of CLUSTER rows, those added in order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ grads, int n_rows,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b0 = 0; b0 < n_rows; b0 += CLUSTER) {
    float v[CLUSTER];
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      v[b] = b0 + b < n_rows ? partial[(size_t)(b0 + b) * n + i] : 0.0f;
    s = b0 ? s + tree_sum(v) : tree_sum(v);
  }
  grads[i] = s;
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_mlp.py mirrors it field
// for field as a ctypes.Structure.  The forward leaves g, dx, partial and
// grads null; the backward reads params, x and hidden and writes partial,
// grads and (when not null) dx.  tile, grid and cluster: the launch's rows a
// tile, blocks and (backward) blocks a cluster, from the wrapper's plan.
struct MlpArgs {
  const float* params;
  const float* x;
  float* out;
  float* hidden[MAX_LAYERS];
  const float* g;
  float* dx;
  float* partial;    // [grid / cluster, n_params]
  float* grads;
  const int* dims;   // host array of n_layers + 1 widths
  int n_layers, activation, B;
  int variant;       // 0: weights in shared memory, 1: in global memory
  int tile, grid, cluster;
};

extern "C" int ppoc_mlp_args_size() { return (int)sizeof(MlpArgs); }

// The device struct of `a` for `variant` and one direction, at a->tile rows
// (0: TILE_MIN).
static bool make_dev(const MlpArgs* a, MlpDev* d, int variant, bool backward) {
  const int tile = a->tile ? a->tile : TILE_MIN;
  if (variant < 0 || variant > 1 || tile < TILE_MIN || tile > TILE_MAX ||
      tile % TILE_STEP || !make_net(&d->net, a->n_layers, a->dims))
    return false;
  d->params = a->params;
  d->x = a->x;
  d->out = a->out;
  for (int l = 0; l < MAX_LAYERS; ++l) d->hidden[l] = a->hidden[l];
  d->g = a->g;
  d->dx = a->dx;
  d->partial = a->partial;
  d->B = a->B;
  d->act = a->activation;
  d->tile = tile;
  d->cluster = backward && a->cluster > 0 ? a->cluster : 1;
  d->dmax = 1;
  for (int l = 0; l <= a->n_layers; ++l)
    d->dmax = a->dims[l] > d->dmax ? a->dims[l] : d->dmax;
  d->ld = tile_ld(d->dmax);
  int off = 0;
  for (int l = 0; l < a->n_layers; ++l) {
    const int din = a->dims[l], dout = a->dims[l + 1];
    d->w_off[l] = off;
    off += pad8(din) * (backward ? bwd_ld(dout) : fwd_ld(dout));
    d->b_off[l] = off;
    if (!backward) off += pad8(dout);
  }
  d->w_floats = variant == 0 ? off : 0;
  return true;
}

static long smem_bytes(const MlpDev& d, int variant, bool backward) {
  long f = d.w_floats + 2L * d.tile * d.ld;
  if (!backward)
    f += variant == 0 ? 0 : 2L * KS * fwd_ld(d.dmax);
  else if (variant == 0)
    f += STAGE + pad8(d.dmax);
  else
    f += 2L * pad8(d.dmax) * XS_LD > DW_GW1 * STAGE + pad8(d.dmax)
             ? 2L * pad8(d.dmax) * XS_LD
             : DW_GW1 * STAGE + pad8(d.dmax);
  return f * (long)sizeof(float);
}

// For `variant` at a->tile rows (0: TILE_MIN): sizes[0], [1]: dynamic
// shared-memory bytes of the forward and backward; sizes[2]: the tile;
// sizes[3]: n_params.  Returns false (0) for a shape the kernels refuse.
extern "C" int ppoc_mlp_sizes(const MlpArgs* a, int variant, long* sizes) {
  MlpDev f{}, b{};
  if (!make_dev(a, &f, variant, false) || !make_dev(a, &b, variant, true))
    return 0;
  sizes[0] = smem_bytes(f, variant, false);
  sizes[1] = smem_bytes(b, variant, true);
  sizes[2] = f.tile;
  sizes[3] = f.net.n_params;
  return 1;
}

using Kernel = void (*)(const MlpDev);

static Kernel kernel_of(int variant, bool backward) {
  if (backward) return variant == 0 ? mlp_bwd_kernel<0> : mlp_bwd_kernel<1>;
  return variant == 0 ? mlp_fwd_kernel<0> : mlp_fwd_kernel<1>;
}

// The launch configuration of `d`'s kernel on `grid` blocks (clusters of
// d.cluster in the backward), its attributes set.
static cudaError_t config(const MlpDev& d, int variant, bool backward,
                          int grid, cudaStream_t stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const cudaError_t err =
      configure<THREADS>(kernel_of(variant, backward), d.cluster,
                         smem_bytes(d, variant, backward), stream, cfg, attr);
  cfg->gridDim = dim3(grid);
  return err;
}

// How many blocks of `variant`'s forward (backward) at a->tile rows (and
// a->cluster blocks a cluster) the card holds at once: out[0].
extern "C" int ppoc_mlp_resident(const MlpArgs* a, int variant, int backward,
                                 long* out) {
  MlpDev d{};
  if (!make_dev(a, &d, variant, backward != 0) || d.cluster > CLUSTER ||
      (d.cluster & (d.cluster - 1)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config(d, variant, backward, d.cluster, nullptr, &cfg,
                           &attr);
  if (err != cudaSuccess) return err;
  int n = 0;
  if (backward) {
    err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel_of(variant, true),
                                         &cfg);
    out[0] = (long)n * d.cluster;
  } else {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(variant, false), THREADS,
          smem_bytes(d, variant, false));
    out[0] = (long)n * sms;
  }
  return err;
}

static int launch(const MlpArgs* a, bool backward, cudaStream_t stream) {
  MlpDev d{};
  if (!make_dev(a, &d, a->variant, backward) || a->B < 1 || a->grid < 1 ||
      (backward && (d.cluster > CLUSTER || (d.cluster & (d.cluster - 1)) ||
                    a->grid % d.cluster)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config(d, a->variant, backward, a->grid, stream, &cfg,
                           &attr);
  if (err != cudaSuccess) return err;
  if (!backward) cfg.numAttrs = 0;   // no cluster
  err = cudaLaunchKernelEx(&cfg, kernel_of(a->variant, backward), d);
  if (err != cudaSuccess) return err;
  if (backward) {
    const int n = d.net.n_params;
    sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        d.partial, a->grads, a->grid / d.cluster, n);
  }
  return cudaGetLastError();
}

extern "C" int ppoc_mlp_forward(const MlpArgs* a, cudaStream_t stream) {
  return launch(a, false, stream);
}

extern "C" int ppoc_mlp_backward(const MlpArgs* a, cudaStream_t stream) {
  return launch(a, true, stream);
}

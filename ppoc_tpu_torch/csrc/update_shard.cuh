// K3, K4 (Gaussian) and K6 (categorical) for nets past one block's shared
// memory: a whole PPO value or policy phase (every epoch x minibatch step)
// as ONE thread-block cluster of SHARDS blocks that shard the weights by
// column.
//
// Replaces ppoc_tpu/ops/pallas_update.py `value_phase_fused` ->
// `_run_value_phase` -> `_value_kernel`/`_value_kernel_unrolled` (K3),
// `policy_phase_fused` -> `_policy_kernel`/`_policy_kernel_unrolled` (K4,
// Gaussian) and `policy_phase_fused_categorical` -> `_policy_kernel_cat`/
// `_policy_kernel_cat_unrolled` (K6) for the nets whose weights, one
// gradient partial and a tile of activations do not fit one block
// (update_cluster.cu's limit: 2x256, the [10,256,256,1] value net, is
// 277.5 KB padded against 227 KB; CARTPOLE_WIDE's [4,256,256,2] policy).
// Each step computes what update_cluster.cu's does: forward, the loss
// gradient in closed form (K3: 2/mb (v - target); K4: the clipped
// surrogate through the unclipped branch, and the log_std gradient with
// the entropy term; K6: cluster.cuh's categorical_head), backward, Adam
// (K4: and log_std's Adam).
//
// What bounds it on the card: not FLOPs.  A step of REACHER_REF's value
// net on 64 rows is ~17 MFLOP, 0.26 us of the card's FP32 rate.  The steps
// are a serial chain through Adam; within a step the products are small
// and dependent, each closed by a barrier, and the weights (a quarter of a
// million floats at 2x256) fit no SM: one SM staging them from L2 for every
// product, as the one-block body this replaces did, took ~420 us a step.
//
// What the design does about it: the weights never move.  Every layer is
// one of three kinds, set from the head down:
//  * ROW (the head, and every second layer below it): block c holds the
//    rows J_c of W (its input columns) and the whole bias; its product is
//    a partial of every output, and the cluster sums the C partials in rank
//    order over distributed shared memory, every block reading every
//    partial, so every block ends with the same bits (the exchange tile,
//    sub x width, is the only data that crosses blocks within a sub-tile);
//  * COL (the layer below a ROW): block c holds the columns J_c of W and
//    b, and computes its columns of the output from the whole input; its
//    input gradient is a partial, summed over the cluster like a ROW
//    output where the layer below is a ROW;
//  * REP (layer 0 where the pattern would make it a ROW, as for the
//    2-hidden-layer nets the paths run, [d0, h1, h2, k] = REP, COL, ROW):
//    d0 is 3-10, so every block holds W0 and computes h1 whole; its
//    gradient is a partial (the COL above hands it a partial), summed over
//    the cluster once a minibatch.
// Every block walks every row of the minibatch in sub-tiles of S rows
// (S the most of 64, 32, ... that fits; the next sub-tile prefetched with
// cp.async), so the loss gradient, its sums and K4's log_std gradient are
// the same bits in every block and cross no block (K6's head is a ROW
// layer: after its exchange every block holds all K logits of every row,
// so its softmax, logit gradient, surrogate and entropy sums too).  After
// the minibatch's
// last sub-tile a cluster barrier; then block c sums its 1/C slice of the
// REP partials in rank order, runs Adam on it and writes the new weights
// into every block's replica, and runs Adam on its own shards (their m and
// v in shared memory where they fit, else in the output tensors in global
// memory, each element read and written by its owner only) and on the
// replicated ROW biases (their m and v in shared memory, the same bits in
// every block); a second cluster barrier.  The products are
// update_cluster.cu's register-tiled loops from shared memory
// (cluster.cuh), on ST = 512 threads, and, for a COL layer's few output
// columns, a tile of a row by 4 columns a thread.
//
// Deterministic: no atomics; within a block every sum in row order or a
// fixed tree, across blocks in rank order.  The bits depend on C (SHARDS
// for every minibatch size, so chained one-step launches equal one long
// launch) and on S (a function of the widths).
#pragma once

#include <cooperative_groups.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;
using namespace ppoc;

namespace {

enum Mode { REP = 0, COL = 1, ROW = 2 };

constexpr int SHARDS = 16;        // blocks in the cluster
constexpr int ST = 512;           // threads a block
constexpr int S_MAX = 64;         // the most rows of a sub-tile
constexpr int S_MIN_SMEM = 16;    // fewer: spill the weights (see Store)
// dynamic shared memory a block may take: the H100's opt-in, 232,448 B,
// less the 1 KB the launch budgets for static shared memory
constexpr long BUDGET = 232448 - 1024;

// The width of a shard of `width` units over C blocks: a multiple of 4, so
// every shard starts on a float4.
__host__ __device__ inline int chunk_of(int width, int C) {
  return r4((width + C - 1) / C);
}

// This block's units [lo, lo + n) of `width` (n may be 0).
struct Span {
  int lo, n;
};
__device__ __forceinline__ Span span_of(int width, int C, int rank) {
  const int lo = min(width, rank * chunk_of(width, C));
  return {lo, min(width, lo + chunk_of(width, C)) - lo};
}

// The layout of one block, in floats (the same offsets in every block, so
// an exchange tile or a partial has one address in each).
struct ShardNet {
  Net net;
  int C, S;                  // blocks, rows of a sub-tile
  int spill;                 // COL and ROW weights in global memory (Store)
  int mode[MAX_LAYERS];
  int rows[MAX_LAYERS];      // rows of the block's W_l (zero past its inputs)
  int cols[MAX_LAYERS];      // its columns: COL the shard's, else dim[l + 1]
  int ld[MAX_LAYERS];        // its row stride: 4 * odd
  int pw[MAX_LAYERS];        // W_l in its params (the gradient: + n_par)
  int pb[MAX_LAYERS];        // b_l (r4(cols) floats)
  int n_par;                 // floats of the params in shared memory
  int n_gpar;                // and in the block's global share (spill)
  int ts[MAX_LAYERS + 1];    // row stride of layer l's output tile; ts[0]: x
  int h_off[MAX_LAYERS];     // layer l's output tile in the activations
  int bm[MAX_LAYERS];        // ROW: its bias's m in the moments (v: + nbm)
  int nbm;                   // floats of the ROW biases' m
  int mom;                   // the block's own m and v in shared memory
  int mo[MAX_LAYERS];        // COL, ROW: their m there (v: + nmo); REP: its
  int nmo;                   // slice's; floats of the own m
  int xw;                    // row stride of an exchange tile
  int o_p, o_h, o_xch, o_zero, o_x, o_e, o_rs, o_ls, o_bm, o_mo, total;
};

bool make_shard_net(ShardNet* sn, int n_layers, const int* dims, int C,
                    int S, int spill, int mom) {
  if (!make_net(&sn->net, n_layers, dims) || C < 1 || S < 1) return false;
  sn->C = C;
  sn->S = S;
  sn->spill = spill;
  sn->mom = mom;
  const int L = n_layers;
  sn->mode[L - 1] = ROW;
  for (int l = L - 2; l >= 0; --l)
    sn->mode[l] = sn->mode[l + 1] == ROW ? COL : ROW;
  if (L >= 2 && sn->mode[0] == ROW) sn->mode[0] = REP;
  int soff = 0, goff = 0, h = 0, nbm = 0, nmo = 0, xw = 4;
  sn->ts[0] = w_ld(dims[0]);
  for (int l = 0; l < L; ++l) {
    const int din = dims[l], dout = dims[l + 1], m = sn->mode[l];
    sn->rows[l] = m == ROW ? chunk_of(din, C) : r4(din);
    sn->cols[l] = m == COL ? chunk_of(dout, C) : dout;
    sn->ld[l] = w_ld(sn->cols[l]);
    int& off = spill && m != REP ? goff : soff;
    sn->pw[l] = off;
    off += sn->rows[l] * sn->ld[l];
    sn->pb[l] = off;
    off += r4(sn->cols[l]);
    sn->ts[l + 1] = w_ld(sn->cols[l]);
    sn->h_off[l] = h;
    h += S * sn->ts[l + 1];
    sn->bm[l] = nbm;
    if (m == ROW) {
      nbm += r4(dout);
      xw = sn->ts[l + 1] > xw ? sn->ts[l + 1] : xw;
    }
    // the block's own elements (own_params), or its REP slice (rep_slice)
    sn->mo[l] = nmo;
    nmo += m == REP   ? 4 * (((sn->rows[l] * sn->ld[l] + r4(dout)) / 4 +
                                C - 1) / C)
           : m == COL ? (sn->rows[l] + 1) * sn->cols[l]
                      : sn->rows[l] * dout;
  }
  sn->n_par = soff;
  sn->n_gpar = goff;
  sn->nbm = nbm;
  sn->nmo = nmo;
  sn->xw = xw;
  sn->o_p = soff;                                  // the gradient
  sn->o_h = 2 * soff;                              // activations (+8: the
  sn->o_xch = sn->o_h + h + 8;                     // dW tile reads 8 columns)
  sn->o_zero = sn->o_xch + 2 * S * xw;             // two exchange tiles
  sn->o_x = sn->o_zero + xw;                       // a zero bias
  sn->o_e = sn->o_x + 2 * S * sn->ts[0];           // x, two sub-tiles
  sn->o_rs = sn->o_e + 2 * S * ES;                 // extras, two sub-tiles
  sn->o_ls = sn->o_rs + S * RSS;                   // row stats
  sn->o_bm = sn->o_ls + 4 * MAX_ACT;               // log_std, its m and v
  sn->o_mo = sn->o_bm + 2 * nbm;                   // ROW biases' m and v
  sn->total = sn->o_mo + (mom ? 2 * r4(nmo) : 0);  // own m and v
  return true;
}

// The layout of `dims` on C blocks: the largest sub-tile (S_MAX, 32, ...,
// S_MIN_SMEM) that fits BUDGET with every weight in shared memory, with
// the block's own Adam moments there too if they fit; else, spilled, the
// largest (S_MAX, ..., 1) that fits; else the spilled 1-row one (which the
// launch refuses).  False for a shape refused.
bool shard_layout(ShardNet* sn, int n_layers, const int* dims, int C) {
  for (int spill = 0; spill <= 1; ++spill)
    for (int S = S_MAX; S >= (spill ? 1 : S_MIN_SMEM); S >>= 1)
      for (int mom = !spill; mom >= 0; --mom) {
        if (!make_shard_net(sn, n_layers, dims, C, S, spill, mom))
          return false;
        if (4L * sn->total <= BUDGET) return true;
      }
  return true;
}

struct ShardDev {
  ShardNet sn;
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  float *scratch, *stats;
  int activation, n_steps, mb, t0, t0_ls, k_act;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
  const int32_t* act_idx;   // K6: the rows' class ids
};

// Where a block's weights and their gradient live: shared memory; with
// SPILL (nets whose COL and ROW weights pass shared memory, such as three
// hidden layers of 448) every layer's but a REP one in the block's share
// of a global scratch, 2 n_gpar floats, which stays in L2 and which the
// products read with plain loads (Adam rewrites it every step).
template <bool SPILL>
struct Store {
  float *W, *P, *gW, *gP;
  __device__ __forceinline__ bool spilled(const ShardNet& sn, int l) const {
    return SPILL && sn.mode[l] != REP;
  }
  __device__ __forceinline__ float* w(const ShardNet& sn, int l) const {
    return (spilled(sn, l) ? gW : W) + sn.pw[l];
  }
  __device__ __forceinline__ float* b(const ShardNet& sn, int l) const {
    return (spilled(sn, l) ? gW : W) + sn.pb[l];
  }
  __device__ __forceinline__ float* gw(const ShardNet& sn, int l) const {
    return (spilled(sn, l) ? gP : P) + sn.pw[l];
  }
  __device__ __forceinline__ float* gb(const ShardNet& sn, int l) const {
    return (spilled(sn, l) ? gP : P) + sn.pb[l];
  }
};

// Layer l's inputs (ROW: the block's rows of W) and outputs (COL: its
// columns) on block `rank`.
__device__ __forceinline__ Span in_span(const ShardNet& sn, int l, int rank) {
  return sn.mode[l] == ROW ? span_of(sn.net.dim[l], sn.C, rank)
                           : Span{0, sn.net.dim[l]};
}
__device__ __forceinline__ Span out_span(const ShardNet& sn, int l,
                                         int rank) {
  return sn.mode[l] == COL ? span_of(sn.net.dim[l + 1], sn.C, rank)
                           : Span{0, sn.net.dim[l + 1]};
}

// Adam on one parameter, as update_cluster.cu's: the bias corrections
// folded into `step` and bc2, eps outside the sqrt.
__device__ __forceinline__ void adam1(float g, float& m, float& v, float& w,
                                      float step, float bc2,
                                      const AdamHyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  w = w - step * m / (sqrtf(v / bc2) + h.eps);
}

// The REP layer's padded slot `o` (from its W) -> flat index, or -1.
__device__ __forceinline__ int rep_flat(const ShardNet& sn, int o) {
  const int wreg = sn.rows[0] * sn.ld[0], dout = sn.net.dim[1];
  if (o < wreg) {
    const int k = o / sn.ld[0], j = o - k * sn.ld[0];
    return k < sn.net.dim[0] && j < dout ? sn.net.w_off[0] + k * dout + j
                                         : -1;
  }
  return o - wreg < dout ? sn.net.b_off[0] + (o - wreg) : -1;
}

// out[r][j] = act(sum_k A[r][k] W[k][j] + b[j]) for r < R, j < N, each sum
// in k order; K = r4(width) (A's columns and W's rows past it are zero).
// For a COL layer's few columns: a thread a row and 4 columns.
__device__ __forceinline__ void fwd_narrow(
    int R, int N, int K, const float* A, int as, const float* W, int ld,
    const float* b, float* out, int os, int act) {
  const int g = (N + 3) >> 2;
  for (int t = threadIdx.x; t < R * g; t += ST) {
    const int r = t / g, c = 4 * (t - r * g);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* a = A + r * as;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      const float4 av = ld4(a + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = at(av, q);
        const float4 w = ld4(W + (k + q) * ld + c);
        acc[0] += x * w.x;
        acc[1] += x * w.y;
        acc[2] += x * w.z;
        acc[3] += x * w.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < N) out[r * os + c + j] = act_fwd(acc[j] + b[c + j], act);
  }
}

// The gradient of a COL layer's few columns: P[k][j] += sum_{r<R} A[r][k]
// G[r][j] and Pb[j] += sum_r G[r][j], each in row order, for k < K, j < N
// (stored when `first`); a thread 4 k x 4 columns, those of k 0..3 the
// bias's 4 columns too.
__device__ __forceinline__ void dw_narrow(
    int R, int K, int N, const float* A, int as, const float* G, int gs,
    float* P, int ld, float* Pb, bool first) {
  const int g = (N + 3) >> 2, kg = (K + 3) >> 2;
  for (int t = threadIdx.x; t < kg * g; t += ST) {
    const int k0 = 4 * (t / g), c = 4 * (t - (t / g) * g);
    float acc[5][4];   // row 4: the bias
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float4 a = ld4(A + r * as + k0), gv = ld4(G + r * gs + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = at(a, i);
        acc[i][0] += x * gv.x;
        acc[i][1] += x * gv.y;
        acc[i][2] += x * gv.z;
        acc[i][3] += x * gv.w;
      }
      if (k0 == 0) {
        acc[4][0] += gv.x;
        acc[4][1] += gv.y;
        acc[4][2] += gv.z;
        acc[4][3] += gv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i < 4 ? k0 + i >= K : k0 > 0) continue;
      float* p = i < 4 ? P + (k0 + i) * ld + c : Pb + c;
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (!first) {
        const float4 o = ld4(p);
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      st4(p, v);
    }
  }
}

// The C blocks' float4s at `local`'s place, summed in rank order, four
// ranks' loads in flight at a time.
__device__ __forceinline__ float4 rank_sum(int C, const float* local) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q0 = 0; q0 < C; q0 += 4) {
    float4 part[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < C) part[q] = ld_cluster4(cluster_addr(local, q0 + q));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < C) {
        if (q0 + q == 0) {
          s = part[0];
          continue;
        }
        s.x += part[q].x;
        s.y += part[q].y;
        s.z += part[q].z;
        s.w += part[q].w;
      }
  }
  return s;
}

// The cluster's sum of the exchange tiles `xp` (rows r < R, columns j < N,
// row stride xw), each element summed over the C blocks in rank order,
// then out[r][j] = f(sum, out[r][j]).  Every block calls it with the same
// arguments and gets the same bits.
template <class F>
__device__ __forceinline__ void all_reduce(int C, int R, int N,
                                           const float* xp, int xw,
                                           float* out, int os, F f) {
  const int g = (N + 3) >> 2;
  for (int t = threadIdx.x; t < R * g; t += ST) {
    const int r = t / g, c = 4 * (t - r * g);
    const float4 s = rank_sum(C, xp + r * xw + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < N) {
        float* o = out + r * os + c + j;
        *o = f(at(s, j), c + j, *o);
      }
  }
}

// --- one sub-tile -------------------------------------------------------------

// Forward of the sub-tile's R rows (x in X) into the output tiles H; a ROW
// layer's partials through the exchange tiles (the `xc`-th exchange uses
// tile xc & 1: a block writes a tile only after the barrier of the
// exchange before it, which no block passes before it has read the tile's
// last use).
template <bool SPILL>
__device__ __forceinline__ void forward(const ShardNet& sn, int rank, int R,
                                        const float* X, const Store<SPILL>& ps,
                                        float* H, float* XCH,
                                        const float* ZERO, int act,
                                        int& xc) {
  const int L = sn.net.n_layers;
  for (int l = 0; l < L; ++l) {
    const int m = sn.mode[l], dout = sn.net.dim[l + 1];
    const Span in = in_span(sn, l, rank), out = out_span(sn, l, rank);
    const float* A = l == 0 ? X + in.lo : H + sn.h_off[l - 1];
    const float *Wl = ps.w(sn, l), *b = ps.b(sn, l);
    float* O = H + sn.h_off[l];
    const int as = sn.ts[l], os = sn.ts[l + 1];
    if (m == REP) {
      fwd_rows<ST>(R, dout, r4(sn.net.dim[l]), A, as, Wl, sn.ld[l], b, O, os,
               true, act);
    } else if (m == COL) {
      fwd_narrow(R, out.n, r4(sn.net.dim[l]), A, as, Wl, sn.ld[l], b, O, os,
                 act);
    } else {
      float* xp = XCH + (xc & 1) * sn.S * sn.xw;
      if (dout <= THIN)
        fwd_thin<ST>(R, dout, in.n, A, as, Wl, sn.ld[l], ZERO, xp, sn.xw, false,
                 act);
      else
        fwd_rows<ST>(R, dout, r4(in.n), A, as, Wl, sn.ld[l], ZERO, xp, sn.xw,
                 false, act);
      cluster_sync();
      const bool hidden = l < L - 1;
      all_reduce(sn.C, R, dout, xp, sn.xw, O, os,
                 [=](float s, int j, float) {
                   const float h = s + b[j];
                   return hidden ? act_fwd(h, act) : h;
                 });
      ++xc;
    }
    __syncthreads();
  }
}

// Backward from the gradient in the head's tile: the block's gradients
// into P (stored when `first`, else added); every output tile is
// overwritten with its layer's gradient.
template <bool SPILL>
__device__ __forceinline__ void backward(const ShardNet& sn, int rank, int R,
                                         float* X, const Store<SPILL>& ps,
                                         float* H, float* XCH, bool first,
                                         int act, int& xc) {
  for (int l = sn.net.n_layers - 1; l >= 0; --l) {
    const int m = sn.mode[l], din = sn.net.dim[l], dout = sn.net.dim[l + 1];
    const Span in = in_span(sn, l, rank), out = out_span(sn, l, rank);
    float* A = l == 0 ? X + in.lo : H + sn.h_off[l - 1];
    const float* G = H + sn.h_off[l];
    const int as = sn.ts[l], gs = sn.ts[l + 1], ld = sn.ld[l];
    float *Pl = ps.gw(sn, l), *Pb = ps.gb(sn, l);
    if (m == ROW) {
      if (dout <= THIN) {
        dw_thin_out<ST>(R, in.n, dout, A, as, G, gs, Pl, ld, Pb, first);
      } else {
        db_sum<ST>(R, dout, G, gs, Pb, first);
        dw_tile<ST>(R, in.n, dout, A, as, G, gs, Pl, ld, first);
      }
    } else if (m == COL) {
      dw_narrow(R, din, out.n, A, as, G, gs, Pl, ld, Pb, first);
    } else if (din <= THIN_K) {
      dw_thin_in<ST>(R, din, dout, A, as, G, gs, Pl, ld, Pb, first);
    } else {
      db_sum<ST>(R, dout, G, gs, Pb, first);
      dw_tile<ST>(R, din, dout, A, as, G, gs, Pl, ld, first);
    }
    __syncthreads();
    if (l == 0) break;
    const float* Wl = ps.w(sn, l);
    if (m == ROW) {
      if (dout <= THIN)
        dx_thin<ST>(R, in.n, dout, G, gs, Wl, ld, A, as, act);
      else
        dx_rows<ST>(R, in.n, r4(dout), G, gs, Wl, ld, A, as, act);
    } else if (sn.mode[l - 1] == REP) {
      // the partial input gradient times act', summed once a minibatch
      dx_rows<ST>(R, din, sn.cols[l], G, gs, Wl, ld, A, as, act);
    } else {
      // below is a ROW: the partials summed over the cluster
      float* xp = XCH + (xc & 1) * sn.S * sn.xw;
      dx_rows<ST>(R, din, sn.cols[l], G, gs, Wl, ld, xp, sn.xw, ACT_NONE);
      cluster_sync();
      all_reduce(sn.C, R, din, xp, sn.xw, A, as,
                 [=](float s, int, float h) { return s * act_grad(h, act); });
      ++xc;
    }
    __syncthreads();
  }
}

// Start copying the rows [row0, row0 + R) of the stream into X and E.
template <int KIND>
__device__ __forceinline__ void fetch_rows(const ShardDev& a, size_t row0,
                                           int R, float* X, float* E) {
  const int d0 = a.sn.net.dim[0], ts0 = a.sn.ts[0];
  const float* xs = a.x + row0 * d0;
  for (int e = threadIdx.x; e < R * d0; e += ST) {
    const int r = e / d0;
    cp_async4(X + r * ts0 + (e - r * d0), xs + e);
  }
  if (KIND == VALUE) {
    for (int r = threadIdx.x; r < R; r += ST)
      cp_async4(E + r * ES, a.tgt + row0 + r);
  } else {
    if (KIND == POLICY) {
      const int k = a.k_act;
      for (int e = threadIdx.x; e < R * k; e += ST) {
        const int r = e / k;
        cp_async4(E + r * ES + (e - r * k), a.act + row0 * k + e);
      }
    } else {   // the class id's bits, never converted
      for (int r = threadIdx.x; r < R; r += ST)
        cp_async4(E + r * ES,
                  reinterpret_cast<const float*>(a.act_idx + row0 + r));
    }
    for (int r = threadIdx.x; r < R; r += ST) {
      cp_async4(E + r * ES + 8, a.lp_old + row0 + r);
      cp_async4(E + r * ES + 9, a.adv + row0 + r);
    }
  }
  cp_async_commit();
}

// --- the block's own parameters ---------------------------------------------

// Calls f(weight, gradient, flat index, moment index) on every weight and
// bias the block holds alone (COL and ROW weights, COL biases), in a fixed
// order: element e of a layer's list goes to thread e % ST.
template <bool SPILL, class F>
__device__ __forceinline__ void own_params(const ShardNet& sn, int rank,
                                           const Store<SPILL>& ps, F f) {
  for (int l = 0; l < sn.net.n_layers; ++l) {
    const int m = sn.mode[l];
    if (m == REP) continue;
    const Span in = in_span(sn, l, rank), out = out_span(sn, l, rank);
    const int dout = sn.net.dim[l + 1], nc = out.n;
    const int nw = in.n * nc, n = nw + (m == COL ? nc : 0);
    float *w = ps.w(sn, l), *g = ps.gw(sn, l);
    const int bo = sn.pb[l] - sn.pw[l];
    for (int e = threadIdx.x; e < n; e += ST) {
      int loc, flat;
      if (e < nw) {
        const int k = e / nc, j = e - k * nc;
        loc = k * sn.ld[l] + j;
        flat = sn.net.w_off[l] + (in.lo + k) * dout + out.lo + j;
      } else {
        loc = bo + (e - nw);
        flat = sn.net.b_off[l] + out.lo + (e - nw);
      }
      f(w[loc], g[loc], flat, sn.mo[l] + e);
    }
  }
}

// The slice [lo4, lo4 + n4) of the REP layer's float4s this block runs
// Adam on (1/C of them).
__device__ __forceinline__ Span rep_slice(const ShardNet& sn, int rank) {
  if (sn.mode[0] != REP) return {0, 0};
  const int all = (sn.rows[0] * sn.ld[0] + r4(sn.net.dim[1])) / 4;
  const int per = (all + sn.C - 1) / sn.C, lo = min(all, rank * per);
  return {lo, min(all, lo + per) - lo};
}

template <int KIND, bool SPILL>
__global__ void __launch_bounds__(ST, 1) shard_phase_kernel(
    const __grid_constant__ ShardDev a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const ShardNet& sn = a.sn;
  const Net& net = sn.net;
  const int L = net.n_layers, C = sn.C, S = sn.S;
  const int tid = threadIdx.x, act = a.activation;
  float *W = sm, *P = sm + sn.o_p, *H = sm + sn.o_h, *XCH = sm + sn.o_xch;
  Store<SPILL> ps{W, P, nullptr, nullptr};
  if (SPILL) {
    ps.gW = a.scratch + (size_t)rank * 2 * sn.n_gpar;
    ps.gP = ps.gW + sn.n_gpar;
  }
  const float* ZERO = sm + sn.o_zero;
  float *Xb = sm + sn.o_x, *Eb = sm + sn.o_e, *RS = sm + sn.o_rs;
  float *LS = sm + sn.o_ls, *BM = sm + sn.o_bm, *BV = BM + sn.nbm;
  // the m and v of an element the block owns: in shared memory (index mi)
  // or in the output moments (flat index f)
  float *MO = sm + sn.o_mo, *VO = MO + r4(sn.nmo);
  auto mref = [&](int f, int mi) -> float& {
    return sn.mom ? MO[mi] : a.m_out[f];
  };
  auto vref = [&](int f, int mi) -> float& {
    return sn.mom ? VO[mi] : a.v_out[f];
  };

  // Zero everything (the padding must read as zero), then the block's
  // weights, the ROW biases' m and v, and log_std's state; the m and v the
  // block owns (its shards, its REP slice) seed the output moments.
  for (int i = tid; i < sn.total / 4; i += ST)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; SPILL && i < 2 * sn.n_gpar; i += ST) ps.gW[i] = 0.0f;
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const Span in = in_span(sn, l, rank), out = out_span(sn, l, rank);
    const int dout = net.dim[l + 1];
    float *w = ps.w(sn, l), *b = ps.b(sn, l);
    for (int e = tid; e < in.n * out.n; e += ST) {
      const int k = e / out.n, j = e - k * out.n;
      w[k * sn.ld[l] + j] =
          a.p_in[net.w_off[l] + (in.lo + k) * dout + out.lo + j];
    }
    for (int j = tid; j < out.n; j += ST) {
      b[j] = a.p_in[net.b_off[l] + out.lo + j];
      if (sn.mode[l] == ROW) {
        BM[sn.bm[l] + j] = a.m_in[net.b_off[l] + j];
        BV[sn.bm[l] + j] = a.v_in[net.b_off[l] + j];
      }
    }
  }
  own_params(sn, rank, ps, [&](float&, float, int f, int mi) {
    mref(f, mi) = a.m_in[f];
    vref(f, mi) = a.v_in[f];
  });
  const Span rs = rep_slice(sn, rank);
  for (int i = tid; i < 4 * rs.n; i += ST) {
    const int f = rep_flat(sn, 4 * rs.lo + i);
    if (f >= 0) {
      mref(f, sn.mo[0] + i) = a.m_in[f];
      vref(f, sn.mo[0] + i) = a.v_in[f];
    }
  }
  const int k = KIND == POLICY ? a.k_act : 1;
  if (KIND == POLICY && tid < k) {
    LS[tid] = a.ls_in[tid];
    LS[MAX_ACT + tid] = a.mls_in[tid];
    LS[2 * MAX_ACT + tid] = a.vls_in[tid];
  }

  const int nsub = (a.mb + S - 1) / S;
  const int n_stat = KIND == POLICY ? 1 + k : 1;
  float* head = H + sn.h_off[L - 1];
  const int hsL = sn.ts[L];
  const float mbf = (float)a.mb;
  if (a.n_steps > 0) fetch_rows<KIND>(a, 0, min(S, a.mb), Xb, Eb);
  float loss = 0.0f, ent_sum = 0.0f;
  int tile = 0, xc = 0;
  __syncthreads();

  for (int s = 0; s < a.n_steps; ++s) {
    float sum_ls = 0.0f, inv_sigma[MAX_ACT];
    if (KIND == POLICY) {
#pragma unroll
      for (int j = 0; j < MAX_ACT; ++j) {
        inv_sigma[j] = j < k ? expf(-LS[j]) : 0.0f;
        if (j < k) sum_ls += LS[j];
      }
      // closed-form Gaussian entropy, once per minibatch step
      const float ent = a.ent0 + sum_ls;
      ent_sum += ent;
      loss += -a.ent_coeff * ent;
    }
    float sacc = 0.0f;   // thread j < n_stat: stat j of this step
    float hacc = 0.0f;   // K6, thread 0: the entropy sum of this step
    for (int u = 0; u < nsub; ++u, ++tile) {
      const int R = min(S, a.mb - u * S);
      float* X = Xb + (tile & 1) * S * sn.ts[0];
      float* E = Eb + (tile & 1) * S * ES;
      cp_async_wait_all();
      __syncthreads();
      // prefetch the next sub-tile (the next step's first after the last)
      const int nu = u + 1 < nsub ? u + 1 : 0, ns = u + 1 < nsub ? s : s + 1;
      if (ns < a.n_steps)
        fetch_rows<KIND>(a, (size_t)ns * a.mb + nu * S,
                         min(S, a.mb - nu * S),
                         Xb + ((tile + 1) & 1) * S * sn.ts[0],
                         Eb + ((tile + 1) & 1) * S * ES);
      forward(sn, rank, R, X, ps, H, XCH, ZERO, act, xc);
      // the loss gradient replaces the head's outputs, row by row; every
      // block has the same outputs and rows, so the same bits
      for (int r = tid; r < R; r += ST) {
        const float* e = E + r * ES;
        float* o = head + r * hsL;
        float* st = RS + r * RSS;
        if (KIND == VALUE) {
          const float diff = o[0] - e[0];
          st[0] = diff * diff;
          o[0] = a.two_over_mb * diff;
        } else if (KIND == CATEGORICAL) {
          categorical_head(e, o, st, a.k_act, a.clip_lo, a.clip_hi,
                           a.ent_coeff, mbf);
        } else {
          float z[MAX_ACT], sumz2 = 0.0f;
#pragma unroll
          for (int j = 0; j < MAX_ACT; ++j)
            if (j < k) {
              z[j] = (e[j] - o[j]) * inv_sigma[j];
              sumz2 += z[j] * z[j];
            }
          const float logp = a.lp0 - sum_ls - 0.5f * sumz2;
          const float adv = e[9];
          const float ratio = expf(logp - e[8]);
          const float clipped = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
          const float ra = ratio * adv, ca = clipped * adv;
          st[0] = fminf(ra, ca);
          // only the unclipped branch carries gradient
          const float dlogp = ra <= ca ? -(adv * ratio / mbf) : 0.0f;
#pragma unroll
          for (int j = 0; j < MAX_ACT; ++j)
            if (j < k) {
              st[1 + j] = dlogp * (z[j] * z[j] - 1.0f);
              o[j] = dlogp * z[j] * inv_sigma[j];
            }
        }
      }
      __syncthreads();
      if (KIND == CATEGORICAL && tid == 0) {   // both stats, in row order
        float t = 0.0f, th = 0.0f;
        for (int r = 0; r < R; ++r) {
          t += RS[r * RSS];
          th += RS[r * RSS + 1];
        }
        sacc += t;
        hacc += th;
      } else if (KIND != CATEGORICAL && tid < n_stat) {   // in row order
        float t = 0.0f;
        for (int r = 0; r < R; ++r) t += RS[r * RSS + tid];
        sacc += t;
      }
      backward(sn, rank, R, X, ps, H, XCH, u == 0, act, xc);
    }
    cluster_sync();

    // Adam: this block's slice of the REP layer (the C partials summed in
    // rank order, every rank's float4 read before the sum; the new weights
    // into every replica), its own shards, and the ROW biases (the same
    // gradient in every block).
    const AdamHyper& h = a.hyper;
    const float tf = (float)(a.t0 + s + 1);
    const float bc1 = 1.0f - expf(tf * h.logb1);
    const float bc2 = 1.0f - expf(tf * h.logb2);
    const float step = h.lr / bc1;
    for (int i = tid; i < rs.n; i += ST) {
      const int o = 4 * (rs.lo + i), pi = sn.pw[0] + o;
      int f[4];
      float mm[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = rep_flat(sn, o + j);
        if (f[j] >= 0) {
          mm[j] = mref(f[j], sn.mo[0] + 4 * i + j);
          vv[j] = vref(f[j], sn.mo[0] + 4 * i + j);
        }
      }
      const float4 g4 = rank_sum(C, P + pi);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
      float w[4] = {W[pi], W[pi + 1], W[pi + 2], W[pi + 3]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f[j] >= 0) {
          adam1(g[j], mm[j], vv[j], w[j], step, bc2, h);
          mref(f[j], sn.mo[0] + 4 * i + j) = mm[j];
          vref(f[j], sn.mo[0] + 4 * i + j) = vv[j];
        }
      const float4 w4 = make_float4(w[0], w[1], w[2], w[3]);
#pragma unroll
      for (int q = 0; q < C_MAX; ++q)
        if (q < C) st_cluster4(cluster_addr(W + pi, q), w4);
    }
    own_params(sn, rank, ps, [&](float& w, float g, int f, int mi) {
      adam1(g, mref(f, mi), vref(f, mi), w, step, bc2, h);
    });
    for (int l = 0; l < L; ++l)
      if (sn.mode[l] == ROW)
        for (int j = tid; j < net.dim[l + 1]; j += ST)
          adam1(ps.gb(sn, l)[j], BM[sn.bm[l] + j], BV[sn.bm[l] + j],
                ps.b(sn, l)[j], step, bc2, h);
    // The loss (every block the same; rank 0 stores it) and K4's log_std
    // Adam (its own timestep; the entropy bonus adds -ent_coeff), the same
    // in every block; K6's loss takes its entropy sum too.
    if (KIND == CATEGORICAL) {
      if (tid == 0) {
        loss += (-sacc - a.ent_coeff * hacc) / mbf;
        ent_sum += hacc / mbf;
      }
    } else if (tid == 0) {
      loss += KIND == VALUE ? sacc : -sacc / mbf;
    }
    if (KIND == POLICY && tid >= 1 && tid < n_stat) {
      const int j = tid - 1;
      const float tl = (float)(a.t0_ls + s + 1);
      const float lc1 = 1.0f - expf(tl * h.logb1);
      const float lc2 = 1.0f - expf(tl * h.logb2);
      const float g = sacc - a.ent_coeff;
      const float m2 = h.b1 * LS[MAX_ACT + j] + h.omb1 * g;
      const float v2 = h.b2 * LS[2 * MAX_ACT + j] + h.omb2 * (g * g);
      LS[MAX_ACT + j] = m2;
      LS[2 * MAX_ACT + j] = v2;
      LS[j] = LS[j] - (h.lr / lc1) * m2 / (sqrtf(v2 / lc2) + h.eps);
    }
    cluster_sync();
  }

  // Each block stores what it owns: its shards, its REP slice (every
  // replica holds the same weights); rank 0 the ROW biases, log_std and
  // the stats.
  own_params(sn, rank, ps, [&](float& w, float, int f, int mi) {
    a.p_out[f] = w;
    a.m_out[f] = mref(f, mi);
    a.v_out[f] = vref(f, mi);
  });
  for (int i = tid; i < 4 * rs.n; i += ST) {
    const int f = rep_flat(sn, 4 * rs.lo + i);
    if (f >= 0) {
      a.p_out[f] = W[sn.pw[0] + 4 * rs.lo + i];
      a.m_out[f] = mref(f, sn.mo[0] + i);
      a.v_out[f] = vref(f, sn.mo[0] + i);
    }
  }
  if (rank == 0) {
    for (int l = 0; l < L; ++l)
      if (sn.mode[l] == ROW)
        for (int j = tid; j < net.dim[l + 1]; j += ST) {
          a.p_out[net.b_off[l] + j] = ps.b(sn, l)[j];
          a.m_out[net.b_off[l] + j] = BM[sn.bm[l] + j];
          a.v_out[net.b_off[l] + j] = BV[sn.bm[l] + j];
        }
    if (KIND == POLICY && tid < k) {
      a.ls_out[tid] = LS[tid];
      a.mls_out[tid] = LS[MAX_ACT + tid];
      a.vls_out[tid] = LS[2 * MAX_ACT + tid];
    }
    if (tid == 0) {
      a.stats[0] = loss;
      if (KIND != VALUE) a.stats[1] = ent_sum;
    }
  }
}

// The cluster of a launch (`cluster`, or SHARDS) and its layout; 0 if the
// shape is refused.
int shard_of(const PhaseArgs* a, ShardNet* sn) {
  const int C = a->cluster > 0 ? a->cluster : SHARDS;
  if (C > C_MAX || !shard_layout(sn, a->n_layers, a->dims, C)) return 0;
  return C;
}

// Clusters of the kind's kernel (its spill variant or not) of C blocks
// with `smem` bytes each that the card holds at once, into *n.
template <int KIND>
cudaError_t shard_clusters(int spill, int C, long smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = spill ? shard_phase_kernel<KIND, true>
                      : shard_phase_kernel<KIND, false>;
  cudaError_t err = configure<ST>(kernel, C, smem, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, (void*)kernel, &cfg);
  return err;
}

template <int KIND>
int launch_shard(const PhaseArgs* a, cudaStream_t stream) {
  ShardDev d{};
  const int C = shard_of(a, &d.sn);
  if (C == 0 || a->mb < 1 || 4L * d.sn.total > BUDGET ||
      (d.sn.spill && !a->scratch))
    return cudaErrorInvalidValue;
  const int L = a->n_layers;
  if (KIND != VALUE && (a->k_act < 1 || a->k_act > MAX_ACT ||
                        d.sn.net.dim[L] != a->k_act))
    return cudaErrorInvalidValue;
  if (KIND == VALUE && d.sn.net.dim[L] != 1) return cudaErrorInvalidValue;
  d.x = a->x; d.tgt = a->tgt; d.act = a->act; d.act_idx = a->act_idx;
  d.lp_old = a->lp_old; d.adv = a->adv;
  d.p_in = a->p_in; d.m_in = a->m_in; d.v_in = a->v_in;
  d.p_out = a->p_out; d.m_out = a->m_out; d.v_out = a->v_out;
  d.ls_in = a->ls_in; d.mls_in = a->mls_in; d.vls_in = a->vls_in;
  d.ls_out = a->ls_out; d.mls_out = a->mls_out; d.vls_out = a->vls_out;
  d.scratch = a->scratch; d.stats = a->stats;
  d.activation = a->activation; d.n_steps = a->n_steps; d.mb = a->mb;
  d.t0 = a->t0; d.t0_ls = a->t0_ls; d.k_act = a->k_act;
  d.two_over_mb = a->two_over_mb; d.lp0 = a->lp0; d.ent0 = a->ent0;
  d.clip_lo = a->clip_lo; d.clip_hi = a->clip_hi; d.ent_coeff = a->ent_coeff;
  d.hyper = a->hyper;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = d.sn.spill ? shard_phase_kernel<KIND, true>
                           : shard_phase_kernel<KIND, false>;
  cudaError_t err = configure<ST>(kernel, C, 4L * d.sn.total, stream, &cfg,
                                  &attr);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;   // cannot be scheduled
  err = cudaLaunchKernelEx(&cfg, kernel, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// shard_clusters of each kind, for the plan: one in each kind's source
// (update_shard.cu, update_shard_policy.cu, update_shard_categorical.cu),
// so that the three compile apart
cudaError_t shard_clusters_value(int spill, int C, long smem, int* n);
cudaError_t shard_clusters_policy(int spill, int C, long smem, int* n);
cudaError_t shard_clusters_categorical(int spill, int C, long smem, int* n);

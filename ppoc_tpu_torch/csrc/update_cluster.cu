// K3, K4 (Gaussian) and K6 (categorical) with the weights in shared
// memory: a whole PPO value or policy phase (every epoch x minibatch step)
// as ONE thread-block cluster of CLUSTER blocks, one block per SM.
//
// Replaces ppoc_tpu/ops/pallas_update.py `value_phase_fused` ->
// `_run_value_phase` -> `_value_kernel`/`_value_kernel_unrolled` (K3),
// `policy_phase_fused` -> `_policy_kernel`/`_policy_kernel_unrolled` (K4,
// Gaussian) and `policy_phase_fused_categorical` -> `_policy_kernel_cat`/
// `_policy_kernel_cat_unrolled` (K6), for every net whose weights, one
// weight-gradient partial and a 32-row tile of activations fit in one
// block's shared memory (the bench's [3,128,128,1], cartpole's and
// acrobot's nets, [4,128,128,2] and [6,128,128,3] for K6, reacher's policy
// at [10,64,64,2]).  Larger nets take update_shard.cu's sharded cluster.
// Each step: forward, the loss gradient in closed form (K3: 2/mb (v -
// target); K4: the clipped surrogate through the unclipped branch, and the
// log_std gradient with the entropy term; K6: the surrogate through a
// log-softmax over the K class logits plus the entropy bonus, as one
// gradient on the logits, cluster.cuh's categorical_head), backward, Adam
// (K4: and log_std's Adam; K6 has no log_std).
//
// What bounds it on the card: not FLOPs.  A step of the bench's
// [3,128,128,1] net on 256 rows is ~26 MFLOP, ~3 us of sixteen SMs' FP32
// FMA rate.  The steps are a serial chain through Adam, and each step is
// itself a chain: small dependent products (forward, then dW and dX layer
// by layer), each closed by a __syncthreads and bound by shared-memory
// loads (a 16-row sub-tile leaves each lane 8 outputs), then the
// cross-block gradient sum, which moves a block's whole partial in and
// the new weights out over distributed shared memory, between two cluster
// barriers.  At the bench shape the products take ~55% of a step, the
// exchange and the barriers ~40% (PERF.md, PR 10).
//
// What the design does about it:
//  * Rows split over the cluster: CLUSTER = 16 blocks for every minibatch
//    size (the fastest of 4, 8 and 16 at 64, 256 and 2048 rows; one size
//    for all, so chained one-step launches equal one long launch).  Block
//    r takes rows [r R, r R + R) of every minibatch (R = ceil(mb / 16)) in
//    32-row sub-tiles, and sums its weight-gradient partial over them in
//    order.
//  * Everything of a step on chip.  Each block holds in shared memory a
//    replica of the weights (W_l rows padded to 4 * odd floats, so a warp
//    reading down a column as float4 hits distinct banks), its gradient
//    partial in the same layout, the post-activations of its sub-tile
//    (the backward overwrites them in place with the gradients), its rows,
//    prefetched one sub-tile ahead with cp.async, and m and v of its Adam
//    slice, loaded once and stored once.
//  * Products from shared memory: a warp owns up to 4 rows x 128 columns
//    (each lane up to 4 x 4 in registers, operands as float4) for the
//    forward and the dX product, 8 x 128 for dW.  The thin products split their
//    work so no warp walks a long chain: a head's forward a warp per row with
//    the lanes splitting k (a fixed shuffle tree), its dW a thread per input
//    row, layer 0's dW a thread per column.
//  * After the backward, a cluster barrier; then block r sums its slice
//    of the parameters (1/16 of the padded layout, in float4s) over the 16
//    partials in rank order, each thread's 16 reads in flight together,
//    runs Adam on it, and writes the new weights into every block's
//    replica; a second cluster barrier.  K4's surrogate and log_std sums
//    are reduced the same way, and every block runs the same log_std Adam
//    on the same sums; K6's surrogate and entropy sums likewise, into
//    rank 0's loss.
//  * Deterministic: no atomics; every sum in a fixed order (within a block
//    in row order or a fixed tree, across blocks in rank order).
#include <cooperative_groups.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;
using namespace ppoc;

namespace {

constexpr int SUB = 32;           // rows of a sub-tile
constexpr int CLUSTER = 16;       // blocks in the cluster

// The padded layout and the shared-memory map, in floats.
struct ClusterNet {
  Net net;
  int ld[MAX_LAYERS];        // W_l's row stride
  int hs[MAX_LAYERS + 1];    // row stride of a tile of width dim[l]: r4
  int pw[MAX_LAYERS];        // W_l (r4(dim[l]) rows, zero past dim[l])
  int pb[MAX_LAYERS];        // b_l (r4(dim[l + 1]) floats)
  int n_padded;
  int h_off[MAX_LAYERS];     // layer l's output tile in the activations
  int o_p, o_h, o_x, o_e, o_rs, o_stat, o_ls, total;
};

bool make_cluster_net(ClusterNet* c, int n_layers, const int* dims) {
  if (!make_net(&c->net, n_layers, dims)) return false;
  for (int l = 0; l <= n_layers; ++l) c->hs[l] = r4(dims[l]);
  int off = 0, h = 0;
  for (int l = 0; l < n_layers; ++l) {
    c->ld[l] = w_ld(dims[l + 1]);
    c->pw[l] = off;
    off += c->hs[l] * c->ld[l];
    c->pb[l] = off;
    off += c->hs[l + 1];
    c->h_off[l] = h;
    h += SUB * c->hs[l + 1];
  }
  c->n_padded = off;
  c->o_p = off;                              // the gradient partial
  c->o_h = 2 * off;                          // activations (+8: the dW
  c->o_x = c->o_h + h + 8;                   // tile reads 8 columns)
  c->o_e = c->o_x + 2 * SUB * c->hs[0];      // x, two sub-tiles
  c->o_rs = c->o_e + 2 * SUB * ES;           // extras, two sub-tiles
  c->o_stat = c->o_rs + SUB * RSS;           // row stats
  c->o_ls = c->o_stat + r4(NS);              // block stats
  c->total = c->o_ls + 4 * MAX_ACT;          // log_std, its m and v
  return true;
}

// float4s of the padded layout a block of a C-block cluster owns for Adam
__host__ __device__ inline int slice4(const ClusterNet& c, int C) {
  return (c.n_padded / 4 + C - 1) / C;
}

// A block's dynamic shared memory in floats: the map above, then m and v of
// its Adam slice.
inline long smem_floats(const ClusterNet& c, int C) {
  return (long)c.total + 8L * slice4(c, C);
}

struct ClusterDev {
  ClusterNet cn;
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  float* stats;
  int activation, n_steps, mb, t0, t0_ls, k_act;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
  const int32_t* act_idx;   // K6: the rows' class ids
};

// Flat (the params' own) index -> padded index.
__device__ __forceinline__ int padded_of(const ClusterNet& c, int i) {
  int l = 0;
  while (l + 1 < c.net.n_layers && i >= c.net.w_off[l + 1]) ++l;
  const int dout = c.net.dim[l + 1], r = i - c.net.w_off[l];
  const int wsz = c.net.dim[l] * dout;
  return r < wsz ? c.pw[l] + (r / dout) * c.ld[l] + r % dout
                 : c.pb[l] + (r - wsz);
}

// Padded index -> flat index, or -1 for a padding slot.
__device__ __forceinline__ int flat_of(const ClusterNet& c, int pi) {
  int l = 0;
  while (l + 1 < c.net.n_layers && pi >= c.pw[l + 1]) ++l;
  const int din = c.net.dim[l], dout = c.net.dim[l + 1];
  const int o = pi - c.pw[l], wreg = c.hs[l] * c.ld[l];
  if (o < wreg) {
    const int row = o / c.ld[l], col = o - row * c.ld[l];
    return row < din && col < dout ? c.net.w_off[l] + row * dout + col : -1;
  }
  return o - wreg < dout ? c.net.b_off[l] + (o - wreg) : -1;
}

// Adam on the parameter in padded slot `pi` (a padding slot stays as it
// is): the bias corrections folded into `step` and bc2, eps outside the
// sqrt, as update.cu's adam_step.
__device__ __forceinline__ void adam(const ClusterNet& cn, int pi, float g,
                                     float& m, float& v, float& w,
                                     float step, float bc2,
                                     const AdamHyper& h) {
  if (flat_of(cn, pi) < 0) return;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  w = w - step * m / (sqrtf(v / bc2) + h.eps);
}

// --- one step ---------------------------------------------------------------

// Forward of the sub-tile's R rows (x in X) into the activation tiles H.
__device__ __forceinline__ void forward(const ClusterNet& cn, int R,
                                        const float* X, const float* W,
                                        float* H, int act) {
  const float* A = X;
  for (int l = 0; l < cn.net.n_layers; ++l) {
    const int dout = cn.net.dim[l + 1];
    const float *Wl = W + cn.pw[l], *b = W + cn.pb[l];
    float* out = H + cn.h_off[l];
    const bool hidden = l < cn.net.n_layers - 1;
    if (dout <= THIN)
      fwd_thin(R, dout, cn.net.dim[l], A, cn.hs[l], Wl, cn.ld[l], b, out,
               cn.hs[l + 1], hidden, act);
    else
      fwd_rows(R, dout, cn.hs[l], A, cn.hs[l], Wl, cn.ld[l], b, out,
               cn.hs[l + 1], hidden, act);
    __syncthreads();
    A = out;
  }
}

// Backward from the gradient in the head's tile into the partial P (stored
// when `first`, else added); every activation tile is overwritten with its
// layer's gradient.
__device__ __forceinline__ void backward(const ClusterNet& cn, int R,
                                         float* X, const float* W, float* H,
                                         float* P, bool first, int act) {
  for (int l = cn.net.n_layers - 1; l >= 0; --l) {
    const int din = cn.net.dim[l], dout = cn.net.dim[l + 1];
    float* A = l == 0 ? X : H + cn.h_off[l - 1];
    const float* G = H + cn.h_off[l];
    const int as = cn.hs[l], gs = cn.hs[l + 1], ld = cn.ld[l];
    float *Pl = P + cn.pw[l], *Pb = P + cn.pb[l];
    if (dout <= THIN) {
      dw_thin_out(R, din, dout, A, as, G, gs, Pl, ld, Pb, first);
    } else if (din <= THIN_K) {
      dw_thin_in(R, din, dout, A, as, G, gs, Pl, ld, Pb, first);
    } else {
      db_sum(R, dout, G, gs, Pb, first);
      dw_tile(R, din, dout, A, as, G, gs, Pl, ld, first);
    }
    __syncthreads();
    if (l > 0) {
      const float* Wl = W + cn.pw[l];
      if (dout <= THIN)
        dx_thin(R, din, dout, G, gs, Wl, ld, A, as, act);
      else
        dx_rows(R, din, gs, G, gs, Wl, ld, A, as, act);
      __syncthreads();
    }
  }
}

// Start copying the rows [row0, row0 + R) of the stream into X and E.
template <int KIND>
__device__ __forceinline__ void fetch_rows(const ClusterDev& a, size_t row0,
                                           int R, float* X, float* E) {
  const int d0 = a.cn.net.dim[0], hs0 = a.cn.hs[0];
  const float* xs = a.x + row0 * d0;
  for (int e = threadIdx.x; e < R * d0; e += CT) {
    const int r = e / d0;
    cp_async4(X + r * hs0 + (e - r * d0), xs + e);
  }
  if (KIND == VALUE) {
    for (int r = threadIdx.x; r < R; r += CT)
      cp_async4(E + r * ES, a.tgt + row0 + r);
  } else {
    if (KIND == POLICY) {
      const int k = a.k_act;
      for (int e = threadIdx.x; e < R * k; e += CT) {
        const int r = e / k;
        cp_async4(E + r * ES + (e - r * k), a.act + row0 * k + e);
      }
    } else {   // the class id's bits, never converted
      for (int r = threadIdx.x; r < R; r += CT)
        cp_async4(E + r * ES,
                  reinterpret_cast<const float*>(a.act_idx + row0 + r));
    }
    for (int r = threadIdx.x; r < R; r += CT) {
      cp_async4(E + r * ES + 8, a.lp_old + row0 + r);
      cp_async4(E + r * ES + 9, a.adv + row0 + r);
    }
  }
  cp_async_commit();
}

template <int KIND>
__global__ void __launch_bounds__(CT, 1) cluster_phase_kernel(
    const __grid_constant__ ClusterDev a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const ClusterNet& cn = a.cn;
  const Net& net = cn.net;
  const int tid = threadIdx.x, act = a.activation;
  float *W = sm, *P = sm + cn.o_p, *H = sm + cn.o_h;
  float *Xb = sm + cn.o_x, *Eb = sm + cn.o_e, *RS = sm + cn.o_rs;
  float *STAT = sm + cn.o_stat, *LS = sm + cn.o_ls;

  // Zero everything (the padding must read as zero), then the weights and
  // m and v of this block's Adam slice: float4s [lo4, hi4) of the padded
  // layout.
  const int S4 = slice4(cn, C), lo4 = rank * S4;
  const int n4 = max(0, min(cn.n_padded / 4, lo4 + S4) - lo4);
  float *M = sm + cn.total, *V = M + 4 * S4;
  for (int i = tid; i < cn.total / 4 + 2 * S4; i += CT)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  for (int i = tid; i < net.n_params; i += CT) W[padded_of(cn, i)] = a.p_in[i];
  for (int i = tid; i < 4 * n4; i += CT) {
    const int f = flat_of(cn, 4 * lo4 + i);
    if (f >= 0) {
      M[i] = a.m_in[f];
      V[i] = a.v_in[f];
    }
  }
  const int k = KIND == POLICY ? a.k_act : 1;
  if (KIND == POLICY && tid < k) {
    LS[tid] = a.ls_in[tid];
    LS[MAX_ACT + tid] = a.mls_in[tid];
    LS[2 * MAX_ACT + tid] = a.vls_in[tid];
  }

  // This block's rows of every minibatch.
  const int rpb = (a.mb + C - 1) / C;
  const int my0 = min(a.mb, rank * rpb);
  const int nrows = min(a.mb, my0 + rpb) - my0;
  const int nsub = (nrows + SUB - 1) / SUB;
  const int n_stat = KIND == POLICY ? 1 + k : KIND == CATEGORICAL ? 2 : 1;
  float* head = H + cn.h_off[net.n_layers - 1];
  const int hsL = cn.hs[net.n_layers];
  const float mbf = (float)a.mb;
  if (nsub > 0 && a.n_steps > 0)
    fetch_rows<KIND>(a, my0, min(SUB, nrows), Xb, Eb);
  float loss = 0.0f, ent_sum = 0.0f;
  int tile = 0;
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
    float sacc = 0.0f;   // thread j < n_stat: the block's stat j this step
    for (int u = 0; u < nsub; ++u, ++tile) {
      const int R = min(SUB, nrows - u * SUB);
      float* X = Xb + (tile & 1) * SUB * cn.hs[0];
      float* E = Eb + (tile & 1) * SUB * ES;
      cp_async_wait_all();
      __syncthreads();
      // prefetch the next sub-tile (the next step's first after the last)
      const int nu = u + 1 < nsub ? u + 1 : 0, ns = u + 1 < nsub ? s : s + 1;
      if (ns < a.n_steps)
        fetch_rows<KIND>(a, (size_t)ns * a.mb + my0 + nu * SUB,
                         min(SUB, nrows - nu * SUB),
                         Xb + ((tile + 1) & 1) * SUB * cn.hs[0],
                         Eb + ((tile + 1) & 1) * SUB * ES);
      forward(cn, R, X, W, H, act);
      // the loss gradient replaces the head's outputs, row by row
      for (int r = tid; r < R; r += CT) {
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
      if (tid < n_stat) {   // the block's stats, in row order
        float t = 0.0f;
        for (int r = 0; r < R; ++r) t += RS[r * RSS + tid];
        sacc += t;
      }
      backward(cn, R, X, W, H, P, u == 0, act);
    }
    if (tid < n_stat) STAT[tid] = sacc;
    cluster_sync();

    // Adam on this block's slice: the C partials summed in rank order over
    // distributed shared memory (every rank's float4 read before the sum,
    // so the reads overlap), the new weights into every replica.
    {
      const AdamHyper& h = a.hyper;
      const float tf = (float)(a.t0 + s + 1);
      const float bc1 = 1.0f - expf(tf * h.logb1);
      const float bc2 = 1.0f - expf(tf * h.logb2);
      const float step = h.lr / bc1;
      for (int i = tid; i < n4; i += CT) {
        const int pi = 4 * (lo4 + i);
        float4 part[C_MAX];
#pragma unroll
        for (int c = 0; c < C_MAX; ++c)
          if (c < C) part[c] = ld_cluster4(cluster_addr(P + pi, c));
        float4 g = part[0];
#pragma unroll
        for (int c = 1; c < C_MAX; ++c)
          if (c < C) {
            g.x += part[c].x;
            g.y += part[c].y;
            g.z += part[c].z;
            g.w += part[c].w;
          }
        float4 w = ld4(W + pi), mm = ld4(M + 4 * i), vv = ld4(V + 4 * i);
        adam(cn, pi, g.x, mm.x, vv.x, w.x, step, bc2, h);
        adam(cn, pi + 1, g.y, mm.y, vv.y, w.y, step, bc2, h);
        adam(cn, pi + 2, g.z, mm.z, vv.z, w.z, step, bc2, h);
        adam(cn, pi + 3, g.w, mm.w, vv.w, w.w, step, bc2, h);
        st4(M + 4 * i, mm);
        st4(V + 4 * i, vv);
#pragma unroll
        for (int c = 0; c < C_MAX; ++c)
          if (c < C) st_cluster4(cluster_addr(W + pi, c), w);
      }
    }
    // The block stats summed in rank order: the loss (rank 0 keeps it),
    // and K4's log_std gradient, on which every block runs the same
    // log_std Adam (its own timestep; the entropy bonus adds -ent_coeff);
    // K6's surrogate and entropy, both into rank 0's loss.
    if (KIND == CATEGORICAL) {
      if (tid == 0 && rank == 0) {
        float part[2][C_MAX];
#pragma unroll
        for (int c = 0; c < C_MAX; ++c)
          if (c < C) {
            part[0][c] = ld_cluster(cluster_addr(STAT, c));
            part[1][c] = ld_cluster(cluster_addr(STAT + 1, c));
          }
        float surr = part[0][0], hsum = part[1][0];
#pragma unroll
        for (int c = 1; c < C_MAX; ++c)
          if (c < C) {
            surr += part[0][c];
            hsum += part[1][c];
          }
        loss += (-surr - a.ent_coeff * hsum) / mbf;
        ent_sum += hsum / mbf;
      }
    } else if (tid < n_stat) {
      float part[C_MAX];
#pragma unroll
      for (int c = 0; c < C_MAX; ++c)
        if (c < C) part[c] = ld_cluster(cluster_addr(STAT + tid, c));
      float t = part[0];
#pragma unroll
      for (int c = 1; c < C_MAX; ++c)
        if (c < C) t += part[c];
      if (tid == 0) {
        if (rank == 0) loss += KIND == VALUE ? t : -t / mbf;
      } else if (KIND == POLICY) {
        const int j = tid - 1;
        const AdamHyper& h = a.hyper;
        const float tl = (float)(a.t0_ls + s + 1);
        const float bc1 = 1.0f - expf(tl * h.logb1);
        const float bc2 = 1.0f - expf(tl * h.logb2);
        const float g = t - a.ent_coeff;
        const float m2 = h.b1 * LS[MAX_ACT + j] + h.omb1 * g;
        const float v2 = h.b2 * LS[2 * MAX_ACT + j] + h.omb2 * (g * g);
        LS[MAX_ACT + j] = m2;
        LS[2 * MAX_ACT + j] = v2;
        LS[j] = LS[j] - (h.lr / bc1) * m2 / (sqrtf(v2 / bc2) + h.eps);
      }
    }
    cluster_sync();
  }

  // Every replica holds the same weights: each block stores its slice.
  for (int i = tid; i < 4 * n4; i += CT) {
    const int f = flat_of(cn, 4 * lo4 + i);
    if (f >= 0) {
      a.p_out[f] = W[4 * lo4 + i];
      a.m_out[f] = M[i];
      a.v_out[f] = V[i];
    }
  }
  if (rank == 0) {
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

// The cluster of a launch (`cluster`, or CLUSTER), its net filled in; 0 if
// the shape is refused.
int cluster_of(const PhaseArgs* a, ClusterNet* cn) {
  if (!make_cluster_net(cn, a->n_layers, a->dims)) return 0;
  const int C = a->cluster > 0 ? a->cluster : CLUSTER;
  return C <= C_MAX ? C : 0;
}

void (*cluster_kernel(int kind))(const ClusterDev) {
  return kind == VALUE    ? cluster_phase_kernel<VALUE>
         : kind == POLICY ? cluster_phase_kernel<POLICY>
                          : cluster_phase_kernel<CATEGORICAL>;
}

}  // namespace

// Dynamic shared-memory bytes of a cluster kernel's block for the net
// `dims` in a cluster of `cluster` blocks (0: CLUSTER; the minibatch size
// does not enter), or -1 for a shape it refuses.
extern "C" long ppoc_phase_cluster_smem(const PhaseArgs* a) {
  ClusterNet cn;
  const int C = cluster_of(a, &cn);
  return C ? smem_floats(cn, C) * (long)sizeof(float) : -1;
}

// How the cluster kernel of `kind` (0 value, 1 policy, 2 categorical)
// launches for `a`:
// out = {blocks in the cluster, rows a block, sub-tiles a block, threads a
// block, dynamic shared-memory bytes, clusters of that shape the card can
// hold at once (cudaOccupancyMaxActiveClusters)}.
extern "C" int ppoc_phase_cluster_plan(const PhaseArgs* a, int kind,
                                       long* out) {
  ClusterNet cn;
  const int C = cluster_of(a, &cn);
  if (C == 0 || a->mb < 1 || kind < VALUE || kind > CATEGORICAL)
    return cudaErrorInvalidValue;
  const int rpb = (a->mb + C - 1) / C;
  const long smem = smem_floats(cn, C) * (long)sizeof(float);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = cluster_kernel(kind);
  cudaError_t err = configure(kernel, C, smem, nullptr, &cfg, &attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  out[0] = C;
  out[1] = rpb;
  out[2] = (rpb + SUB - 1) / SUB;
  out[3] = CT;
  out[4] = smem;
  out[5] = n;
  return err;
}

static int launch_cluster(const PhaseArgs* a, cudaStream_t stream, int kind) {
  ClusterDev d{};
  const int C = cluster_of(a, &d.cn);
  if (C == 0 || a->mb < 1) return cudaErrorInvalidValue;
  const int L = a->n_layers;
  if (kind != VALUE && (a->k_act < 1 || a->k_act > MAX_ACT ||
                        d.cn.net.dim[L] != a->k_act))
    return cudaErrorInvalidValue;
  if (kind == VALUE && d.cn.net.dim[L] != 1) return cudaErrorInvalidValue;
  d.x = a->x; d.tgt = a->tgt; d.act = a->act; d.act_idx = a->act_idx;
  d.lp_old = a->lp_old; d.adv = a->adv;
  d.p_in = a->p_in; d.m_in = a->m_in; d.v_in = a->v_in;
  d.p_out = a->p_out; d.m_out = a->m_out; d.v_out = a->v_out;
  d.ls_in = a->ls_in; d.mls_in = a->mls_in; d.vls_in = a->vls_in;
  d.ls_out = a->ls_out; d.mls_out = a->mls_out; d.vls_out = a->vls_out;
  d.stats = a->stats;
  d.activation = a->activation; d.n_steps = a->n_steps; d.mb = a->mb;
  d.t0 = a->t0; d.t0_ls = a->t0_ls; d.k_act = a->k_act;
  d.two_over_mb = a->two_over_mb; d.lp0 = a->lp0; d.ent0 = a->ent0;
  d.clip_lo = a->clip_lo; d.clip_hi = a->clip_hi; d.ent_coeff = a->ent_coeff;
  d.hyper = a->hyper;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = cluster_kernel(kind);
  cudaError_t err = configure(kernel, C,
                              smem_floats(d.cn, C) * (long)sizeof(float),
                              stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;   // cannot be scheduled
  err = cudaLaunchKernelEx(&cfg, kernel, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int ppoc_value_phase_cluster(const PhaseArgs* a,
                                        cudaStream_t stream) {
  return launch_cluster(a, stream, VALUE);
}

extern "C" int ppoc_policy_phase_cluster(const PhaseArgs* a,
                                         cudaStream_t stream) {
  return launch_cluster(a, stream, POLICY);
}

extern "C" int ppoc_policy_phase_categorical_cluster(const PhaseArgs* a,
                                                     cudaStream_t stream) {
  return launch_cluster(a, stream, CATEGORICAL);
}

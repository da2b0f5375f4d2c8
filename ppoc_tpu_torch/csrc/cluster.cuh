// What the fused update phases share (K3, K4 and K6, each a kind of the
// two thread-block cluster kernels: update_cluster.cu with the weights
// replicated in each block, update_shard.cu with them sharded by column):
// the launch's constants, padded strides, cp.async, distributed shared
// memory and the cluster barrier, the register-tiled products over a
// sub-tile of rows, and K6's per-row loss head.  The functions are inline
// because both sources include this header.
#pragma once

#include "phase_args.cuh"

namespace {

using namespace ppoc;

constexpr int CT = 256;           // threads a block (the products' NT)
constexpr int THIN = MAX_ACT;     // outputs this few take the thin products
constexpr int THIN_K = 16;        // inputs this few: the column-wise dW
constexpr int ES = 12;            // row extras: tgt, act[0..7] or the
                                  // class id's bits; then lp at 8, adv at 9
constexpr int NS = 1 + MAX_ACT;   // row stats: the loss, then log_std's
                                  // terms (K4) or the entropy (K6)
constexpr int RSS = 12;           // row stride of the row stats
constexpr int C_MAX = 16;         // the most a forced cluster size may take
constexpr int PORTABLE_C = 8;     // larger: the non-portable opt-in

// K3, K4 (Gaussian) and K6 (categorical); the plans' `kind` argument
enum Kind { VALUE = 0, POLICY = 1, CATEGORICAL = 2 };

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
// W_l's row stride: 4 floats times an odd number, so the 8 lanes of a
// quarter warp reading float4s down a column meet 8 distinct bank groups
__host__ __device__ inline int w_ld(int dout) {
  return 4 * (((dout + 3) >> 2) | 1);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Distributed shared memory: `local`'s twin in block `rank` of the cluster,
// and loads and stores there.
__device__ __forceinline__ unsigned cluster_addr(const float* local,
                                                 int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(local);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster4(unsigned addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// Every thread of the cluster: writes before it (to any block's shared
// memory) are seen by every read after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// --- the products, each over a block's R sub-tile rows ----------------------

// out[r][j] = f(sum_k A[r][k] W[k][j] + b[j]) for r < R, j < N (f the
// activation where `hidden`), each sum in k order; K = r4(width): A's
// columns and W's rows past the width are zero.  A warp owns TM rows x 128
// columns, a lane TM x 4.
template <int TM, int NT = CT>
__device__ __forceinline__ void fwd_tile(
    int R, int N, int K, const float* A, int as, const float* W, int ld,
    const float* b, float* out, int os, bool hidden, int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tm = (R + TM - 1) / TM, tn = (N + 127) >> 7;
  for (int wt = warp; wt < tm * tn; wt += NT / 32) {
    const int r0 = (wt / tn) * TM, c = (wt % tn) * 128 + 4 * lane;
    if (c >= N) continue;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const float* a = A + r0 * as;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 av[TM], wv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = ld4(a + i * as + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = ld4(W + (k + q) * ld + c);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = at(av[i], q);
          acc[i][0] += x * wv[q].x;
          acc[i][1] += x * wv[q].y;
          acc[i][2] += x * wv[q].z;
          acc[i][3] += x * wv[q].w;
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (r0 + i >= R) break;
      float* o = out + (r0 + i) * os;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N) {
          const float h = acc[i][j] + b[c + j];
          o[c + j] = hidden ? act_fwd(h, act) : h;
        }
    }
  }
}

// The same for N <= THIN (a head): a warp per row, the lanes splitting k,
// each lane's sums added by a fixed shuffle tree.
template <int NT = CT>
__device__ __forceinline__ void fwd_thin(
    int R, int N, int K, const float* A, int as, const float* W, int ld,
    const float* b, float* out, int os, bool hidden, int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += NT / 32) {
    float s[THIN];
#pragma unroll
    for (int j = 0; j < THIN; ++j) s[j] = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float a = A[r * as + k];
      const float4 w0 = ld4(W + k * ld);
      s[0] += a * w0.x;
      s[1] += a * w0.y;
      s[2] += a * w0.z;
      s[3] += a * w0.w;
      if (N > 4) {
        const float4 w1 = ld4(W + k * ld + 4);
        s[4] += a * w1.x;
        s[5] += a * w1.y;
        s[6] += a * w1.z;
        s[7] += a * w1.w;
      }
    }
#pragma unroll
    for (int j = 0; j < THIN; ++j) {
      if (j >= N) break;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    }
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < THIN; ++j)
        if (j < N) {
          const float h = s[j] + b[j];
          out[r * os + j] = hidden ? act_fwd(h, act) : h;
        }
  }
}

// dX in place: A[r][k] <- (sum_j G[r][j] W[k][j]) act'(A[r][k]) for r < R,
// k < K, each sum in j order; Nj = r4(N): G's and W's columns past N are
// zero.  A (the layer's saved input) is read and written here only.  A warp
// owns TM rows x 128 k, a lane TM rows x k = lane + 32 q.
template <int TM, int NT = CT>
__device__ __forceinline__ void dx_tile(
    int R, int K, int Nj, const float* G, int gs, const float* W, int ld,
    float* A, int as, int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tm = (R + TM - 1) / TM, tk = (K + 127) >> 7;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int wt = warp; wt < tm * tk; wt += NT / 32) {
    const int r0 = (wt / tk) * TM, kb = (wt % tk) * 128 + lane;
    if (kb >= K) continue;
    bool kv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) kv[q] = kb + 32 * q < K;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < Nj; j += 4) {
      float4 gv[TM], wv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) gv[i] = ld4(G + (r0 + i) * gs + j);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = kv[q] ? ld4(W + (kb + 32 * q) * ld + j) : zero;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] += gv[i].x * wv[q].x;
          acc[i][q] += gv[i].y * wv[q].y;
          acc[i][q] += gv[i].z * wv[q].z;
          acc[i][q] += gv[i].w * wv[q].w;
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (r0 + i >= R) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (kv[q]) {
          float* h = A + (r0 + i) * as + kb + 32 * q;
          *h = acc[i][q] * act_grad(*h, act);
        }
    }
  }
}

// Rows a warp owns in the row-tiled products: as many as keep every warp
// busy, up to 4 (for sub-tiles of at most 8 rows, 16, 32).
template <int NT = CT>
__device__ __forceinline__ void fwd_rows(int R, int N, int K, const float* A,
                                         int as, const float* W, int ld,
                                         const float* b, float* out, int os,
                                         bool hidden, int act) {
  if (R > 16)
    fwd_tile<4, NT>(R, N, K, A, as, W, ld, b, out, os, hidden, act);
  else if (R > 8)
    fwd_tile<2, NT>(R, N, K, A, as, W, ld, b, out, os, hidden, act);
  else
    fwd_tile<1, NT>(R, N, K, A, as, W, ld, b, out, os, hidden, act);
}
template <int NT = CT>
__device__ __forceinline__ void dx_rows(int R, int K, int Nj, const float* G,
                                        int gs, const float* W, int ld,
                                        float* A, int as, int act) {
  if (R > 16)
    dx_tile<4, NT>(R, K, Nj, G, gs, W, ld, A, as, act);
  else if (R > 8)
    dx_tile<2, NT>(R, K, Nj, G, gs, W, ld, A, as, act);
  else
    dx_tile<1, NT>(R, K, Nj, G, gs, W, ld, A, as, act);
}

// The same for N <= THIN (a head's): a warp per row, a lane per k.
template <int NT = CT>
__device__ __forceinline__ void dx_thin(
    int R, int K, int N, const float* G, int gs, const float* W, int ld,
    float* A, int as, int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = warp; r < R; r += NT / 32) {
    const float4 g0 = ld4(G + r * gs);
    const float4 g1 = N > 4 ? ld4(G + r * gs + 4) : zero;
    for (int k = lane; k < K; k += 32) {
      const float4 w0 = ld4(W + k * ld);
      float s = 0.0f;
      s += g0.x * w0.x;
      s += g0.y * w0.y;
      s += g0.z * w0.z;
      s += g0.w * w0.w;
      if (N > 4) {
        const float4 w1 = ld4(W + k * ld + 4);
        s += g1.x * w1.x;
        s += g1.y * w1.y;
        s += g1.z * w1.z;
        s += g1.w * w1.w;
      }
      float* h = A + r * as + k;
      *h = s * act_grad(*h, act);
    }
  }
}

// The block's weight-gradient partial: P[k][j] = sum_{r<R} A[r][k] G[r][j]
// in row order for k < K, j < N, stored on the first sub-tile of a step
// and added after.  A warp owns 8 k x 128 columns, a lane 8 x 4.
template <int NT = CT>
__device__ __forceinline__ void dw_tile(
    int R, int K, int N, const float* A, int as, const float* G, int gs,
    float* P, int ld, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tk = (K + 7) >> 3, tn = (N + 127) >> 7;
  for (int wt = warp; wt < tk * tn; wt += NT / 32) {
    const int k0 = (wt / tn) * 8, c = (wt % tn) * 128 + 4 * lane;
    if (c >= N) continue;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      const float4 a0 = ld4(A + r * as + k0), a1 = ld4(A + r * as + k0 + 4);
      const float4 g = ld4(G + r * gs + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = i < 4 ? at(a0, i) : at(a1, i - 4);
        acc[i][0] += x * g.x;
        acc[i][1] += x * g.y;
        acc[i][2] += x * g.z;
        acc[i][3] += x * g.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k0 + i >= K) break;
      float* p = P + (k0 + i) * ld + c;
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

// db's partial: a thread per column, in row order.
template <int NT = CT>
__device__ __forceinline__ void db_sum(
    int R, int N, const float* G, int gs, float* Pb, bool first) {
  for (int j = threadIdx.x; j < N; j += NT) {
    float s = 0.0f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) s += G[r * gs + j];
    Pb[j] = first ? s : Pb[j] + s;
  }
}

// dW and db for N <= THIN (a head's): a thread per input row k (k == K:
// db, A = 1), its N sums in registers, in row order.
template <int NT = CT>
__device__ __forceinline__ void dw_thin_out(
    int R, int K, int N, const float* A, int as, const float* G, int gs,
    float* P, int ld, float* Pb, bool first) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = threadIdx.x; k <= K; k += NT) {
    float s[THIN];
#pragma unroll
    for (int j = 0; j < THIN; ++j) s[j] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float a = k < K ? A[r * as + k] : 1.0f;
      const float4 g0 = ld4(G + r * gs);
      const float4 g1 = N > 4 ? ld4(G + r * gs + 4) : zero;
#pragma unroll
      for (int j = 0; j < THIN; ++j)
        s[j] += a * (j < 4 ? at(g0, j) : at(g1, j - 4));
    }
    float* dst = k < K ? P + k * ld : Pb;
#pragma unroll
    for (int j = 0; j < THIN; ++j)
      if (j < N) dst[j] = first ? s[j] : dst[j] + s[j];
  }
}

// dW and db for K <= THIN_K (layer 0 of the nets here): a thread per
// column j, the K + 1 sums in registers, in row order.
template <int NT = CT>
__device__ __forceinline__ void dw_thin_in(
    int R, int K, int N, const float* A, int as, const float* G, int gs,
    float* P, int ld, float* Pb, bool first) {
  for (int j = threadIdx.x; j < N; j += NT) {
    float s[THIN_K + 1];
#pragma unroll
    for (int k = 0; k <= THIN_K; ++k) s[k] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float g = G[r * gs + j];
#pragma unroll
      for (int k4 = 0; k4 < THIN_K; k4 += 4) {
        if (k4 >= K) break;
        const float4 a = ld4(A + r * as + k4);
        s[k4] += a.x * g;
        s[k4 + 1] += a.y * g;
        s[k4 + 2] += a.z * g;
        s[k4 + 3] += a.w * g;
      }
      s[THIN_K] += g;
    }
#pragma unroll
    for (int k = 0; k < THIN_K; ++k)
      if (k < K) P[k * ld + j] = first ? s[k] : P[k * ld + j] + s[k];
    Pb[j] = first ? s[THIN_K] : Pb[j] + s[THIN_K];
  }
}

// K6's loss head on one row (ppoc_tpu/ops/pallas_update.py:824-866): the
// log-softmax of the K logits o[0..K) (the head's padding columns never
// enter), logp of the row's class (the int32 bits in e[0]), ratio =
// exp(logp - lp_old), the clipped surrogate min(ratio adv, clip(ratio)
// adv) into st[0] and the entropy H = -sum_k p_k logp_k into st[1]; then
// the logit gradient dlogp (onehot - p) + (ent_coeff / mb) p (logp + H) in
// place of o[0..K), zero in o[K..r4(K)), with dlogp = -(adv ratio / mb) on
// the unclipped branch and 0 on the clipped one.
//
// It runs in double from the float logits and rounds each result once.
// In float, 1 - p and logp + H cancel, and each class's gradient rounds on
// its own: with two classes the two gradients should be equal and
// opposite, and the next layer's gradient sum_k dz_k W[j][k] turns their
// unequal rounding into an error |W[j][1]| / |W[j][0] - W[j][1]| times
// larger, which Adam's eps turns into a visible step where a weight's
// gradient cancels over the minibatch.  Rounded from double, the two are
// exact negatives.  Its cost is a few double exps a row, once a step.
__device__ __forceinline__ void categorical_head(const float* e, float* o,
                                                 float* st, int K,
                                                 float clip_lo, float clip_hi,
                                                 float ent_coeff, float mbf) {
  double zmax = o[0];
  for (int k = 1; k < K; ++k) zmax = fmax(zmax, (double)o[k]);
  double sum = 0.0;
  for (int k = 0; k < K; ++k) sum += exp((double)o[k] - zmax);
  const double lse = zmax + log(sum);
  const int cls = __float_as_int(e[0]);
  double logp = 0.0, H = 0.0;
  for (int k = 0; k < K; ++k) {
    const double lpa = (double)o[k] - lse;
    if (k == cls) logp = lpa;
    H -= exp(lpa) * lpa;
  }
  const double adv = e[9];
  const double ratio = exp(logp - (double)e[8]);
  const double clipped = fmin(fmax(ratio, (double)clip_lo), (double)clip_hi);
  const double ra = ratio * adv, ca = clipped * adv;
  st[0] = (float)fmin(ra, ca);
  st[1] = (float)H;
  // only the unclipped branch carries the surrogate's gradient
  const double dlogp = ra <= ca ? -(adv * ratio / mbf) : 0.0;
  const double ent_mb = (double)ent_coeff / mbf;
  for (int k = 0; k < r4(K); ++k) {
    if (k < K) {
      const double lpa = (double)o[k] - lse, p = exp(lpa);
      o[k] = (float)(dlogp * ((k == cls ? 1.0 : 0.0) - p)
                     + ent_mb * p * (lpa + H));
    } else {
      o[k] = 0.0f;
    }
  }
}

// The launch configuration of `kernel` on a cluster of C blocks of NT
// threads with `smem` bytes each, its attributes set.
template <int NT = CT, class Dev>
cudaError_t configure(void (*kernel)(const Dev), int C, long smem,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > PORTABLE_C)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

}  // namespace

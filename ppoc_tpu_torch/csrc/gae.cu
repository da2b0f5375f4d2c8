// K2: GAE(lambda) + whole-buffer advantage normalisation in one launch.
//
// Replaces ppoc_tpu/ops/pallas_gae.py `gae_norm_fused` -> `_kernel`:
// delta = r + gamma V'(1 - term) - V; the backward recurrence
// A_t = delta_t + gamma lam (1 - done_t) A_{t+1} with done = term | trunc;
// target = V + A; then A <- (A - mean) / (sqrt(var) + 1e-8) with the
// population moments, taken two-pass (mean first, then the variance).
//
// What bounds it on the card: the bytes are small (14 read and 8 written
// an element: 0.16 MB at the bench's 64 x 200, 8.6 MB at 4096 x 150) and
// the operations trivial; the time is the T-step serial recurrence, the
// memory latency under it, and the launch.
//
// The design.  One thread-block cluster of up to 16 blocks (the plan,
// `gae_plan`, mirrored by ops/cuda_gae.py `plan`): where the whole buffer's
// deltas and done flags fit one block's shared memory, one block takes
// every env column; past that, block b takes the columns [b C, (b + 1) C),
// C a multiple of 32 and at most 16 blocks, so 4096 columns no longer
// share one SM.
//  * The parallel pass: every thread of a block computes delta and the done
//    flag of a share of its elements (a step's columns are neighbouring
//    threads, each thread's loads of several elements issued together) into
//    shared memory: 5 bytes an element.
//  * The serial pass: one thread a column walks the steps backward reading
//    shared memory only, U steps' loads issued together before their U
//    dependent FMAs.  The advantages overwrite the deltas in place.
//  * Where a block's columns x T steps do not fit its shared memory, it
//    takes the steps in chunks of `rows` from the last, carrying each
//    column's A in shared memory, and the unnormalised advantages wait in
//    the output buffer for the moments.
//  * The moments: each block sums its elements (each thread in index order,
//    then block_sum), then every block sums the blocks' partials in rank
//    order over distributed shared memory; twice (the mean, then the
//    variance).  No float atomics: the same bits from call to call.
// Every plan computes each element with the same expressions (delta, the
// recurrence's FMA, V + A), so the unnormalised advantages and the targets
// are the same bits in every plan; with one block each thread sums its
// elements in index order before block_sum, so the normalised advantages
// are those of a one-block kernel too.  In a cluster only the moments'
// summation order differs.
#include <cooperative_groups.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GAE_THREADS = 1024;
constexpr int GAE_MAX_BLOCKS = 16;   // the largest cluster (non-portable)
// dynamic shared memory a block may take: the card's 232,448 less room
// for the static arrays below
constexpr int GAE_SMEM = 224 * 1024;
constexpr int GAE_U = 8;             // serial steps whose loads go together
constexpr int GAE_BATCH = 4;         // elements a thread loads together

struct GaePlan {
  int blocks, cols, rows;   // blocks, env columns a block, steps a chunk
  long smem;                // dynamic shared-memory bytes a block
};

// The plan of a T x E launch; false where none exists (the entry refuses
// the launch).  At most 16 blocks by construction: C >= E / 16.
bool gae_plan(int T, int E, GaePlan* p) {
  if (T < 1 || E < 1) return false;
  int C = E;                                  // one block, the whole buffer
  if (5L * T * E > GAE_SMEM) {
    const int per = (E + GAE_MAX_BLOCKS - 1) / GAE_MAX_BLOCKS;
    C = 32 * ((per + 31) / 32);
    C = C < E ? C : E;
  }
  const int blocks = (E + C - 1) / C;
  int rows = T;
  if (5L * T * C > GAE_SMEM) {                // chunks, carries in smem
    rows = (int)((GAE_SMEM - 4L * C - 4) / (5L * C));
    if (rows < 1) return false;
  }
  p->blocks = blocks;
  p->cols = C;
  p->rows = rows;
  p->smem = 4L * rows * C + (((long)rows * C + 3) & ~3L) +
            (rows < T ? 4L * C : 0L);
  return true;
}

struct GaeArgs {
  const float *r, *v, *nv;
  const bool *term, *trunc;
  float *adv, *tgt;
  int T, E, cols, rows, normalize;
  float gamma, gl;
};

// Walks one column's steps [0, n) of a chunk (local rows) from the last:
// D holds the deltas and becomes the advantages, F the done flags; `top`:
// the chunk ends at step T - 1, where A = delta.  Returns the carry A.
// GAE_U steps' loads go out together ahead of their dependent FMAs.
__device__ __forceinline__ float walk(float* D, const unsigned char* F,
                                      int stride, int n, bool top, float acc,
                                      float gl) {
  int r = n - 1;
  if (top && r >= 0) {
    acc = D[r * stride];
    --r;
  }
  for (; r >= GAE_U - 1; r -= GAE_U) {
    float d[GAE_U];
    bool f[GAE_U];
#pragma unroll
    for (int u = 0; u < GAE_U; ++u) {
      d[u] = D[(r - u) * stride];
      f[u] = F[(r - u) * stride];
    }
#pragma unroll
    for (int u = 0; u < GAE_U; ++u) {
      const float c = f[u] ? 0.0f : gl;   // gamma lam (1 - done), exactly
      acc = d[u] + c * acc;
      D[(r - u) * stride] = acc;
    }
  }
  for (; r >= 0; --r) {
    const float c = F[r * stride] ? 0.0f : gl;
    acc = D[r * stride] + c * acc;
    D[r * stride] = acc;
  }
  return acc;
}

// The sum of `x` over the cluster's blocks, in rank order (every thread);
// `slot` a float of static shared memory no block reads or writes in
// between.  `x` is the block's sum (every thread has it).
__device__ __forceinline__ float cluster_total(float x, float* slot, int nb) {
  if (nb == 1) return x;
  if (threadIdx.x == 0) *slot = x;
  cluster_sync();
  float tot = 0.0f;
  for (int k = 0; k < nb; ++k) tot += ld_cluster(cluster_addr(slot, k));
  return tot;
}

// Runs body(n, i, gi) over the elements of steps [t0, t1) of a block's Cb
// columns that this thread takes, GAE_BATCH at a time (n of them valid; i
// the index in the chunk, (t - t0) Cb + e, gi the index in the [T, E]
// planes): where Cb <= blockDim.x a thread keeps one column and takes every
// (blockDim.x / Cb)-th step, else every blockDim.x-th column of each step.
template <typename Body>
__device__ __forceinline__ void for_elements(int t0, int t1, int Cb, int E,
                                             int c0, Body body) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int i[GAE_BATCH];
  size_t gi[GAE_BATCH];
  if (Cb <= nt) {
    const int per = nt / Cb, e = tid % Cb;
    if (tid >= per * Cb) return;
    for (int t = t0 + tid / Cb; t < t1; t += per * GAE_BATCH) {
      int n = 0;
#pragma unroll
      for (int u = 0; u < GAE_BATCH; ++u) {
        const int tu = t + u * per;
        i[u] = (tu - t0) * Cb + e;
        gi[u] = (size_t)tu * E + c0 + e;
        n += tu < t1;
      }
      body(n, i, gi);
    }
  } else {
    for (int t = t0; t < t1; ++t)
      for (int e = tid; e < Cb; e += nt * GAE_BATCH) {
        int n = 0;
#pragma unroll
        for (int u = 0; u < GAE_BATCH; ++u) {
          const int eu = e + u * nt;
          i[u] = (t - t0) * Cb + eu;
          gi[u] = (size_t)t * E + c0 + eu;
          n += eu < Cb;
        }
        body(n, i, gi);
      }
  }
}

__global__ void __launch_bounds__(GAE_THREADS, 1)
gae_norm_kernel(const __grid_constant__ GaeArgs a) {
  extern __shared__ __align__(16) unsigned char gsm[];
  __shared__ float red[33];
  __shared__ float part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int T = a.T, E = a.E, C = a.cols, R = a.rows;
  const int c0 = rank * C, Cb = min(C, E - c0);   // this block's columns
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool whole = R >= T;   // every step of the columns in shared memory
  float* D = reinterpret_cast<float*>(gsm);
  unsigned char* F = gsm + 4L * R * C;
  float* carry = reinterpret_cast<float*>(gsm + 4L * R * C +
                                          (((long)R * C + 3) & ~3L));
  const float gamma = a.gamma, gl = a.gl;

  for (int t1 = T; t1 > 0; t1 -= R) {   // chunks of R steps from the last
    const int t0 = max(0, t1 - R), n = (t1 - t0) * Cb;
    __syncthreads();   // the last chunk's D and F are no longer read
    for_elements(t0, t1, Cb, E, c0, [&](int n, const int* i,
                                        const size_t* gi) {
      float rr[GAE_BATCH], vv[GAE_BATCH], nvv[GAE_BATCH];
      bool te_b[GAE_BATCH], tr_b[GAE_BATCH];
#pragma unroll
      for (int u = 0; u < GAE_BATCH; ++u) {
        if (u < n) {
          rr[u] = a.r[gi[u]];
          vv[u] = a.v[gi[u]];
          nvv[u] = a.nv[gi[u]];
          te_b[u] = a.term[gi[u]];
          tr_b[u] = a.trunc[gi[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < GAE_BATCH; ++u) {
        if (u < n) {
          const float te = te_b[u] ? 1.0f : 0.0f;
          D[i[u]] = rr[u] + gamma * nvv[u] * (1.0f - te) - vv[u];
          F[i[u]] = te_b[u] || tr_b[u];
        }
      }
    });
    __syncthreads();
    for (int e = tid; e < Cb; e += nt) {
      const float acc = walk(D + e, F + e, Cb, t1 - t0, t1 == T,
                             t1 == T ? 0.0f : carry[e], gl);
      if (!whole) carry[e] = acc;
    }
    __syncthreads();
    // the targets, and the advantages as they are where no moments follow
    // or they wait in the output buffer for them
    for_elements(t0, t1, Cb, E, c0, [&](int n, const int* i,
                                        const size_t* gi) {
      float vv[GAE_BATCH];
#pragma unroll
      for (int u = 0; u < GAE_BATCH; ++u)
        if (u < n) vv[u] = a.v[gi[u]];
#pragma unroll
      for (int u = 0; u < GAE_BATCH; ++u) {
        if (u < n) {
          a.tgt[gi[u]] = vv[u] + D[i[u]];
          if (!a.normalize || !whole) a.adv[gi[u]] = D[i[u]];
        }
      }
    });
  }
  if (!a.normalize) return;
  __syncthreads();   // the output buffer's advantages, for every thread

  // the unnormalised advantages: D (whole) or the output buffer
  const int n = T * Cb;
  const auto at = [&](int i) {
    return whole ? D[i] : a.adv[(size_t)(i / Cb) * E + c0 + i % Cb];
  };
  float s = 0.0f;
  for (int i = tid; i < n; i += nt) s += at(i);
  const float count = (float)((long)T * E);
  const float mean = cluster_total(block_sum(s, red), &part[0], nb) / count;
  float q = 0.0f;
  for (int i = tid; i < n; i += nt) {
    const float d = at(i) - mean;
    q += d * d;
  }
  const float var = cluster_total(block_sum(q, red), &part[1], nb) / count;
  const float denom = sqrtf(var) + 1e-8f;
  for_elements(0, T, Cb, E, c0, [&](int m, const int* i, const size_t* gi) {
    float x[GAE_BATCH];
#pragma unroll
    for (int u = 0; u < GAE_BATCH; ++u)
      if (u < m) x[u] = whole ? D[i[u]] : a.adv[gi[u]];
#pragma unroll
    for (int u = 0; u < GAE_BATCH; ++u)
      if (u < m) a.adv[gi[u]] = (x[u] - mean) / denom;
  });
  if (nb > 1) cluster_sync();   // no block leaves while another reads it
}

}  // namespace

// The launch's plan: out = {blocks (the cluster), env columns a block,
// steps a chunk (T: every step in shared memory), dynamic shared-memory
// bytes a block}.  Returns 0, or cudaErrorInvalidValue where the kernel
// takes no such launch.
extern "C" int ppoc_gae_plan(int T, int E, long* out) {
  GaePlan p;
  if (!gae_plan(T, E, &p)) return cudaErrorInvalidValue;
  out[0] = p.blocks;
  out[1] = p.cols;
  out[2] = p.rows;
  out[3] = p.smem;
  return 0;
}

extern "C" int ppoc_gae_norm(const float* r, const float* v, const float* nv,
                             const bool* term, const bool* trunc, float* adv,
                             float* tgt, int T, int E, float gamma, float gl,
                             int normalize, cudaStream_t stream) {
  GaePlan p;
  if (!gae_plan(T, E, &p)) return cudaErrorInvalidValue;
  const GaeArgs a{r, v, nv, term, trunc, adv, tgt, T, E, p.cols, p.rows,
                  normalize, gamma, gl};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<GAE_THREADS>(gae_norm_kernel, p.blocks, p.smem,
                                           stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gae_norm_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* ppoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

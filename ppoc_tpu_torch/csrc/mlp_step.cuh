// The forward, backward and Adam code of K6's one-block update phase
// (update.cu): one minibatch step of an MLP, run by ONE block.  K5
// (mlp.cu) uses its padded weight layout, `block_gemm` and `sliced_gemm`;
// the functions are inline because both sources include this header.
//
// Layout during a phase:
//   * the weights: in shared memory, each W_l row padded to d_{l+1} + 1
//     floats so a warp reading down a W column (the dX product) hits 32
//     banks; or, for nets larger than one block's shared memory
//     (GLOBAL_W), in the phase's output params in global memory (L2-
//     resident), flat and unpadded, with each product staging its weight
//     operand SLICE rows at a time through a small shared-memory slice;
//   * global scratch (L2-resident, allocated by the wrapper): the post-
//     activations of every layer for the minibatch, two ping-pong gradient
//     buffers and the flat gradient;
//   * the Adam moments stay in their (output) tensors in global memory.
// The products are the block's own loops (`block_gemm`, `sliced_gemm`):
// each warp owns a 4-row x 128-column tile, each lane 4x4 outputs in
// registers, so one k-step costs 8 loads for 16 FMAs.  Both sum each
// output in k order, so the two placements of the weights give the same
// bits.
#pragma once

#include "common.cuh"

namespace ppoc {

constexpr int SLICE = 32;   // rows of a product's B per staged slice

struct PaddedNet {
  Net net;
  int pw_off[MAX_LAYERS];   // W_l in the padded shared-memory layout
  int pb_off[MAX_LAYERS];   // b_l in the padded shared-memory layout
  int n_padded;
  int h_off[MAX_LAYERS];    // layer l's outputs in the activation scratch
  int h_floats;             // activation scratch size: mb * (d1 + ... + dL)
  int g_floats;             // one gradient buffer: mb * max(d1..dL)
};

inline bool make_padded(PaddedNet* p, int n_layers, const int* dims, int mb) {
  if (!make_net(&p->net, n_layers, dims) || mb < 1) return false;
  int off = 0, h = 0, dmax = 1;
  for (int l = 0; l < n_layers; ++l) {
    p->pw_off[l] = off;
    off += dims[l] * (dims[l + 1] + 1);
    p->pb_off[l] = off;
    off += dims[l + 1];
    p->h_off[l] = h;
    h += mb * dims[l + 1];
    dmax = dims[l + 1] > dmax ? dims[l + 1] : dmax;
  }
  p->n_padded = off;
  p->h_floats = h;
  p->g_floats = mb * dmax;
  return true;
}

struct AdamHyper {
  float lr, b1, b2, omb1, omb2, logb1, logb2, eps;   // omb = 1 - b, logb = log b
};

// Everything one phase step needs; built once per launch.
struct StepCtx {
  PaddedNet pn;
  int mb, act;
  float* W;        // the weights: shared memory, padded layout; with
                   // GLOBAL_W the flat params in global memory
  float* Ws;       // GLOBAL_W: the shared-memory slice the products stage
                   // W through, SLICE x (max width + 1) floats
  float* H;        // scratch activations
  float* G[2];     // scratch gradient ping-pong; G[0] = dLoss/dOutput on entry
  float* dP;       // scratch flat gradient (unpadded layout)
};

// Where W_l and b_l start in c.W, and W_l's row stride.
template <bool GLOBAL_W>
__device__ __forceinline__ int w_start(const PaddedNet& pn, int l) {
  return GLOBAL_W ? pn.net.w_off[l] : pn.pw_off[l];
}
template <bool GLOBAL_W>
__device__ __forceinline__ int b_start(const PaddedNet& pn, int l) {
  return GLOBAL_W ? pn.net.b_off[l] : pn.pb_off[l];
}
template <bool GLOBAL_W>
__device__ __forceinline__ int w_stride(const PaddedNet& pn, int l) {
  return GLOBAL_W ? pn.net.dim[l + 1] : pn.net.dim[l + 1] + 1;
}

// Flat (unpadded) parameter index -> padded shared-memory index.
__device__ __forceinline__ int padded_index(const PaddedNet& pn, int i) {
  int l = 0;
  while (l + 1 < pn.net.n_layers && i >= pn.net.w_off[l + 1]) ++l;
  const int dout = pn.net.dim[l + 1];
  const int r = i - pn.net.w_off[l];
  const int wsz = pn.net.dim[l] * dout;
  return r < wsz ? pn.pw_off[l] + (r / dout) * (dout + 1) + r % dout
                 : pn.pb_off[l] + (r - wsz);
}

// C = A x B over the block: out(r, j) for r < M, j < N is
// epi(r, j, sum_k la(r, k) * lb(k, j)), the sum taken in k order.
template <class LA, class LB, class Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K, LA la, LB lb,
                                           Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int tm = (M + 3) >> 2, tn = (N + 127) >> 7;
  for (int wt = warp; wt < tm * tn; wt += n_warps) {
    const int r0 = (wt / tn) * 4;
    const int c0 = (wt % tn) * 128 + lane;
    if (c0 >= N) continue;
    bool rv[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rv[i] = r0 + i < M;
      cv[i] = c0 + 32 * i < N;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = rv[i] ? la(r0 + i, k) : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = cv[q] ? lb(k, c0 + 32 * q) : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += av[i] * bv[q];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (rv[i] && cv[q]) epi(r0 + i, c0 + 32 * q, acc[i][q]);
  }
}

// C = A x B over the block with B staged through shared memory in slices
// of SLICE rows: out(r, j) for r < M, j < N is epi(r, j, sum_k la(r, k) *
// lb(k - k0, j)), the sum taken in k order; before the slice of rows
// k0..k0+kn every thread calls load_b(k0, kn), which writes them where lb
// reads.  Each warp owns one 4-row x 128-column tile of C at a time, as in
// block_gemm, and keeps its sums in registers across the slices, so B is
// staged once for every round of n_warps tiles (one round for M <= 32,
// N <= 256 at 512 threads).  Every thread of the block must call it.
template <class LA, class LB, class SB, class Epi>
__device__ __forceinline__ void sliced_gemm(int M, int N, int K, LA la,
                                            LB lb, SB load_b, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int tm = (M + 3) >> 2, tn = (N + 127) >> 7;
  for (int base = 0; base < tm * tn; base += n_warps) {
    const int wt = base + warp;
    const bool own = wt < tm * tn;
    const int r0 = own ? (wt / tn) * 4 : 0;
    const int c0 = own ? (wt % tn) * 128 + lane : 0;
    bool rv[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rv[i] = own && r0 + i < M;
      cv[i] = own && c0 + 32 * i < N;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += SLICE) {
      const int kn = min(SLICE, K - k0);
      __syncthreads();   // the previous slice's (or product's) reads are done
      load_b(k0, kn);
      __syncthreads();
      if (!cv[0]) continue;
      for (int k = 0; k < kn; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = rv[i] ? la(r0 + i, k0 + k) : 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = cv[q] ? lb(k, c0 + 32 * q) : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] += av[i] * bv[q];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (rv[i] && cv[q]) epi(r0 + i, c0 + 32 * q, acc[i][q]);
  }
}

// Forward of the minibatch x [mb, d0] -> post-activations in c.H.
// GLOBAL_W stages W's rows SLICE at a time into c.Ws [SLICE][dout] with
// plain loads: Adam rewrites the weights every step, so nothing may read
// them through the read-only (non-coherent) cache.  Ends with
// __syncthreads.
template <bool GLOBAL_W>
__device__ inline void mlp_forward(const StepCtx& c, const float* x) {
  const Net& net = c.pn.net;
  const int L = net.n_layers;
  for (int l = 0; l < L; ++l) {
    const int din = net.dim[l], dout = net.dim[l + 1];
    const float* A = l == 0 ? x : c.H + c.pn.h_off[l - 1];
    const float* W = c.W + w_start<GLOBAL_W>(c.pn, l);
    const float* b = c.W + b_start<GLOBAL_W>(c.pn, l);
    float* out = c.H + c.pn.h_off[l];
    const bool hidden = l < L - 1;
    const int act = c.act;
    auto la = [=](int r, int k) { return A[r * din + k]; };
    auto epi = [=](int r, int j, float s) {
      const float h = s + b[j];
      out[r * dout + j] = hidden ? act_fwd(h, act) : h;
    };
    if constexpr (GLOBAL_W) {
      float* Ws = c.Ws;
      sliced_gemm(
          c.mb, dout, din, la,
          [=](int k, int j) { return Ws[k * dout + j]; },
          [=](int k0, int kn) {
            for (int i = threadIdx.x; i < kn * dout; i += blockDim.x)
              Ws[i] = W[(size_t)k0 * dout + i];
          },
          epi);
    } else {
      block_gemm(
          c.mb, dout, din, la,
          [=](int k, int j) { return W[k * (dout + 1) + j]; }, epi);
    }
    __syncthreads();
  }
}

// Backward from G[0] = dLoss/dOutput [mb, d_L]: writes the flat gradient
// to c.dP.  Per layer, dW (with db as its extra row) and dX read the same
// operands; dW/db reads no weights.  GLOBAL_W stages the dX product's W
// columns SLICE at a time, transposed, into c.Ws [SLICE][din + 1] (rows
// padded so the stores of a warp hit distinct banks), with plain loads.
// Ends with __syncthreads.
template <bool GLOBAL_W>
__device__ inline void mlp_backward(const StepCtx& c, const float* x) {
  const Net& net = c.pn.net;
  const int L = net.n_layers, mb = c.mb, act = c.act;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dim[l], dout = net.dim[l + 1];
    const float* A = l == 0 ? x : c.H + c.pn.h_off[l - 1];
    const float* g = c.G[cur];
    float* dW = c.dP + net.w_off[l];
    float* db = c.dP + net.b_off[l];
    // dW[k][j] = sum_r A[r][k] g[r][j]; row k = din is db[j] = sum_r g[r][j]
    block_gemm(
        din + 1, dout, mb,
        [=](int k, int r) { return k < din ? A[r * din + k] : 1.0f; },
        [=](int r, int j) { return g[r * dout + j]; },
        [=](int k, int j, float s) {
          if (k < din) dW[k * dout + j] = s; else db[j] = s;
        });
    if (l > 0) {
      // g'[r][k] = (sum_j g[r][j] W[k][j]) * act'(A[r][k])
      const float* W = c.W + w_start<GLOBAL_W>(c.pn, l);
      float* gn = c.G[1 - cur];
      auto la = [=](int r, int j) { return g[r * dout + j]; };
      auto epi = [=](int r, int k, float s) {
        gn[r * din + k] = s * act_grad(A[r * din + k], act);
      };
      if constexpr (GLOBAL_W) {
        float* Ws = c.Ws;
        const int ld = din + 1;
        sliced_gemm(
            mb, din, dout, la,
            [=](int j, int k) { return Ws[j * ld + k]; },
            [=](int j0, int jn) {
              for (int i = threadIdx.x; i < din * jn; i += blockDim.x) {
                const int k = i / jn, jj = i - k * jn;
                Ws[jj * ld + k] = W[(size_t)k * dout + j0 + jj];
              }
            },
            epi);
      } else {
        block_gemm(
            mb, din, dout, la,
            [=](int j, int k) { return W[k * (dout + 1) + j]; }, epi);
      }
    }
    __syncthreads();
    cur = 1 - cur;
  }
}

// Adam on every weight, with the bias corrections 1 - exp(t log b) folded
// into the step size and eps outside the sqrt.  Ends with __syncthreads,
// which also orders the weight updates before the next step's reads.
template <bool GLOBAL_W>
__device__ inline void adam_step(const StepCtx& c, float* m, float* v, int t,
                                 const AdamHyper& h) {
  const float tf = (float)t;
  const float bc1 = 1.0f - expf(tf * h.logb1);
  const float bc2 = 1.0f - expf(tf * h.logb2);
  const float step = h.lr / bc1;
  const Net& net = c.pn.net;
  for (int l = 0; l < net.n_layers; ++l) {
    const int dout = net.dim[l + 1];
    const int wsz = net.dim[l] * dout;
    const int ld = w_stride<GLOBAL_W>(c.pn, l);
    for (int r = threadIdx.x; r < wsz + dout; r += blockDim.x) {
      const int i = net.w_off[l] + r;
      const int pi = r < wsz
                         ? w_start<GLOBAL_W>(c.pn, l) + (r / dout) * ld + r % dout
                         : b_start<GLOBAL_W>(c.pn, l) + (r - wsz);
      const float g = c.dP[i];
      const float m2 = h.b1 * m[i] + h.omb1 * g;
      const float v2 = h.b2 * v[i] + h.omb2 * (g * g);
      m[i] = m2;
      v[i] = v2;
      c.W[pi] = c.W[pi] - step * m2 / (sqrtf(v2 / bc2) + h.eps);
    }
  }
  __syncthreads();
}

}  // namespace ppoc

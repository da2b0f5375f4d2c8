// The forward, backward and Adam code that the fused update phases (K3, K4
// in update.cu) share: one minibatch step of an MLP, run by ONE block.
// K5 (mlp.cu) uses its padded weight layout and `block_gemm`; the
// functions are inline because both sources include this header.
//
// Layout during a phase:
//   * shared memory: the weights, each W_l row padded to d_{l+1} + 1 floats
//     so a warp reading down a W column (the dX product) hits 32 banks;
//   * global scratch (L2-resident, allocated by the wrapper): the post-
//     activations of every layer for the minibatch, two ping-pong gradient
//     buffers and the flat gradient;
//   * the Adam moments stay in their (output) tensors in global memory.
// The products are the block's own loops (`block_gemm`): each warp owns a
// 4-row x 128-column tile, each lane 4x4 outputs in registers, so one
// k-step costs 8 loads for 16 FMAs.
#pragma once

#include "common.cuh"

namespace ppoc {

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
  float* W;        // shared memory, padded layout
  float* H;        // scratch activations
  float* G[2];     // scratch gradient ping-pong; G[0] = dLoss/dOutput on entry
  float* dP;       // scratch flat gradient (unpadded layout)
};

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

// Forward of the minibatch x [mb, d0] -> post-activations in c.H.
// Ends with __syncthreads.
__device__ inline void mlp_forward(const StepCtx& c, const float* x) {
  const Net& net = c.pn.net;
  const int L = net.n_layers;
  for (int l = 0; l < L; ++l) {
    const int din = net.dim[l], dout = net.dim[l + 1];
    const float* A = l == 0 ? x : c.H + c.pn.h_off[l - 1];
    const float* W = c.W + c.pn.pw_off[l];
    const float* b = c.W + c.pn.pb_off[l];
    float* out = c.H + c.pn.h_off[l];
    const bool hidden = l < L - 1;
    const int act = c.act;
    block_gemm(
        c.mb, dout, din,
        [=](int r, int k) { return A[r * din + k]; },
        [=](int k, int j) { return W[k * (dout + 1) + j]; },
        [=](int r, int j, float s) {
          const float h = s + b[j];
          out[r * dout + j] = hidden ? act_fwd(h, act) : h;
        });
    __syncthreads();
  }
}

// Backward from G[0] = dLoss/dOutput [mb, d_L]: writes the flat gradient
// to c.dP.  Per layer, dW (with db as its extra row) and dX read the same
// operands and run in one pass.  Ends with __syncthreads.
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
      const float* W = c.W + c.pn.pw_off[l];
      float* gn = c.G[1 - cur];
      block_gemm(
          mb, din, dout,
          [=](int r, int j) { return g[r * dout + j]; },
          [=](int j, int k) { return W[k * (dout + 1) + j]; },
          [=](int r, int k, float s) {
            gn[r * din + k] = s * act_grad(A[r * din + k], act);
          });
    }
    __syncthreads();
    cur = 1 - cur;
  }
}

// Adam on every weight, with the bias corrections 1 - exp(t log b) folded
// into the step size and eps outside the sqrt.  Ends with __syncthreads.
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
    for (int r = threadIdx.x; r < wsz + dout; r += blockDim.x) {
      const int i = net.w_off[l] + r;
      const int pi = r < wsz ? c.pn.pw_off[l] + (r / dout) * (dout + 1) + r % dout
                             : c.pn.pb_off[l] + (r - wsz);
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

// K5's (mlp.cu) padded weight layout and its block products, and the Adam
// hyperparameters every update phase takes (phase_args.cuh, update_bf16.cu).
//
// Layout: each W_l row padded to d_{l+1} + 1 floats, so a warp reading down
// a W column (the dX product) hits 32 banks.  The products are the block's
// own loops (`block_gemm`; `sliced_gemm` stages B SLICE rows at a time
// through a small shared-memory slice, for weights that stay in global
// memory): each warp owns a 4-row x 128-column tile, each lane 4x4 outputs
// in registers, so one k-step costs 8 loads for 16 FMAs.  Both sum each
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
};

inline bool make_padded(PaddedNet* p, int n_layers, const int* dims) {
  if (!make_net(&p->net, n_layers, dims)) return false;
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    p->pw_off[l] = off;
    off += dims[l] * (dims[l + 1] + 1);
    p->pb_off[l] = off;
    off += dims[l + 1];
  }
  p->n_padded = off;
  return true;
}

struct AdamHyper {
  float lr, b1, b2, omb1, omb2, logb1, logb2, eps;   // omb = 1 - b, logb = log b
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

}  // namespace ppoc

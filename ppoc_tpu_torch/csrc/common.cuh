// Shared definitions of the port's CUDA kernels (sm_90a).
//
// An MLP travels between Python and the kernels as ONE flat float array in
// the JAX package's layer order: W0 [d0 x d1] row-major, b0 [d1], W1, b1, ...
// `Net` records the widths and the offsets of each W_l and b_l in it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppoc {

constexpr int MAX_LAYERS = 8;
constexpr int MAX_ACT = 8;   // largest continuous action dimension

enum Activation : int { ACT_RELU = 0, ACT_TANH = 1, ACT_NONE = 2 };

struct Net {
  int n_layers;
  int dim[MAX_LAYERS + 1];
  int w_off[MAX_LAYERS];
  int b_off[MAX_LAYERS];
  int n_params;
};

// Fills `net` from the widths d0..dL; false if the depth is out of range.
inline bool make_net(Net* net, int n_layers, const int* dims) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  net->n_layers = n_layers;
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return false;
    net->dim[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net->w_off[l] = off;
    off += dims[l] * dims[l + 1];
    net->b_off[l] = off;
    off += dims[l + 1];
  }
  net->n_params = off;
  return true;
}

__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  if (act == ACT_TANH) return tanhf(x);
  return x;
}

// Activation derivative from the saved post-activation h = act(x).
__device__ __forceinline__ float act_grad(float h, int act) {
  if (act == ACT_RELU) return h > 0.0f ? 1.0f : 0.0f;
  if (act == ACT_TANH) return 1.0f - h * h;
  return 1.0f;
}

// Sum of `v` over the block; every thread gets the total.  `red` holds at
// least 33 floats of shared memory.  Contains __syncthreads: call it from
// every thread of the block.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // `red` may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

}  // namespace ppoc

// The C entry points return cudaGetLastError() after the launch (0 = ok).
extern "C" const char* ppoc_error_string(int code);

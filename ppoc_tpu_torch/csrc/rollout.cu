// K1: the whole T-step Pendulum rollout as one kernel launch.
//
// Replaces ppoc_tpu/ops/pallas_rollout.py `rollout_fused` -> `_kernel`
// (pendulum lane, `_pendulum_lane`; RNG `_fmix32`/`_uniform01`).  Each step
// runs the policy MLP forward, Box-Muller Gaussian sampling and log-prob,
// the pendulum physics, horizon truncation and auto-reset, and optionally
// V(s) and V(s') from the value net or the completed-episode R/J sums.
//
// What bounds it on the card: the T steps are a serial chain, and one step
// is a few small dependent MLP layers (at the bench shape 64 envs through
// [3,128,128,1] nets: about 2 MFLOP per net per step).  So the kernel is
// latency-bound: bytes and FLOPs are far below the card's rates.
//
// What the design does about it: the T loop runs inside the kernel (one
// launch per rollout, as on the TPU), the policy and value weights
// (2 x 17,153 floats at the bench shape, 137 KB) sit in dynamic shared
// memory for the whole rollout, and each block owns a tile of ET envs whose
// state lives in registers.  A layer is one pass of the block: one thread
// per (net, output unit), ET accumulators each, so the policy forward and
// V(s) run side by side.  Blocks are independent (one per env tile).
#include "common.cuh"

using namespace ppoc;

namespace {

constexpr int ET = 8;          // envs per block
constexpr int THREADS = 256;   // >= 2 x the widest hidden layer works best

// Pendulum constants as float32, as the JAX lane computes them.
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float HORIZON_F = 200.0f;

__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// Counter RNG over (seed, step, draw, global lane): pallas_rollout._uniform01.
__device__ __forceinline__ uint32_t rng_bits(uint32_t s0, uint32_t s1,
                                             uint32_t t, uint32_t draw,
                                             uint32_t lane) {
  return fmix32(s0 + t * 0x632BE59Bu + draw * 0x9E3779B9u +
                (lane ^ s1) * 0x2545F491u);
}

__device__ __forceinline__ float uniform01(uint32_t s0, uint32_t s1,
                                           uint32_t t, uint32_t draw,
                                           uint32_t lane) {
  // 24-bit mantissa construction: exact in float32
  return (float)(int)(rng_bits(s0, s1, t, draw, lane) >> 8) *
         (1.0f / 16777216.0f);
}

struct DevArgs {
  Net net[2];                 // [0] policy, [1] value
  const float* params[2];
  const float* log_std;
  const float* st0;           // [E, 2] carried (theta, theta_dot)
  const float* steps0;        // [E]
  int fresh, with_v, act_dim, activation, T, E, hmax;
  uint32_t s0, s1;
  float gamma, lp0;
  float *obs, *next_obs, *action, *log_prob, *reward, *value, *next_value;
  bool *terminated, *truncated;
  float *st_final, *steps_final, *metrics;
};

// Forward nets [first, first+count) over the block's env tile: `in` is
// smem [d0][ET]; net n ping-pongs its hidden layers through bufs[n] and
// writes its output to outs[n] (smem [d_L][ET]).  The nets have equal
// depth.  Ends with __syncthreads.
__device__ void tile_forward(const Net* nets, float* const* P, int first,
                             int count, const float* in, float* const* bufs,
                             float* const* outs, int hmax, int act) {
  const int L = nets[first].n_layers;
  for (int l = 0; l < L; ++l) {
    int total = 0;
    for (int n = first; n < first + count; ++n) total += nets[n].dim[l + 1];
    for (int item = threadIdx.x; item < total; item += blockDim.x) {
      int n = first, j = item;
      while (j >= nets[n].dim[l + 1]) { j -= nets[n].dim[l + 1]; ++n; }
      const Net& net = nets[n];
      const int din = net.dim[l], dout = net.dim[l + 1];
      const float* W = P[n] + net.w_off[l];
      const float* src = l == 0 ? in : bufs[n] + ((l - 1) & 1) * hmax * ET;
      float acc[ET];
#pragma unroll
      for (int e = 0; e < ET; ++e) acc[e] = 0.0f;
      for (int k = 0; k < din; ++k) {
        const float w = W[k * dout + j];
#pragma unroll
        for (int e = 0; e < ET; ++e) acc[e] += src[k * ET + e] * w;
      }
      const float b = P[n][net.b_off[l] + j];
      float* dst = l == L - 1 ? outs[n] : bufs[n] + (l & 1) * hmax * ET;
#pragma unroll
      for (int e = 0; e < ET; ++e) {
        float h = acc[e] + b;
        if (l < L - 1) h = act_fwd(h, act);
        dst[j * ET + e] = h;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
rollout_pendulum_kernel(const DevArgs a) {
  extern __shared__ float smem[];
  __shared__ Net nets[2];
  __shared__ float log_std[MAX_ACT];

  const int tid = threadIdx.x;
  const int n_nets = a.with_v ? 2 : 1;
  if (tid < 2) nets[tid] = a.net[tid];
  if (tid < a.act_dim) log_std[tid] = a.log_std[tid];

  // shared memory: params of each net, input tile, per-net ping-pong
  // hidden buffers, per-net output tile
  float* P[2];
  float* bufs[2];
  float* outs[2];
  float* p = smem;
  for (int n = 0; n < n_nets; ++n) { P[n] = p; p += a.net[n].n_params; }
  float* x = p;                          p += a.net[0].dim[0] * ET;
  for (int n = 0; n < n_nets; ++n) { bufs[n] = p; p += 2 * a.hmax * ET; }
  for (int n = 0; n < n_nets; ++n) {
    outs[n] = p;
    p += a.net[n].dim[a.net[n].n_layers] * ET;
  }
  for (int n = 0; n < n_nets; ++n)
    for (int i = tid; i < a.net[n].n_params; i += blockDim.x)
      P[n][i] = a.params[n][i];

  // env state: thread tid < ET owns env e of this block's tile
  const int e = blockIdx.x * ET + tid;
  const bool owner = tid < ET;
  const bool live = owner && e < a.E;
  const uint32_t lane = (uint32_t)e;
  float th = 0.0f, thd = 0.0f, steps = 0.0f;
  float racc = 0.0f, jacc = 0.0f, gpow = 1.0f, mR = 0.0f, mJ = 0.0f, mN = 0.0f;
  if (live) {
    if (a.fresh) {
      const uint32_t t_init = 0xFFFF0000u;
      th = -PI_F + TWO_PI_F * uniform01(a.s0, a.s1, t_init, 50, lane);
      thd = -1.0f + 2.0f * uniform01(a.s0, a.s1, t_init, 51, lane);
    } else {
      th = a.st0[2 * e];
      thd = a.st0[2 * e + 1];
      steps = a.steps0[e];
    }
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t row = (size_t)t * a.E + e;
    if (owner) {
      const float o0 = cosf(th), o1 = sinf(th);
      x[0 * ET + tid] = o0;
      x[1 * ET + tid] = o1;
      x[2 * ET + tid] = thd;
      if (live) {
        a.obs[row * 3 + 0] = o0;
        a.obs[row * 3 + 1] = o1;
        a.obs[row * 3 + 2] = thd;
      }
    }
    __syncthreads();
    tile_forward(nets, P, 0, n_nets, x, bufs, outs, a.hmax, a.activation);

    if (owner) {
      // Box-Muller sampling; the stored action is the UNCLIPPED mu + eps*sigma
      float lp = a.lp0, u0 = 0.0f;
      for (int j = 0; j < a.act_dim; ++j) {
        const float ls = log_std[j];
        const float sigma = expf(ls);
        const float u1 = fmaxf(uniform01(a.s0, a.s1, t, 2 * j, lane), 1e-12f);
        const float u2 = uniform01(a.s0, a.s1, t, 2 * j + 1, lane);
        const float eps = sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI_F * u2);
        const float mu = outs[0][j * ET + tid];
        const float act = mu + eps * sigma;
        const float z = (act - mu) / sigma;
        lp = lp - ls - 0.5f * z * z;
        if (live) a.action[row * a.act_dim + j] = act;
        if (j == 0) u0 = act;
      }
      // pendulum physics (pallas_rollout._pendulum_lane.step)
      const float u = fminf(fmaxf(u0, -2.0f), 2.0f);
      const float v = th + PI_F;
      const float an = v - TWO_PI_F * floorf(v / TWO_PI_F) - PI_F;
      const float cost = an * an + 0.1f * thd * thd + 0.001f * u * u;
      const float thd2 =
          fminf(fmaxf(thd + (15.0f * sinf(th) + 3.0f * u) * 0.05f, -8.0f), 8.0f);
      const float th2 = th + thd2 * 0.05f;
      const float reward = -cost;
      const float steps2 = steps + 1.0f;
      const float trunc = fmaxf((steps2 >= HORIZON_F ? 1.0f : 0.0f), 0.0f);
      const float done = trunc;   // pendulum never terminates
      const float n0 = cosf(th2), n1 = sinf(th2);
      x[0 * ET + tid] = n0;
      x[1 * ET + tid] = n1;
      x[2 * ET + tid] = thd2;
      if (live) {
        a.log_prob[row] = lp;
        a.reward[row] = reward;
        a.terminated[row] = false;
        a.truncated[row] = trunc > 0.0f;
        a.next_obs[row * 3 + 0] = n0;
        a.next_obs[row * 3 + 1] = n1;
        a.next_obs[row * 3 + 2] = thd2;
        if (a.with_v) a.value[row] = outs[1][tid];
      }
      // completed-episode metrics
      const float racc2 = racc + reward;
      const float jacc2 = jacc + gpow * reward;
      mR += done * racc2;
      mJ += done * jacc2;
      mN += done;
      racc = (1.0f - done) * racc2;
      jacc = (1.0f - done) * jacc2;
      gpow = done > 0.0f ? 1.0f : gpow * a.gamma;
      // auto-reset with draws 50, 51 at step t
      const float fth = -PI_F + TWO_PI_F * uniform01(a.s0, a.s1, t, 50, lane);
      const float fthd = -1.0f + 2.0f * uniform01(a.s0, a.s1, t, 51, lane);
      th = done > 0.0f ? fth : th2;
      thd = done > 0.0f ? fthd : thd2;
      steps = done > 0.0f ? 0.0f : steps2;
    }
    __syncthreads();
    if (a.with_v) {
      tile_forward(nets, P, 1, 1, x, bufs, outs, a.hmax, a.activation);
      if (live) a.next_value[row] = outs[1][tid];
    }
  }
  if (live) {
    a.st_final[2 * e] = th;
    a.st_final[2 * e + 1] = thd;
    a.steps_final[e] = steps;
    a.metrics[e] = mR;
    a.metrics[a.E + e] = mJ;
    a.metrics[2 * a.E + e] = mN;
  }
}

__global__ void rng_bits_kernel(int32_t* out, int n, uint32_t s0, uint32_t s1,
                                uint32_t t, uint32_t draw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)rng_bits(s0, s1, t, draw, (uint32_t)i);
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_rollout.py mirrors it
// field for field as a ctypes.Structure.
struct RolloutArgs {
  const float* policy_params;
  const float* value_params;     // null: no V planes
  const float* log_std;
  const float* st0;              // null: fresh reset
  const float* steps0;
  const int* policy_dims;        // host arrays of n_layers + 1 widths
  const int* value_dims;
  int n_layers, act_dim, activation, T, E;
  uint32_t s0, s1;
  float gamma, lp0;
  float *obs, *next_obs, *action, *log_prob, *reward, *value, *next_value;
  bool *terminated, *truncated;
  float *st_final, *steps_final, *metrics;
};

extern "C" int ppoc_rollout_args_size() { return (int)sizeof(RolloutArgs); }

// Dynamic shared memory the rollout kernel needs, in bytes (or -1).
static long rollout_smem(const DevArgs& d) {
  const int n_nets = d.with_v ? 2 : 1;
  long floats = (long)d.net[0].dim[0] * ET;
  for (int n = 0; n < n_nets; ++n) {
    const Net& net = d.net[n];
    floats += net.n_params + 2L * d.hmax * ET + (long)net.dim[net.n_layers] * ET;
  }
  return floats * (long)sizeof(float);
}

extern "C" long ppoc_rollout_smem_bytes(const RolloutArgs* a) {
  DevArgs d{};
  if (!make_net(&d.net[0], a->n_layers, a->policy_dims)) return -1;
  d.with_v = a->value_params != nullptr;
  if (d.with_v && !make_net(&d.net[1], a->n_layers, a->value_dims)) return -1;
  d.hmax = 1;
  for (int n = 0; n < (d.with_v ? 2 : 1); ++n)
    for (int l = 1; l < a->n_layers; ++l)
      d.hmax = d.net[n].dim[l] > d.hmax ? d.net[n].dim[l] : d.hmax;
  return rollout_smem(d);
}

extern "C" int ppoc_rollout_pendulum(const RolloutArgs* a, cudaStream_t stream) {
  DevArgs d{};
  if (!make_net(&d.net[0], a->n_layers, a->policy_dims)) return cudaErrorInvalidValue;
  d.with_v = a->value_params != nullptr;
  if (d.with_v && !make_net(&d.net[1], a->n_layers, a->value_dims))
    return cudaErrorInvalidValue;
  if (a->act_dim < 1 || a->act_dim > MAX_ACT || d.net[0].dim[0] != 3)
    return cudaErrorInvalidValue;
  d.hmax = 1;
  for (int n = 0; n < (d.with_v ? 2 : 1); ++n)
    for (int l = 1; l < a->n_layers; ++l)
      d.hmax = d.net[n].dim[l] > d.hmax ? d.net[n].dim[l] : d.hmax;
  d.params[0] = a->policy_params;
  d.params[1] = a->value_params;
  d.log_std = a->log_std;
  d.fresh = a->st0 == nullptr;
  d.st0 = a->st0;
  d.steps0 = a->steps0;
  d.act_dim = a->act_dim;
  d.activation = a->activation;
  d.T = a->T;
  d.E = a->E;
  d.s0 = a->s0;
  d.s1 = a->s1;
  d.gamma = a->gamma;
  d.lp0 = a->lp0;
  d.obs = a->obs;
  d.next_obs = a->next_obs;
  d.action = a->action;
  d.log_prob = a->log_prob;
  d.reward = a->reward;
  d.value = a->value;
  d.next_value = a->next_value;
  d.terminated = a->terminated;
  d.truncated = a->truncated;
  d.st_final = a->st_final;
  d.steps_final = a->steps_final;
  d.metrics = a->metrics;

  const long smem = rollout_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      rollout_pendulum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a->E + ET - 1) / ET;
  rollout_pendulum_kernel<<<blocks, THREADS, smem, stream>>>(d);
  return cudaGetLastError();
}

extern "C" int ppoc_rng_bits(int32_t* out, int n, uint32_t s0, uint32_t s1,
                             uint32_t t, uint32_t draw, cudaStream_t stream) {
  rng_bits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(out, n, s0, s1, t, draw);
  return cudaGetLastError();
}

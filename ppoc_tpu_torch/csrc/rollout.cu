// K1: the whole T-step rollout as one kernel launch, for every env lane of
// the JAX package (pendulum, simple, cartpole, mountain_car,
// mountain_car_norm, acrobot, reacher).
//
// Replaces ppoc_tpu/ops/pallas_rollout.py `rollout_fused` -> `_kernel`
// (lanes `_pendulum_lane`, `_simple_lane`, `_cartpole_lane`,
// `_mountain_car_lane`, `_acrobot_lane`, `_reacher_lane`; RNG
// `_fmix32`/`_uniform01`).  Each step runs the policy MLP forward, samples
// (Box-Muller Gaussian for a continuous lane, Gumbel-max over the class
// logits with an exact log-softmax log-prob for a discrete one), steps the
// lane's physics, applies termination, horizon truncation and auto-reset,
// and optionally V(s) and V(s') from the value net or the completed-episode
// R/J sums.
//
// What bounds it on the card: the T steps are a serial chain, and one step
// is a few small dependent MLP layers (at the bench shape 64 envs through
// [3,128,128,1] nets: about 2 MFLOP per net per step).  So the kernel is
// latency-bound there: bytes and FLOPs are far below the card's rates.  At
// reacher's throughput shape (4096 envs through [10,256,256,2] and
// [10,256,256,1] nets, V(s) and V(s') each step) a step is ~410 KFLOP per
// env, 252 GFLOP in all over 150 steps: FP32 operations bound it (~3.8 ms).
//
// What the design does about it: the T loop runs inside the kernel (one
// launch per rollout, as on the TPU) and each block owns a tile of ET envs
// whose state lives in registers.  A layer is one pass of the block: one
// thread per (net, output unit), ET accumulators each, so the policy
// forward and V(s) run side by side.  Blocks are independent (one per env
// tile).  Two variants of one template, picked by size at the launch:
//   * small nets (the bench's 2 x 17,153 floats, 137 KB) sit in dynamic
//     shared memory for the whole rollout; ET = 8 envs a block, 256
//     threads;
//   * nets larger than one block's shared memory (reacher's two 2x256 nets,
//     ~137 K floats, 550 KB) stay in global memory, where they remain
//     resident in the 50 MB L2, and are read with __ldg, four input rows
//     in flight per thread; ET = 32 envs a block, so each weight read
//     serves 32 envs (read from shared memory as float4s), and 512
//     threads, one per (net, unit) of a 2x256 layer.  Only the
//     activations of the tile sit in shared memory.
// Both sum each unit's products in input order, so for the same nets the
// two variants give the same bits.
//
// A lane is a struct (`PendulumLane`, `SimpleLane`, `CartPoleLane`,
// `MountainCarLane<norm>`, `AcrobotLane`, `ReacherLane`) with its state and
// obs widths D and O, its class count K (0: continuous), its horizon and
// `reset`, `obs`, `step`; the kernel is a template over it.  Every lane but
// pendulum multiplies with __fmul_rn, which the compiler never fuses into
// an FMA, so each operation rounds as PyTorch's elementwise kernels round
// it and the plain version on the card follows the same trajectory bit for
// bit while the two draw the same actions (MountainCar's goal test and
// left wall, and reacher's distance, flip on one ulp).
#include "common.cuh"

using namespace ppoc;

namespace {

// the two variants: envs per block and threads per block
constexpr int ET = 8;            // nets in shared memory
constexpr int THREADS = 256;     // >= 2 x the widest hidden layer works best
constexpr int ET_L = 32;         // nets in global memory (a multiple of 4)
constexpr int THREADS_L = 512;

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t T_INIT = 0xFFFF0000u;   // the step counter of the entry reset
// the Gumbel draws' clip [1e-12, 1 - 1e-7], as float32 rounds the bounds
constexpr float U_LO = 1e-12f;
constexpr float U_HI = 0.99999988f;

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

// A reset's uniforms: draw 50 + j at step t for state row j.
struct ResetDraws {
  uint32_t s0, s1, t, lane;
  __device__ float operator()(int j) const {
    return uniform01(s0, s1, t, 50u + (uint32_t)j, lane);
  }
};

// Gumbel-max over K logits with the log-softmax log-prob of the pick
// (pallas_rollout.py `_kernel`, discrete branch): u_k = clip(U(t, k)),
// y_k = h_k - log(-log u_k), the strict > keeps the lower index on a tie,
// log_prob = h_a - (zmax + log sum_k exp(h_k - zmax)).
__device__ __forceinline__ int gumbel_max(const float* h, int K, uint32_t s0,
                                          uint32_t s1, uint32_t t,
                                          uint32_t lane, float* log_prob) {
  float zmax = h[0];
  for (int k = 1; k < K; ++k) zmax = fmaxf(zmax, h[k]);
  float sum = 0.0f;
  for (int k = 0; k < K; ++k) sum = sum + expf(h[k] - zmax);
  const float lse = zmax + logf(sum);
  float best = 0.0f;
  int idx = 0;
  for (int k = 0; k < K; ++k) {
    const float u = fminf(fmaxf(uniform01(s0, s1, t, (uint32_t)k, lane), U_LO),
                          U_HI);
    const float y = h[k] - logf(-logf(u));
    if (k == 0 || y > best) {
      best = y;
      idx = k;
    }
  }
  *log_prob = h[idx] - lse;
  return idx;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// --- lanes (pallas_rollout.LANE_ENVS) ------------------------------------

struct PendulumLane {
  static constexpr int D = 2, O = 3, K = 0;
  static constexpr float HORIZON = 200.0f;
  template <class R>
  __device__ static void reset(float* s, R rand) {
    s[0] = -PI_F + TWO_PI_F * rand(0);
    s[1] = -1.0f + 2.0f * rand(1);
  }
  __device__ static void obs(const float* s, float* o) {
    o[0] = cosf(s[0]);
    o[1] = sinf(s[0]);
    o[2] = s[1];
  }
  // act[0]: the UNCLIPPED sampled torque
  __device__ static void step(const float* s, const float* act, float* s2,
                              float* reward, float* term) {
    const float th = s[0], thd = s[1];
    const float u = fminf(fmaxf(act[0], -2.0f), 2.0f);
    const float v = th + PI_F;
    const float an = v - TWO_PI_F * floorf(v / TWO_PI_F) - PI_F;
    const float cost = an * an + 0.1f * thd * thd + 0.001f * u * u;
    const float thd2 =
        fminf(fmaxf(thd + (15.0f * sinf(th) + 3.0f * u) * 0.05f, -8.0f), 8.0f);
    s2[0] = th + thd2 * 0.05f;
    s2[1] = thd2;
    *reward = -cost;
    *term = 0.0f;   // pendulum never terminates
  }
};

struct CartPoleLane {
  static constexpr int D = 4, O = 4, K = 2;
  static constexpr float HORIZON = 500.0f;
  template <class R>
  __device__ static void reset(float* s, R rand) {
#pragma unroll
    for (int j = 0; j < D; ++j) s[j] = -0.05f + mul(0.1f, rand(j));
  }
  __device__ static void obs(const float* s, float* o) {
#pragma unroll
    for (int j = 0; j < D; ++j) o[j] = s[j];
  }
  // act[0]: the class id as a float (1: push right)
  __device__ static void step(const float* s, const float* act, float* s2,
                              float* reward, float* term) {
    const float x = s[0], xd = s[1], th = s[2], thd = s[3];
    const float force = act[0] > 0.5f ? 10.0f : -10.0f;
    const float c = cosf(th), si = sinf(th);
    // POLEMASS_LENGTH 0.05, TOTAL_MASS 1.1, LENGTH 0.5, MASSPOLE 0.1
    const float temp = (force + mul(mul(mul(0.05f, thd), thd), si)) / 1.1f;
    const float th_acc = (mul(9.8f, si) - mul(c, temp)) /
                         mul(0.5f, 1.3333334f - mul(mul(0.1f, c), c) / 1.1f);
    const float x_acc = temp - mul(mul(0.05f, th_acc), c) / 1.1f;
    s2[0] = x + mul(0.02f, xd);
    s2[1] = xd + mul(0.02f, x_acc);
    s2[2] = th + mul(0.02f, thd);
    s2[3] = thd + mul(0.02f, th_acc);
    // THETA_THRESHOLD 12 * 2 pi / 360 as float32
    const bool out = fabsf(s2[0]) > 2.4f || fabsf(s2[2]) > 0.20943952f;
    *reward = 1.0f;
    *term = out ? 1.0f : 0.0f;
  }
};

struct AcrobotLane {
  static constexpr int D = 4, O = 6, K = 3;
  static constexpr float HORIZON = 500.0f;
  template <class R>
  __device__ static void reset(float* s, R rand) {
#pragma unroll
    for (int j = 0; j < D; ++j) s[j] = -0.1f + mul(0.2f, rand(j));
  }
  __device__ static void obs(const float* s, float* o) {
    o[0] = cosf(s[0]);
    o[1] = sinf(s[0]);
    o[2] = cosf(s[1]);
    o[3] = sinf(s[1]);
    o[4] = s[2];
    o[5] = s[3];
  }
  // Book-convention dynamics with unit masses and link lengths, centres of
  // mass at 0.5, unit inertias, g = 9.8; every product of Python constants
  // is rounded to float32 once, as the JAX lane's are.
  __device__ static void dsdt(const float* y, float torque, float* dy) {
    const float th1 = y[0], th2 = y[1], d1_ = y[2], d2_ = y[3];
    const float c2 = cosf(th2), s2 = sinf(th2);
    const float d1 = 0.25f + (1.25f + c2) + 1.0f + 1.0f;
    const float d2 = 0.25f + mul(0.5f, c2) + 1.0f;
    const float phi2 = mul(4.9f, cosf(th1 + th2 - 1.5707964f));
    const float phi1 = mul(mul(-0.5f, mul(d2_, d2_)), s2) -
                       mul(mul(d2_, d1_), s2) +
                       mul(14.7f, cosf(th1 - 1.5707964f)) + phi2;
    const float dd2 =
        (torque + mul(d2 / d1, phi1) - mul(mul(0.5f, mul(d1_, d1_)), s2) -
         phi2) /
        (1.25f - mul(d2, d2) / d1);
    const float dd1 = -(mul(d2, dd2) + phi1) / d1;
    dy[0] = d1_;
    dy[1] = d2_;
    dy[2] = dd1;
    dy[3] = dd2;
  }
  __device__ static float wrap(float x) {
    const float v = x + PI_F;
    return v - mul(TWO_PI_F, floorf(v / TWO_PI_F)) - PI_F;
  }
  // act[0]: the class id as a float; the torque is act - 1
  __device__ static void step(const float* s, const float* act, float* s2,
                              float* reward, float* term) {
    const float torque = act[0] - 1.0f;
    float k1[4], k2[4], k3[4], k4[4], y[4];
    dsdt(s, torque, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = s[j] + mul(0.1f, k1[j]);
    dsdt(y, torque, k2);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = s[j] + mul(0.1f, k2[j]);
    dsdt(y, torque, k3);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = s[j] + mul(0.2f, k3[j]);
    dsdt(y, torque, k4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s2[j] = s[j] + mul(0.033333335f, k1[j] + mul(2.0f, k2[j]) +
                                           mul(2.0f, k3[j]) + k4[j]);
    s2[0] = wrap(s2[0]);
    s2[1] = wrap(s2[1]);
    s2[2] = fminf(fmaxf(s2[2], -12.566371f), 12.566371f);   // 4 pi
    s2[3] = fminf(fmaxf(s2[3], -28.274334f), 28.274334f);   // 9 pi
    const bool up = -cosf(s2[0]) - cosf(s2[1] + s2[0]) > 1.0f;
    *term = up ? 1.0f : 0.0f;
    *reward = *term - 1.0f;
  }
};

struct SimpleLane {
  static constexpr int D = 1, O = 1, K = 0;
  static constexpr float HORIZON = 15.0f;
  template <class R>
  __device__ static void reset(float* s, R) {
    s[0] = 0.0f;
  }
  __device__ static void obs(const float* s, float* o) { o[0] = s[0]; }
  __device__ static void step(const float* s, const float* act, float* s2,
                              float* reward, float* term) {
    const float x = s[0] + fminf(fmaxf(act[0], -1.0f), 1.0f);
    s2[0] = x;
    *term = x >= 5.0f ? 1.0f : 0.0f;
    *reward = *term;   // reward 1 iff terminated
  }
};

// MountainCarContinuous; NORM maps the obs to [-1, 1] with the JAX lane's
// Python-float mid and half-width (-0.3 and 0.9 as float32), which the
// normalize_obs wrapper's float32 arrays differ from in the last bit.
template <bool NORM>
struct MountainCarLane {
  static constexpr int D = 2, O = 2, K = 0;
  static constexpr float HORIZON = 999.0f;
  template <class R>
  __device__ static void reset(float* s, R rand) {
    s[0] = -0.6f + mul(0.2f, rand(0));
    s[1] = 0.0f;
  }
  __device__ static void obs(const float* s, float* o) {
    if (NORM) {
      o[0] = (s[0] - -0.3f) / 0.9f;
      o[1] = s[1] / 0.07f;
    } else {
      o[0] = s[0];
      o[1] = s[1];
    }
  }
  // act[0]: the UNCLIPPED sampled force; the reward penalises it raw
  __device__ static void step(const float* s, const float* act, float* s2,
                              float* reward, float* term) {
    const float pos = s[0], vel = s[1];
    const float force = fminf(fmaxf(act[0], -1.0f), 1.0f);
    float vel2 = vel + mul(force, 0.0015f) - mul(0.0025f, cosf(mul(3.0f, pos)));
    vel2 = fminf(fmaxf(vel2, -0.07f), 0.07f);
    const float pos2 = fminf(fmaxf(pos + vel2, -1.2f), 0.6f);
    if (pos2 <= -1.2f && vel2 < 0.0f) vel2 = 0.0f;   // the left wall
    s2[0] = pos2;
    s2[1] = vel2;
    *term = pos2 >= 0.45f && vel2 >= 0.0f ? 1.0f : 0.0f;
    *reward = mul(*term, 100.0f) - mul(mul(0.1f, act[0]), act[0]);
  }
};

// Two-link reacher: state q1, q2, qd1, qd2, target x, y; links 0.5 long.
struct ReacherLane {
  static constexpr int D = 6, O = 10, K = 0;
  static constexpr float HORIZON = 150.0f;
  __device__ static void tip(float q1, float q2, float* x, float* y) {
    const float q12 = q1 + q2;
    *x = mul(0.5f, cosf(q1)) + mul(0.5f, cosf(q12));
    *y = mul(0.5f, sinf(q1)) + mul(0.5f, sinf(q12));
  }
  template <class R>
  __device__ static void reset(float* s, R rand) {
    s[0] = -PI_F + mul(TWO_PI_F, rand(0));
    s[1] = -PI_F + mul(TWO_PI_F, rand(1));
    const float radius = 0.1f + mul(0.8f, rand(2));   // 0.9 (L1 + L2) - 0.1
    const float angle = -PI_F + mul(TWO_PI_F, rand(3));
    s[2] = 0.0f;
    s[3] = 0.0f;
    s[4] = mul(radius, cosf(angle));
    s[5] = mul(radius, sinf(angle));
  }
  __device__ static void obs(const float* s, float* o) {
    float x, y;
    tip(s[0], s[1], &x, &y);
    o[0] = cosf(s[0]);
    o[1] = cosf(s[1]);
    o[2] = sinf(s[0]);
    o[3] = sinf(s[1]);
    o[4] = s[2] / 4.0f;
    o[5] = s[3] / 4.0f;
    o[6] = s[4];
    o[7] = s[5];
    o[8] = x - s[4];
    o[9] = y - s[5];
  }
  // act[0], act[1]: the UNCLIPPED sampled torques
  __device__ static void step(const float* s, const float* act, float* s2,
                              float* reward, float* term) {
    const float u1 = fminf(fmaxf(act[0], -1.0f), 1.0f);
    const float u2 = fminf(fmaxf(act[1], -1.0f), 1.0f);
    const float qd1 = fminf(
        fmaxf(s[2] + mul(mul(8.0f, u1) - mul(0.5f, s[2]), 0.05f), -4.0f), 4.0f);
    const float qd2 = fminf(
        fmaxf(s[3] + mul(mul(8.0f, u2) - mul(0.5f, s[3]), 0.05f), -4.0f), 4.0f);
    s2[0] = s[0] + mul(qd1, 0.05f);
    s2[1] = s[1] + mul(qd2, 0.05f);
    s2[2] = qd1;
    s2[3] = qd2;
    s2[4] = s[4];
    s2[5] = s[5];
    float x, y;
    tip(s2[0], s2[1], &x, &y);
    const float dx = x - s[4], dy = y - s[5];
    const float dist = sqrtf(mul(dx, dx) + mul(dy, dy));
    *reward = -dist - mul(0.01f, mul(u1, u1) + mul(u2, u2));
    *term = 0.0f;   // reacher only truncates
  }
};

struct DevArgs {
  Net net[2];                 // [0] policy, [1] value
  const float* params[2];
  const float* log_std;
  const float* st0;           // [E, D] carried lane state
  const float* steps0;        // [E]
  int fresh, with_v, act_dim, activation, T, E, hmax;
  uint32_t s0, s1;
  float gamma, lp0;
  float *obs, *next_obs, *action, *log_prob, *reward, *value, *next_value;
  int32_t* action_idx;        // discrete lanes: [T, E] class ids
  bool *terminated, *truncated;
  float *st_final, *steps_final, *metrics;
};

// Forward nets [first, first+count) over the block's env tile of ET_
// envs: `in` is smem [d0][ET_]; net n reads its weights from P[n] (shared
// memory, or global memory with GLOBAL_W), ping-pongs its hidden layers
// through bufs[n] and writes its output to outs[n] (smem [d_L][ET_]).  The
// nets have equal depth.  Each unit sums its products in input order.
// Ends with __syncthreads.
template <int ET_, bool GLOBAL_W>
__device__ void tile_forward(const Net* nets, const float* const* P,
                             int first, int count, const float* in,
                             float* const* bufs, float* const* outs, int hmax,
                             int act) {
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
      const float* src = l == 0 ? in : bufs[n] + ((l - 1) & 1) * hmax * ET_;
      float acc[ET_];
#pragma unroll
      for (int e = 0; e < ET_; ++e) acc[e] = 0.0f;
      float b;
      if constexpr (GLOBAL_W) {
        // four weight loads in flight before their FMAs; the tile's inputs
        // read as float4 (each row of ET_ floats is 16-byte aligned)
        int k = 0;
        for (; k + 4 <= din; k += 4) {
          float w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = __ldg(W + (k + u) * dout + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4* s4 =
                reinterpret_cast<const float4*>(src + (k + u) * ET_);
#pragma unroll
            for (int e = 0; e < ET_ / 4; ++e) {
              const float4 v = s4[e];
              acc[4 * e] += v.x * w[u];
              acc[4 * e + 1] += v.y * w[u];
              acc[4 * e + 2] += v.z * w[u];
              acc[4 * e + 3] += v.w * w[u];
            }
          }
        }
        for (; k < din; ++k) {
          const float w = __ldg(W + k * dout + j);
#pragma unroll
          for (int e = 0; e < ET_; ++e) acc[e] += src[k * ET_ + e] * w;
        }
        b = __ldg(P[n] + net.b_off[l] + j);
      } else {
        for (int k = 0; k < din; ++k) {
          const float w = W[k * dout + j];
#pragma unroll
          for (int e = 0; e < ET_; ++e) acc[e] += src[k * ET_ + e] * w;
        }
        b = P[n][net.b_off[l] + j];
      }
      float* dst = l == L - 1 ? outs[n] : bufs[n] + (l & 1) * hmax * ET_;
#pragma unroll
      for (int e = 0; e < ET_; ++e) {
        float h = acc[e] + b;
        if (l < L - 1) h = act_fwd(h, act);
        dst[j * ET_ + e] = h;
      }
    }
    __syncthreads();
  }
}

// One block runs ET_ envs for all T steps.  GLOBAL_W: the nets stay in
// global memory; else they are copied into dynamic shared memory first.
template <class Lane, int ET_, bool GLOBAL_W>
__global__ void __launch_bounds__(GLOBAL_W ? THREADS_L : THREADS)
    rollout_kernel(const DevArgs a) {
  constexpr int D = Lane::D, O = Lane::O;
  extern __shared__ __align__(16) float smem[];
  __shared__ Net nets[2];
  __shared__ float log_std[MAX_ACT];

  const int tid = threadIdx.x;
  const int n_nets = a.with_v ? 2 : 1;
  if (tid < 2) nets[tid] = a.net[tid];
  if (Lane::K == 0 && tid < a.act_dim) log_std[tid] = a.log_std[tid];

  // shared memory: params of each net (unless GLOBAL_W), input tile,
  // per-net ping-pong hidden buffers, per-net output tile
  const float* P[2] = {a.params[0], a.params[1]};
  float* bufs[2];
  float* outs[2];
  float* p = smem;
  if (!GLOBAL_W) {
    for (int n = 0; n < n_nets; ++n) {
      for (int i = tid; i < a.net[n].n_params; i += blockDim.x)
        p[i] = a.params[n][i];
      P[n] = p;
      p += a.net[n].n_params;
    }
  }
  float* x = p;                          p += a.net[0].dim[0] * ET_;
  for (int n = 0; n < n_nets; ++n) { bufs[n] = p; p += 2 * a.hmax * ET_; }
  for (int n = 0; n < n_nets; ++n) {
    outs[n] = p;
    p += a.net[n].dim[a.net[n].n_layers] * ET_;
  }

  // env state: thread tid < ET_ owns env e of this block's tile
  const int e = blockIdx.x * ET_ + tid;
  const bool owner = tid < ET_;
  const bool live = owner && e < a.E;
  const uint32_t lane = (uint32_t)e;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.0f;
  float steps = 0.0f;
  float racc = 0.0f, jacc = 0.0f, gpow = 1.0f, mR = 0.0f, mJ = 0.0f, mN = 0.0f;
  if (live) {
    if (a.fresh) {
      Lane::reset(s, ResetDraws{a.s0, a.s1, T_INIT, lane});
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = a.st0[(size_t)e * D + d];
      steps = a.steps0[e];
    }
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t row = (size_t)t * a.E + e;
    if (owner) {
      float o[O];
      Lane::obs(s, o);
#pragma unroll
      for (int d = 0; d < O; ++d) {
        x[d * ET_ + tid] = o[d];
        if (live) a.obs[row * O + d] = o[d];
      }
    }
    __syncthreads();
    tile_forward<ET_, GLOBAL_W>(nets, P, 0, n_nets, x, bufs, outs, a.hmax,
                                 a.activation);

    if (owner) {
      float act[MAX_ACT];
      float lp;
      if constexpr (Lane::K > 0) {
        float h[Lane::K];
#pragma unroll
        for (int k = 0; k < Lane::K; ++k) h[k] = outs[0][k * ET_ + tid];
        const int idx = gumbel_max(h, Lane::K, a.s0, a.s1, (uint32_t)t, lane,
                                   &lp);
        act[0] = (float)idx;
        if (live) a.action_idx[row] = idx;
      } else {
        // Box-Muller sampling; the stored action is the UNCLIPPED mu + eps*sigma
        lp = a.lp0;
        for (int j = 0; j < a.act_dim; ++j) {
          const float ls = log_std[j];
          const float sigma = expf(ls);
          const float u1 = fmaxf(uniform01(a.s0, a.s1, t, 2 * j, lane), 1e-12f);
          const float u2 = uniform01(a.s0, a.s1, t, 2 * j + 1, lane);
          const float eps = sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI_F * u2);
          const float mu = outs[0][j * ET_ + tid];
          const float ac = mu + eps * sigma;
          const float z = (ac - mu) / sigma;
          lp = lp - ls - 0.5f * z * z;
          if (live) a.action[row * a.act_dim + j] = ac;
          act[j] = ac;
        }
      }
      float s2[D], reward, term;
      Lane::step(s, act, s2, &reward, &term);
      const float steps2 = steps + 1.0f;
      const float trunc =
          fmaxf((steps2 >= Lane::HORIZON ? 1.0f : 0.0f) - term, 0.0f);
      const float done = fmaxf(term, trunc);
      float no[O];
      Lane::obs(s2, no);
#pragma unroll
      for (int d = 0; d < O; ++d) x[d * ET_ + tid] = no[d];
      if (live) {
        a.log_prob[row] = lp;
        a.reward[row] = reward;
        a.terminated[row] = term > 0.0f;
        a.truncated[row] = trunc > 0.0f;
#pragma unroll
        for (int d = 0; d < O; ++d) a.next_obs[row * O + d] = no[d];
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
      // auto-reset with draws 50 + j at step t
      float fresh[D];
      Lane::reset(fresh, ResetDraws{a.s0, a.s1, (uint32_t)t, lane});
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = done > 0.0f ? fresh[d] : s2[d];
      steps = done > 0.0f ? 0.0f : steps2;
    }
    __syncthreads();
    if (a.with_v) {
      tile_forward<ET_, GLOBAL_W>(nets, P, 1, 1, x, bufs, outs, a.hmax,
                                   a.activation);
      if (live) a.next_value[row] = outs[1][tid];
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) a.st_final[(size_t)e * D + d] = s[d];
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

// The rollout's sampler alone, on given logits [n, K] at step t for lanes
// 0..n-1: writes the class ids and log-probs.
__global__ void gumbel_max_kernel(const float* logits, int n, int K,
                                  uint32_t s0, uint32_t s1, uint32_t t,
                                  int32_t* idx, float* log_prob) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float h[MAX_ACT];
  for (int k = 0; k < K; ++k) h[k] = logits[(size_t)i * K + k];
  idx[i] = gumbel_max(h, K, s0, s1, t, (uint32_t)i, &log_prob[i]);
}

template <class Lane, int ET_, bool GLOBAL_W>
cudaError_t launch(const DevArgs& d, long smem, cudaStream_t stream) {
  auto kernel = rollout_kernel<Lane, ET_, GLOBAL_W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(d.E + ET_ - 1) / ET_, GLOBAL_W ? THREADS_L : THREADS, smem,
           stream>>>(d);
  return cudaGetLastError();
}

// Calls f(Lane{}) for the lane with code `lane` (RolloutArgs::lane);
// returns cudaErrorInvalidValue for an unknown code.
template <class F>
cudaError_t with_lane(int lane, F f) {
  switch (lane) {
    case 0: return f(PendulumLane{});
    case 1: return f(CartPoleLane{});
    case 2: return f(AcrobotLane{});
    case 3: return f(SimpleLane{});
    case 4: return f(MountainCarLane<false>{});
    case 5: return f(MountainCarLane<true>{});
    case 6: return f(ReacherLane{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_rollout.py mirrors it
// field for field as a ctypes.Structure.
struct RolloutArgs {
  const float* policy_params;
  const float* value_params;     // null: no V planes
  const float* log_std;          // continuous lanes only
  const float* st0;              // null: fresh reset; else [E, D]
  const float* steps0;
  const int* policy_dims;        // host arrays of n_layers + 1 widths
  const int* value_dims;
  int lane;     // 0 pendulum, 1 cartpole, 2 acrobot, 3 simple,
                // 4 mountain_car, 5 mountain_car_norm, 6 reacher
  int variant;  // 0: nets in shared memory, 1: nets in global memory
  int n_layers, act_dim, activation, T, E;
  uint32_t s0, s1;
  float gamma, lp0;
  float *obs, *next_obs, *action, *log_prob, *reward, *value, *next_value;
  int32_t* action_idx;
  bool *terminated, *truncated;
  float *st_final, *steps_final, *metrics;
};

extern "C" int ppoc_rollout_args_size() { return (int)sizeof(RolloutArgs); }

// Dynamic shared memory the rollout kernel needs in `variant`, in bytes.
static long rollout_smem(const DevArgs& d, int variant) {
  const long et = variant == 0 ? ET : ET_L;
  const int n_nets = d.with_v ? 2 : 1;
  long floats = (long)d.net[0].dim[0] * et;
  for (int n = 0; n < n_nets; ++n) {
    const Net& net = d.net[n];
    floats += 2L * d.hmax * et + (long)net.dim[net.n_layers] * et;
    if (variant == 0) floats += net.n_params;
  }
  return floats * (long)sizeof(float);
}

// Fills the nets of `d` from `a`; false for a shape the kernel refuses.
static bool make_nets(DevArgs* d, const RolloutArgs* a) {
  if (!make_net(&d->net[0], a->n_layers, a->policy_dims)) return false;
  d->with_v = a->value_params != nullptr;
  if (d->with_v && !make_net(&d->net[1], a->n_layers, a->value_dims))
    return false;
  d->hmax = 1;
  for (int n = 0; n < (d->with_v ? 2 : 1); ++n)
    for (int l = 1; l < a->n_layers; ++l)
      d->hmax = d->net[n].dim[l] > d->hmax ? d->net[n].dim[l] : d->hmax;
  return true;
}

// Dynamic shared memory of the launch in `variant` (0 or 1), or -1 for
// nets the kernel refuses.
extern "C" long ppoc_rollout_smem_bytes(const RolloutArgs* a, int variant) {
  DevArgs d{};
  if (!make_nets(&d, a) || variant < 0 || variant > 1) return -1;
  return rollout_smem(d, variant);
}

extern "C" int ppoc_rollout(const RolloutArgs* a, cudaStream_t stream) {
  DevArgs d{};
  if (!make_nets(&d, a) || a->variant < 0 || a->variant > 1)
    return cudaErrorInvalidValue;
  const int n_out = d.net[0].dim[a->n_layers];
  const cudaError_t shape = with_lane(a->lane, [&](auto lane) {
    using Lane = decltype(lane);
    const int out = Lane::K > 0 ? Lane::K : a->act_dim;
    const bool ok = d.net[0].dim[0] == Lane::O && a->act_dim >= 1 &&
                    a->act_dim <= MAX_ACT && out == a->act_dim &&
                    n_out == out;
    return ok ? cudaSuccess : cudaErrorInvalidValue;
  });
  if (shape != cudaSuccess) return shape;
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
  d.action_idx = a->action_idx;
  d.log_prob = a->log_prob;
  d.reward = a->reward;
  d.value = a->value;
  d.next_value = a->next_value;
  d.terminated = a->terminated;
  d.truncated = a->truncated;
  d.st_final = a->st_final;
  d.steps_final = a->steps_final;
  d.metrics = a->metrics;

  const long smem = rollout_smem(d, a->variant);
  return with_lane(a->lane, [&](auto lane) {
    using Lane = decltype(lane);
    return a->variant == 0 ? launch<Lane, ET, false>(d, smem, stream)
                           : launch<Lane, ET_L, true>(d, smem, stream);
  });
}

extern "C" int ppoc_rng_bits(int32_t* out, int n, uint32_t s0, uint32_t s1,
                             uint32_t t, uint32_t draw, cudaStream_t stream) {
  rng_bits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(out, n, s0, s1, t, draw);
  return cudaGetLastError();
}

extern "C" int ppoc_gumbel_max(const float* logits, int n, int K, uint32_t s0,
                               uint32_t s1, uint32_t t, int32_t* idx,
                               float* log_prob, cudaStream_t stream) {
  if (K < 1 || K > MAX_ACT) return cudaErrorInvalidValue;
  gumbel_max_kernel<<<(n + 255) / 256, 256, 0, stream>>>(logits, n, K, s0, s1,
                                                         t, idx, log_prob);
  return cudaGetLastError();
}

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
// [10,256,256,1] nets) a step is ~270 KFLOP per env, 167 GFLOP in all over
// 150 steps: FP32 operations bound it (~2.5 ms).
//
// What the design does about it: the T loop runs inside the kernel (one
// launch per rollout, as on the TPU) and each block owns a tile of ET envs
// whose state lives in registers.  Blocks are independent, and each runs
// all T steps, so the launch picks the smallest ET in {1, 2, 4, 8} whose
// grid the card holds at once (cuda_rollout.tile_for): 64 envs take 64
// one-env blocks, not 8 eight-env ones, and a step's chain is as short as
// the products allow.  A layer pass is split-K: unit j's input sum is cut
// into S parts (layer_split, from the layer's widths alone), held by S
// neighbouring lanes of one warp, part p summing inputs p, p + S, ... in
// order with fused multiply-adds (four weights loaded ahead of their
// products), the S partials added in a butterfly of
// shuffles (lane xor 1, 2, ..., S / 2).  Hidden layers take S <= 4; an
// output layer of 1 or 2 units spreads over a whole warp each, where one
// thread summed 128 inputs while the block waited.  Each env's sums are
// thus the same bits at any tile and in either variant.  V(s') is the next
// step's V(s) wherever step t is not done (the same net on the same obs
// bits), so the value net's third pass runs only at a step where an env
// of the tile is done, and at the last step.  512 threads a block.  Two
// variants of one template, picked by size at the launch:
//   * small nets (the bench's 2 x 17,153 floats, 137 KB) sit in dynamic
//     shared memory for the whole rollout, sized for the largest tile; a
//     layer's weights are stored with each row's columns rotated by
//     (k mod S) * 32 / S, so the S lanes of a unit, reading S rows of one
//     column, hit 32 distinct banks;
//   * nets larger than one block's shared memory (reacher's two 2x256 nets,
//     ~137 K floats, 550 KB) stay in global memory, where they remain
//     resident in the 50 MB L2, and are read with __ldg; ET = 32 envs a
//     block, so each weight read serves 32 envs, read from shared memory
//     as float4s from rows whose 4-env
//     chunks are rotated by the row (conflict-free across the S rows a
//     warp reads).  Only the activations of the tile sit in shared memory.
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

constexpr int THREADS = 512;     // both variants: 16 warps
constexpr int ET_MAX = 8;        // nets in shared memory: tiles 1, 2, 4, 8
constexpr int ET_L = 32;         // nets in global memory (a multiple of 4)

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
  int vnext_all;              // 1: the V(s') pass at every step (tests)
  uint32_t s0, s1;
  float gamma, lp0;
  float *obs, *next_obs, *action, *log_prob, *reward, *value, *next_value;
  int32_t* action_idx;        // discrete lanes: [T, E] class ids
  bool *terminated, *truncated;
  float *st_final, *steps_final, *metrics;
};

// How many parts S a unit's input sum is split into, for a layer of din
// inputs and dout units: a power of two, from the widths alone, so an env's
// sums are the same bits at any tile, block size and variant.  Wide layers
// (dout >= 32) take at most 4 parts of at least 32 inputs (the units fill
// the warps already); narrow ones, the output layers, up to 32 parts of at
// least 4 inputs, so a unit spreads over a warp.  ppoc_rollout_layer_split
// exposes it to the tests.
__host__ __device__ __forceinline__ int layer_split(int din, int dout) {
  const int per = dout < 32 ? 4 : 32;
  const int cap = dout < 32 ? 32 : 4;
  int s = 1;
  while (2 * s <= cap && 2 * s * per <= din) s *= 2;
  return s;
}

// Where env e of activation row r sits in a tile of ET_ envs a row: rows of
// ET_ floats; past 8 envs the row's 4-env chunks are rotated by the row, so
// the S consecutive rows that one warp's lanes read land in distinct banks.
template <int ET_>
__device__ __forceinline__ int at(int r, int e) {
  if constexpr (ET_ > ET_MAX)
    return r * ET_ + ((((e >> 2) + r) & (ET_ / 4 - 1)) << 2) + (e & 3);
  else
    return r * ET_ + e;
}

// acc[e] += x[row k][e] * w for the tile's ET_ envs, as fused multiply-adds.
template <int ET_>
__device__ __forceinline__ void fma_row(float* acc, const float* x, int k,
                                        float w) {
  if constexpr (ET_ >= 4) {
#pragma unroll
    for (int c = 0; c < ET_ / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(x + at<ET_>(k, 4 * c));
      acc[4 * c] = __fmaf_rn(v.x, w, acc[4 * c]);
      acc[4 * c + 1] = __fmaf_rn(v.y, w, acc[4 * c + 1]);
      acc[4 * c + 2] = __fmaf_rn(v.z, w, acc[4 * c + 2]);
      acc[4 * c + 3] = __fmaf_rn(v.w, w, acc[4 * c + 3]);
    }
  } else if constexpr (ET_ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(x + 2 * k);
    acc[0] = __fmaf_rn(v.x, w, acc[0]);
    acc[1] = __fmaf_rn(v.y, w, acc[1]);
  } else {
    acc[0] = __fmaf_rn(x[k], w, acc[0]);
  }
}

// Float offsets into the dynamic shared memory `smem`, sized for a tile of
// EC envs a row (ET_MAX, or ET_L in the global-memory variant): the obs
// tile, per net two ping-pong hidden tiles and the output tile, then
// (nets in shared memory) each net's parameters.
struct Layout {
  int x, buf[2], out[2], par[2], pitch;   // pitch: hmax * EC
};

extern __shared__ __align__(16) float smem[];

// One layer l of nets [first, first + count) over the block's tile of ET_
// envs, into the next hidden tile or the output tile.  The units' slots
// (dout x S parts per net, each net's padded to whole warps) are dealt to
// the warps 32 at a time; lane (u, p) of a slot group sums part p of unit
// u.  Ends with __syncthreads.
template <int ET_, bool GLOBAL_W>
__device__ __forceinline__ void layer_pass(const Net* nets, const float* gp0,
                                        const float* gp1, const Layout L,
                                        int first, int count, int l,
                                        int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int last = nets[first].n_layers - 1;
  int chunks0 = 0, total = 0;
  for (int n = first; n < first + count; ++n) {
    const int s = layer_split(nets[n].dim[l], nets[n].dim[l + 1]);
    const int c = (nets[n].dim[l + 1] * s + 31) >> 5;
    if (n == first) chunks0 = c;
    total += c;
  }
  for (int c = warp; c < total; c += n_warps) {
    const int n = c < chunks0 ? first : first + 1;
    const Net& net = nets[n];
    const int din = net.dim[l], dout = net.dim[l + 1];
    const int S = layer_split(din, dout), sh = __ffs(S) - 1;
    const int slot = ((c < chunks0 ? c : c - chunks0) << 5) + lane;
    const int unit = slot >> sh, part = slot & (S - 1);
    const bool valid = unit < dout;
    const float* x =
        smem + (l == 0 ? L.x : L.buf[n] + ((l - 1) & 1) * L.pitch);
    float acc[ET_];
#pragma unroll
    for (int e = 0; e < ET_; ++e) acc[e] = 0.0f;
    float b = 0.0f;
    if (valid) {
      // four weights in flight, then their products in input order
      const float* W;
      if constexpr (GLOBAL_W) {
        const float* P = n == 0 ? gp0 : gp1;
        W = P + net.w_off[l] + unit;
        b = __ldg(P + net.b_off[l] + unit);
      } else {
        // the rotated column of this unit in the rows k = part (mod S)
        const float* P = smem + L.par[n];
        W = P + net.w_off[l] + (unit + (part << (5 - sh))) % dout;
        b = P[net.b_off[l] + unit];
      }
      auto weight = [&](int k) {
        if constexpr (GLOBAL_W) return __ldg(W + (size_t)k * dout);
        else return W[k * dout];
      };
      int k = part;
      for (; k + 3 * S < din; k += 4 * S) {
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = weight(k + u * S);
#pragma unroll
        for (int u = 0; u < 4; ++u) fma_row<ET_>(acc, x, k + u * S, w[u]);
      }
      for (; k < din; k += S) fma_row<ET_>(acc, x, k, weight(k));
    }
    for (int o = 1; o < S; o <<= 1) {
#pragma unroll
      for (int e = 0; e < ET_; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (valid && part == 0) {
      float* dst =
          smem + (l == last ? L.out[n] : L.buf[n] + (l & 1) * L.pitch);
#pragma unroll
      for (int e = 0; e < ET_; ++e) {
        float h = acc[e] + b;
        if (l < last) h = act_fwd(h, act);
        dst[at<ET_>(unit, e)] = h;
      }
    }
  }
  __syncthreads();
}

// Forward nets [first, first + count) (equal depth) over the tile in the
// obs tile; the outputs land in the nets' output tiles.
template <int ET_, bool GLOBAL_W>
__device__ __forceinline__ void tile_forward(const Net* nets, const DevArgs& a,
                                             const Layout& L, int first,
                                             int count) {
  for (int l = 0; l < nets[first].n_layers; ++l)
    layer_pass<ET_, GLOBAL_W>(nets, a.params[0], a.params[1], L, first, count,
                              l, a.activation);
}

// One block runs ET_ envs for all T steps.  GLOBAL_W: the nets stay in
// global memory; else they are copied into dynamic shared memory first,
// each layer's rows rotated as layer_pass reads them.
template <class Lane, int ET_, bool GLOBAL_W>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const DevArgs a) {
  constexpr int D = Lane::D, O = Lane::O;
  constexpr int EC = GLOBAL_W ? ET_L : ET_MAX;   // the pitch smem is sized for
  __shared__ Net nets[2];
  __shared__ float log_std[MAX_ACT];

  const int tid = threadIdx.x;
  const int n_nets = a.with_v ? 2 : 1;
  if (tid < 2) nets[tid] = a.net[tid];
  if (Lane::K == 0 && tid < a.act_dim) log_std[tid] = a.log_std[tid];

  Layout L;
  int p = 0;
  L.x = p;
  p += a.net[0].dim[0] * EC;
  L.pitch = a.hmax * EC;
  for (int n = 0; n < n_nets; ++n) { L.buf[n] = p; p += 2 * L.pitch; }
  for (int n = 0; n < n_nets; ++n) {
    L.out[n] = p;
    p += a.net[n].dim[a.net[n].n_layers] * EC;
  }
  if (!GLOBAL_W) {
    for (int n = 0; n < n_nets; ++n) {
      const Net& net = a.net[n];
      const float* src = a.params[n];
      float* dst = smem + p;
      L.par[n] = p;
      for (int l = 0; l < net.n_layers; ++l) {
        const int din = net.dim[l], dout = net.dim[l + 1];
        const int S = layer_split(din, dout), rot = 32 / S;
        for (int i = tid; i < din * dout; i += blockDim.x) {
          const int k = i / dout, j = i - k * dout;
          dst[net.w_off[l] + k * dout + (j + (k & (S - 1)) * rot) % dout] =
              src[net.w_off[l] + i];
        }
        for (int i = tid; i < dout; i += blockDim.x)
          dst[net.b_off[l] + i] = src[net.b_off[l] + i];
      }
      p += net.n_params;
    }
  }
  float* x = smem + L.x;
  const float* pout = smem + L.out[0];
  const float* vout = smem + L.out[a.with_v ? 1 : 0];

  // env state: thread tid < ET_ owns env e of this block's tile
  const int e = blockIdx.x * ET_ + tid;
  const bool owner = tid < ET_;
  const bool live = owner && e < a.E;
  const uint32_t lane = (uint32_t)e;
  float s[D], o[O];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.0f;
#pragma unroll
  for (int d = 0; d < O; ++d) o[d] = 0.0f;
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
  if (owner) Lane::obs(s, o);
  // next_value of the previous step waits for this step's V(s): the obs of
  // a step that did not end is the previous step's next obs, the same bits
  bool pending = false;
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t row = (size_t)t * a.E + e;
    if (owner) {
#pragma unroll
      for (int d = 0; d < O; ++d) {
        x[at<ET_>(d, tid)] = o[d];
        if (live) a.obs[row * O + d] = o[d];
      }
    }
    __syncthreads();
    tile_forward<ET_, GLOBAL_W>(nets, a, L, 0, n_nets);

    bool done_t = false;
    if (owner) {
      if (a.with_v && live) {
        const float v = vout[at<ET_>(0, tid)];
        a.value[row] = v;
        if (pending) a.next_value[row - a.E] = v;
      }
      float act[MAX_ACT];
      float lp;
      if constexpr (Lane::K > 0) {
        float h[Lane::K];
#pragma unroll
        for (int k = 0; k < Lane::K; ++k) h[k] = pout[at<ET_>(k, tid)];
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
          const float mu = pout[at<ET_>(j, tid)];
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
      done_t = done > 0.0f;
      float no[O];
      Lane::obs(s2, no);
#pragma unroll
      for (int d = 0; d < O; ++d) x[at<ET_>(d, tid)] = no[d];
      if (live) {
        a.log_prob[row] = lp;
        a.reward[row] = reward;
        a.terminated[row] = term > 0.0f;
        a.truncated[row] = trunc > 0.0f;
#pragma unroll
        for (int d = 0; d < O; ++d) a.next_obs[row * O + d] = no[d];
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
      for (int d = 0; d < D; ++d) s[d] = done_t ? fresh[d] : s2[d];
      steps = done_t ? 0.0f : steps2;
      if (done_t) {
        Lane::obs(s, o);
      } else {
#pragma unroll
        for (int d = 0; d < O; ++d) o[d] = no[d];
      }
    }
    // V(s') from the value net where the next step's V(s) cannot stand in:
    // an env of the tile is done, or this is the last step
    const bool last = t == a.T - 1;
    const bool any_done = __syncthreads_or(live && done_t);
    if (a.with_v && (any_done || last || a.vnext_all)) {
      tile_forward<ET_, GLOBAL_W>(nets, a, L, 1, 1);
      if (live && (done_t || last || a.vnext_all))
        a.next_value[row] = vout[at<ET_>(0, tid)];
    }
    pending = a.with_v && !(done_t || last || a.vnext_all);
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

using Kernel = void (*)(const DevArgs);

// Calls f(kernel) with the rollout kernel of a lane, variant (0: nets in
// shared memory, 1: in global memory) and tile (envs a block);
// cudaErrorInvalidValue for a tile the variant does not take.
template <class Lane, class F>
cudaError_t with_kernel(int variant, int tile, F f) {
  if (variant == 1)
    return tile == ET_L ? f(rollout_kernel<Lane, ET_L, true>)
                        : cudaErrorInvalidValue;
  switch (tile) {
    case 1: return f(rollout_kernel<Lane, 1, false>);
    case 2: return f(rollout_kernel<Lane, 2, false>);
    case 4: return f(rollout_kernel<Lane, 4, false>);
    case 8: return f(rollout_kernel<Lane, 8, false>);
    default: return cudaErrorInvalidValue;
  }
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
  int tile;     // envs a block: 1, 2, 4 or 8 (variant 0), 32 (variant 1)
  int n_layers, act_dim, activation, T, E;
  uint32_t s0, s1;
  float gamma, lp0;
  float *obs, *next_obs, *action, *log_prob, *reward, *value, *next_value;
  int32_t* action_idx;
  bool *terminated, *truncated;
  float *st_final, *steps_final, *metrics;
};

extern "C" int ppoc_rollout_args_size() { return (int)sizeof(RolloutArgs); }

extern "C" int ppoc_rollout_layer_split(int din, int dout) {
  return layer_split(din, dout);
}

// Dynamic shared memory the rollout kernel needs in `variant`, in bytes.
static long rollout_smem(const DevArgs& d, int variant) {
  const long et = variant == 0 ? ET_MAX : ET_L;   // the largest tile
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

// Fills `d` from `a` for a launch; cudaErrorInvalidValue for nets, a lane,
// variant or tile the kernel refuses.
static cudaError_t fill(DevArgs* dp, const RolloutArgs* a) {
  DevArgs& d = *dp;
  if (!make_nets(&d, a) || a->variant < 0 || a->variant > 1)
    return cudaErrorInvalidValue;
  const int n_out = d.net[0].dim[a->n_layers];
  const cudaError_t shape = with_lane(a->lane, [&](auto lane) {
    using Lane = decltype(lane);
    const int out = Lane::K > 0 ? Lane::K : a->act_dim;
    const bool ok = d.net[0].dim[0] == Lane::O && a->act_dim >= 1 &&
                    a->act_dim <= MAX_ACT && out == a->act_dim &&
                    n_out == out;
    return ok ? with_kernel<Lane>(a->variant, a->tile,
                                  [](Kernel) { return cudaSuccess; })
              : cudaErrorInvalidValue;
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
  return cudaSuccess;
}

static int launch(const RolloutArgs* a, int vnext_all, cudaStream_t stream) {
  DevArgs d{};
  const cudaError_t ok = fill(&d, a);
  if (ok != cudaSuccess) return ok;
  d.vnext_all = vnext_all;
  const long smem = rollout_smem(d, a->variant);
  return with_lane(a->lane, [&](auto lane) {
    return with_kernel<decltype(lane)>(a->variant, a->tile, [&](Kernel k) {
      cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      void* args[] = {&d};
      err = cudaLaunchKernel(reinterpret_cast<const void*>(k),
                             dim3((d.E + a->tile - 1) / a->tile),
                             dim3(THREADS), args, (size_t)smem, stream);
      return err != cudaSuccess ? err : cudaGetLastError();
    });
  });
}

extern "C" int ppoc_rollout(const RolloutArgs* a, cudaStream_t stream) {
  return launch(a, 0, stream);
}

// The same launch with the value net's V(s') pass at every step, where
// ppoc_rollout takes V(s') from the next step's V(s) wherever a step did
// not end: the two must give the same bits (a card test holds them).
extern "C" int ppoc_rollout_vnext_every_step(const RolloutArgs* a,
                                             cudaStream_t stream) {
  return launch(a, 1, stream);
}

// How many blocks of the launch `a` (its lane, variant, tile and shared
// memory) the current device holds at once: its SMs times the blocks an SM
// holds (the occupancy query); a negative cudaError_t on failure.
extern "C" int ppoc_rollout_resident(const RolloutArgs* a) {
  DevArgs d{};
  const cudaError_t ok = fill(&d, a);
  if (ok != cudaSuccess) return -(int)ok;
  const long smem = rollout_smem(d, a->variant);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = with_lane(a->lane, [&](auto lane) {
      return with_kernel<decltype(lane)>(a->variant, a->tile, [&](Kernel k) {
        cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                             THREADS, smem);
      });
    });
  return err == cudaSuccess ? sms * per_sm : -(int)err;
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

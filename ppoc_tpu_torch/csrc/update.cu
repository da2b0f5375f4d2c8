// K6: a whole categorical PPO policy phase (every epoch x minibatch step)
// as one kernel launch of one block, in both variants.  K3 and K4 run as
// thread-block clusters: update_cluster.cu with the nets in shared memory,
// update_shard.cu with them sharded over the cluster.
//
// Replaces ppoc_tpu/ops/pallas_update.py `policy_phase_fused_categorical`
// -> `_policy_kernel_cat`/`_policy_kernel_cat_unrolled`.  Each step: MLP
// forward on the pre-gathered minibatch, the loss gradient in closed form
// (the clipped surrogate through a log-softmax over the class logits plus
// the entropy bonus, as one gradient on the logits), backward, and Adam.
//
// What bounds it on the card: the steps are serial through Adam (200
// policy steps per fit at the bench shape), and one step of a
// [4,128,128,2] net on 256 rows is ~25 MFLOP in small dependent products.
// The phase runs on ONE SM and is bound by that SM's FP32 FMA issue rate,
// plus one __syncthreads per layer.
//
// What the design does about it: one persistent block of 1024 threads
// walks every step with no launch between steps; the weights stay in
// shared memory for the whole phase (69.6 KB padded at the bench shape);
// activations, gradients and the Adam moments live in a global scratch the
// wrapper allocates, which stays in the 50 MB L2; the products are
// register-tiled block loops (mlp_step.cuh).
//
// Nets larger than one block's shared memory (2x256: [4,256,256,2] is
// 68,102 padded floats, 272 KB, against 227 KB) take a second variant,
// picked by size at the launch (GLOBAL_W): the weights live in the output
// params in global memory
// (`load_state` copies p_in there, Adam updates them in place), and each
// product stages its weight operand SLICE = 32 rows at a time through 33
// KB of shared memory (`sliced_gemm`): the forward W's rows, the dX
// product W's columns transposed.  dW/db reads no weights.  The weights
// change every step, so they are read with plain loads (never __ldg or a
// const __restrict__ pointer, whose non-coherent cache could return the
// previous step's values); adam_step's closing __syncthreads orders the
// update before the next step's staging.  Every output is summed in the
// same order in both variants, so on a net both take the whole phase is
// the same bits.  Each round of 32 warp tiles re-stages W: one round at mb
// 64 x 256 columns, 32 rounds at the 2048-row gate.
#include "mlp_step.cuh"
#include "phase_args.cuh"

using namespace ppoc;

namespace {

constexpr int THREADS = 1024;

struct PhaseDev {
  PaddedNet pn;
  const float *x, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  float *scratch, *stats;
  const int32_t* act_idx;
  int activation, n_steps, mb, t0, k_act;
  float clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

// GLOBAL_W: the weights are the output params, `smem` the staging slice.
template <bool GLOBAL_W>
__device__ StepCtx make_ctx(const PhaseDev& a, float* smem) {
  StepCtx c;
  c.pn = a.pn;
  c.mb = a.mb;
  c.act = a.activation;
  c.W = GLOBAL_W ? a.p_out : smem;
  c.Ws = smem;
  c.H = a.scratch;
  c.G[0] = c.H + a.pn.h_floats;
  c.G[1] = c.G[0] + a.pn.g_floats;
  c.dP = c.G[1] + a.pn.g_floats;
  return c;
}

// Seed the outputs from the inputs (params into shared memory, or into
// the output params where the weights stay in global memory).
template <bool GLOBAL_W>
__device__ void load_state(const PhaseDev& a, const StepCtx& c) {
  for (int i = threadIdx.x; i < a.pn.net.n_params; i += blockDim.x) {
    c.W[GLOBAL_W ? i : padded_index(a.pn, i)] = a.p_in[i];
    a.m_out[i] = a.m_in[i];
    a.v_out[i] = a.v_in[i];
  }
  __syncthreads();
}

template <bool GLOBAL_W>
__device__ void store_params(const PhaseDev& a, const StepCtx& c) {
  if constexpr (!GLOBAL_W)
    for (int i = threadIdx.x; i < a.pn.net.n_params; i += blockDim.x)
      a.p_out[i] = c.W[padded_index(a.pn, i)];
}

// K6, per step and row r of the minibatch (pallas_update.py:824-883):
// log-softmax of the K logits h, logp = logp_all[a] through the one-hot
// sum, ratio = exp(logp - lp_old), surr = min(ratio adv, clip(ratio) adv),
// H = -sum_k p_k logp_all_k, and the logit gradient
// G[r,k] = dlogp (onehot - p) + (ent_coeff / mb) p (logp_all + H) with
// dlogp = -(adv ratio / mb) on the unclipped branch, else 0.  The rows'
// class ids are read as int32.  Loss and entropy sums come back in stats.
template <bool GLOBAL_W>
__global__ void __launch_bounds__(THREADS, 1)
categorical_policy_phase_kernel(const PhaseDev a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const StepCtx c = make_ctx<GLOBAL_W>(a, smem);
  const int K = a.k_act;
  load_state<GLOBAL_W>(a, c);
  const int d0 = a.pn.net.dim[0];
  const float* logits = c.H + a.pn.h_off[a.pn.net.n_layers - 1];   // [mb, K]
  const float mbf = (float)a.mb;
  const float ent_mb = a.ent_coeff / mbf;
  float loss = 0.0f, ent_sum = 0.0f;
  for (int s = 0; s < a.n_steps; ++s) {
    const size_t row0 = (size_t)s * a.mb;
    const float* x = a.x + row0 * d0;
    mlp_forward<GLOBAL_W>(c, x);
    float surr_part = 0.0f, h_part = 0.0f;
    for (int r = threadIdx.x; r < a.mb; r += blockDim.x) {
      const size_t row = row0 + r;
      const float* h = logits + (size_t)r * K;
      float zmax = h[0];
      for (int k = 1; k < K; ++k) zmax = fmaxf(zmax, h[k]);
      float sum = 0.0f;
      for (int k = 0; k < K; ++k) sum += expf(h[k] - zmax);
      const float lse = zmax + logf(sum);
      const int act = a.act_idx[row];
      float lpa[MAX_ACT], p[MAX_ACT];
      float logp = 0.0f, H = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_ACT; ++k) {
        if (k < K) {
          lpa[k] = h[k] - lse;
          p[k] = expf(lpa[k]);
          logp += k == act ? lpa[k] : 0.0f;
          H += p[k] * lpa[k];
        }
      }
      H = -H;
      const float adv = a.adv[row];
      const float ratio = expf(logp - a.lp_old[row]);
      const float clipped = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
      const float ra = ratio * adv, ca = clipped * adv;
      surr_part += fminf(ra, ca);
      h_part += H;
      // only the unclipped branch carries the surrogate's gradient
      const float dlogp = ra <= ca ? -(adv * ratio / mbf) : 0.0f;
      float* g = c.G[0] + (size_t)r * K;
#pragma unroll
      for (int k = 0; k < MAX_ACT; ++k) {
        if (k < K) {
          const float onehot = k == act ? 1.0f : 0.0f;
          g[k] = dlogp * (onehot - p[k]) + ent_mb * p[k] * (lpa[k] + H);
        }
      }
    }
    const float surr = block_sum(surr_part, red);
    const float hsum = block_sum(h_part, red);
    loss += (-surr - a.ent_coeff * hsum) / mbf;
    ent_sum += hsum / mbf;

    mlp_backward<GLOBAL_W>(c, x);
    adam_step<GLOBAL_W>(c, a.m_out, a.v_out, a.t0 + s + 1, a.hyper);
  }
  store_params<GLOBAL_W>(a, c);
  if (threadIdx.x == 0) {
    a.stats[0] = loss;
    a.stats[1] = ent_sum;
  }
}

}  // namespace

extern "C" int ppoc_phase_args_size() { return (int)sizeof(PhaseArgs); }

// Dynamic shared memory of `variant`: the padded weights, or one staged
// slice of a product's weight operand (SLICE rows of the widest layer + 1).
static long phase_smem(const PaddedNet& pn, int variant) {
  if (variant == 0) return (long)pn.n_padded * (long)sizeof(float);
  int dmax = 1;
  for (int l = 0; l <= pn.net.n_layers; ++l)
    dmax = pn.net.dim[l] > dmax ? pn.net.dim[l] : dmax;
  return (long)SLICE * (dmax + 1) * (long)sizeof(float);
}

// sizes[0]: scratch floats the wrapper must allocate (either variant);
// sizes[1], sizes[2]: dynamic shared-memory bytes of the variant with the
// weights in shared memory and of the one with them in global memory.
// Returns false (0) for a shape the kernels refuse.
extern "C" int ppoc_phase_sizes(const PhaseArgs* a, long* sizes) {
  PaddedNet pn;
  if (!make_padded(&pn, a->n_layers, a->dims, a->mb)) return 0;
  sizes[0] = (long)pn.h_floats + 2L * pn.g_floats + pn.net.n_params;
  sizes[1] = phase_smem(pn, 0);
  sizes[2] = phase_smem(pn, 1);
  return 1;
}

static void (*phase_kernel(int variant))(const PhaseDev) {
  return variant == 0 ? categorical_policy_phase_kernel<false>
                      : categorical_policy_phase_kernel<true>;
}

extern "C" int ppoc_policy_phase_categorical(const PhaseArgs* a,
                                             cudaStream_t stream) {
  PhaseDev d{};
  if (!make_padded(&d.pn, a->n_layers, a->dims, a->mb)) return cudaErrorInvalidValue;
  if (a->variant < 0 || a->variant > 1) return cudaErrorInvalidValue;
  if (a->k_act < 1 || a->k_act > MAX_ACT ||
      d.pn.net.dim[a->n_layers] != a->k_act)
    return cudaErrorInvalidValue;
  d.x = a->x; d.lp_old = a->lp_old; d.adv = a->adv;
  d.p_in = a->p_in; d.m_in = a->m_in; d.v_in = a->v_in;
  d.p_out = a->p_out; d.m_out = a->m_out; d.v_out = a->v_out;
  d.scratch = a->scratch; d.stats = a->stats; d.act_idx = a->act_idx;
  d.activation = a->activation; d.n_steps = a->n_steps; d.mb = a->mb;
  d.t0 = a->t0; d.k_act = a->k_act;
  d.clip_lo = a->clip_lo; d.clip_hi = a->clip_hi; d.ent_coeff = a->ent_coeff;
  d.hyper = a->hyper;
  const int smem = (int)phase_smem(d.pn, a->variant);
  auto kernel = phase_kernel(a->variant);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, THREADS, smem, stream>>>(d);
  return cudaGetLastError();
}

// K3 and K4: a whole PPO update phase (every epoch x minibatch step) as one
// kernel launch.
//
// Replaces ppoc_tpu/ops/pallas_update.py `value_phase_fused` ->
// `_run_value_phase` -> `_value_kernel`/`_value_kernel_unrolled` (K3) and
// `policy_phase_fused` -> `_policy_kernel`/`_policy_kernel_unrolled` (K4,
// Gaussian).  Each step: MLP forward on the pre-gathered minibatch, the
// loss gradient in closed form (K3: MSE, 2/mb (v - target); K4: clipped
// surrogate, gradient only through the unclipped branch, plus the entropy
// term on log_std), backward, and Adam (K4: two Adams, the net's and
// log_std's, each with its own timestep).
//
// What bounds it on the card: the steps are serial through Adam (500 value
// and 200 policy steps per fit at the bench shape), and one step of a
// [3,128,128,1] net on 256 rows is ~25 MFLOP in small dependent products,
// far too little to spread over many SMs without a grid-wide barrier per
// layer.  So the phase runs on ONE SM and is bound by that SM's FP32 FMA
// issue rate, plus one __syncthreads per layer.
//
// What the design does about it: one persistent block of 1024 threads
// walks every step with no launch between steps; the weights stay in
// shared memory for the whole phase (69.6 KB padded at the bench shape);
// activations, gradients and the Adam moments live in a global scratch the
// wrapper allocates, which stays in the 50 MB L2; the products are
// register-tiled block loops (mlp_step.cuh).  Tensor cores and a
// thread-block cluster (distributed shared memory) are later steps.
#include "mlp_step.cuh"

using namespace ppoc;

namespace {

constexpr int THREADS = 1024;

struct PhaseDev {
  PaddedNet pn;
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  float *scratch, *stats;
  int activation, n_steps, mb, t0, t0_ls, k_act;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

__device__ StepCtx make_ctx(const PhaseDev& a, float* smem) {
  StepCtx c;
  c.pn = a.pn;
  c.mb = a.mb;
  c.act = a.activation;
  c.W = smem;
  c.H = a.scratch;
  c.G[0] = c.H + a.pn.h_floats;
  c.G[1] = c.G[0] + a.pn.g_floats;
  c.dP = c.G[1] + a.pn.g_floats;
  return c;
}

// Seed the outputs from the inputs (params into shared memory).
__device__ void load_state(const PhaseDev& a, const StepCtx& c) {
  for (int i = threadIdx.x; i < a.pn.net.n_params; i += blockDim.x) {
    c.W[padded_index(a.pn, i)] = a.p_in[i];
    a.m_out[i] = a.m_in[i];
    a.v_out[i] = a.v_in[i];
  }
  __syncthreads();
}

__device__ void store_params(const PhaseDev& a, const StepCtx& c) {
  for (int i = threadIdx.x; i < a.pn.net.n_params; i += blockDim.x)
    a.p_out[i] = c.W[padded_index(a.pn, i)];
}

__global__ void __launch_bounds__(THREADS, 1) value_phase_kernel(const PhaseDev a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const StepCtx c = make_ctx(a, smem);
  load_state(a, c);
  const int d0 = a.pn.net.dim[0];
  const float* out = c.H + a.pn.h_off[a.pn.net.n_layers - 1];   // [mb, 1]
  float loss = 0.0f;
  for (int s = 0; s < a.n_steps; ++s) {
    const float* x = a.x + (size_t)s * a.mb * d0;
    const float* tgt = a.tgt + (size_t)s * a.mb;
    mlp_forward(c, x);
    float sq = 0.0f;
    for (int r = threadIdx.x; r < a.mb; r += blockDim.x) {
      const float diff = out[r] - tgt[r];
      sq += diff * diff;
      c.G[0][r] = a.two_over_mb * diff;
    }
    loss += block_sum(sq, red);
    mlp_backward(c, x);
    adam_step(c, a.m_out, a.v_out, a.t0 + s + 1, a.hyper);
  }
  store_params(a, c);
  if (threadIdx.x == 0) a.stats[0] = loss;
}

__global__ void __launch_bounds__(THREADS, 1) policy_phase_kernel(const PhaseDev a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ float ls[MAX_ACT], mls[MAX_ACT], vls[MAX_ACT];
  const StepCtx c = make_ctx(a, smem);
  const int k = a.k_act;
  if (threadIdx.x < k) {
    ls[threadIdx.x] = a.ls_in[threadIdx.x];
    mls[threadIdx.x] = a.mls_in[threadIdx.x];
    vls[threadIdx.x] = a.vls_in[threadIdx.x];
  }
  load_state(a, c);
  const int d0 = a.pn.net.dim[0];
  const float* mu = c.H + a.pn.h_off[a.pn.net.n_layers - 1];   // [mb, k]
  const float mbf = (float)a.mb;
  float loss = 0.0f, ent_sum = 0.0f;
  for (int s = 0; s < a.n_steps; ++s) {
    const size_t row0 = (size_t)s * a.mb;
    const float* x = a.x + row0 * d0;
    float sum_ls = 0.0f, inv_sigma[MAX_ACT];
    for (int j = 0; j < k; ++j) {
      sum_ls += ls[j];
      inv_sigma[j] = expf(-ls[j]);
    }
    // closed-form Gaussian entropy, once per minibatch step
    const float ent = a.ent0 + sum_ls;
    ent_sum += ent;
    loss += -a.ent_coeff * ent;

    mlp_forward(c, x);
    float surr_part = 0.0f, gls_part[MAX_ACT];
    for (int j = 0; j < k; ++j) gls_part[j] = 0.0f;
    for (int r = threadIdx.x; r < a.mb; r += blockDim.x) {
      const size_t row = row0 + r;
      float z[MAX_ACT], sumz2 = 0.0f;
      for (int j = 0; j < k; ++j) {
        z[j] = (a.act[row * k + j] - mu[r * k + j]) * inv_sigma[j];
        sumz2 += z[j] * z[j];
      }
      const float logp = a.lp0 - sum_ls - 0.5f * sumz2;
      const float adv = a.adv[row];
      const float ratio = expf(logp - a.lp_old[row]);
      const float clipped = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
      const float ra = ratio * adv, ca = clipped * adv;
      surr_part += fminf(ra, ca);
      // only the unclipped branch carries gradient
      const float dlogp = ra <= ca ? -(adv * ratio / mbf) : 0.0f;
      for (int j = 0; j < k; ++j) {
        gls_part[j] += dlogp * (z[j] * z[j] - 1.0f);
        c.G[0][r * k + j] = dlogp * z[j] * inv_sigma[j];
      }
    }
    const float surr = block_sum(surr_part, red);
    loss += -surr / mbf;
    float gls[MAX_ACT];
    for (int j = 0; j < k; ++j) gls[j] = block_sum(gls_part[j], red);

    mlp_backward(c, x);
    adam_step(c, a.m_out, a.v_out, a.t0 + s + 1, a.hyper);
    // log_std Adam (its own timestep); the entropy bonus adds -ent_coeff
    if (threadIdx.x < k) {
      const int j = threadIdx.x;
      const AdamHyper& h = a.hyper;
      const float tl = (float)(a.t0_ls + s + 1);
      const float bc1 = 1.0f - expf(tl * h.logb1);
      const float bc2 = 1.0f - expf(tl * h.logb2);
      const float g = gls[j] - a.ent_coeff;
      const float m2 = h.b1 * mls[j] + h.omb1 * g;
      const float v2 = h.b2 * vls[j] + h.omb2 * (g * g);
      mls[j] = m2;
      vls[j] = v2;
      ls[j] = ls[j] - (h.lr / bc1) * m2 / (sqrtf(v2 / bc2) + h.eps);
    }
    __syncthreads();
  }
  store_params(a, c);
  if (threadIdx.x < k) {
    a.ls_out[threadIdx.x] = ls[threadIdx.x];
    a.mls_out[threadIdx.x] = mls[threadIdx.x];
    a.vls_out[threadIdx.x] = vls[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    a.stats[0] = loss;
    a.stats[1] = ent_sum;
  }
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_update.py mirrors it
// field for field as a ctypes.Structure.  Value phases leave the policy
// fields null, policy phases `tgt`.
struct PhaseArgs {
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  float *scratch, *stats;
  const int* dims;   // host array of n_layers + 1 widths
  int n_layers, activation, n_steps, mb, t0, t0_ls, k_act;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

extern "C" int ppoc_phase_args_size() { return (int)sizeof(PhaseArgs); }

// sizes[0]: scratch floats the wrapper must allocate; sizes[1]: dynamic
// shared-memory bytes.  Returns false (0) for a shape the kernels refuse.
extern "C" int ppoc_phase_sizes(const PhaseArgs* a, long* sizes) {
  PaddedNet pn;
  if (!make_padded(&pn, a->n_layers, a->dims, a->mb)) return 0;
  sizes[0] = (long)pn.h_floats + 2L * pn.g_floats + pn.net.n_params;
  sizes[1] = (long)pn.n_padded * (long)sizeof(float);
  return 1;
}

static int launch_phase(const PhaseArgs* a, cudaStream_t stream, bool policy) {
  PhaseDev d{};
  if (!make_padded(&d.pn, a->n_layers, a->dims, a->mb)) return cudaErrorInvalidValue;
  if (policy && (a->k_act < 1 || a->k_act > MAX_ACT ||
                 d.pn.net.dim[a->n_layers] != a->k_act))
    return cudaErrorInvalidValue;
  if (!policy && d.pn.net.dim[a->n_layers] != 1) return cudaErrorInvalidValue;
  d.x = a->x; d.tgt = a->tgt; d.act = a->act; d.lp_old = a->lp_old; d.adv = a->adv;
  d.p_in = a->p_in; d.m_in = a->m_in; d.v_in = a->v_in;
  d.p_out = a->p_out; d.m_out = a->m_out; d.v_out = a->v_out;
  d.ls_in = a->ls_in; d.mls_in = a->mls_in; d.vls_in = a->vls_in;
  d.ls_out = a->ls_out; d.mls_out = a->mls_out; d.vls_out = a->vls_out;
  d.scratch = a->scratch; d.stats = a->stats;
  d.activation = a->activation; d.n_steps = a->n_steps; d.mb = a->mb;
  d.t0 = a->t0; d.t0_ls = a->t0_ls; d.k_act = a->k_act;
  d.two_over_mb = a->two_over_mb; d.lp0 = a->lp0; d.ent0 = a->ent0;
  d.clip_lo = a->clip_lo; d.clip_hi = a->clip_hi; d.ent_coeff = a->ent_coeff;
  d.hyper = a->hyper;
  const int smem = d.pn.n_padded * (int)sizeof(float);
  auto kernel = policy ? policy_phase_kernel : value_phase_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, THREADS, smem, stream>>>(d);
  return cudaGetLastError();
}

extern "C" int ppoc_value_phase(const PhaseArgs* a, cudaStream_t stream) {
  return launch_phase(a, stream, false);
}

extern "C" int ppoc_policy_phase(const PhaseArgs* a, cudaStream_t stream) {
  return launch_phase(a, stream, true);
}

// K2: GAE(lambda) + whole-buffer advantage normalisation in one launch.
//
// Replaces ppoc_tpu/ops/pallas_gae.py `gae_norm_fused` -> `_kernel`:
// delta = r + gamma V'(1 - term) - V; the backward recurrence
// A_t = delta_t + gamma lam (1 - done_t) A_{t+1} with done = term | trunc;
// target = V + A; then A <- (A - mean) / (sqrt(var) + 1e-8) with the
// population moments, taken two-pass (mean first, then the variance).
//
// What bounds it on the card: at the bench shape the problem is 12,800
// elements (five 51 KB input planes), so bandwidth and FLOPs are trivial;
// the time is the T-step serial recurrence plus the launch.
//
// What the design does about it: one block does everything, so the global
// reduction needs no second launch: one thread per env column runs the
// recurrence (reads of step t are coalesced across the columns), the
// unnormalised advantages stay in shared memory when T*E fits there, and
// block reductions give the moments.  Past the shared-memory size the
// advantages round-trip through the output buffer instead (a second pass
// over global memory, same formula).
#include "common.cuh"

using namespace ppoc;

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
gae_norm_kernel(const float* __restrict__ r, const float* __restrict__ v,
                const float* __restrict__ nv, const bool* __restrict__ term,
                const bool* __restrict__ trunc, float* adv,
                float* __restrict__ tgt, int T, int E, float gamma, float gl,
                int normalize, int in_smem) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  float* A = in_smem ? smem : adv;
  const int n = T * E;

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float a = 0.0f;
    for (int t = T - 1; t >= 0; --t) {
      const int i = t * E + e;
      const float te = term[i] ? 1.0f : 0.0f;
      const float dn = (term[i] || trunc[i]) ? 1.0f : 0.0f;
      const float delta = r[i] + gamma * nv[i] * (1.0f - te) - v[i];
      a = t == T - 1 ? delta : delta + gl * (1.0f - dn) * a;
      A[i] = a;
      tgt[i] = v[i] + a;
    }
  }
  __syncthreads();

  if (!normalize) {
    if (in_smem)
      for (int i = threadIdx.x; i < n; i += blockDim.x) adv[i] = A[i];
    return;
  }
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += A[i];
  const float mean = block_sum(s, red) / (float)n;
  float q = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = A[i] - mean;
    q += d * d;
  }
  const float var = block_sum(q, red) / (float)n;
  const float denom = sqrtf(var) + 1e-8f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) adv[i] = (A[i] - mean) / denom;
}

}  // namespace

// Advantages stay in shared memory up to this many bytes.
constexpr int GAE_SMEM_LIMIT = 200 * 1024;

extern "C" int ppoc_gae_norm(const float* r, const float* v, const float* nv,
                             const bool* term, const bool* trunc, float* adv,
                             float* tgt, int T, int E, float gamma, float gl,
                             int normalize, cudaStream_t stream) {
  const long bytes = (long)T * E * (long)sizeof(float);
  const int in_smem = bytes <= GAE_SMEM_LIMIT;
  const int smem = in_smem ? (int)bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      gae_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gae_norm_kernel<<<1, THREADS, smem, stream>>>(r, v, nv, term, trunc, adv, tgt,
                                                T, E, gamma, gl, normalize,
                                                in_smem);
  return cudaGetLastError();
}

extern "C" const char* ppoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The host-side argument block of the fused update phases (K3, K4 and K6,
// each a kind of update_cluster.cu's and update_shard.cu's cluster
// kernels); ppoc_tpu_torch/ops/cuda_update.py mirrors it field for field as
// a ctypes.Structure, and update.cu's ppoc_phase_args_size lets it
// check the size.  Value phases leave the policy fields null, policy phases
// `tgt`; the categorical phase reads its actions from `act_idx` and leaves
// `act` and the log_std fields null.
#pragma once

#include "mlp_step.cuh"

struct PhaseArgs {
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  float *scratch, *stats;
  const int32_t* act_idx;
  const int* dims;   // host array of n_layers + 1 widths
  int n_layers, activation, n_steps, mb, t0, t0_ls, k_act;
  int cluster;       // cluster kernels: blocks in the cluster (0: the rule's)
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  ppoc::AdamHyper hyper;
};

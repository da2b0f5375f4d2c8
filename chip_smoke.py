"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: prints the card's name and power limit; exits non-zero without
   a CUDA device.
2. Build: compiles ppoc_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. Bench path, kernels: K1 rollout (with the V planes, and with the
   metrics at the evaluation shape; every K1 row prints the tile, envs a
   block, its launch took), then a step's device time of K1 at 64 x 200
   by forced tile (1, 2, 4, 8: rollout_grid_times), K2 GAE, K3 value
   phase and K4 policy phase against their plain PyTorch versions on the
   card, at the bench configuration's shapes, with TF32 off; prints both
   times.  K3 and K4
   also on the reference schedule's rows (PPOConfig(env="pendulum"): 15
   envs x 200 steps, minibatch 64).  K3 and K4 run as one thread-block
   cluster (csrc/update_cluster.cu); each check prints the cluster's
   blocks, rows a block and shared memory.
4. Bench path: Trainer(bench config).solve(-200, max_epochs=40) on the card
   (64 envs x 200 steps, minibatch 256, 4 fits per epoch, kernel_backend
   "pallas"), with each kernel's launch count read around it (one cluster
   K3 and one cluster K4 a fit, none in global memory) and the wall per
   epoch.  Then checkpoint, resume and serving from the solved trainer
   (checkpoint_phases): save and Trainer.from_checkpoint on the card,
   every leaf and the config equal; a bench epoch resumed from a file
   equal bit for bit to the uninterrupted one, with one epoch's launches;
   serve.load_policy acting on 256 bench observations through K5's
   forward (the launch counted, the plain version never run, mlp.apply
   (..., "pallas")'s bits, within K5's tolerance of the plain version;
   an act call's wall and device us) and the same rows through POST /act
   of make_server; the reference ppo.c format out and back bitwise; the
   CLI in process (--save, --resume, --eval-only), each returning 0 with
   its launches counted.  Then two epochs of the reference schedule
   PPOConfig(env="pendulum"), its K3 and K4 launches held to one a fit.
5. Throughput path, kernels: K1 at 1024 envs, K2 at 200 x 1024 (past one
   block's shared memory, so a cluster of 16 blocks), and K5 (the
   whole-MLP forward and backward, 3xTF32 products on the tensor cores) at
   8192 and 256 rows, each against its plain version; K5's backward twice,
   bit for bit; every K5 row prints the row tile and grid its timed
   launches took, and the backward its clusters and partial rows.  Then
   K5's registers and spills from nvcc.log, and its rounding at 8192 rows
   against a float64 forward and backward beside the plain version's (RMS
   error and signed lean per layer and for dX, check_mlp_lean): the
   kernel's RMS within MLP_RMS_FACTOR of the plain version's and its lean
   within MLP_LEAN_FACTOR of the plain's RMS, where a control, the plain
   version with one-term TF32 products (allow_tf32), must fail.
6. Throughput path: Trainer(tpu_preset("pendulum")) on the card by default,
   4 epochs (minibatch 8192: the generic phases, K5 forward and backward
   per minibatch, no K3/K4), then Trainer.evaluate(deterministic=True),
   with the launch counts read around each, and the mean policy's actions
   held to the plain forward on the recorded obs.
7. Discrete kernels, for cartpole and then acrobot: K1's lane at 64 envs x
   200 steps with the V planes and at 64 x 500 with the metrics (RNG bits
   exactly; the Gumbel-max sampler bit for bit on shared logits; the
   kernel's draws, log-probs, V planes and physics held to the plain
   versions on its own trajectory; whole trajectories per env up to the
   first near-tie of the perturbed logits), K2 on the lane rollout's
   planes (real terminations), K3 on the lane's value rows ([4|6,128,128,1],
   one step and the whole phase), and K6, the categorical policy phase, at
   minibatch 256 x 200 steps ([4,128,128,2] with ent_coeff 0, then
   [6,128,128,3] with ent_coeff 0.01), a kind of K3's and K4's replicated
   cluster (its plan printed): each step from the kernel's state against
   one float64 step (held again, at step 0 and at a step past that,
   against the float64 steps with the ReLU gates and clip branches within
   rounding taken either way, where the lr +1% step must fail), chained
   one-step launches against one long launch bit for bit, the whole phase
   loosely, and one step's signed lean.
8. Discrete path: Trainer(bench config with env "cartpole", eval_len 500)
   .solve(475, max_epochs=40), then the same for "acrobot" with
   .solve(-100, max_epochs=40), with the launch counts read around each
   (K1's lane, K2, K3 and K6 run; K4 does not); then
   Trainer.evaluate(deterministic=True) on the trained CartPole policy
   (argmax through K5).
9. K7, the flash attention: forward (out, lse), dq and dk/dv against the
   plain version (autograd through materialised scores) at the recall_xl
   minibatch shape (T 1024, B 4, H 4, hd 8) with a recall_xl rollout's
   episodes and with p_done 0.02, at the value-pass shape (B 32), at a
   ragged T 1030, at the JAX package's X-ray shape (T 2048, B 16, H 8,
   hd 64) and with rel -1, 0 and +1; the backward twice, bit for bit;
   timed beside the plain version and scaled_dot_product_attention with
   the boolean mask (library_ms; the port never calls it), each backward
   kernel beside the plain and library backward with respect to its own
   inputs (q for dq, k and v for dk/dv); at each timed shape the share of
   the in-range tiles the kernels visit (cuda_attn.visited_tiles: a block
   skips the tiles whose episode ids do not meet its rows').  Then the
   f32 kernels' rounding at the recall_xl minibatch and the X-ray shape
   against float64 beside the plain version's (out, lse, dq, dk, dv: RMS
   error and signed lean, check_flash_lean), held as K5 is, where the
   plain version with one-term TF32 products must fail.  Every K2 check
   prints the plan its launch took (cuda_gae.plan, held to the C side's).
10. apply_seq through K7 against apply_seq through the materialised core
   at recall_xl's widths (d 32, 2 layers, 4 heads, T 1024, E 4): outputs
   and every parameter gradient.
11. The attention learning check: Trainer(recall, attn_dim 16) on the
   card must reach R > 0.9 within 5 epochs (T 6: the materialised path;
   training stops at the first epoch that does).
12. The attention path: Trainer(recall_xl at the width of
   examples/recall_xl_curriculum.py, rollout_len = eval_len = 1024), the
   decode-against-replay log-prob gap at the initial weights, then one
   epoch (Trainer.train_epoch, then Trainer.evaluate), each epoch's R
   and its wall time split by phase, with the launches read around each
   phase and held to the count the config gives (the split must cover
   the epoch's wall); then Trainer.evaluate(deterministic=True), which
   launches no kernel.
13. K1's four new lanes against their plain versions at each path's
   shapes (RNG bits exactly; the entry reset and the first 10 steps
   against the plain rollout; the kernel's own actions replayed through
   the plain physics, equal bit for bit; log-probs and V planes against
   the plain forward; the metrics against the kernel's trajectory):
   reacher at 4096 x 150 with the V planes and 2x256 nets (the
   global-memory variant) and at 256 x 150 with the metrics,
   mountain_car_norm at 512 x 999 and 256 x 999, simple and mountain_car
   at the bench shape (64 x 200; mountain_car's evaluation 64 x 999); K2
   on the reacher and MountainCar planes; K5 at 16384 rows of the 2x256
   nets and at 256 rows (the global-memory variant), with phase 5's
   rounding check at 16384 rows of [10,256,256,1], and at 8192 rows of
   [2,128,128,1]; K4 at two action dims on reacher rows (hidden 64,
   minibatch 256), as the bench's K4 is held.
14. The simple lane's path (the bench shape, solve(0.5, 10)) and raw
   mountain_car's (2 epochs), with their launches.
15. The reacher regime at full width (4096 envs x 150, minibatch 16384 in
   blocks of 4096, hidden 2x256): evaluate, 3 epochs, each split by
   phase and evaluated, every launch held to the config's count (a fit:
   one K1 rollout with the V planes, one K2, 370 + 148 K5 forwards and
   backwards; an evaluation one K1 rollout with the metrics), eval R up
   by more than 5, training env-steps/s; then evaluate(deterministic=True)
   (150 K5 forwards).
16. The MountainCarContinuous recipe (512 envs x 999, minibatch 8192,
   ent_coeff 0.005): Trainer.train(30, stop_at_R=90) on seed 0, which
   must solve; by the rule declared before any run, if it misses seeds 1
   and 2 run and must both solve; R per epoch, the solve epoch, the wall
   and the launches against the config's.
17. K3, K4 and K6 past one block's shared memory (sharded over a
   thread-block cluster):
   K3 and K4 on REACHER_REF's rows (the reference schedule at 2x256:
   [10,256,256,1] for 460 steps and [10,256,256,2], two action dims, for
   184, minibatch 64), K3 and K6 on CARTPOLE_WIDE's rows ([4,256,256,1],
   [4,256,256,2]), each as the bench's phases are held (each step from
   the kernel's state against float64, chained launches against one
   launch bit for bit, the whole phase within its WHOLE_RATIO row) and
   launched in its second variant with the sharded cluster's plan
   printed; K3 and K6 for 20 steps at minibatch 2048, the fused gate's
   edge, held the same way (their whole phase's distance printed only),
   beside the generic phases (the path past the gate) on the same rows,
   wall and device time; each timed beside its plain version.  Then the
   sharded cluster's registers and spills from nvcc.log, a step's device
   time of K3 on [10,256,256,1] by cluster size (4, 8, 16) at minibatch 64
   and 2048 and of K6 on [4,256,256,2] at minibatch 64, and K3 on
   [3,192,192,1] (pendulum at the reference schedule, between the
   replicated cluster's boundary and 2x256) held and timed the same way.
   K3 and K4 here, K4 in phases 3 and 13, and K6 here and in phase 7: the
   signed lean of one step's gradient against the plain version's
   (LEAN_TOL), with a control (the plain gradient 8 ulps toward zero)
   that must fail.
18. The two 2x256 paths under the fused gate: REACHER_REF for 3 epochs
   by phase (eval R up by more than 5) and CARTPOLE_WIDE's
   solve(475, max_epochs=10), which must solve; each phase's launches
   held to the config's (a fit: one K1 rollout with the V planes and one
   K3 and one K4 or K6, all in their second variant, one K2; an
   evaluation one K1 rollout with the metrics; no shared-memory phase
   kernel).
19. K7's bf16 variant (kernel_backend "bf16": q, k, v, dout as bf16, p, ds
   and w rounded to bf16 for their products, dq, dk, dv written as bf16)
   against its plain versions (the forward chunked as the kernel) at
   phase 9's shapes and relations, on the same inputs rounded to bf16;
   the backward twice, bit for bit; timed beside the plain versions and
   scaled_dot_product_attention in bf16 with the mask; at each timed shape
   the share of tiles visited, and a control forward that sums l from
   bf16(p) (attention_plain_bf16(round_l=True)), which must fail the check
   the kernel passes; at the value pass and X-ray each output's signed
   lean against its plain version, pooled over three inputs, within
   LEAN_TOL, and at the value pass a control whose sums round toward zero
   (toward_zero=True), which must lean past it; the three bf16 kernels'
   registers and spills from the build's nvcc.log.  Then apply_seq
   "bf16" through it against the same through its plain versions at
   recall_xl's widths, each output and gradient leaf held by its distance
   against the bf16-vs-float32 distance.
20. RECALL_XL_BF16 (RECALL_XL with kernel_backend "bf16"): the decode
   against the bf16 replay at the initial weights, 1 epoch by phase with
   every launch held to the config's count (K7's bf16 kernels only: 2, 160
   and 64 of each a fit), then evaluate(deterministic=True); K7 bf16's
   share of the epochs' wall (its launches times its device ms at the
   timed shapes).
21. REACHER_BF16 (the reacher regime with kernel_backend "bf16", the JAX
   package's "bf16 + shuffle_block" recipe): evaluate, 3 epochs by phase
   (a fit is one K1 launch without the V planes, as the JAX package's
   "bf16" rollout takes none, and one K2; the value forwards and both
   phases are bf16 library products: no K3, K4, K5 or K6), eval R up by
   more than 5, then evaluate(deterministic=True) (no kernel); the bf16
   MLP product (mlp.bf16_dot, bf16 tensor cores) against the CPU form run
   on the card with TF32 off.
22. K3 bf16 and K4 bf16, the bf16 big-tile phases, on REACHER_BF16's fit
   buffer at full width (one K1 rollout without the V planes, the bf16
   value forwards, K2: 614,400 rows; minibatch 16384 in blocks of 4096,
   [10,256,256,1] for 370 steps and [10,256,256,2] for 148): the main path
   ppo.value_phase_fused(..., bf16=True) then policy_phase_fused(...,
   bf16=True), one cooperative launch each (the grid and the product route
   printed), with every launch counter read around it; then 185 + 185
   (74 + 74) steps in two launches against one bit for bit, two identical
   launches bit for bit, two steps against the plain version and the bf16
   generic phase at tests/test_bigmb.py's tolerances, each kernel's device
   time beside its plain version's and the generic phase's wall and device
   time; on each stream of BIGMB_SEEDS one step against the plain version
   summed in the kernel's order, leaf by leaf, with two controls that must
   fail the same check (the plain version with float32 cotangents, the
   generic bf16 phase), and the whole phase against the plain version and
   the generic phase by distance; a second value phase on the same buffer
   ending at a lower mean loss; a step's device time by grid size.
23. K3, K4 and K6 as a replicated cluster: the three kinds' registers
   and spills from nvcc.log; a step's device time of K3 on [3,128,128,1]
   by cluster size (4, 8, 16) at minibatch 64, 256 and 2048 and of K6 on
   [4,128,128,2] at minibatch 256; K3 at the
   fused gate's edge (20 steps x 2048 rows drawn from the bench's value
   rows) as the bench's phases are held (its whole phase's distance
   printed only), timed beside the plain version and the generic phases
   (ppo.value_phase past the gate) on the same rows.
24. The rest of the single-device MLP family, one epoch each through
   Trainer with every launch counter held to the path's
   (slice18_phases): STAB_BENCH and STAB_CARTPOLE (the five stabilisers:
   K1 with the V planes, K2, the generic phases through K5, no K3/K4/K6;
   the first fit's first value and policy steps against float64 beside
   the plain step, the clip switched off as a control that must fail;
   the first fit's target_kl freeze on the card and the CPU), the MoE
   example ("moe:0": no kernel; the mixture on 12,800 rows against
   float64, the top-2 gate; then "moe:2:bf16": K2 alone), AFFINE
   (calibrate(bench_config(0)): the env loop through K5, K2, K3, K4, no
   K1) and JNP (no kernel).
25. The recurrent family and the last sequence-trunk options
   (slice19_phases), each through Trainer with every launch counter read
   around it: RNN_RECALL (examples/recurrent_memory.py's GRU, up to 5
   epochs to R > 0.9, no kernel; the epoch-0 replay ratio over a fit),
   PENDULUM_PO_GRU at full width and CARTPOLE_PO_GRU (one fit each, no
   kernel; the BPTT gradient and the value planes of one minibatch
   against float64 on the card beside the CPU's float32), LSTM_RECALL
   (one epoch, the cell against float64), PO_STACK (pendulum_po_stack
   under "pallas": the env loop through K5, K2, K3, K4, no K1; K5's and
   K3/K4's rows at its widths), the critic->policy transplant on a GRU
   and an attention trainer, AUX_XL (recall_xl with the aux value head:
   K7 in the policy phase, the hidden plane through K7 against the plain
   core, the aux gradient) and SERVE_RNN (a GRU and an LSTM file served
   on the card, 200 steps against the CPU's cell).
26. The host actor, the sweeps and the tooling (slice20_phases), with
   every launch counter read around each run: HOST_SOLVE
   (HostTrainer(bench_config) on the C++ engine's pendulum, the device
   actor, "pallas": solve(-200, 40) through train(stop_at_R); a fit 200
   actor K5 forwards, 2 value-plane K5 forwards, K2, K3, K4, no K1; the
   first host fit's K5, K2, K3 and K4 against their plain versions, K3
   and K4 step by step against float64 as the bench's), HOST_OVERLAP
   (the host actor overlapped, 2 epochs: a fit 2 K5, K2, K3, K4, no actor
   launch; each window's stored log-probs those of the weights before the
   update it overlapped, bit for bit; the fit wall and device idle share
   serial against overlapped), HOST_CARTPOLE (one fit: K6 with K3 and K2
   on a host trajectory), HOST_SIDECAR (RunningObsNorm and
   RunningRewardNorm, save, serve.load_policy on the card against
   HostPolicy on the normalised observations, a fresh load restoring both
   statistics exactly), SWEEP (solve_many(bench_config(0), [0, 1, 2]):
   lane 0 equal to the same run's Trainer.solve bit for bit, each lane's
   K1-K4 and wall) and PROFILE / NAN (profiling.trace of a bench epoch
   naming K3's and K4's kernels; nan_guard over a bench fit, then over an
   update on observations with one NaN, which must raise).  No phase
   needs gymnasium.
27. The relief valves and the single-device examples (slice21_phases),
   with every launch counter read around each run: VALVES
   (bench_config against bench_config with fits_per_program=2, two
   epochs each: every param and Adam leaf, the metrics and the K1-K4
   launches equal; the committed recall_curriculum_1024_s0.bin against
   the same with fit_dispatch="phased" and rollout_chunk=256, one fit
   each: bit for bit, K7's three kernels alone and equal; the 8192 and
   16384 rungs built on the card with their own valves and
   check_kernel_fit), CURRICULUM (examples_torch/recall_xl_curriculum.py
   resuming the committed 512, 1024 and 2048 rungs in a temporary
   directory: each rung evaluated, R >= 0.9, exit 0, no launch, no file
   rewritten) and TRAIN_PENDULUM (examples_torch/train_pendulum.py at
   full size: solved, K1-K4 as the bench solve's, its ppo_model.bin
   reloaded to every leaf and an equal mean-policy evaluation).

Each phase's title line gives the seconds since the script started.
Any failed check raises, so the script exits non-zero.  The last two lines
are a JSON object of per-kernel results and the JSON status line.  Per
kernel: "ms" is the kernel's device time per call (CUDA events around
many calls queued behind a spin kernel), "plain_ms" the plain version's
device-kernel time per call (the profiler's kernel durations summed);
"bound_ms" is the least time the card could take for the same work, from
the H100 SXM's FP32 and memory peaks (the bf16 rows: its bf16 tensor-core
peak, and their bytes at 2 B a bf16 element);
"launches" come from the path's run: K1 counts its launches per lane and
per mode, with the V planes (training) and with the metrics (evaluation),
and per variant (``rollout[lane]``: the nets in shared memory;
``rollout_global[lane]``: in global memory), K3, K4, K6 and K5 per
variant (``value_phase``, ``value_phase_global``, ``mlp_forward``,
``mlp_forward_global``, ...);
K7's are read around each phase of the recall_xl run, so the value
pass's forwards (B 32) and the update phases' (B 4) are counted apart, and
per variant (``flash_*``, ``flash_*_bf16``).  A K1 launch without the V
planes (evaluation, and REACHER_BF16's training rollouts) counts under
"metrics".
For K7's backward kernels "plain_ms" is autograd through the plain
version with respect to the kernel's own inputs (q for dq, k and v for
dk/dv); for the bf16 rows it is the bf16 backward's plain version of
that kernel.  "library_ms" is scaled_dot_product_attention with the mask for
K7 (in bf16 for the bf16 rows; its backward with respect to the same
inputs for the backward kernels), else null: no single PyTorch call computes K1-K6's
functions.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
import warnings

SOLVE_R = -200.0
THROUGHPUT_EPOCHS = 4
# the discrete path's solve targets: Gymnasium's CartPole-v1 threshold, and
# the usual Acrobot-v1 one
DISCRETE_SOLVE_R = {"cartpole": 475.0, "acrobot": -100.0}
# a perturbed-logit gap below this is a near-tie: the kernel's logits and
# cuBLAS's differ by ~1e-6, so only there may the two samplers pick apart
NEAR_TIE = 1e-4
# name -> (CUDA source, the TPU kernel it replaces: its pallas_call)
KERNELS = {
    **{f"rollout{variant}[{lane}]": ("ppoc_tpu_torch/csrc/rollout.cu",
                                     "ppoc_tpu/ops/pallas_rollout.py:695")
       for variant in ("", "_global")
       for lane in ("pendulum", "simple", "cartpole", "mountain_car",
                    "mountain_car_norm", "acrobot", "reacher")},
    "gae_norm": ("ppoc_tpu_torch/csrc/gae.cu",
                 "ppoc_tpu/ops/pallas_gae.py:134"),
    "value_phase": ("ppoc_tpu_torch/csrc/update_cluster.cu",
                    "ppoc_tpu/ops/pallas_update.py:396"),
    "policy_phase": ("ppoc_tpu_torch/csrc/update_cluster.cu",
                     "ppoc_tpu/ops/pallas_update.py:749"),
    "policy_phase_categorical": ("ppoc_tpu_torch/csrc/update_cluster.cu",
                                 "ppoc_tpu/ops/pallas_update.py:944"),
    "value_phase_global": ("ppoc_tpu_torch/csrc/update_shard.cu",
                           "ppoc_tpu/ops/pallas_update.py:396"),
    "policy_phase_global": ("ppoc_tpu_torch/csrc/update_shard_policy.cu",
                            "ppoc_tpu/ops/pallas_update.py:749"),
    "policy_phase_categorical_global": (
        "ppoc_tpu_torch/csrc/update_shard_categorical.cu",
        "ppoc_tpu/ops/pallas_update.py:944"),
    "mlp_forward": ("ppoc_tpu_torch/csrc/mlp.cu",
                    "ppoc_tpu/ops/pallas_mlp.py:139"),
    "mlp_backward": ("ppoc_tpu_torch/csrc/mlp.cu",
                     "ppoc_tpu/ops/pallas_mlp.py:226"),
    "mlp_forward_global": ("ppoc_tpu_torch/csrc/mlp.cu",
                           "ppoc_tpu/ops/pallas_mlp.py:139"),
    "mlp_backward_global": ("ppoc_tpu_torch/csrc/mlp.cu",
                            "ppoc_tpu/ops/pallas_mlp.py:226"),
    "flash_fwd": ("ppoc_tpu_torch/csrc/attn.cu",
                  "ppoc_tpu/ops/pallas_attn.py:189"),
    "flash_bwd_dq": ("ppoc_tpu_torch/csrc/attn.cu",
                     "ppoc_tpu/ops/pallas_attn.py:335"),
    "flash_bwd_dkv": ("ppoc_tpu_torch/csrc/attn.cu",
                      "ppoc_tpu/ops/pallas_attn.py:352"),
    "flash_fwd_bf16": ("ppoc_tpu_torch/csrc/attn.cu",
                       "ppoc_tpu/ops/pallas_attn.py:189"),
    "flash_bwd_dq_bf16": ("ppoc_tpu_torch/csrc/attn.cu",
                          "ppoc_tpu/ops/pallas_attn.py:335"),
    "flash_bwd_dkv_bf16": ("ppoc_tpu_torch/csrc/attn.cu",
                           "ppoc_tpu/ops/pallas_attn.py:352"),
    "value_phase_bf16": ("ppoc_tpu_torch/csrc/update_bf16.cu",
                         "ppoc_tpu/ops/pallas_update.py:396"),
    "policy_phase_bf16": ("ppoc_tpu_torch/csrc/update_bf16.cu",
                          "ppoc_tpu/ops/pallas_update.py:749"),
}
# the loose whole-phase limits of check_phase: a kernel's distance from
# float64 over a 1% learning-rate error's, about 1.5x the largest reading
# of tools/policy_phase_drift.py over seeds and row draws (PERF.md); the
# 2x256 rows from its --hidden 256 256 readings (3 seeds x 2 draws each:
# K3 0.1025 on CARTPOLE_WIDE's rows, K4 0.5518, K6 0.1484)
WHOLE_RATIO = {"K3": 0.5, "K4": 0.5, "K6": 0.75,
               "K3 2x256": 0.16, "K4 2x256": 0.83, "K6 2x256": 0.23}
# check_phase's step-by-step limit: one kernel step against one float64
# step from the same state, beyond twice the plain float32 step's
# distance.  On ReLU nets a step this flags (K3, K4, K6) is held again,
# against the float64 steps with every decision that float32 rounding
# could flip taken either way (:func:`gate_band`): a ReLU gate or clip
# branch within GATE_SLACK times the float32 forward's largest error of
# its edge; at most MAX_ROW_FLIPS of them in one row (2**k evaluations of
# the row)
STEP_TOL = 2e-7
GATE_SLACK = 4
MAX_ROW_FLIPS = 10
# For the sharded cluster (K3, K4 and K6 in the "global" slot, whose sums
# run in another order than any other kernel's), gate_band(near_eps=True)
# also lets each gradient element near
# Adam's eps range over ROUND_SLACK times its float32 rounding bound (a
# first-order error analysis of its sums: a sum of n terms within n ulps
# of the sum of their magnitudes, in any order).  Near eps means Adam's
# sqrt(v_hat) at the float64 gradient within ROUND_NEAR times eps (at a
# first step, |g| within ROUND_NEAR eps; eps at least 3% of the step's
# denominator): there Adam turns a rounding of a gradient that cancels
# into a visible change of the step; elsewhere the band is the replicated
# K3/K4's own.  It has been needed on REACHER_REF's K4 rows at 1.16 eps,
# in a card test of [3,160,160,160,1] past 4 eps
# (tests/test_torch_step_walk.py), and in card tests of the sharded K6
# (tests/test_torch_cuda.py).  The replicated clusters are held without it
ROUND_SLACK = 2
ROUND_NEAR = 32
# the phases' signed lean (see LEAN_TOL): each layer's gradient (the first
# Adam moment of one step from zero moments) against the plain version's,
# pooled over the first LEAN_STEPS minibatches; the control moves the plain
# gradient LEAN_ULPS float32 ulps toward zero (a lean of ~6.6e-7), which
# the check must flag
LEAN_STEPS = 3
LEAN_ULPS = 8
# K5's lean check (check_mlp_lean), fixed before its first chip run.  RMS:
# 3xTF32 keeps 22 of a product's 24 bits (it drops a_small b_small and what
# each split rounds away, ~1.2 unit roundoffs of RMS a product on the CPU
# emulation, tests/test_torch_tf32.py), beside float32's own ~1-5 roundoffs
# of a sum of 8-16384 terms, so the kernel lands at 1-1.5x the plain
# version's RMS; 3 leaves room for cuBLAS summing some products (the long
# dW sums) in a more accurate order.  Lean: the tensor cores truncate each
# mma's sum toward zero; a k-step's three mmas start from zero, so that is
# under one ulp of an 8-term partial a step, about one float32 rounding of
# the result, at most the plain version's RMS; 2 x that RMS is the limit.
# Truncating into the running sum instead (the k-step's mma taking the
# accumulator) would lean by ~3 K/16 ulps of the sum, past the limit by 10x
# or more at K >= 128.  One-term TF32 drops ~13 bits: RMS ~5000 unit
# roundoffs (tests/test_torch_tf32.py), past 3x by far.
MLP_RMS_FACTOR = 3.0
MLP_LEAN_FACTOR = 2.0
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor cores,
# HBM3 bandwidth, dense TF32 on the tensor cores.  bound_ms keeps FP32 for
# every kernel, so the column compares across PRs; K5's rows (3xTF32
# products since PR 14) also print 3 x operations / PEAK_TF32.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12


T_START = time.perf_counter()


def header(text: str, **_) -> None:
    """A phase's title line, with the seconds since the script started."""
    print(f"{text} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def bound_ms(ops: float, nbytes: float):
    """(least ms, what sets it): the larger of operations over the FP32
    peak and bytes over the memory peak."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def products(widths) -> int:
    """Multiply-adds of one row through an MLP: sum of d_in * d_out."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def n_params(widths) -> int:
    return products(widths) + sum(widths[1:])


def rollout_bound(pwidths, vwidths, raw):
    """K1 on the trajectory ``raw`` it produced, with the V planes when
    ``vwidths`` is given, else with the metrics.  Forwards: the policy's
    T*E, and the value net's T*E for V(s), plus V(s') only where it is not
    the next step's V(s): the last step's E and each earlier done step (2
    FLOP per multiply-add).  Reads the nets, writes obs, next_obs (the
    lane's obs width), the action columns (float32, or one int32 class
    id), log_prob, reward (and V, V'), the two done planes (bytes), the
    final state and steps (and the three metrics rows)."""
    T, E, O = raw.obs.shape
    cols = O + O + raw.action.shape[-1] + 2
    ops = 2 * T * E * products(pwidths)
    nbytes = 4 * n_params(pwidths) + 4 * (raw.st_final.shape[1] + 1) * E
    if vwidths is None:
        nbytes += 4 * 3 * E
    else:
        inner_done = int((raw.terminated | raw.truncated)[:-1].sum())
        ops += 2 * (T * E + E + inner_done) * products(vwidths)
        nbytes += 4 * n_params(vwidths)
        cols += 2
    return bound_ms(ops, nbytes + T * E * (4 * cols + 2))


def gae_bound(T: int, E: int):
    """K2: reads r, V, V' (float32) and the two done planes, writes the
    advantages and targets; about 16 operations an element."""
    return bound_ms(16 * T * E, T * E * (4 * 3 + 2 + 4 * 2))


def phase_bound(widths, n_steps: int, mb: int, extra_cols: int):
    """K3/K4: per step the forward, dW/db and dX past layer 0 (2 FLOP per
    multiply-add) and ~12 operations an Adam parameter; reads each row
    once (d0 + extra_cols floats), reads and writes params and moments."""
    per_step = 2 * mb * (2 * products(widths) + products(widths[1:]))
    ops = n_steps * (per_step + 12 * n_params(widths))
    nbytes = 4 * (n_steps * mb * (widths[0] + extra_cols)
                  + 6 * n_params(widths))
    return bound_ms(ops, nbytes)


def mlp_bounds(widths, rows: int):
    """K5 forward (products; reads x and the params, writes out and the
    hidden post-activations) and backward with dX (dW/db and dX of every
    layer; reads x, the hiddens, the cotangent and params, writes the
    gradients and dX)."""
    hidden = sum(widths[1:-1])
    fwd = bound_ms(2 * rows * products(widths),
                   4 * (rows * (widths[0] + widths[-1] + hidden)
                        + n_params(widths)))
    bwd = bound_ms(4 * rows * products(widths),
                   4 * (rows * (2 * widths[0] + widths[-1] + hidden)
                        + 2 * n_params(widths)))
    return fwd, bwd


def bench_config(seed: int = 0):
    """bench.py's bench_config: pendulum, 64 envs x 200 steps, minibatch
    256, 4 fits per epoch, the fused kernels."""
    from ppoc_tpu_torch import PPOConfig

    return PPOConfig(env="pendulum", seed=seed, n_envs=64, rollout_len=200,
                     minibatch_size=256, fits_per_epoch=4, eval_envs=64,
                     eval_len=200, kernel_backend="pallas")


# the five stabilisers on top of bench_config: STAB_BENCH (pendulum) and
# STAB_CARTPOLE (cartpole, eval_len 500)
STAB = dict(max_grad_norm=0.5, clip_value=0.2, target_kl=0.02,
            lr_anneal=True, ent_anneal=True, ent_coeff=0.01)


def stab_config(seed: int = 0, env: str = "pendulum"):
    """bench_config with the five stabilisers (the generic phases: the
    fused gate refuses them)."""
    cfg = bench_config(seed).replace(env=env, **STAB)
    return cfg.replace(eval_len=500) if env == "cartpole" else cfg


def moe_config(seed: int = 0, **kw):
    """examples/moe_expert_parallel.py's single-device mixture: pendulum,
    64 envs x 200 steps, minibatch 256, 4 fits, 4 experts, dense gating,
    kernel_backend "pallas" (which a mixture runs as "moe:0")."""
    from ppoc_tpu_torch import PPOConfig

    return PPOConfig(env="pendulum", seed=seed, n_envs=64, rollout_len=200,
                     minibatch_size=256, fits_per_epoch=4, n_epochs=6,
                     eval_envs=64, n_experts=4,
                     kernel_backend="pallas").replace(**kw)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Milliseconds per call on the card (CUDA events), after a warm-up:
    what a caller waits, the host's launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, warm: bool = True) -> float:
    """Milliseconds of device-kernel time per call, after a warm-up (unless
    ``warm`` is false, for a function that just ran): the durations of
    every kernel the call launches, summed from torch.profiler's CUDA
    activity, read from the profiler's raw records.  Unlike timed_ms it
    leaves out the gaps in which the device waits for the host.  The raw
    records spare building the profiler's Python event list, whose cost
    grows with the records (a plain rollout launches ~100 kernels a step,
    so its long windows dominated the run's time, PERF.md); CPU activity
    is not recorded, as no reading here needs it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda)
    return ns / 1e6 / reps


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds per call of a hand kernel's wrapper, after a
    warm-up: the ``reps`` calls are queued behind a spin kernel
    (``torch.cuda._sleep``), so the device runs them back to back once it
    wakes, and CUDA events around them time the device alone, without the
    host's launch costs.  A call is one launch of the kernel (two for K5's
    backward) plus the wrapper's flatten of the weights."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000 + 1_000_000 * reps)   # ~0.5 ms a call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(kernel, plain, reps: int, plain_reps: int, warm: bool = True):
    """{"ms", "plain_ms"}: the kernel's device time per call
    (:func:`queued_ms`) and the plain version's device-kernel time per call
    (:func:`device_ms`; ``warm`` false: the plain version has just run).  The profiler does not time the hand kernels: on
    this card it dropped whole records of their launches, 1, 3 or 5 of 5
    in one window (PERF.md)."""
    return {"ms": queued_ms(kernel, reps),
            "plain_ms": device_ms(plain, plain_reps, warm)}


def rollout_timings(kernel, plain, reps: int, plain_reps: int,
                    warm: bool = True):
    """:func:`timings` of a K1 launch, with the envs a block ("tile") and
    the grid ("blocks") its timed launches took."""
    from ppoc_tpu_torch.ops import cuda_rollout

    out = timings(kernel, plain, reps, plain_reps, warm)
    launch = cuda_rollout.last_launch       # the kernel's last timed launch
    return dict(out, tile=launch["tile"], blocks=launch["blocks"])


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(name: str, err: float, tol: float, what: str = "max |diff|"
          ) -> float:
    print(f"  {name}: {what} {err:.3e} (tolerance {tol:.0e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err} exceeds {tol}")
    return err


def read_counts(counters):
    return {c.kernel: c.n for c in counters}


def check_on_card(tr) -> None:
    """Trainer(cfg) without a device must have chosen CUDA device 0."""
    import torch

    if tr.device != torch.device("cuda", 0):
        raise AssertionError(f"Trainer(cfg) chose {tr.device}, not cuda:0")


def count_diff(before, after):
    """The counters that moved, by how much."""
    return {k: after[k] - before[k] for k in before if after[k] != before[k]}


def check_rollout(cfg, ts, env, dev):
    """K1's pendulum lane at ``cfg``'s training shape with the V planes:
    exact RNG bits; the trajectory held to the plain physics by decoding
    each recorded obs and re-stepping it (robust to ulp drift in the
    transcendentals); log-probs and V planes held to the plain forward on
    the recorded obs; the first steps held to the plain version directly.
    Then at the evaluation shape (eval_envs x eval_len) with the metrics,
    held to the kernel's own trajectory.  Returns (trajectory, max abs
    error, timings) for each of the two modes."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.envs.pendulum import PendulumState
    from ppoc_tpu_torch.models import mlp, policy
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    E, T = cfg.n_envs, cfg.rollout_len
    lanes = torch.arange(E * 4, dtype=torch.int64, device=dev)
    for s0, s1, t, draw in [(0, 0, 0, 0), (0xDEADBEEF, 0x12345678, 7, 1),
                            (0xFFFFFFFF, 0x9E3779B9, cr.T_INIT, 50),
                            (123456789, 987654321, 199, 51)]:
        got = cr.rng_bits_cuda(s0, s1, t, draw, E * 4, dev)
        want = cr.rng_bits(s0, s1, t, draw, lanes)
        if not torch.equal(got, want):
            raise AssertionError(f"RNG bits differ at {(s0, s1, t, draw)}")
    print("  RNG bits: identical to the plain version", flush=True)

    pp, vp = ts.policy_params, ts.v_params
    seed = (0x01234567, 0x89ABCDEF)
    raw = cr.rollout_kernel(pp["mlp"], pp["log_std"], vp, seed, E, T)
    ref = cr.rollout_plain(pp["mlp"], pp["log_std"], vp, seed, E, T)
    torch.cuda.synchronize()
    errs = {}  # absolute errors
    errs["obs[0]"] = check("first obs (reset draws)",
                           max_err(raw.obs[0], ref.obs[0]), 1e-6)
    errs["early"] = check("steps 0-9 vs plain", max(
        max_err(raw.action[:10], ref.action[:10]),
        max_err(raw.next_obs[:10], ref.next_obs[:10])), 1e-4)
    # decode obs -> state, re-step the plain physics with the kernel's action
    th = torch.atan2(raw.obs[..., 1], raw.obs[..., 0]).reshape(-1)
    st = PendulumState(th, raw.obs[..., 2].reshape(-1),
                       torch.zeros_like(th, dtype=torch.int32))
    _, nobs, rew, _, _ = env.step(st, raw.action.reshape(-1, 1))
    errs["physics"] = check("next_obs vs re-stepped physics",
                            max_err(nobs.reshape(T, E, 3), raw.next_obs), 1e-4)
    errs["reward"] = check("reward vs re-stepped physics",
                           max_err(rew.reshape(T, E), raw.reward), 1e-3)
    mu = mlp.apply(pp["mlp"], raw.obs, "relu")
    lp = policy.gaussian_log_prob_from_mean(mu, pp["log_std"], raw.action)
    errs["log_prob"] = check("log_prob vs plain forward",
                             max_err(lp, raw.log_prob), 1e-4)
    errs["value"] = check("V(s), V(s') vs plain forward", max(
        max_err(mlp.apply(vp, raw.obs, "relu")[..., 0], raw.value),
        max_err(mlp.apply(vp, raw.next_obs, "relu")[..., 0],
                raw.next_value)), 1e-4)
    if not (torch.equal(raw.truncated, ref.truncated)
            and raw.truncated[T - 1].all() and not raw.terminated.any()):
        raise AssertionError("truncation flags differ from the plain version")
    eps = ((raw.action[..., 0] - mu[..., 0]) / torch.exp(pp["log_std"][0]))
    if abs(float(eps.mean())) > 0.03 or abs(float(eps.std()) - 1) > 0.03:
        raise AssertionError(f"sampling noise not N(0,1): {eps.mean()}, "
                             f"{eps.std()}")
    times = rollout_timings(
        lambda: cr.rollout_kernel(pp["mlp"], pp["log_std"], vp, seed, E, T),
        lambda: cr.rollout_plain(pp["mlp"], pp["log_std"], vp, seed, E, T),
        20, 1, warm=False)
    # metrics: the kernel's completed-episode sums vs its own trajectory
    margs = (pp["mlp"], pp["log_std"], None, seed, cfg.eval_envs,
             cfg.eval_len, "relu", None, None, env.spec.gamma)
    raw_m = cr.rollout_kernel(*margs)
    sum_r, sum_j, n_eps = raw_m.metrics.sum(dim=1)
    traj = ppo.Transition(raw_m.obs, raw_m.action, raw_m.log_prob,
                          raw_m.next_obs, raw_m.reward, raw_m.terminated,
                          raw_m.truncated)
    want = ppo.eval_metrics_from_traj(traj, env.spec.gamma)
    if float(n_eps) != float(want.episodes) or float(n_eps) < cfg.eval_envs:
        raise AssertionError(f"episode count {n_eps} vs {want.episodes}")
    m_err = check(f"{cfg.eval_envs} x {cfg.eval_len} with the metrics: R, J "
                  f"sums vs the trajectory (relative)", max(
                      abs(float(sum_r / n_eps - want.R)) / abs(float(want.R)),
                      abs(float(sum_j / n_eps - want.J)) / abs(float(want.J))),
                  1e-4)
    m_times = rollout_timings(lambda: cr.rollout_kernel(*margs),
                              lambda: cr.rollout_plain(*margs), 20, 1,
                              warm=False)
    return (raw, max(errs.values()), times), (raw_m, m_err, m_times)


def rollout_grid_times(ts, dev, E: int = 64, T: int = 200) -> dict:
    """A step's device time of K1's pendulum lane with the V planes on the
    bench nets at E x T, by forced tile (cuda_rollout.TILES): a launch of
    T steps less one of none, over the steps (queued_ms); the tile the
    launch takes by itself (cuda_rollout.tile_for) is marked.  Returns
    {tile: us a step}."""
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    pp, vp = ts.policy_params, ts.v_params
    out, row = {}, []
    cr.rollout_kernel(pp["mlp"], pp["log_std"], vp, (3, 4), E, 0)
    own = cr.last_launch["tile"]
    for tile in cr.TILES:
        ms = [queued_ms(lambda n=n: cr.rollout_kernel(
            pp["mlp"], pp["log_std"], vp, (3, 4), E, n, tile=tile), 5)
            for n in (0, T)]
        out[tile] = 1e3 * (ms[1] - ms[0]) / T
        row.append(f"{tile}{'*' if tile == own else ''} "
                   f"({-(-E // tile)} blocks): {out[tile]:.3f}")
    print(f"  K1 pendulum, V planes, {E} envs: us a step by tile ({T} steps "
          f"less none; * the launch's own): {', '.join(row)}", flush=True)
    return out


def check_gae(cfg, raw, dev):
    """K2 on the kernel rollout's planes, to about 1e-5."""
    from ppoc_tpu_torch.ops import cuda_gae

    trunc = raw.truncated.clone()
    trunc[-1] |= ~raw.terminated[-1]
    args = (raw.reward, raw.value, raw.next_value, raw.terminated, trunc,
            0.99, cfg.lam)
    adv, tgt = cuda_gae.gae_norm_kernel(*args)
    adv_p, tgt_p = cuda_gae.gae_norm_plain(*args)
    err = check("advantages", max_err(adv, adv_p), 1e-5)
    check("targets (relative)",
          max_err(tgt, tgt_p) / float(tgt_p.abs().max()), 1e-5)
    plan = cuda_gae.kernel_plan(*raw.reward.shape)
    if plan != cuda_gae.plan(*raw.reward.shape):
        raise AssertionError(f"K2's plan {plan} is not cuda_gae.plan's")
    print(f"  K2's plan: {plan.blocks} blocks of {plan.cols} env columns, "
          f"{plan.rows} steps a chunk, {plan.smem} B of shared memory a "
          f"block", flush=True)
    times = timings(lambda: cuda_gae.gae_norm_kernel(*args),
                    lambda: cuda_gae.gae_norm_plain(*args), 50, 3)
    # record() prints a "tile (blocks)": here the columns a block
    return adv, tgt, err, dict(times, tile=plan.cols, blocks=plan.blocks)


def phase_rows(cfg, raw, adv, tgt, dev, draw_seed: int = 1):
    """One fit's pre-gathered rows, in stream order: the value phase's
    (obs, target) and the policy phase's (obs, action, log_prob, adv)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer

    traj = ppo.Transition(raw.obs, raw.action, raw.log_prob, raw.next_obs,
                          raw.reward, raw.terminated, raw.truncated)
    buf = buffer.from_rollout(traj, adv, tgt)
    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(draw_seed), dev)
    vcols = buffer.gather_mb((buf.obs, buf.target), draws.value_idx)
    pcols = buffer.gather_mb(
        (buf.obs, buf.action, buf.log_prob, buf.advantage), draws.policy_idx)
    return vcols, pcols


def to_double(tree):
    """A copy of a tensor tree (lists, tuples, AdamStates) with its float
    tensors in float64 (integer tensors, the class ids, stay as they
    are)."""
    import torch

    from ppoc_tpu_torch.ops.adam import AdamState

    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, AdamState):
        return AdamState(to_double(tree.m), to_double(tree.v), tree.t)
    return type(tree)(to_double(x) for x in tree)


def check_phases(cfg, ts, raw, adv, tgt, dev):
    """K3 and K4 against their plain versions, as :func:`check_phase`
    holds them; K3's whole phase also within 2e-4 of the plain version's
    (no ReLU gate flips on these rows); K4's signed lean
    (:func:`phase_lean`)."""
    from ppoc_tpu_torch.ops import cuda_update as cu

    vcols, pcols = phase_rows(cfg, raw, adv, tgt, dev)
    pol = ts.policy_params
    return check_value_phase(cfg, ts, vcols, whole_tol=2e-4,
                             whole_stats_tol=1e-5), check_phase(
        "policy phase", cu.policy_phase_kernel, cu.policy_phase_plain,
        (pol["mlp"], pol["log_std"], ts.opt_policy, ts.opt_log_std), pcols,
        cfg, cfg.lr_policy, [(cfg.clip_eps, cfg.ent_coeff),
                             (cfg.clip_eps, 0.01)], WHOLE_RATIO["K4"],
        lean=True)


def check_value_phase(cfg, ts, vcols, **whole):
    """K3 on one fit's pre-gathered value rows ``vcols``, as
    :func:`check_phase` holds it."""
    from ppoc_tpu_torch.ops import cuda_update as cu

    return check_phase("value phase", cu.value_phase_kernel,
                       cu.value_phase_plain, (ts.v_params, ts.opt_v), vcols,
                       cfg, cfg.lr_v, [()], WHOLE_RATIO["K3"], **whole)


def check_phase(label, kernel, plain, state, cols, cfg, lr, extras,
                whole_ratio, whole_tol=None, whole_stats_tol=1e-4,
                lean=False):
    """A whole update phase kernel against its plain version on one fit's
    pre-gathered rows ``cols``; returns (max abs error, timings).  K3:
    ``state`` = (params, Adam) and ``extras`` [()]; K4: (params, log_std,
    Adam, log_std Adam) and K6: (params, Adam), each with ``extras``
    [(clip_eps, the path's ent_coeff), (clip_eps, 0.01)].

    The launch plan of the kernel's cluster is printed
    (:func:`cluster_line`).  One step is held at 1e-6 and 20 steps at
    1e-4, with each of ``extras``, the loss (and entropy) alike, relative
    where above 1.  The sharded cluster (the net past the replicated
    cluster's shared memory) sums in an order of its own, and one step of
    it past 1e-6 is held again, to
    STEP_TOL, as the walk below holds a flagged
    step, with the float64 steps also taking each gradient element near
    Adam's eps over its float32 rounding either way (:func:`gate_band`,
    ``near_eps``; the element that fails the 1e-6 check is printed with
    its gradient and its band); the float64 step with lr +1% must fail
    that hold.  A
    whole phase cannot be held tightly: float32 rounding alone, in the
    plain version or in one rounding of the starting weights under
    float64, flips ReLU gates and clip branches and moves its end by up to
    0.45 of what a 1% learning-rate error does (PERF.md).  So it is held
    two ways.  Tightly, step by step: the phase is walked one launch per
    step from the kernel's own state, each step must agree with one
    float64 step from that state to STEP_TOL (a 1% learning-rate error
    moves one step by about 3e-6) beyond twice the distance of one plain
    float32 step from that state (on a step where a row lies within
    rounding of a ReLU gate, any float32 step parts from float64, by up to
    1.3e-5), and the chained launches must equal the single launch bit for
    bit.  On ReLU nets a step this flags, and step 0, are held again,
    against the float64 steps with the gates and clip branches (K4, K6)
    within rounding taken either way (:func:`gate_band`), and
    there the float64 step with the learning rate 1% high must fail that
    hold (the sharded cluster's band with ``near_eps``).  A flagged step
    is printed at the weight farthest outside the band
    (:func:`band_reading`).
    Loosely, as a
    whole: the kernel's distance from float64 (L2) must stay under
    ``whole_ratio`` times the distance of the 1% learning-rate run
    (WHOLE_RATIO; ``None``: printed only, for rows that have no reading to
    set it from), its loss (and entropy) within ``whole_stats_tol`` of the
    plain version's and, with ``whole_tol``, its weights within that of
    the plain version's.  The whole-phase verdict comes last, after the
    step-by-step one.  ``lean``: also the signed lean of one step's
    gradient (:func:`phase_lean`)."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import _build, cuda_update as cu

    mb = cfg.minibatch_size
    n_p = cols[0].shape[0] // mb
    ns = len(state)
    kind = {cu.value_phase_kernel: "value",
            cu.policy_phase_kernel: "policy",
            cu.policy_phase_categorical_kernel: "categorical policy"}[kernel]
    widths = mlp.dims(state[0])
    sharded = (cu.variant_bytes(widths)[0]
               > _build.smem_optin(cols[0].device))
    cluster_line(label, kind, widths, mb, cols[0].device, sharded)
    near = sharded   # gate_band's near_eps
    hp = cu.Hyper.of(lr, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps)
    h_lr = cu.Hyper.of(1.01 * lr, cfg.adam_beta1, cfg.adam_beta2,
                       cfg.adam_eps)

    def weights(out):
        return trained(out, ns)

    def run(fn, n, extra=extras[0], hyper=hp, cast=lambda x: x, st=state,
            s=0):
        return fn(*(cast(c[s * mb:(s + n) * mb]) for c in cols),
                  *cast(st), n, mb, cfg.activation, hyper, *extra)

    def stats_err(a, b):
        """The loss (and entropy) apart, relative where above 1."""
        return max(abs(float(x - y)) / max(1.0, abs(float(y)))
                   for x, y in zip(a[ns:], b[ns:]))

    stats = "loss, entropy" if extras[0] else "loss"
    banded = cfg.activation == "relu"

    def held_at_gates(st, s, k1, own, extra=extras[0]):
        """The kernel step's and the lr +1% float64 step's distance
        outside :func:`gate_band` at step ``s``, each beyond twice the
        plain float32 step's ``own``, and the decisions within rounding."""
        band, n_near = gate_band(
            st, [c[s * mb:(s + 1) * mb] for c in cols], hp, extra, near)
        own = outside(weights(own), band)
        fault = run(plain, 1, extra, cast=to_double, hyper=h_lr, st=st, s=s)
        return (outside(weights(k1), band) - 2 * own,
                outside(weights(fault), band) - 2 * own, n_near)

    def held_near_eps(what, tol, k, pl, extra):
        """The sharded cluster's one step ``k`` past ``tol`` from the plain
        step ``pl``: printed at the weight farthest outside the band
        (:func:`band_reading`), then held to STEP_TOL beyond twice the
        plain step's distance outside the band with ``near_eps``, where the
        lr +1% float64 step must not be held."""
        reading = band_reading(state, [c[:mb] for c in cols], hp, extra, k,
                               pl, run(plain, 1, extra, cast=to_double))
        excess, fault, n_near = held_at_gates(state, 0, k, pl, extra)
        print(f"  {what}: {max_err(weights(k), weights(pl)):.3e} from the "
              f"plain step; {reading}; {n_near} decisions within rounding; "
              f"beyond twice the plain step's, the kernel {excess:.3e} "
              f"outside that band, the float64 step with lr +1% "
              f"{fault:.3e} (must exceed {STEP_TOL:.0e})", flush=True)
        if not fault > STEP_TOL:
            raise AssertionError(f"{what}: the float64 step with lr +1% "
                                 f"lies within {STEP_TOL} of the band "
                                 f"({fault}): no yardstick")
        return check(f"{what}: weights beyond twice the plain step's "
                     f"distance outside the float64 band with the rounding "
                     f"near eps", excess, STEP_TOL, what="max excess")

    p_err = 0.0
    for n, tol in ((1, 1e-6), (20, 1e-4)):
        for extra in extras:
            k, pl = run(kernel, n, extra), run(plain, n, extra)
            what = f"{label}, {n} steps" + (
                f", ent_coeff {extra[1]}" if extra else "")
            err = max_err(weights(k), weights(pl))
            if n == 1 and near and banded and err > tol:
                p_err = max(p_err, held_near_eps(what, tol, k, pl, extra))
            else:
                p_err = max(p_err, check(f"{what}: weights", err, tol))
            check(f"{what}: {stats}", stats_err(k, pl), tol)
    if lean:
        phase_lean(label, run, kernel, plain, state)
    k, pl = run(kernel, n_p), run(plain, n_p)
    if whole_tol is not None:
        check(f"{label}, {n_p} steps: weights", max_err(weights(k),
                                                         weights(pl)),
              whole_tol)
    exact = run(plain, n_p, cast=to_double)
    lr_fault = run(plain, n_p, cast=to_double, hyper=h_lr)
    w0, wx = weights(state).double(), weights(exact)
    travel = float((wx - w0).norm())

    def dist(r):
        return float((weights(r).double() - wx).norm()) / travel

    d_k, d_p, d_lr = dist(k), dist(pl), dist(lr_fault)
    print(f"  {label}, {n_p} steps, |run - float64| / |travel| (L2): "
          f"kernel {d_k:.4f}, plain float32 {d_p:.4f}, float64 with lr "
          f"+1% {d_lr:.4f}; max |kernel - float64| "
          f"{max_err(weights(k), wx):.3e}, max |plain - float64| "
          f"{max_err(weights(pl), wx):.3e}", flush=True)
    p_err = max(p_err, max_err(weights(k), weights(pl)))

    def step_err(a, b):
        return max_err(weights(a), weights(b))

    lr_step = step_err(run(plain, 1, cast=to_double),
                       run(plain, 1, cast=to_double, hyper=h_lr))
    print(f"  {label}, step 0: a 1% learning-rate error moves the weights "
          f"by {lr_step:.3e}", flush=True)

    local, held, st = [], [], state   # (kernel, plain step errors, excess)
    for s in range(n_p):
        k1 = run(kernel, 1, st=st, s=s)[:ns]
        x1 = run(plain, 1, cast=to_double, st=st, s=s)
        p1 = run(plain, 1, st=st, s=s)
        err, own = step_err(k1, x1), step_err(p1, x1)
        excess = err - 2 * own
        if banded and (s == 0 or excess > STEP_TOL):
            at_gates, fault, n_near = held_at_gates(st, s, k1, p1)
            held.append((s, n_near, excess, at_gates, fault))
            if excess > STEP_TOL:
                print(f"  {label}, step {s}: " + band_reading(
                    st, [c[s * mb:(s + 1) * mb] for c in cols], hp,
                    extras[0], k1, p1, x1), flush=True)
            excess = min(excess, at_gates)
        local.append((err, own, excess))
        st = k1
    errs = sorted(e for e, _, _ in local)
    over = [(e, p) for e, p, _ in local if e > STEP_TOL]
    print(f"  {label}: one step from the kernel's state vs float64: median "
          f"{errs[n_p // 2]:.3e}, max {errs[-1]:.3e}; {len(over)} of {n_p} "
          f"steps over {STEP_TOL:.0e}, where the plain float32 step is off "
          f"by {[f'{p:.3e}' for _, p in over]}", flush=True)
    for s, n_near, excess, at_gates, fault in held:
        print(f"  {label}, step {s}: {n_near} decisions within rounding; "
              f"beyond twice the plain float32 step's, the kernel step's "
              f"distance from float64 {excess:.3e}, from the float64 steps "
              f"with those either way {at_gates:.3e}; the float64 "
              f"step with lr +1%'s from them {fault:.3e} (must exceed "
              f"{STEP_TOL:.0e})", flush=True)
        if not fault > STEP_TOL:
            raise AssertionError(
                f"{label}, step {s}: the float64 step with lr +1% lies "
                f"within {STEP_TOL} of the float64 steps with the "
                f"decisions within rounding either way ({fault}): no "
                f"yardstick")
    p_err = max(p_err, errs[-1])
    check(f"{label}, each of {n_p} steps from the kernel's state vs one "
          f"float64 step, beyond twice the plain float32 step's distance"
          + (" (or from the float64 steps with the decisions within "
             "rounding" + (" and the gradient's rounding near eps"
                           if near else "") + " either way)"
             if banded else ""),
          max(x for _, _, x in local), STEP_TOL, what="max excess")
    if not torch.equal(weights(st), weights(k)):
        raise AssertionError(f"{label}: {n_p} chained one-step launches "
                             f"differ from one {n_p}-step launch")
    print(f"  {label}: {n_p} chained one-step launches equal one "
          f"{n_p}-step launch bit for bit", flush=True)
    if whole_ratio is not None:
        check(f"{label}, {n_p} steps: kernel's distance from float64 over "
              f"the lr +1% run's", d_k / d_lr, whole_ratio, what="ratio")
    check(f"{label}, {n_p} steps: {stats}", stats_err(k, pl),
          whole_stats_tol)
    return p_err, timings(lambda: run(kernel, n_p), lambda: run(plain, n_p),
                          5, 1)


def trained(out, ns):
    """The trained tensors of a phase's first ``ns`` outputs (its state)
    as one float tensor: the net, flattened, and log_std."""
    import torch

    from ppoc_tpu_torch.models import mlp

    return torch.cat([mlp.flatten(out[0])] + [
        x.reshape(-1) for x in out[1:ns] if isinstance(x, torch.Tensor)])


def band_reading(state, rows, hyper, extra, k, pl, x1) -> str:
    """Where the step ``k`` of one K3, K4 or K6 minibatch ``rows`` from
    ``state`` lies farthest outside the float64 band without the rounding
    near eps (:func:`gate_band`), as a line of text: the weight's index,
    its float64 gradient (from the first Adam moment of ``x1``, the
    float64 step), Adam's sqrt(v_hat) there in eps, the kernel's, the
    plain step ``pl``'s and float64's weight, and the band there without
    and with the gradient's rounding near eps."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    ns = len(state)
    band, _ = gate_band(state, rows, hyper, extra)
    wide, _ = gate_band(state, rows, hyper, extra, True)
    wk = trained(k, ns).double()
    i = int(torch.maximum(band[0] - wk, wk - band[1]).argmax())

    def moment(out, which):
        return torch.cat([
            getattr(o, which).reshape(-1)
            if isinstance(getattr(o, which), torch.Tensor)
            else mlp.flatten(getattr(o, which))
            for o in out[ns // 2:ns]]).double()

    g = (moment(x1, "m") - hyper.b1 * moment(state, "m")) / hyper.omb1
    t = (state[ns // 2].t if i < mlp.flatten(state[0]).numel()
         else state[ns - 1].t)
    v_hat = float(moment(x1, "v")[i]) / cu._bias_corrections(t + 1,
                                                              hyper)[1]
    return (f"at element {i}, farthest outside the float64 band: float64 "
            f"gradient {float(g[i]):.4e}, Adam's sqrt(v_hat) "
            f"{math.sqrt(v_hat) / hyper.eps:.2f} eps (rounding taken within "
            f"{ROUND_NEAR}); weight kernel {float(wk[i]):.9e}, plain "
            f"{float(trained(pl, ns)[i]):.9e}, float64 "
            f"{float(trained(x1, ns)[i]):.9e}, band "
            f"[{float(band[0][i]):.9e}, {float(band[1][i]):.9e}], with the "
            f"gradient's rounding [{float(wide[0][i]):.9e}, "
            f"{float(wide[1][i]):.9e}]")


def gate_band(state, rows, hyper, extra=(), near_eps=False):
    """The float64 step of one K3, K4 or K6 minibatch from ``state``, with
    every decision within float32 rounding taken either way: ((lowest,
    highest) of each weight over those steps, flattened as
    ``check_phase``'s weights, in float64; the number of such decisions).
    K3: ``state`` (ReLU net, Adam), ``rows`` (obs, targets); K4: ``state``
    (net, log_std, Adam, log_std's Adam), ``rows`` (obs, actions, old
    log-probs, advantages), ``extra`` (clip_eps, ent_coeff); K6: ``state``
    (net, Adam), ``rows`` (obs, int32 class ids, old log-probs,
    advantages), ``extra`` (clip_eps, ent_coeff); as the plain versions
    take them.

    A decision is a ReLU gate whose float64 pre-activation lies within
    GATE_SLACK times the largest error of the float32 forward in its
    layer, and in K4 and K6 a row's clip branch (ra <= ca) whose float64
    ratio lies within GATE_SLACK times the float32 ratios' largest error
    of a clip edge.  A
    row's decisions are taken every way together (2**k evaluations of its
    gradient); rows add to the gradient independently, so each gradient
    element ranges over its base value plus the sum of the rows' ranges.
    With ``near_eps`` (the checks of the sharded cluster), each
    gradient element at which Adam's sqrt(v_hat) lies within ROUND_NEAR
    times eps also ranges over ROUND_SLACK times its float32 rounding
    bound (:func:`rounding`): any order of its sums lies inside.  Each
    weight's step is a function of its own gradient element alone with one
    turning point, so its range is that of the step at both ends, at the
    base and at the turning point where it lies between them."""
    import itertools

    import torch

    from ppoc_tpu_torch.ops import cuda_update as cu

    policy = len(state) == 4
    categorical = not policy and len(rows) == 4
    params, opts = state[0], state[2:] if policy else state[1:]
    W = [w.double() for w, _ in params]
    B = [b.double() for _, b in params]
    L, mb = len(params), rows[0].shape[0]
    cols = [c.double() for c in rows]
    x = cols[0]

    def forward(ws, bs, h):
        """The hidden layers' pre-activations, and the output."""
        zs = []
        for w, b in zip(ws[:-1], bs[:-1]):
            zs.append(h @ w + b)
            h = torch.relu(zs[-1])
        return zs, h @ ws[-1] + bs[-1]

    def apart(a, b):
        return float((a - b.double()).abs().max())

    z64, y64 = forward(W, B, x)
    z32, y32 = forward([w for w, _ in params], [b for _, b in params],
                       rows[0])
    near = [z.abs() <= GATE_SLACK * apart(z, y) for z, y in zip(z64, z32)]
    if policy:
        ls = state[1].double()
        clip_eps, ent_coeff = extra
        lp0 = -0.5 * ls.shape[0] * math.log(2 * math.pi)

        def ratio(mu, log_std, act, lp):
            z = (act - mu) * torch.exp(-log_std)
            return torch.exp(lp0 - log_std.sum() - 0.5 * (z * z).sum(dim=1)
                             - lp), z

        r64 = ratio(y64, ls, cols[1], cols[2])[0]
        r32 = ratio(y32, state[1], rows[1], rows[2])[0]
        to_edge = torch.minimum((r64 - (1 - clip_eps)).abs(),
                                (r64 - (1 + clip_eps)).abs())
        near_clip = to_edge <= GATE_SLACK * apart(r64, r32)
        clip = (r64 * cols[3]
                <= torch.clamp(r64, 1 - clip_eps, 1 + clip_eps) * cols[3])
    elif categorical:
        clip_eps, ent_coeff = extra
        cls = rows[1].reshape(-1).long()

        def cat_ratio(y, c, lp):
            """The ratio of the classes ``c``, and the log-softmax of
            ``y``."""
            lpa = torch.log_softmax(y, dim=1)
            return torch.exp(lpa.gather(1, c[:, None])[:, 0] - lp), lpa

        r64 = cat_ratio(y64, cls, cols[2])[0]
        r32 = cat_ratio(y32, cls, rows[2])[0]
        to_edge = torch.minimum((r64 - (1 - clip_eps)).abs(),
                                (r64 - (1 + clip_eps)).abs())
        near_clip = to_edge <= GATE_SLACK * apart(r64, r32)
        clip = (r64 * cols[3]
                <= torch.clamp(r64, 1 - clip_eps, 1 + clip_eps) * cols[3])
    else:
        near_clip = torch.zeros(mb, dtype=torch.bool, device=x.device)
        clip = None

    def grad(i, masks, unclipped):
        """The flat float64 gradient of the rows ``i`` with the hidden
        gates ``masks`` and (K4, K6) the unclipped branches ``unclipped``,
        as the plain version's loss over ``mb`` rows gives it."""
        hs, h = [], x[i]
        for l in range(L - 1):
            h = torch.where(masks[l], h @ W[l] + B[l], 0.0)
            hs.append(h)
        y = h @ W[-1] + B[-1]
        if policy:
            r, z = ratio(y, ls, cols[1][i], cols[2][i])
            dlogp = -(cols[3][i] * r / mb) * unclipped
            g = dlogp[:, None] * z * torch.exp(-ls)
            tail = [(dlogp[:, None] * (z * z - 1.0)).sum(dim=0)]
        elif categorical:
            r, lpa = cat_ratio(y, cls[i], cols[2][i])
            p = torch.exp(lpa)
            H = -(p * lpa).sum(dim=1, keepdim=True)
            onehot = torch.nn.functional.one_hot(cls[i], y.shape[1]).to(
                y.dtype)
            dlogp = -(cols[3][i] * r / mb) * unclipped
            g = (dlogp[:, None] * (onehot - p)
                 + (ent_coeff / mb) * p * (lpa + H))
            tail = []
        else:
            g = (2.0 / mb) * (y[:, 0] - cols[1][i])[:, None]
            tail = []
        out = [None] * (2 * L)
        for l in range(L - 1, -1, -1):
            out[2 * l] = (x[i] if l == 0 else hs[l - 1]).T @ g
            out[2 * l + 1] = g.sum(dim=0)
            if l > 0:
                g = (g @ W[l].T) * masks[l - 1]
        return torch.cat([o.reshape(-1) for o in out + tail])

    base = [z > 0 for z in z64]
    g0 = grad(slice(None), base, clip)
    if policy:
        g0[-ls.shape[0]:] -= ent_coeff
    lo, hi = torch.zeros_like(g0), torch.zeros_like(g0)
    n_near = 0
    for r in torch.cat([m.any(dim=1).nonzero()[:, 0] for m in near]
                       + [near_clip.nonzero()[:, 0]]).unique().tolist():
        flips = [(l, u) for l in range(L - 1)
                 for u in near[l][r].nonzero()[:, 0].tolist()]
        flips += [None] if bool(near_clip[r]) else []    # the clip branch
        if len(flips) > MAX_ROW_FLIPS:
            raise AssertionError(f"row {r}: {len(flips)} decisions within "
                                 f"rounding (at most {MAX_ROW_FLIPS})")
        n_near += len(flips)
        own = [m[r:r + 1] for m in base]
        own_clip = clip[r:r + 1] if clip is not None else None
        g_r = grad(slice(r, r + 1), own, own_clip)
        r_lo, r_hi = torch.zeros_like(g0), torch.zeros_like(g0)
        for which in itertools.product((False, True), repeat=len(flips)):
            masks, unclipped = [m.clone() for m in own], own_clip
            for at, f in zip(flips, which):
                if f and at is None:
                    unclipped = ~own_clip
                elif f:
                    masks[at[0]][0, at[1]] = ~masks[at[0]][0, at[1]]
            d = grad(slice(r, r + 1), masks, unclipped) - g_r
            r_lo, r_hi = torch.minimum(r_lo, d), torch.maximum(r_hi, d)
        lo, hi = lo + r_lo, hi + r_hi

    def flat(trees):
        """Each tree's tensors: a tensor (log_std, its moments) whole, a
        net's (W, b) pairs in order."""
        return [t.double().clone() for tree in trees for t in
                ([tree] if isinstance(tree, torch.Tensor) else
                 [x for pair in tree for x in pair])]

    P = flat([params] + ([state[1]] if policy else []))
    M, V = flat([o.m for o in opts]), flat([o.v for o in opts])
    split = len(P) - policy     # the net's tensors, then log_std's

    def step(g):
        p, m, v = ([t.clone() for t in ts] for ts in (P, M, V))
        gs = [d.view_as(t) for d, t in zip(g.split([t.numel() for t in p]),
                                           p)]
        for o, part in zip(opts, (slice(None, split), slice(split, None))):
            cu._adam_(p[part], gs[part], m[part], v[part], o.t + 1, hyper)
        return torch.cat([t.reshape(-1) for t in p])

    m = torch.cat([t.reshape(-1) for t in M])
    v = torch.cat([t.reshape(-1) for t in V])
    if near_eps:
        bc2 = torch.cat([torch.full((sum(t.numel() for t in P[part]),),
                                    cu._bias_corrections(o.t + 1, hyper)[1],
                                    dtype=g0.dtype, device=g0.device)
                         for o, part in zip(opts, (slice(None, split),
                                                   slice(split, None)))])
        v_hat = (hyper.b2 * v + hyper.omb2 * g0 * g0) / bc2
        bound = ROUND_SLACK * (rounding(
            W, B, x, cols, z64, y64, base, clip, mb,
            (ls, lp0, ratio) if policy else None,
            ent_coeff if categorical else None) + 2 * ULP * g0.abs())
        bound = torch.where(v_hat.sqrt() <= ROUND_NEAR * hyper.eps, bound,
                            0.0)
        lo, hi = lo - bound, hi + bound
    # Adam's step m'/sqrt(v') (eps aside) turns where the gradient is
    # (1 - b1) b2 v / (b1 (1 - b2) m)
    turn = torch.nan_to_num(hyper.omb1 * hyper.b2 * v
                            / (hyper.b1 * hyper.omb2 * m))
    turn = torch.minimum(torch.maximum(turn, g0 + lo), g0 + hi)
    steps = torch.stack([step(g0 + lo), step(g0 + hi), step(g0),
                         step(turn)])
    return (steps.min(dim=0).values, steps.max(dim=0).values), n_near


ULP = 2.0 ** -24   # float32's unit roundoff


def rounding(W, B, x, cols, z64, y64, masks, unclipped, mb, policy=None,
             categorical=None):
    """A first-order bound, in float64, on how far a float32 computation of
    one K3, K4 or K6 step's gradient can lie from the exact one, flattened
    as gate_band's gradient, for the float64 net ``W``, ``B`` on the rows
    ``cols`` (x first) with its pre-activations ``z64``, output ``y64``,
    ReLU gates ``masks`` and (K4, K6) unclipped rows ``unclipped``;
    ``policy`` (K4): (log_std, the log-prob's constant, gate_band's ratio);
    ``categorical`` (K6): the entropy coefficient.  Every sum of n terms in
    any order lies within n ulps of the sum of their magnitudes; errors
    carried from the inputs of a product add through its magnitudes; an
    exp or a log adds 2 ulps of its result."""
    import torch

    def gam(n):
        return n * ULP

    L = len(W)
    acts = [x] + [torch.relu(z) for z in z64]        # each layer's input
    err = [torch.zeros_like(x)]
    for l in range(L - 1):
        wa = W[l].abs()
        ez = err[l] @ wa + gam(wa.shape[0] + 1) * (acts[l].abs() @ wa
                                                   + B[l].abs())
        err.append(ez * masks[l])
    wa = W[-1].abs()
    ey = err[-1] @ wa + gam(wa.shape[0] + 1) * (acts[-1].abs() @ wa
                                                + B[-1].abs())
    if policy:
        ls, lp0, ratio = policy
        r, z = ratio(y64, ls, cols[1], cols[2])
        s = torch.exp(-ls)
        ez = ey * s + 2 * ULP * z.abs()
        elogp = (z.abs() * ez).sum(dim=1) + gam(z.shape[1] + 3) * (
            abs(lp0) + ls.abs().sum() + (z * z).sum(dim=1))
        dlogp = -(cols[3] * r / mb) * unclipped
        edl = dlogp.abs() * (elogp + 4 * ULP)
        g = dlogp[:, None] * z * s
        eg = (edl[:, None] * z.abs() + dlogp.abs()[:, None] * ez) * s + (
            3 * ULP * g.abs())
        zz = (z * z - 1.0).abs()
        tail = [(edl[:, None] * zz + dlogp.abs()[:, None] * 2 * z.abs() * ez
                 ).sum(dim=0) + gam(mb) * (dlogp.abs()[:, None] * zz)
                .sum(dim=0)]
    elif categorical is not None:
        K = y64.shape[1]
        lpa = torch.log_softmax(y64, dim=1)
        p = torch.exp(lpa)
        zmax = y64.max(dim=1, keepdim=True).values
        lse = y64[:, :1] - lpa[:, :1]
        # the log-sum-exp moves by at most its inputs' largest move; its K
        # exps, their sum, the log and the add round
        e_lse = (ey.max(dim=1, keepdim=True).values + gam(K + 4)
                 + gam(2) * (zmax.abs() + lse.abs()))
        elpa = ey + e_lse + ULP * lpa.abs()
        ep = p * (elpa + gam(2))
        onehot = torch.nn.functional.one_hot(
            cols[1].reshape(-1).long(), K).to(y64.dtype)
        logp, elogp = (onehot * lpa).sum(dim=1), (onehot * elpa).sum(dim=1)
        H = -(p * lpa).sum(dim=1, keepdim=True)
        eH = ((ep * lpa.abs() + p * elpa).sum(dim=1, keepdim=True)
              + gam(K + 1) * (p * lpa).abs().sum(dim=1, keepdim=True))
        r = torch.exp(logp - cols[2])
        dlogp = -(cols[3] * r / mb) * unclipped
        edl = dlogp.abs() * (elogp + gam(2) * (logp.abs() + cols[2].abs())
                             + gam(5))
        c = categorical / mb
        t1 = dlogp[:, None] * (onehot - p)
        t2 = c * p * (lpa + H)
        g = t1 + t2
        eg = (edl[:, None] * (onehot - p).abs() + dlogp.abs()[:, None] * ep
              + c * (ep * (lpa + H).abs() + p * (elpa + eH))
              + gam(6) * (t1.abs() + t2.abs()))
        tail = []
    else:
        g = (2.0 / mb) * (y64[:, 0] - cols[1])[:, None]
        eg = (2.0 / mb) * ey + 2 * ULP * g.abs()
        tail = []
    out = [None] * (2 * L)
    ga = g.abs()
    for l in range(L - 1, -1, -1):
        a = acts[l].abs()
        out[2 * l] = a.T @ eg + err[l].T @ ga + gam(mb) * (a.T @ ga)
        out[2 * l + 1] = eg.sum(dim=0) + gam(mb) * ga.sum(dim=0)
        if l > 0:
            wa = W[l].abs()
            eg = (eg @ wa.T + gam(wa.shape[1]) * (ga @ wa.T)) * masks[l - 1]
            ga = (ga @ wa.T) * masks[l - 1]
    return torch.cat([o.reshape(-1) for o in out + tail])


def outside(w, band) -> float:
    """How far the weights ``w`` lie outside ``band`` (lowest, highest),
    at most over the elements."""
    import torch

    lo, hi = band
    w = w.double()
    return float(torch.maximum(lo - w, w - hi).clamp_min(0).max())


def phase_lean(label, run, kernel, plain, state):
    """The signed lean (see LEAN_TOL) of one phase step's gradient against
    the plain version's: from zero Adam moments the step's first moment is
    (1 - beta1) times the gradient, so per layer (W and b together)
    sum((m_kernel - m_plain) * sign(m_plain)) / sum(|m_plain|), pooled over
    the first LEAN_STEPS minibatches of the rows; below zero is toward
    zero.  The kernel's largest |lean| must stay within LEAN_TOL; the
    control, the plain gradient moved LEAN_ULPS ulps toward zero, must
    lean past it.  Printed beside: the kernel's and the plain version's
    lean against the float64 step's gradient, which shows which side a
    reading comes from (the plain version's float32 forward leans K4's
    2x256 cotangent by ~1.5e-7, PERF.md).  ``run``: check_phase's
    launcher."""
    import torch

    from ppoc_tpu_torch.ops import adam
    from ppoc_tpu_torch.ops.adam import AdamState

    fresh = tuple(adam.init(x.m) if isinstance(x, AdamState) else x
                  for x in state)
    i = next(j for j, x in enumerate(state)
             if isinstance(x, AdamState) and isinstance(x.m, list))
    L = len(state[0])
    num = {k: [0.0] * L for k in ("kernel", "control", "kernel, float64",
                                   "plain, float64")}
    den = {k: [0.0] * L for k in ("plain", "float64")}
    for s in range(LEAN_STEPS):
        mk = run(kernel, 1, st=fresh, s=s)[i].m
        mp = run(plain, 1, st=fresh, s=s)[i].m
        mx = run(plain, 1, cast=to_double, st=fresh, s=s)[i].m
        for l in range(L):
            b = torch.cat([x.reshape(-1) for x in mp[l]])
            a = torch.cat([x.reshape(-1) for x in mk[l]])
            x = torch.cat([t.reshape(-1) for t in mx[l]])
            c = b.clone()
            for _ in range(LEAN_ULPS):
                c = torch.nextafter(c, torch.zeros_like(c))
            sign, sign_x = b.double().sign(), x.sign()
            den["plain"][l] += float(b.double().abs().sum())
            den["float64"][l] += float(x.abs().sum())
            for key, got, want, sg in (
                    ("kernel", a, b, sign), ("control", c, b, sign),
                    ("kernel, float64", a, x, sign_x),
                    ("plain, float64", b, x, sign_x)):
                num[key][l] += float(((got.double() - want.double()) * sg)
                                     .sum())
    leans = {k: [n / d for n, d in zip(v, den["float64" if "float64" in k
                                                else "plain"])]
             for k, v in num.items()}
    print(f"  {label}: one step's gradient, lean by layer pooled over "
          f"{LEAN_STEPS} minibatches: kernel "
          + ", ".join(f"{x:+.3e}" for x in leans["kernel"])
          + f" (|lean| at most {LEAN_TOL:.1e}); control ({LEAN_ULPS} ulps "
          f"toward zero) " + ", ".join(f"{x:+.3e}" for x in leans["control"])
          + "; against float64: kernel " + ", ".join(
              f"{x:+.3e}" for x in leans["kernel, float64"])
          + ", plain " + ", ".join(
              f"{x:+.3e}" for x in leans["plain, float64"]), flush=True)
    if not max(abs(x) for x in leans["kernel"]) <= LEAN_TOL:
        raise AssertionError(f"{label}: the kernel's gradient leans "
                             f"{leans['kernel']}")
    if not min(abs(x) for x in leans["control"]) > LEAN_TOL:
        raise AssertionError(f"{label}: the lean check passes a gradient "
                             f"{LEAN_ULPS} ulps toward zero: "
                             f"{leans['control']}")
    print(f"  {label}: the control fails the lean check, as it must",
          flush=True)


def check_mlp(params, x, activation: str, dev):
    """K5 at one batch of the path: forward (output and saved hiddens) and
    backward (dW, db, dX) against the plain versions, with a seeded
    cotangent; the backward twice, equal bit for bit.  Then K5 as the
    path reaches it: ``mlp.apply(backend="pallas")`` and
    ``torch.autograd.grad`` with x not requiring grad, so the backward
    skips dX; its dW/db are held to the plain backward and to the
    dX-computing launch bit for bit.  Returns (max abs error, forward
    timings, backward timings)."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_mlp as cm

    rows = x.shape[0]
    ct = torch.randn(rows, mlp.dims(params)[-1],
                     generator=torch.Generator().manual_seed(rows)).to(dev)
    out, hid = cm.mlp_forward_kernel(params, x, activation)
    out_p, hid_p = cm.mlp_forward_plain(params, x, activation)
    torch.cuda.synchronize()
    err = check(f"K5 forward, {rows} rows: output and hiddens", max(
        max_err(a, b) for a, b in zip([out, *hid], [out_p, *hid_p])), 1e-5)
    grads, dx = cm.mlp_backward_kernel(params, x, hid, ct, activation)
    again, dx2 = cm.mlp_backward_kernel(params, x, hid, ct, activation)
    grads_p, dx_p = cm.mlp_backward_plain(params, x, hid, ct, activation)
    torch.cuda.synchronize()
    got = [t for pair in grads for t in pair] + [dx]
    want = [t for pair in grads_p for t in pair] + [dx_p]
    # float32 sums of up to `rows` terms, taken in another order
    check(f"K5 backward, {rows} rows: dW, db, dX, max |diff| over the "
          f"leaf's max |plain|", max(max_err(a, b) / float(b.abs().max())
                                     for a, b in zip(got, want)), 1e-4,
          what="ratio")
    err = max(err, *(max_err(a, b) for a, b in zip(got, want)))
    if not (torch.equal(mlp.flatten(grads), mlp.flatten(again))
            and torch.equal(dx, dx2)):
        raise AssertionError("two runs of K5's backward differ")
    print(f"  K5 backward, {rows} rows: two runs equal bit for bit",
          flush=True)
    leaves = [t.detach().clone().requires_grad_()
              for pair in params for t in pair]
    pairs = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    out_a = mlp.apply(pairs, x, activation, "pallas")
    auto = torch.autograd.grad(out_a, leaves, grad_outputs=ct)
    torch.cuda.synchronize()
    want = [t for pair in grads_p for t in pair]
    check(f"K5 through autograd (no dX), {rows} rows: dW, db, max |diff| "
          f"over the leaf's max |plain|", max(
              max_err(a, b) / float(b.abs().max())
              for a, b in zip(auto, want)), 1e-4, what="ratio")
    err = max(err, *(max_err(a, b) for a, b in zip(auto, want)))
    if not all(torch.equal(a, b) for a, b in
               zip(auto, [t for pair in grads for t in pair])):
        raise AssertionError("K5's backward without dX differs from the "
                             "launch with dX")
    print(f"  K5 through autograd (no dX), {rows} rows: dW, db equal the "
          f"launch with dX bit for bit", flush=True)
    fwd = timings(lambda: cm.mlp_forward_kernel(params, x, activation),
                  lambda: cm.mlp_forward_plain(params, x, activation), 50, 20)
    bwd = timings(
        lambda: cm.mlp_backward_kernel(params, x, hid, ct, activation),
        lambda: cm.mlp_backward_plain(params, x, hid, ct, activation), 50, 20)
    # the row tile and grid the timed launches took (cuda_mlp.tile_for)
    for t, way in ((fwd, "forward"), (bwd, "backward")):
        plan = cm.last_launch[way]
        t.update(tile=plan["tile"], blocks=plan["blocks"])
    plan = cm.last_launch["backward"]
    print(f"  K5 backward, {rows} rows: clusters of {plan['cluster']} "
          f"blocks, {plan['blocks'] // plan['cluster']} partial rows",
          flush=True)
    return err, fwd, bwd


def mlp_resources() -> dict:
    """{"forward" | "backward", with " global" for variant 1: "N
    registers, S B spill stores, L B spill loads"} of K5's kernels
    (csrc/mlp.cu), from the build's nvcc.log (the compiler's -Xptxas -v
    report)."""
    import re

    from ppoc_tpu_torch.ops import _build

    res, name = {}, None
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '\S*mlp_(fwd|bwd)_kernel"
                      r"ILi(\d)E", line)
        if m:
            name = {"fwd": "forward", "bwd": "backward"}[m.group(1)] + (
                " global" if m.group(2) == "1" else "")
            continue
        if re.search(r"Compiling entry function", line):
            name = None
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            res[name] = (f"{spill.group(1)} B spill stores, "
                         f"{spill.group(2)} B spill loads")
        if name and regs:
            res[name] = f"{regs.group(1)} registers, " + res.get(name, "")
    want = ["backward", "backward global", "forward", "forward global"]
    if sorted(res) != want:
        raise AssertionError(f"nvcc.log reports the K5 kernels {res}")
    return res


def mlp_lean_stats(got, want):
    """(RMS error, lean) of ``got`` against the float64 ``want``: the RMS
    of the difference over the RMS of ``want``, and the signed mean
    sum((got - want) * sign(want)) / sum(|want|) (below zero: toward
    zero)."""
    e = got.double() - want
    rms = float(e.square().sum().sqrt() / want.square().sum().sqrt())
    lean = float((e * want.sign()).sum() / want.abs().sum())
    return rms, lean


def lean_verdicts(ref, got, rms_factor: float, lean_factor: float):
    """Each item of ``ref`` (name -> float64 tensor) against the float32
    results ``got`` ({"kernel" | "plain" | "control": {name: tensor}}), by
    :func:`mlp_lean_stats`: returns (rows, failed, control_fails), rows
    (name, kernel (RMS, lean), plain (RMS, lean), control (RMS, lean)).
    An item fails where the kernel's RMS passes rms_factor times the plain
    version's or its |lean| lean_factor times the plain's larger of |lean|
    and RMS; the control fails where its RMS passes rms_factor times the
    plain version's."""
    rows, failed, control_fails = [], [], []
    for name, want in ref.items():
        (rk, lk), (rp, lp), (rc, lc) = (mlp_lean_stats(got[k][name], want)
                                        for k in ("kernel", "plain",
                                                  "control"))
        rows.append((name, (rk, lk), (rp, lp), (rc, lc)))
        if not (rk <= rms_factor * rp
                and abs(lk) <= lean_factor * max(abs(lp), rp)):
            failed.append(name)
        if not rc <= rms_factor * rp:
            control_fails.append(name)
    return rows, failed, control_fails


def report_lean(label: str, what: str, ref, got, rms_factor: float,
                lean_factor: float) -> None:
    """Prints :func:`lean_verdicts` of ``got`` against ``ref`` and raises
    where the kernel fails an item or the control fails none."""
    rows, failed, control_fails = lean_verdicts(ref, got, rms_factor,
                                                lean_factor)
    for name, (rk, lk), (rp, lp), (rc, lc) in rows:
        print(f"  {label}, {name}: RMS error / lean against float64: kernel "
              f"{rk:.3e} / {lk:+.3e}, plain {rp:.3e} / {lp:+.3e}, "
              f"one-term TF32 control {rc:.3e} / {lc:+.3e}", flush=True)
    print(f"  {label}: the kernel's RMS within {rms_factor} x the "
          f"plain version's and its |lean| within {lean_factor} x the "
          f"plain's larger of |lean| and RMS on every item: "
          f"{'no, ' + ', '.join(failed) if failed else 'yes'}; the control "
          f"fails the RMS part on {', '.join(control_fails) or 'nothing'}",
          flush=True)
    if failed:
        raise AssertionError(f"{label}: {what} leaves float32 rounding on "
                             f"{failed}")
    if not control_fails:
        raise AssertionError(f"{label}: the one-term TF32 control passes "
                             f"the lean check")


def check_mlp_lean(label: str, params, x, activation: str, dev):
    """K5's rounding against float64, beside the plain version's (cuBLAS
    FP32): per layer the forward's output and dW/db (W and b together),
    and dX, each as RMS error and lean (mlp_lean_stats) against a float64
    forward and backward of the same float32 inputs (the backward's: the
    plain forward's hiddens and a seeded cotangent, for all three).  The
    kernel's RMS must stay within MLP_RMS_FACTOR of the plain version's
    and its |lean| within MLP_LEAN_FACTOR of the plain version's larger
    of |lean| and RMS; the control, the plain version with
    torch.backends.cuda.matmul.allow_tf32 (one-term TF32 products), must
    fail the RMS part on some item."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_mlp as cm

    rows = x.shape[0]
    ct = torch.randn(rows, mlp.dims(params)[-1],
                     generator=torch.Generator().manual_seed(rows + 1)
                     ).to(dev)
    _, hid = cm.mlp_forward_plain(params, x, activation)
    p64 = [(w.double(), b.double()) for w, b in params]

    def items(out, hs, grads, dx):
        d = {f"forward {l}": h for l, h in enumerate(list(hs) + [out])}
        d.update({f"dW/db {l}": torch.cat([w.reshape(-1), b.reshape(-1)])
                  for l, (w, b) in enumerate(grads)})
        d["dX"] = dx
        return d

    ref = items(*cm.mlp_forward_plain(p64, x.double(), activation),
                *cm.mlp_backward_plain(p64, x.double(),
                                       [h.double() for h in hid],
                                       ct.double(), activation))

    def run(fwd, bwd):
        return items(*fwd(params, x, activation),
                     *bwd(params, x, hid, ct, activation))

    got = {"kernel": run(cm.mlp_forward_kernel, cm.mlp_backward_kernel),
           "plain": run(cm.mlp_forward_plain, cm.mlp_backward_plain)}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got["control"] = run(cm.mlp_forward_plain, cm.mlp_backward_plain)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    report_lean(label, "K5", ref, got, MLP_RMS_FACTOR, MLP_LEAN_FACTOR)


def throughput_path(cfg, dev, counters):
    """Trainer(cfg) on the card by default: THROUGHPUT_EPOCHS epochs, then
    the mean-policy evaluation, each with the launch counts read around
    it; the mean policy's actions held to the plain forward."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp

    tr = Trainer(cfg)
    check_on_card(tr)
    names = [c.kernel for c in counters]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.train(n_epochs=THROUGHPUT_EPOCHS, log=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_n = dict(zip(names, (c.n for c in counters)))
    train_s = sum(h["time_s"] for h in hist)
    steps = len(hist) * cfg.steps_per_epoch
    print(f"  {len(hist)} epochs: R {[round(h['R'], 3) for h in hist]}",
          flush=True)
    print(f"  training time per epoch (s) "
          f"{[round(h['time_s'], 4) for h in hist]}; {train_s:.3f} s of "
          f"training, {steps / train_s:.0f} env-steps/s; {wall:.3f} s with "
          f"the evaluations; launches {train_n}", flush=True)
    if not all(math.isfinite(h["R"]) for h in hist):
        raise AssertionError("non-finite eval return on the throughput path")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]),
            tr.state.policy_params["log_std"])):
        raise AssertionError("non-finite weights on the throughput path")
    if (min(train_n[k] for k in ("rollout[pendulum]/values", "gae_norm",
                                 "mlp_forward", "mlp_backward")) < 1
            or train_n["value_phase"] or train_n["policy_phase"]
            or train_n["policy_phase_categorical"]):
        raise AssertionError(f"the throughput path must run K1, K2 and K5 "
                             f"and no K3/K4: {train_n}")

    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = tr.evaluate(deterministic=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_n = dict(zip(names, (c.n for c in counters)))
    print(f"  evaluate(deterministic=True): R {ev.R:.3f}, J {ev.J:.3f}, "
          f"episodes {int(ev.episodes)}, {eval_s:.3f} s; launches {eval_n}",
          flush=True)
    if not (math.isfinite(ev.R) and ev.episodes == cfg.eval_envs):
        raise AssertionError(f"mean-policy evaluation failed: {ev}")
    if (eval_n["mlp_forward"] != cfg.eval_len
            or eval_n["rollout[pendulum]/values"]
            or eval_n["rollout[pendulum]/metrics"]):
        raise AssertionError(f"the mean-policy evaluation must be "
                             f"{cfg.eval_len} K5 forwards: {eval_n}")
    pp = tr.state.policy_params
    draws = ppo.draw_eval(cfg, tr.env, torch.Generator().manual_seed(7), dev,
                          deterministic=True)
    traj = ppo.rollout_env_loop(cfg, tr.env, pp, draws)
    act_err = check("mean-policy actions vs the plain forward on the "
                    "recorded obs", max_err(traj.action, mlp.apply(
                        pp["mlp"], traj.obs, cfg.activation)), 1e-5)
    return tr, train_n, eval_n, act_err


def decode_state(lane: str, obs):
    """The lane state a recorded obs [..., O] came from: cartpole's obs is
    its state; acrobot's angles come back through atan2 (to ~1 ulp)."""
    import torch

    if lane == "cartpole":
        return list(obs.unbind(-1))
    return [torch.atan2(obs[..., 1], obs[..., 0]),
            torch.atan2(obs[..., 3], obs[..., 2]), obs[..., 4], obs[..., 5]]


def check_discrete_rollout(lane: str, ts, E: int, T: int, with_v: bool,
                           seed, dev):
    """K1's discrete ``lane`` at E x T, with the V planes (``with_v``) or
    with the metrics, against its plain version; returns (kernel
    trajectory, max abs error, timings).

    * RNG bits exactly, for the sampler's draws 0..K-1 and the resets'
      50..53.
    * The sampler on shared logits (the plain forward on the kernel's
      obs): the kernel's Gumbel-max bit for bit against the plain one.
    * The kernel's own draws equal the shared-logit draws wherever the
      perturbed top two lie NEAR_TIE or more apart; log-probs and V planes
      held to the plain forward on the recorded obs; each recorded
      (obs, action) re-stepped through the plain lane physics reproduces
      next_obs, reward and the done flags.
    * Whole trajectories per env against the plain rollout, up to the
      first step where the two pick apart, which must be a near-tie; the
      number of envs that reach one is printed.
    * With the metrics: the completed-episode sums against the kernel's
      own trajectory."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    ln = cr.LANES[lane]
    K = ln.n_actions
    pp, vp = ts.policy_params["mlp"], (ts.v_params if with_v else None)
    s0, s1 = seed
    lanes = torch.arange(E, dtype=torch.int64, device=dev)
    for draw in [*range(K), *(50 + j for j in range(ln.state_dim))]:
        for t in (0, T - 1, cr.T_INIT):
            if not torch.equal(cr.rng_bits_cuda(s0, s1, t, draw, E, dev),
                               cr.rng_bits(s0, s1, t, draw, lanes)):
                raise AssertionError(f"RNG bits differ at {(t, draw)}")
    print(f"  RNG bits of draws 0-{K - 1}, 50-{49 + ln.state_dim}: "
          f"identical to the plain version", flush=True)
    args = (pp, None, vp, seed, E, T, "relu", None, None, 0.99, lane)
    raw, ref = cr.rollout_kernel(*args), cr.rollout_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    h = mlp.apply(pp, raw.obs, "relu")                      # [T, E, K]
    shared = torch.empty(T, E, dtype=torch.int64, device=dev)
    gap = torch.empty(T, E, device=dev)
    lp_err = 0.0
    for t in range(T):
        i_k, lp_k = cr.gumbel_max_cuda(h[t].contiguous(), s0, s1, t)
        i_p, lp_p = cr.gumbel_max_plain(h[t], s0, s1, t, lanes)
        if not torch.equal(i_k, i_p):
            raise AssertionError(f"the kernel's sampler picks other classes "
                                 f"than the plain one at step {t}")
        lp_err = max(lp_err, max_err(lp_k, lp_p))
        shared[t] = i_p
        gap[t] = cr.gumbel_gap(h[t], s0, s1, t, lanes)
    errs["sampler"] = check("sampler on shared logits: classes equal, "
                            "log-probs", lp_err, 1e-6)
    near = gap < NEAR_TIE
    act = raw.action[..., 0].long()
    if ((act != shared) & ~near).any():
        raise AssertionError("the kernel's draws differ from the sampler's "
                             "on its own logits away from a near-tie")
    print(f"  kernel draws equal the shared-logit draws at every step "
          f"({int(near.sum())} of {T * E} steps near a tie, "
          f"{int((act != shared).sum())} of them picked apart)", flush=True)
    lp = torch.log_softmax(h, -1).gather(-1, act[..., None])[..., 0]
    errs["log_prob"] = check("log_prob vs plain forward", max_err(
        lp, raw.log_prob), 1e-5)
    if with_v:
        errs["value"] = check("V(s), V(s') vs plain forward", max(
            max_err(mlp.apply(vp, raw.obs, "relu")[..., 0], raw.value),
            max_err(mlp.apply(vp, raw.next_obs, "relu")[..., 0],
                    raw.next_value)), 1e-4)
    rows, reward, term = ln.step(decode_state(lane, raw.obs),
                                 [act.to(torch.float32)])
    nobs = torch.stack(ln.obs(rows), -1)
    # cartpole re-steps its exact state; acrobot's decoded angles carry
    # ~1 ulp into one RK4 step, whose velocity terms reach ~400
    tol = 1e-6 if lane == "cartpole" else 1e-3
    errs["physics"] = check("next_obs, reward vs re-stepped plain physics",
                            max(max_err(nobs, raw.next_obs),
                                max_err(reward, raw.reward)), tol)
    if not torch.equal(term > 0, raw.terminated):
        raise AssertionError("termination flags differ from the re-stepped "
                             "physics")
    if (raw.terminated & raw.truncated).any():
        raise AssertionError("a step both terminated and truncated")
    # per env: identical up to the first step the two rollouts pick apart
    apart = raw.action[..., 0] != ref.action[..., 0]
    first = torch.where(apart.any(0), apart.to(torch.int64).argmax(0),
                        torch.full((E,), T, device=dev))
    for e in torch.nonzero(first < T).flatten().tolist():
        if not near[first[e], e]:
            raise AssertionError(f"env {e}: the kernel and the plain rollout "
                                 f"pick apart at step {int(first[e])}, not "
                                 f"a near-tie")
    keep = (torch.arange(T, device=dev)[:, None] < first[None, :])
    traj_err = 0.0
    for a, b in ((raw.obs, ref.obs), (raw.next_obs, ref.next_obs),
                 (raw.reward, ref.reward), (raw.log_prob, ref.log_prob)):
        mask = keep if a.dim() == 2 else keep[..., None]
        traj_err = max(traj_err, max_err(a * mask, b * mask))
    if not (torch.equal(raw.terminated & keep, ref.terminated & keep)
            and torch.equal(raw.truncated & keep, ref.truncated & keep)):
        raise AssertionError("done flags differ from the plain rollout")
    hit = int((near & (torch.arange(T, device=dev)[:, None]
                       <= first.clamp(max=T - 1)[None, :])).any(0).sum())
    errs["trajectory"] = check(
        f"trajectories per env up to the first pick-apart ({hit} of {E} envs "
        f"reach a near-tie, {int((first < T).sum())} pick apart)", traj_err,
        1e-4)
    print(f"  {int(raw.terminated.sum())} terminations, "
          f"{int(raw.truncated.sum())} truncations in the window",
          flush=True)
    if not with_v:
        traj, _, (sum_r, sum_j, n_eps) = cr.rollout_fused(
            lane, ts.policy_params, seed, E, T, return_metrics=True)
        want = ppo.eval_metrics_from_traj(traj, 0.99)
        if float(n_eps) != float(want.episodes) or float(n_eps) < 1:
            raise AssertionError(f"episode count {n_eps} vs {want.episodes}")
        check("R, J sums vs the trajectory (relative)", max(
            abs(float(sum_r / n_eps - want.R)) / abs(float(want.R)),
            abs(float(sum_j / n_eps - want.J)) / abs(float(want.J))), 1e-4)
    times = rollout_timings(lambda: cr.rollout_kernel(*args),
                            lambda: cr.rollout_plain(*args), 20, 1,
                            warm=False)
    return raw, max(errs.values()), times


def discrete_path(lane: str, dev, counters):
    """Trainer(bench config for ``lane``, eval_len 500).solve(target, 40)
    with the launch counts read around it; returns (trainer, result, wall,
    launches)."""
    import torch

    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp

    cfg = bench_config().replace(env=lane, eval_len=500)
    tr = Trainer(cfg, dev)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.solve(DISCRETE_SOLVE_R[lane], max_epochs=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {c.kernel: c.n for c in counters}
    steps = res["epochs"] * cfg.steps_per_epoch
    print(f"  epochs {res['epochs']}, final R {res['R']:.3f}, wall "
          f"{wall:.3f} s, {steps / wall:.0f} env-steps/s (training and "
          f"evaluation), launches {n}", flush=True)
    if not (math.isfinite(res["R"]) and res["R"] >= DISCRETE_SOLVE_R[lane]):
        raise AssertionError(f"{lane} not solved in 40 epochs: R {res['R']}")
    if (min(n[k] for k in (f"rollout[{lane}]/values",
                           f"rollout[{lane}]/metrics", "gae_norm",
                           "value_phase", "policy_phase_categorical")) < 1
            or n["policy_phase"]):
        raise AssertionError(f"the discrete path must run K1's {lane} lane, "
                             f"K2, K3 and K6, and no K4: {n}")
    fits = res["epochs"] * cfg.fits_per_epoch
    got = (n[f"rollout[{lane}]/values"], n[f"rollout[{lane}]/metrics"])
    if got != (fits, res["epochs"]):
        raise AssertionError(f"K1 launches {got} with the V planes and with "
                             f"the metrics, not {fits} training and "
                             f"{res['epochs']} evaluation rollouts")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]))):
        raise AssertionError(f"non-finite weights after the {lane} solve")
    return tr, res, wall, n


# --- the attention sequence path (K7) ----------------------------------------

# recall_xl at the width of the repo's recipe
# (examples/recall_xl_curriculum.py), without its stabiliser and checkpoint
# hand-off (transplant_patience), one window of 1024 steps
RECALL_XL = dict(env="recall_xl", n_envs=32, rollout_len=1024,
                 eval_len=1024, minibatch_size=4096, fits_per_epoch=2,
                 eval_envs=64, hidden=(32,), seed=0, lr_policy=1e-3,
                 lr_v=1e-3, attn_dim=32, attn_layers=2, attn_heads=4,
                 kernel_backend="pallas")
RECALL_XL_EPOCHS = 1
# the JAX package's own attention learning check (tests/test_pallas_attn.py)
RECALL = dict(env="recall", n_envs=128, rollout_len=6, minibatch_size=192,
              fits_per_epoch=8, eval_envs=256, eval_len=6, hidden=(32,),
              seed=1, lr_policy=1e-3, lr_v=1e-3, attn_dim=16, attn_layers=1,
              attn_heads=2, kernel_backend="pallas")
# the recall learning check's mark (an eval R over 256 episodes of 0 or 1
# cannot equal it)
RECALL_LEARNED = 0.9
# K7 against its plain version: out and lse to 1e-5, the gradients to 1e-4,
# each over the largest magnitude of the plain result (at least 1): the
# kernel's online softmax and its sums over up to 2048 keys run in another
# order than the plain version's matmuls
FLASH_OUT_TOL, FLASH_GRAD_TOL = 1e-5, 1e-4
# K7 f32's lean check (check_flash_lean), fixed before its first chip run:
# K5's factors, for K5's reasons.  Its products are 3xTF32 as K5's (22 of a
# product's 24 bits; each k-step's three mmas formed from zero, then added
# in float32 with round to nearest, so the truncating tensor cores lean by
# under an ulp of an 8-term partial a step), beside float32 roundings of
# its own (expf, logf, the online softmax's rescales) that the plain
# version also makes; the one-term TF32 control drops ~13 bits of every
# score and product.
FLASH_RMS_FACTOR, FLASH_LEAN_FACTOR = MLP_RMS_FACTOR, MLP_LEAN_FACTOR
# K7's three kernels (forward, dq, dk/dv) in each variant
K7_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
K7_BF16_NAMES = tuple(n + "_bf16" for n in K7_NAMES)


def dones_of_rollout(name: str, T: int, B: int, dev):
    """[T, B] done flags of a T-step window of env ``name`` (the episode
    pattern that window's rollout has: recall's ends depend on time
    alone)."""
    import torch

    from ppoc_tpu_torch import envs

    env = envs.make(name)
    g = torch.Generator().manual_seed(0)
    state, _ = envs.vector_reset(env, g, B, dev)
    dones = []
    for _ in range(T):
        fresh = envs.vector_reset(env, g, B, dev)
        state, _, _, _, term, trunc = envs.vector_autoreset_step(
            env, state, torch.zeros(B, 1, device=dev), fresh)
        dones.append(term | trunc)
    return torch.stack(dones)


def random_dones(T: int, B: int, p_done: float, seed: int, dev):
    import torch

    g = torch.Generator().manual_seed(seed)
    return (torch.rand(T, B, generator=g) < p_done).to(dev)


def flash_case(T: int, B: int, H: int, hd: int, dones, seed: int, dev,
               k_dones=None):
    """Folded K7 inputs: q, k, v, an output cotangent and an lse cotangent
    from a seeded generator, and the two sides' episode ids [B, T] from
    ``dones`` (and ``k_dones`` for the key side, else the same)."""
    import torch

    from ppoc_tpu_torch.models import attn
    from ppoc_tpu_torch.ops import cuda_attn as ca

    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B * H, T, hd, generator=g).to(dev)
                     for _ in range(4))
    g_lse = torch.randn(B * H, T, generator=g).to(dev)
    ep_q = ca.fold_ep(attn.episode_ids(dones))
    ep_k = ep_q if k_dones is None else ca.fold_ep(attn.episode_ids(k_dones))
    return q, k, v, dout, g_lse, ep_q, ep_k


def flash_bounds(case, rel: int, H: int):
    """K7's three bounds for ``case``: FP32 operations over the valid
    (query, key) pairs this case's episode ids allow -- forward 4 hd + 4 a
    pair (q.k, p.v, the max, exp and sum), dq 6 hd + 4, dk/dv 8 hd + 4 --
    or the bytes (each input read once, each output written once)."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, _, _, _, _, ep_q, ep_k = case
    BH, T, hd = q.shape
    pairs = int(ca.valid_mask(ep_q, ep_k, rel, 1).sum()) * H
    row, ids, vec = 4 * BH * T * hd, 4 * 2 * ep_q.numel(), 4 * BH * T
    return (bound_ms(pairs * (4 * hd + 4), 3 * row + ids + row + vec),
            bound_ms(pairs * (6 * hd + 4), 4 * row + ids + 2 * vec + row),
            bound_ms(pairs * (8 * hd + 4), 4 * row + ids + 2 * vec
                     + 2 * row)), pairs


def flash_tf32_bounds(pairs: int, hd: int):
    """K7 f32's products as 3xTF32 on the tensor cores: three times their
    operations (forward 4 hd a valid pair, dq 6 hd, dk/dv 8 hd) over the
    TF32 peak, ms."""
    return tuple(1e3 * 3 * pairs * c * hd / PEAK_TF32 for c in (4, 6, 8))


def check_flash_lean(label: str, case, rel: int, H: int):
    """K7 f32's rounding against float64, beside the plain version's: out,
    lse (the rows with a valid key), dq, dk and dv, each as RMS error and
    lean (mlp_lean_stats) against attention_plain in float64 on the same
    float32 inputs and cotangents, with autograd; the kernel's backward
    takes its own forward's out and lse.  Held as K5 is (report_lean:
    FLASH_RMS_FACTOR, FLASH_LEAN_FACTOR), where the control, the plain
    version with torch.backends.cuda.matmul.allow_tf32 (one-term TF32
    products), must fail."""
    import torch

    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, dout, g_lse, ep_q, ep_k = case
    kargs = (q, k, v, ep_q, ep_k, rel, H)
    out, lse = ca.flash_fwd_kernel(*kargs)
    bargs = kargs + (dout, ca.dsum_of(dout, out, g_lse).contiguous(), lse)
    dq = ca.flash_dq_kernel(*bargs)
    dk, dv = ca.flash_dkv_kernel(*bargs)

    def plain(dtype):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        o, l = ca.attention_plain(*leaves, ep_q, ep_k, rel, H)
        grads = torch.autograd.grad((o, l), leaves,
                                    (dout.to(dtype), g_lse.to(dtype)))
        return (o.detach(), l.detach(), *grads)

    ref = plain(torch.float64)
    valid = ref[1] > ca.NEG / 2

    def items(o, l, gq, gk, gv):
        return {"out": o, "lse": l[valid], "dq": gq, "dk": gk, "dv": gv}

    got = {"kernel": items(out, lse, dq, dk, dv),
           "plain": items(*plain(torch.float32))}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got["control"] = items(*plain(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    report_lean(label, "K7 f32", items(*ref), got, FLASH_RMS_FACTOR,
                FLASH_LEAN_FACTOR)


def visit_shares(case, rel: int, rows: int) -> str:
    """The share of the in-range tiles K7 visits on ``case`` with ``rows``
    own rows a block (:func:`cuda_attn.visited_tiles`): forward and dq,
    then dk/dv."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    ep_q, ep_k = case[5], case[6]
    shares = []
    for keys in (False, True):
        vis, in_range = ca.visited_tiles(ep_q, ep_k, rel, rows, ca.TILE,
                                         keys)
        n_vis, n_in = int(vis.sum()), int(in_range.sum())
        shares.append(f"{n_vis} of {n_in} ({n_vis / max(1, n_in):.4f})")
    return f"tiles visited: forward and dq {shares[0]}, dk/dv {shares[1]}"


def check_flash(label: str, case, rel: int, H: int, dev, time_it=False):
    """K7's forward (out, lse) and its dq and dk/dv kernels against the
    plain version (autograd through it) on ``case``, each held over the
    largest magnitude of the plain result; rows with no valid key must
    come back out 0 and lse NEG exactly; the backward launched twice must
    agree bit for bit.  Returns ({name: max abs error}, {kernel: timings}
    or None)."""
    import torch

    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, dout, g_lse, ep_q, ep_k = case
    kargs = (q, k, v, ep_q, ep_k, rel, H)
    out, lse = ca.flash_fwd_kernel(*kargs)
    dsum = ca.dsum_of(dout, out, g_lse).contiguous()
    bargs = kargs + (dout, dsum, lse)
    dq = ca.flash_dq_kernel(*bargs)
    dk, dv = ca.flash_dkv_kernel(*bargs)
    dq2 = ca.flash_dq_kernel(*bargs)
    dk2, dv2 = ca.flash_dkv_kernel(*bargs)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_p, lse_p = ca.attention_plain(*leaves, ep_q, ep_k, rel, H)
    grads_p = torch.autograd.grad((out_p, lse_p), leaves, (dout, g_lse))
    out_p, lse_p = out_p.detach(), lse_p.detach()
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2)):
        raise AssertionError(f"{label}: two runs of K7's backward differ")
    empty = lse_p <= ca.NEG / 2
    if not (torch.equal(lse[empty], lse_p[empty])
            and (out[empty] == 0).all()):
        raise AssertionError(f"{label}: rows with no valid key are not out "
                             f"0 and lse NEG")
    errs = {}
    for name, a, b, tol in (
            ("out", out, out_p, FLASH_OUT_TOL),
            ("lse", lse[~empty], lse_p[~empty], FLASH_OUT_TOL),
            ("dq", dq, grads_p[0], FLASH_GRAD_TOL),
            ("dk", dk, grads_p[1], FLASH_GRAD_TOL),
            ("dv", dv, grads_p[2], FLASH_GRAD_TOL)):
        errs[name] = max_err(a, b) if a.numel() else 0.0
        scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
        print(f"  {label}, {name}: max |diff| {errs[name]:.3e}, over the "
              f"plain max {errs[name] / scale:.3e} (tolerance {tol:.0e})",
              flush=True)
        if not errs[name] / scale <= tol:
            raise AssertionError(f"{label}: {name} exceeds {tol}")
    print(f"  {label}: backward twice, bit for bit; "
          f"{int(empty.sum())} rows with no valid key", flush=True)
    if not time_it:
        return errs, None
    import torch.nn.functional as F

    B = ep_q.shape[0]
    T, hd = q.shape[1], q.shape[2]
    mask = ca.valid_mask(ep_q, ep_k, rel, 1)[:, None]              # [B, 1, T, T]
    q4, k4, v4 = (t.detach().reshape(B, H, T, hd).requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    d4 = dout.reshape(B, H, T, hd)
    plain_graph = ca.attention_plain(*leaves, ep_q, ep_k, rel, H)

    def plain_bwd(wrt):
        # autograd through the plain version, with respect to ``wrt`` only
        return lambda: torch.autograd.grad(plain_graph, wrt, (dout, g_lse),
                                           retain_graph=True)

    def lib_bwd(wrt):
        return lambda: torch.autograd.grad(lib_out, wrt, d4,
                                           retain_graph=True)

    times = {
        "flash_fwd": timings(lambda: ca.flash_fwd_kernel(*kargs),
                             lambda: ca.attention_plain(*kargs), 20, 3),
        "flash_bwd_dq": timings(lambda: ca.flash_dq_kernel(*bargs),
                                plain_bwd(leaves[:1]), 20, 3),
        "flash_bwd_dkv": timings(lambda: ca.flash_dkv_kernel(*bargs),
                                 plain_bwd(leaves[1:]), 20, 3),
    }
    times["flash_fwd"]["library_ms"] = queued_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
        20)
    times["flash_bwd_dq"]["library_ms"] = queued_ms(lib_bwd((q4,)), 20)
    times["flash_bwd_dkv"]["library_ms"] = queued_ms(lib_bwd((k4, v4)), 20)
    whole = {"plain": device_ms(plain_bwd(leaves), 3),
             "library": queued_ms(lib_bwd((q4, k4, v4)), 20)}
    fwd_bwd = {"kernel": sum(times[k]["ms"] for k in times),
               "plain": times["flash_fwd"]["plain_ms"] + whole["plain"],
               "library": times["flash_fwd"]["library_ms"]
               + whole["library"]}
    parts = "; ".join(f"{k} {t['ms']:.4f} / {t['plain_ms']:.4f} / "
                      f"{t['library_ms']:.4f}" for k, t in times.items())
    print(f"  {label}: {visit_shares(case, rel, ca.ROWS)}", flush=True)
    print(f"  {label}: device ms, kernel / plain / SDPA: {parts}; whole "
          f"backward (dq, dk, dv) plain {whole['plain']:.4f}, SDPA "
          f"{whole['library']:.4f}; forward + backward kernel "
          f"{fwd_bwd['kernel']:.4f} / plain {fwd_bwd['plain']:.4f} / SDPA "
          f"{fwd_bwd['library']:.4f}", flush=True)
    return errs, times


def check_flash_all(dev):
    """K7 at every shape the path gives it and at the JAX package's chip
    X-ray shape; returns {shape name: (case, rel, H, errors, timings)}."""
    T, B, H, hd = 1024, 4, 4, 8
    xl = dones_of_rollout("recall_xl", T, 32, dev)
    runs = {}
    for name, case, rel, Hn, time_it in (
            ("recall_xl minibatch (T 1024, B 4, H 4, hd 8), rollout "
             "episodes", flash_case(T, B, H, hd, xl[:, :B], 1, dev), 0, H,
             True),
            ("recall_xl minibatch, p_done 0.02",
             flash_case(T, B, H, hd, random_dones(T, B, 0.02, 2, dev), 3,
                        dev), 0, H, False),
            ("recall_xl value pass (T 1024, B 32, H 4, hd 8)",
             flash_case(T, 32, H, hd, xl, 4, dev), 0, H, True),
            ("ragged T 1030 (B 4, H 4, hd 8), p_done 0.02",
             flash_case(1030, B, H, hd, random_dones(1030, B, 0.02, 5, dev),
                        6, dev), 0, H, False),
            ("X-ray (T 2048, B 16, H 8, hd 64), p_done 0.02",
             flash_case(2048, 16, 8, 64, random_dones(2048, 16, 0.02, 7,
                                                      dev), 8, dev),
             0, 8, True)):
        errs, times = check_flash(name, case, rel, Hn, dev, time_it)
        runs[name] = (case, rel, Hn, errs, times)
    q_d = random_dones(T, B, 0.02, 9, dev)
    k_d = random_dones(T, B, 0.02, 10, dev)
    for rel in (-1, 0, 1):
        name = f"ring block rel {rel:+d} (T 1024, B 4, H 4, hd 8)"
        errs, _ = check_flash(name, flash_case(T, B, H, hd, q_d, 11, dev,
                                               k_dones=k_d), rel, H, dev)
        runs[name] = (None, rel, H, errs, None)
    return runs


def check_apply_seq(dev):
    """apply_seq through K7 ("pallas", T >= FLASH_MIN_T) against apply_seq
    through the materialised core ("jnp") at recall_xl's widths (d 32, 2
    layers, 4 heads, T 1024, E 4): the outputs and every parameter
    gradient of sum(out * c), each over the leaf's largest magnitude."""
    import torch

    from ppoc_tpu_torch.models import attn
    from ppoc_tpu_torch.ops import adam

    T, E = 1024, 4
    g = torch.Generator().manual_seed(12)
    p = attn.init(2, 32, 2, 4, 128, T + 1, (32, 32, 1), g, dev)
    xs = torch.randn(T, E, 2, generator=g).to(dev)
    dones = torch.cat([dones_of_rollout("recall_xl", T, 2, dev),
                       random_dones(T, 2, 0.02, 13, dev)], dim=1)
    c = torch.randn(T, E, 1, generator=g).to(dev)
    res = {}
    for backend in ("pallas", "jnp"):
        leaves = adam.tree_map(lambda t: t.detach().requires_grad_(), p)
        out = attn.apply_seq(leaves, xs, dones, "relu", backend=backend)
        res[backend] = (out.detach(), torch.autograd.grad(
            (out * c).sum(), adam.tree_leaves(leaves)))
    torch.cuda.synchronize()
    out_err = max_err(res["pallas"][0], res["jnp"][0])
    check("apply_seq outputs, K7 vs the materialised core", out_err,
          FLASH_OUT_TOL)
    ratio = max(max_err(a, b) / max(1.0, float(b.abs().max())) for a, b in
                zip(res["pallas"][1], res["jnp"][1]))
    check(f"apply_seq: {len(res['jnp'][1])} parameter gradients, max |diff| "
          f"over the leaf's max (at least 1)", ratio, FLASH_GRAD_TOL,
          what="ratio")
    return max(out_err, *(max_err(a, b) for a, b in
                          zip(res["pallas"][1], res["jnp"][1])))


def recall_learning(counters):
    """The JAX package's attention learning check on the card: recall (T
    6: the materialised path, no K7 launch) must reach R > 0.9 within 5
    epochs (training stops at the first epoch that does)."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo.trainer import Trainer

    tr = Trainer(PPOConfig(**RECALL))
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    hist = tr.train(5, log=False, stop_at_R=RECALL_LEARNED)
    torch.cuda.synchronize()
    n = {c.kernel: c.n for c in counters}
    print(f"  R {[round(h['R'], 4) for h in hist]}, "
          f"{time.perf_counter() - t0:.3f} s; launches {n}", flush=True)
    if not hist[-1]["R"] > RECALL_LEARNED:
        raise AssertionError(f"recall not learned in 5 epochs: "
                             f"R {hist[-1]['R']}")
    if any(n.values()):
        raise AssertionError(f"recall at T 6 launched a kernel: {n}")
    return hist[-1]["R"]


class PhaseClock:
    """Wall time and kernel launches of one fit's phases: wraps the
    functions ``ppo.train_epoch`` calls (module attributes, looked up at
    call time; ``targets``: (module, function, phase), SEQUENCE for an
    attention trunk, MLP for the MLP fit, its row draws included) with a
    synchronise after each call (and before it, where the stream is busy)
    and reads the launch counters around each call.  It is entered
    around ``Trainer.train_epoch`` alone, so the evaluation's own rollout
    is not counted, or (MLP_SOLVE) around ``Trainer.solve``, whose
    evaluations are a phase.  The host's own code between the wrapped
    calls (the fit loop, its returns and the fit metrics' small
    reductions) is timed as "host", and the clock's bookkeeping (asking
    whether the stream is idle before each call, reading and adding the
    launch counters around it, wrapping and unwrapping the functions) as
    "clock".  :meth:`split` fails if a phase was never called, if a
    counted kernel launched between the wrapped calls (a call the
    wrappers miss), or if more than UNTIMED_SHARE of the epoch's wall is
    left untimed: the window's edges and the waits of calls that found
    the stream busy (device work queued by code the wrappers miss).  The
    path is unchanged; the synchronisation only ends each phase where the
    host would wait anyway at the next one's first read."""

    SEQUENCE = (("recurrent", "rollout_rnn", "rollout"),
                ("recurrent", "compute_values_rnn", "values + GAE"),
                ("ppo", "_seq_advantages", "values + GAE"),
                ("recurrent", "value_phase_rnn", "value phase"),
                ("recurrent", "policy_phase_rnn", "policy phase"))
    MLP = (("ppo", "rollout", "rollout"),
           ("ppo", "compute_advantages", "GAE"),
           ("buffer", "from_rollout", "GAE"),      # the fit's row buffer
           ("ppo", "value_phase", "value phase"),
           ("ppo", "policy_phase", "policy phase"),
           ("ppo", "draw_fit", "draws"))
    # a solve: the fits, then each epoch's evaluation and its draws
    MLP_SOLVE = MLP + (("ppo", "evaluate", "evaluation"),
                       ("ppo", "draw_eval", "draws"))
    # the host's code between the phases was once left untimed and held to
    # this share: a REACHER_REF epoch (10 fits, 0.51-0.54 s) read 2-6 ms of
    # it by host speed, past 1% on slow hosts with no call finding the
    # stream busy; it is timed now, and a call the wrappers miss shows by
    # its launches or by its wait
    UNTIMED_SHARE = 0.01

    def __init__(self, counters, targets=SEQUENCE):
        self.counters = counters
        self.targets = targets
        self.phases = tuple(dict.fromkeys(ph for _, _, ph in targets))
        self.t = dict.fromkeys(self.phases, 0.0)
        self.calls = dict.fromkeys(self.phases, 0)
        self.launches = {ph: {c.kernel: 0 for c in counters}
                         for ph in self.phases}
        self.own = 0.0      # the bookkeeping's seconds
        self.host = 0.0     # the seconds between the wrapped calls
        self.stray = {}     # {kernel: launches between the wrapped calls}
        self.busy = 0       # calls that found the stream busy
        self.mark = None    # (time, counts) where the last call ended
        self.saved = []

    def gap(self, t, counts):
        """Time the host's code since the last mark and hold its launches
        to none."""
        t_mark, n_mark = self.mark
        self.host += t - t_mark
        for c, n, m in zip(self.counters, counts, n_mark):
            if n != m:
                self.stray[c.kernel] = self.stray.get(c.kernel, 0) + n - m

    def wrap(self, mod, name, phase):
        import functools

        import torch

        fn = getattr(mod, name)

        @functools.wraps(fn)
        def timed(*a, **kw):
            c0 = time.perf_counter()
            n0 = [c.n for c in self.counters]
            self.gap(c0, n0)
            if not torch.cuda.current_stream().query():
                # device work queued by code the wrappers miss: the wait
                # for it stays untimed
                self.busy += 1
                torch.cuda.synchronize()
                c0 = time.perf_counter()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                self.t[phase] += t1 - t0
                self.calls[phase] += 1
                launches = self.launches[phase]
                n1 = [c.n for c in self.counters]
                for c, n, m in zip(self.counters, n0, n1):
                    launches[c.kernel] += m - n
                t2 = time.perf_counter()
                self.own += (t0 - c0) + (t2 - t1)
                self.mark = (t2, n1)

        self.saved.append((mod, name, fn))
        setattr(mod, name, timed)

    def __enter__(self):
        t0 = time.perf_counter()
        from ppoc_tpu_torch.algo import ppo, recurrent
        from ppoc_tpu_torch.data import buffer

        mods = {"ppo": ppo, "recurrent": recurrent, "buffer": buffer}
        for mod, name, phase in self.targets:
            self.wrap(mods[mod], name, phase)
        n = [c.n for c in self.counters]
        t1 = time.perf_counter()
        self.own += t1 - t0
        self.mark = (t1, n)
        return self

    def __exit__(self, *exc):
        t0 = time.perf_counter()
        self.gap(t0, [c.n for c in self.counters])
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.own += time.perf_counter() - t0

    def split(self, wall: float):
        """{phase: seconds} plus "host" (between the calls), "clock" (the
        bookkeeping) and "untimed", checked against the epoch's ``wall``."""
        if not all(self.calls.values()):
            raise AssertionError(f"a phase of the epoch was never timed: "
                                 f"calls {self.calls}")
        if self.stray:
            raise AssertionError(f"kernels launched between the wrapped "
                                 f"calls: {self.stray}")
        untimed = wall - sum(self.t.values()) - self.host - self.own
        if not 0.0 <= untimed <= self.UNTIMED_SHARE * wall:
            raise AssertionError(
                f"the phases {self.t}, the host's {self.host:.4f} s between "
                f"them and the clock's {self.own:.4f} s leave {untimed:.4f} s "
                f"of the epoch's {wall:.4f} s untimed (limit "
                f"{self.UNTIMED_SHARE:.0%}; {self.busy} calls found the "
                f"stream busy)")
        return dict(self.t, host=self.host, clock=self.own, untimed=untimed)


def recall_xl_path(dev, counters, config=None, names=K7_NAMES,
                   gap_tol=1e-4):
    """Trainer(``config``, recall_xl at the recipe's widths by default) on
    the card by default: the decode-against-replay gap at the initial
    weights, then RECALL_XL_EPOCHS epochs through K7 (the kernels
    ``names``: forward, dq, dk/dv of the config's variant), each epoch's R
    and its wall time split by phase (:class:`PhaseClock`), with the
    launches read around each phase and held to the count the config gives
    (every other kernel none); then evaluate(deterministic=True).  Returns
    (trainer, {phase: {kernel: launches}} of the epochs, {phase: {kernel:
    launches}} a fit from the config, log-prob gap, per-epoch rows)."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo import ppo, recurrent
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.ops import adam

    cfg = PPOConfig(**(RECALL_XL if config is None else config))
    tr = Trainer(cfg)
    check_on_card(tr)
    # decode against replay at the initial weights: the rollout's stored
    # log-probs (plain float32 decode) and the epoch-0 replay through K7
    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(11), dev,
                         tr.env)
    pp = tr.state.policy_params
    traj, _ = recurrent.rollout_rnn(cfg, tr.env, pp, draws.seq)
    with torch.no_grad():
        logp, _ = recurrent.policy_log_probs_rnn(
            cfg, pp, traj.obs, traj.action, traj.terminated | traj.truncated,
            False, ppo.backend_of(cfg))
    gap = max_err(logp, traj.log_prob)
    print(f"  decode against the K7 replay at epoch 0: largest log-prob gap "
          f"{gap:.3e}, largest |ratio - 1| "
          f"{float((torch.exp(logp - traj.log_prob) - 1).abs().max()):.3e}",
          flush=True)
    check("decode against replay, log-probs", gap, gap_tol)

    seqs, n_mb = recurrent.seq_minibatch_plan(cfg.n_envs, cfg.rollout_len,
                                              cfg.minibatch_size)
    # K7's launches a fit by phase, from the config: one forward a layer
    # in the value pass, a forward and both backwards a layer in each
    # minibatch step of the two phases
    L = cfg.attn_layers
    fwd = names[0]
    per_fit = {"rollout": {},
               "values + GAE": {fwd: L},
               "value phase": dict.fromkeys(
                   names, L * cfg.n_epochs_value * n_mb),
               "policy phase": dict.fromkeys(
                   names, L * cfg.n_epochs_policy * n_mb),
               "evaluation": {}}
    fits = RECALL_XL_EPOCHS * cfg.fits_per_epoch
    by_phase = {ph: {c.kernel: 0 for c in counters} for ph in per_fit}
    rows = []
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RECALL_XL_EPOCHS):
        # Trainer.train(1, initial_eval=False), one phase at a time
        clock = PhaseClock(counters)
        t_fit = time.perf_counter()
        with clock:
            fit = tr.train_epoch()
            torch.cuda.synchronize()
        split = clock.split(time.perf_counter() - t_fit)
        fit = ppo.FitMetrics(*(float(x) for x in fit))
        n0 = {c.kernel: c.n for c in counters}
        t_ev = time.perf_counter()
        ev = tr.evaluate()
        torch.cuda.synchronize()
        split["evaluation"] = time.perf_counter() - t_ev
        for ph, counts in clock.launches.items():
            for k, v in counts.items():
                by_phase[ph][k] += v
        for c in counters:
            by_phase["evaluation"][c.kernel] += c.n - n0[c.kernel]
        rows.append(dict(R=ev.R, split=split))
        print(f"  epoch {i}: R {ev.R:.4f}, value loss {fit.value_loss:.5f}, "
              f"policy loss {fit.policy_loss:.5f}; wall split (s) "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
              flush=True)
        if not all(math.isfinite(x) for x in (*fit, ev.R)):
            raise AssertionError(f"non-finite loss on {cfg.env}: {fit}, "
                                 f"R {ev.R}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {c.kernel: c.n for c in counters}
    want = {ph: {c.kernel: per_fit[ph].get(c.kernel, 0) * fits
                 for c in counters} for ph in per_fit}
    print(f"  {RECALL_XL_EPOCHS} epochs in {wall:.3f} s; launches {n}",
          flush=True)
    for ph in per_fit:
        got = {k: v for k, v in by_phase[ph].items() if v}
        print(f"    {ph}: launches {got}; from the config ({n_mb} "
              f"minibatches, {fits} fits) "
              f"{ {k: v * fits for k, v in per_fit[ph].items()} }",
              flush=True)
        if by_phase[ph] != want[ph]:
            raise AssertionError(f"{ph}: launches {by_phase[ph]} differ "
                                 f"from the config's {want[ph]}")
    if n != {k: sum(want[ph][k] for ph in want) for k in n}:
        raise AssertionError(f"K7 launches {n} are not the phases' sum")
    if not all(torch.isfinite(t).all() for t in adam.tree_leaves(
            (tr.state.v_params, tr.state.policy_params))):
        raise AssertionError("non-finite weights after recall_xl")

    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    ev = tr.evaluate(deterministic=True)
    torch.cuda.synchronize()
    ev_n = {c.kernel: c.n for c in counters}
    print(f"  evaluate(deterministic=True): R {ev.R:.4f}, episodes "
          f"{int(ev.episodes)}, {time.perf_counter() - t0:.3f} s; launches "
          f"{ev_n}", flush=True)
    if any(ev_n.values()) or ev.episodes != cfg.eval_envs:
        raise AssertionError(f"the mean-policy evaluation of recall_xl: "
                             f"{ev}, launches {ev_n}")
    return tr, by_phase, per_fit, gap, rows


def attention_phases(dev, counters, record):
    """The attention sequence path: K7 against its plain version at every
    shape, apply_seq through K7 against the plain core, the recall
    learning check, then recall_xl at full width through K7."""
    header("[K7 flash attention: forward, dq, dk/dv against the plain "
          "version]", flush=True)
    runs = check_flash_all(dev)
    header("[K7 f32's rounding against float64, beside the plain version's "
           "and a one-term TF32 control]")
    for key in ("recall_xl minibatch (T 1024, B 4, H 4, hd 8), rollout "
                "episodes", "X-ray (T 2048, B 16, H 8, hd 64), p_done 0.02"):
        case, rel, H, _, _ = runs[key]
        check_flash_lean(key, case, rel, H)
    header("[apply_seq through K7 against the materialised core, recall_xl "
          "widths]", flush=True)
    seq_err = check_apply_seq(dev)
    header("[recall learning check: Trainer(recall, attn_dim 16).train(5)]",
          flush=True)
    recall_learning(counters)
    header(f"[recall_xl path: Trainer(recall_xl, attn_dim 32, 2 layers, 4 "
          f"heads), {RECALL_XL_EPOCHS} epochs, then "
          f"evaluate(deterministic=True)]", flush=True)
    _, by_phase, per_fit, gap, _ = recall_xl_path(dev, counters)
    shapes = (("recall_xl minibatch (T 1024, B 4, H 4, hd 8), rollout "
               "episodes", "recall_xl update phases, minibatch of 4 env "
               "columns", [1024, 4, 4, 8]),
              ("recall_xl value pass (T 1024, B 32, H 4, hd 8)",
               "recall_xl value pass of the V planes", [1024, 32, 4, 8]))
    for key, path, shape in shapes:
        case, rel, H, errs, times = runs[key]
        bounds, pairs = flash_bounds(case, rel, H)
        for name, tf32 in zip(K7_NAMES, flash_tf32_bounds(pairs, shape[3])):
            times[name]["tf32x3_bound_ms"] = tf32
        value_pass = "value pass" in key
        for i, name in enumerate(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")):
            if value_pass and name != "flash_fwd":
                continue      # the value pass runs no backward
            launches = (by_phase["values + GAE"][name] if value_pass else
                        by_phase["value phase"][name]
                        + by_phase["policy phase"][name])
            err = (max(errs["out"], errs["lse"]), errs["dq"],
                   max(errs["dk"], errs["dv"]))[i]
            record(name, path + f" ({pairs} valid pairs)", shape, launches,
                   err, times[name], bounds[i], times[name]["library_ms"])
    case, rel, H, errs, times = runs[
        "X-ray (T 2048, B 16, H 8, hd 64), p_done 0.02"]
    bounds, pairs = flash_bounds(case, rel, H)
    tf32 = flash_tf32_bounds(pairs, case[0].shape[2])
    xray = {name: dict(times[name], bound_ms=bounds[i][0],
                       bound_by=bounds[i][1], tf32x3_bound_ms=tf32[i])
            for i, name in enumerate(K7_NAMES)}
    print(f"  K7 at the X-ray shape (T 2048, B 16, H 8, hd 64, {pairs} valid "
          f"pairs; not on the path): {json.dumps(xray)}", flush=True)
    print(f"  apply_seq through K7 against the plain core, max |diff| "
          f"{seq_err:.3e}; decode against replay, largest log-prob gap "
          f"{gap:.3e}; K7 launches a fit by phase, from the config "
          f"{per_fit}", flush=True)


# --- K1's last four lanes, the reacher regime, MountainCarContinuous -----

# the reacher throughput regime (bench_phases.py:44-46 with
# docs/RESULTS.md's shuffle_block 4096) and the MountainCarContinuous recipe
# (docs/RESULTS.md:980, 986-995)
REACHER = dict(env="reacher", n_envs=4096, rollout_len=150,
               minibatch_size=16384, fits_per_epoch=1, hidden=(256, 256),
               eval_envs=256, eval_len=150, shuffle_block=4096,
               kernel_backend="pallas")
REACHER_EPOCHS = 3
# eval R must rise by more than this: the JAX package's bar
# (tests/test_envs.py:209-223)
REACHER_GAIN = 5.0
MCC = dict(env="mountain_car_norm", n_envs=512, rollout_len=999,
           minibatch_size=8192, fits_per_epoch=1, eval_envs=256,
           eval_len=999, ent_coeff=0.005, kernel_backend="pallas")
MCC_EPOCHS = 30
MCC_SOLVED = 90.0
# the rule, declared before any run: seed 0 must solve; if it misses,
# seeds 1 and 2 run and both must solve
MCC_SEEDS = (0, 1, 2)
# simple's learning check: R > 0.5, the bar of the JAX package's standard
# drive of this env, at the bench shape, within 10 epochs
SIMPLE_SOLVED = 0.5


def check_lane(lane: str, ts, E: int, T: int, with_v: bool, seed, dev,
               st0=None, steps0=None):
    """K1's continuous ``lane`` at E x T, with the V planes (``with_v``) or
    with the metrics, against its plain version; returns (kernel
    trajectory, max abs error, timings, variant launched).

    * RNG bits exactly, for the sampler's draws 0..2A-1 and the resets'.
    * The entry reset (or the carried state's obs) equal bit for bit; the
      first 10 steps held to a 10-step plain rollout (the two policies'
      forwards, the kernel's loop and cuBLAS, differ by ~1e-6).
    * The whole trajectory: the kernel's own actions replayed through the
      plain physics (``cuda_rollout.replay_plain``) reproduce its obs,
      next_obs, rewards, done flags and final state bit for bit (the lanes'
      physics rounds as PyTorch's ops do).
    * Log-probs and V planes held to the plain forward on the recorded
      obs; the sampling noise a standard normal.
    * With the metrics: the completed-episode sums against the kernel's
      own trajectory."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp, policy
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    ln = cr.LANES[lane]
    pp = ts.policy_params
    vp = ts.v_params if with_v else None
    A = pp["log_std"].shape[0]
    s0, s1 = seed
    lanes = torch.arange(E, dtype=torch.int64, device=dev)
    for draw in [*range(2 * A), *(50 + j for j in range(ln.state_dim))]:
        for t in (0, T - 1, cr.T_INIT):
            if not torch.equal(cr.rng_bits_cuda(s0, s1, t, draw, E, dev),
                               cr.rng_bits(s0, s1, t, draw, lanes)):
                raise AssertionError(f"RNG bits differ at {(t, draw)}")
    print(f"  RNG bits of draws 0-{2 * A - 1}, 50-{49 + ln.state_dim}: "
          f"identical to the plain version", flush=True)
    args = (pp["mlp"], pp["log_std"], vp, seed, E, T, "relu", st0, steps0,
            0.99, lane)
    g0 = sum(c.n for c in cr.global_launches.values())
    raw = cr.rollout_kernel(*args)
    variant = ("global" if sum(c.n for c in cr.global_launches.values()) > g0
               else "smem")
    ref = cr.rollout_plain(*args[:5], min(T, 10), *args[6:])
    torch.cuda.synchronize()
    print(f"  the launch took the {variant!r} variant", flush=True)
    errs = {}
    if not torch.equal(raw.obs[0], ref.obs[0]):
        raise AssertionError("the first obs differs from the plain version")
    errs["early"] = check("steps 0-9 vs plain", max(
        max_err(raw.action[:10], ref.action[:10]),
        max_err(raw.next_obs[:10], ref.next_obs[:10])), 1e-4)
    rep = cr.replay_plain(lane, raw.action, seed, st0, steps0)
    for key in ("obs", "next_obs", "reward", "terminated", "truncated",
                "st_final", "steps_final"):
        if not torch.equal(rep[key], getattr(raw, key)):
            raise AssertionError(
                f"{key} differs from the kernel's actions replayed through "
                f"the plain physics: max |diff| "
                f"{max_err(rep[key], getattr(raw, key)):.3e}")
    print("  the kernel's actions replayed through the plain physics: obs, "
          "next_obs, rewards, done flags and final state equal bit for bit",
          flush=True)
    mu = mlp.apply(pp["mlp"], raw.obs, "relu")
    lp = policy.gaussian_log_prob_from_mean(mu, pp["log_std"], raw.action)
    errs["log_prob"] = check("log_prob vs plain forward",
                             max_err(lp, raw.log_prob), 1e-4)
    if with_v:
        errs["value"] = check("V(s), V(s') vs plain forward", max(
            max_err(mlp.apply(vp, raw.obs, "relu")[..., 0], raw.value),
            max_err(mlp.apply(vp, raw.next_obs, "relu")[..., 0],
                    raw.next_value)), 1e-4)
    eps = (raw.action - mu) / torch.exp(pp["log_std"])
    if abs(float(eps.mean())) > 0.03 or abs(float(eps.std()) - 1) > 0.03:
        raise AssertionError(f"sampling noise not N(0,1): {eps.mean()}, "
                             f"{eps.std()}")
    print(f"  {int(raw.terminated.sum())} terminations, "
          f"{int(raw.truncated.sum())} truncations in the window", flush=True)
    if not with_v:
        traj = ppo.Transition(raw.obs, raw.action, raw.log_prob, raw.next_obs,
                              raw.reward, raw.terminated, raw.truncated)
        want = ppo.eval_metrics_from_traj(traj, 0.99)
        sum_r, sum_j, n_eps = raw.metrics.sum(dim=1)
        if float(n_eps) != float(want.episodes) or float(n_eps) < 1:
            raise AssertionError(f"episode count {n_eps} vs {want.episodes}")
        check(f"R, J sums over {int(n_eps)} episodes vs the trajectory "
              f"(relative where above 1)", max(
                  abs(float(sum_r / n_eps - want.R))
                  / max(1.0, abs(float(want.R))),
                  abs(float(sum_j / n_eps - want.J))
                  / max(1.0, abs(float(want.J)))), 1e-4)
    times = rollout_timings(lambda: cr.rollout_kernel(*args),
                            lambda: cr.rollout_plain(*args), 10, 1,
                            warm=False)
    return raw, max(errs.values()), times, variant


def check_mlp_variant(params, x, dev, counters):
    """:func:`check_mlp`, and which variant of K5 it launched (from the
    launch counters)."""
    from ppoc_tpu_torch.ops import cuda_mlp as cm

    g0 = cm.fwd_global_launches.n
    out = check_mlp(params, x, "relu", dev)
    return out, "global" if cm.fwd_global_launches.n > g0 else "smem"


def epochs_by_phase(tr, n_epochs: int, per_epoch, counters, label: str):
    """Trainer ``tr``: evaluate, then ``n_epochs`` epochs, each
    ``Trainer.train_epoch`` timed by phase (:class:`PhaseClock`) and then
    evaluated, with every launch counter read around each phase and held
    to ``per_epoch`` ({phase: {kernel: launches}}, "evaluation" one
    evaluation's); eval R must rise by more than REACHER_GAIN.  Returns
    ({phase: {kernel: launches}} of the run, the initial evaluation
    included, per-epoch rows)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp

    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    n0 = read_counts(counters)
    ev0 = tr.evaluate()
    torch.cuda.synchronize()
    if count_diff(n0, read_counts(counters)) != per_epoch["evaluation"]:
        raise AssertionError(f"the {label} evaluation's launches differ from "
                             f"{per_epoch['evaluation']}")
    print(f"  evaluation before training: R {ev0.R:.4f}, episodes "
          f"{int(ev0.episodes)}", flush=True)
    by_phase = {ph: dict(v) if ph == "evaluation" else {}
                for ph, v in per_epoch.items()}
    rows, train_s = [], 0.0
    for i in range(n_epochs):
        clock = PhaseClock(counters, PhaseClock.MLP)
        gc.collect()        # earlier runs' garbage, collected outside
        t_fit = time.perf_counter()
        with clock:
            fit = tr.train_epoch()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_fit
        split = clock.split(wall)
        fit = ppo.FitMetrics(*(float(x) for x in fit))
        train_s += wall
        n0 = read_counts(counters)
        t_ev = time.perf_counter()
        ev = tr.evaluate()
        torch.cuda.synchronize()
        split["evaluation"] = time.perf_counter() - t_ev
        got = {ph: {k: v for k, v in clock.launches[ph].items() if v}
               for ph in clock.phases}
        got["evaluation"] = count_diff(n0, read_counts(counters))
        if got != per_epoch:
            raise AssertionError(f"{label} epoch {i}: launches {got} differ "
                                 f"from the config's {per_epoch}")
        for ph, counts in got.items():
            for k, v in counts.items():
                by_phase[ph][k] = by_phase[ph].get(k, 0) + v
        rows.append(dict(R=ev.R, wall=wall, split=split))
        print(f"  epoch {i}: R {ev.R:.4f}, value loss {fit.value_loss:.5f}, "
              f"policy loss {fit.policy_loss:.5f}; fit {wall:.3f} s, split "
              f"(s) " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; {clock.busy} calls found the stream busy", flush=True)
        if not all(math.isfinite(x) for x in (*fit, ev.R)):
            raise AssertionError(f"non-finite loss on {label}: {fit}, R "
                                 f"{ev.R}")
    print(f"  launches by phase, from the config: {per_epoch}; each epoch's "
          f"equal", flush=True)
    steps = n_epochs * tr.cfg.steps_per_epoch
    print(f"  {n_epochs} epochs: {train_s:.3f} s of training, "
          f"{steps / train_s:.0f} env-steps/s (training alone)", flush=True)
    check(f"eval R rise over {n_epochs} epochs ({ev0.R:.3f} -> "
          f"{rows[-1]['R']:.3f}), above {REACHER_GAIN}",
          -(rows[-1]["R"] - ev0.R), -REACHER_GAIN, what="minus the rise")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]),
            tr.state.policy_params.get("log_std", torch.zeros(0)))):
        raise AssertionError(f"non-finite weights after the {label} epochs")
    return by_phase, rows


def reacher_path(dev, counters):
    """Trainer(REACHER) on the card by default: REACHER_EPOCHS epochs by
    phase (:func:`epochs_by_phase`: a fit one K1 rollout with the V
    planes, one K2, a K5 forward and backward per minibatch step; an
    evaluation one K1 rollout with the metrics); then
    evaluate(deterministic=True), eval_len K5 forwards.  Returns (trainer,
    {phase: {kernel: launches}} of the run, per-epoch rows)."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo.trainer import Trainer

    cfg = PPOConfig(**REACHER)
    tr = Trainer(cfg)
    check_on_card(tr)
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    n_p = cfg.n_epochs_policy * cfg.num_minibatches
    f = cfg.fits_per_epoch
    # each fit: one K1 rollout with the V planes, one K2, a K5 forward and
    # backward (2x256 nets: the global-memory variant) per minibatch step;
    # each evaluation one K1 rollout with the metrics
    per_epoch = {
        "rollout": {"rollout_global[reacher]/values": f},
        "GAE": {"gae_norm": f},
        "value phase": {"mlp_forward_global": f * n_v,
                        "mlp_backward_global": f * n_v},
        "policy phase": {"mlp_forward_global": f * n_p,
                         "mlp_backward_global": f * n_p},
        "draws": {},
        "evaluation": {"rollout_global[reacher]/metrics": 1}}
    by_phase, rows = epochs_by_phase(tr, REACHER_EPOCHS, per_epoch, counters,
                                     "reacher")
    n0 = read_counts(counters)
    t0 = time.perf_counter()
    evd = tr.evaluate(deterministic=True)
    torch.cuda.synchronize()
    det = count_diff(n0, read_counts(counters))
    print(f"  evaluate(deterministic=True): R {evd.R:.4f}, episodes "
          f"{int(evd.episodes)}, {time.perf_counter() - t0:.3f} s; launches "
          f"{det}", flush=True)
    if det != {"mlp_forward_global": cfg.eval_len} or not math.isfinite(
            evd.R):
        raise AssertionError(f"the reacher mean-policy evaluation must be "
                             f"{cfg.eval_len} K5 forwards: {det}, {evd}")
    by_phase["mean-policy evaluation"] = det
    return tr, by_phase, rows


def mcc_path(dev, counters):
    """The MountainCarContinuous recipe: Trainer(MCC, seed)
    .train(MCC_EPOCHS, stop_at_R=MCC_SOLVED) on seed 0; if it misses, on
    seeds 1 and 2, which must both solve (MCC_SEEDS' rule).  The launch
    counters are held to the config's count for each run.  Returns the
    seed-0 run's (trainer, launches, history)."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo.trainer import Trainer

    runs = []
    for seed in MCC_SEEDS:
        if runs and runs[0]["solved"]:
            break
        cfg = PPOConfig(**MCC, seed=seed)
        tr = Trainer(cfg)
        check_on_card(tr)
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.train(n_epochs=MCC_EPOCHS, stop_at_R=MCC_SOLVED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: v for k, v in read_counts(counters).items() if v}
        epochs = len(hist)
        steps = (cfg.n_epochs_value + cfg.n_epochs_policy) * \
            cfg.num_minibatches * cfg.fits_per_epoch * epochs
        want = {"rollout[mountain_car_norm]/values":
                cfg.fits_per_epoch * epochs,
                "rollout[mountain_car_norm]/metrics": epochs + 1,
                "gae_norm": cfg.fits_per_epoch * epochs,
                "mlp_forward": steps, "mlp_backward": steps}
        solved = hist[-1]["R"] >= MCC_SOLVED
        R = [round(h["R"], 3) for h in hist]
        train_s = sum(h["time_s"] for h in hist)
        print(f"  seed {seed}: {'solved' if solved else 'NOT solved'} at "
              f"epoch {epochs} with R {hist[-1]['R']:.3f}; R per epoch {R}; "
              f"wall {wall:.3f} s (training {train_s:.3f} s, "
              f"{cfg.steps_per_epoch * epochs / wall:.0f} env-steps/s with "
              f"the evaluations); launches {n}", flush=True)
        if n != want:
            raise AssertionError(f"MountainCar launches {n} differ from the "
                                 f"config's {want}")
        runs.append(dict(seed=seed, solved=solved, tr=tr, n=n, hist=hist,
                         wall=wall))
    if not (runs[0]["solved"] or all(r["solved"] for r in runs[1:])):
        raise AssertionError(f"MountainCarContinuous not solved: seed 0 "
                             f"missed, and seeds 1 and 2 gave "
                             f"{[r['solved'] for r in runs[1:]]}")
    r0 = runs[0]
    return r0["tr"], r0["n"], r0["hist"], runs


def small_lane_config(lane: str):
    """The bench shape on ``simple`` (hidden 32) or raw ``mountain_car``
    (one fit an epoch, its 999-step horizon as the evaluation window)."""
    if lane == "simple":
        return bench_config().replace(env="simple", hidden=(32, 32))
    return bench_config().replace(env="mountain_car", fits_per_epoch=1,
                                  eval_len=999)


def small_lane_path(lane: str, dev, counters):
    """The bench shape on a small lane: ``simple`` must learn to reach its
    goal (Trainer.solve(SIMPLE_SOLVED, 10)), raw ``mountain_car`` trains 2
    epochs (a sparse reward: no solve expected).  Returns (trainer,
    launches, result)."""
    import torch

    from ppoc_tpu_torch.algo.trainer import Trainer

    cfg = small_lane_config(lane)
    tr = Trainer(cfg, dev)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if lane == "simple":
        res = tr.solve(SIMPLE_SOLVED, max_epochs=10)
        epochs = res["epochs"]
    else:
        hist = tr.train(n_epochs=2, log=False)
        res = {"epochs": 2, "R": hist[-1]["R"]}
        epochs = 2
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {k: v for k, v in read_counts(counters).items() if v}
    print(f"  {lane}: epochs {epochs}, R {res['R']:.4f}, wall {wall:.3f} s; "
          f"launches {n}", flush=True)
    fits = epochs * cfg.fits_per_epoch
    evals = epochs + (0 if lane == "simple" else 1)
    if (n.get(f"rollout[{lane}]/values"), n.get(f"rollout[{lane}]/metrics"),
            n.get("value_phase"), n.get("policy_phase")) != (
                fits, evals, fits, fits):
        raise AssertionError(f"{lane}: launches {n}, not {fits} training "
                             f"and {evals} evaluation rollouts, {fits} K3 "
                             f"and K4 phases")
    if lane == "simple" and not res["R"] > SIMPLE_SOLVED:
        raise AssertionError(f"simple did not learn: R {res['R']}")
    if not math.isfinite(res["R"]):
        raise AssertionError(f"{lane}: non-finite R")
    return tr, n, res


def reacher_mcc_phases(dev, counters, record):
    """K1's four new lanes against their plain versions at each path's
    shapes, K5's global-memory variant, K4 at two action dims; then the
    simple and mountain_car lanes' paths, the reacher regime and the
    MountainCarContinuous recipe, each with its launches; records every
    kernel row."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_rollout, cuda_update

    rcfg = PPOConfig(**REACHER)
    ts = Trainer(rcfg, dev).state
    pw, vw = mlp.dims(ts.policy_params["mlp"]), mlp.dims(ts.v_params)
    E, T = rcfg.n_envs, rcfg.rollout_len
    header(f"[K1 reacher lane: {E} envs x {T} steps with the V planes, nets "
           f"{pw} / {vw}]")
    raw, r_err, r_t, var = check_lane("reacher", ts, E, T, True,
                                      (0x01234567, 0x7F4A7C15), dev)
    if var != "global":
        raise AssertionError("2x256 nets must take the global-memory variant")
    L, EE = rcfg.eval_len, rcfg.eval_envs
    header(f"[K1 reacher lane: {EE} x {L} with the metrics]")
    raw_m, rm_err, rm_t, _ = check_lane("reacher", ts, EE, L, False,
                                        (0x0BADF00D, 0x5EED), dev)
    header(f"[K2 at {T} x {E}: the reacher rollout's planes]")
    _, _, rg_err, rg_t = check_gae(rcfg, raw, dev)
    draws = ppo.draw_fit(rcfg, torch.Generator().manual_seed(3), dev)
    x_mb, = buffer.gather_mb((raw.obs.reshape(-1, pw[0]),),
                             draws.value_idx[0, 0], rcfg.shuffle_block)
    header(f"[K5 at {rcfg.minibatch_size} rows, widths {vw} and {pw}, and "
           f"at {EE} rows (the mean-policy evaluation)]")
    (k5v, v_var) = check_mlp_variant(ts.v_params, x_mb, dev, counters)
    (k5p, p_var) = check_mlp_variant(ts.policy_params["mlp"], x_mb, dev,
                                     counters)
    (k5e, e_var) = check_mlp_variant(ts.policy_params["mlp"],
                                     raw.obs[0, :EE].contiguous(), dev,
                                     counters)
    if {v_var, p_var, e_var} != {"global"}:
        raise AssertionError("K5 at 2x256 must take the global-memory "
                             "variant")
    check_mlp_lean(f"K5 at {rcfg.minibatch_size} rows, widths {vw}",
                   ts.v_params, x_mb, rcfg.activation, dev)

    mcfg = PPOConfig(**MCC)
    tsm = Trainer(mcfg, dev).state
    mw = mlp.dims(tsm.v_params)
    mpw = mlp.dims(tsm.policy_params["mlp"])
    E, T, L, EE = mcfg.n_envs, mcfg.rollout_len, mcfg.eval_len, \
        mcfg.eval_envs
    header(f"[K1 mountain_car_norm lane: {E} envs x {T} steps with the V "
           f"planes]")
    rawc, c_err, c_t, _ = check_lane("mountain_car_norm", tsm, E, T, True,
                                     (0x9E3779B9, 0x85EBCA6B), dev)
    header(f"[K1 mountain_car_norm lane: {EE} x {L} with the metrics]")
    rawcm, cm_err, cm_t, _ = check_lane("mountain_car_norm", tsm, EE, L,
                                        False, (0xC2B2AE35, 0x632BE59B), dev)
    header(f"[K2 at {T} x {E}: the MountainCar rollout's planes]")
    _, _, cg_err, cg_t = check_gae(mcfg, rawc, dev)
    draws = ppo.draw_fit(mcfg, torch.Generator().manual_seed(4), dev)
    xc_mb, = buffer.gather_mb((rawc.obs.reshape(-1, mw[0]),),
                              draws.value_idx[0, 0])
    header(f"[K5 at {mcfg.minibatch_size} rows, widths {mw}]")
    (k5c, c_var) = check_mlp_variant(tsm.v_params, xc_mb, dev, counters)

    small = {}
    for i, lane in enumerate(("simple", "mountain_car")):
        scfg = small_lane_config(lane)
        sts = Trainer(scfg, dev).state
        E, T, L = scfg.n_envs, scfg.rollout_len, scfg.eval_len
        header(f"[K1 {lane} lane: {E} envs x {T} steps with the V planes]")
        sraw, s_err, s_t, _ = check_lane(lane, sts, E, T, True,
                                         (0x2545F491 + i, 17), dev)
        header(f"[K1 {lane} lane: {E} x {L} with the metrics]")
        sraw_m, sm_err, sm_t, _ = check_lane(lane, sts, E, L, False,
                                             (0x632BE59B + i, 29), dev)
        small[lane] = dict(cfg=scfg, pw=mlp.dims(sts.policy_params["mlp"]),
                           vw=mlp.dims(sts.v_params),
                           rollout=(s_err, s_t), metrics=(sm_err, sm_t),
                           raw=sraw, raw_m=sraw_m)

    kcfg = PPOConfig(env="reacher", n_envs=64, rollout_len=150,
                     minibatch_size=256, hidden=(64, 64),
                     kernel_backend="pallas")
    kts = Trainer(kcfg, dev).state
    header(f"[K4 at two action dims: reacher rows, widths "
           f"{mlp.dims(kts.policy_params['mlp'])}, minibatch 256]")
    pol = kts.policy_params
    kraw = cuda_rollout.rollout_kernel(
        pol["mlp"], pol["log_std"], kts.v_params, (0x1234, 0x5678),
        kcfg.n_envs, kcfg.rollout_len, lane="reacher")
    kadv, ktgt, _, _ = check_gae(kcfg, kraw, dev)
    _, pcols = phase_rows(kcfg, kraw, kadv, ktgt, dev, draw_seed=5)
    k4_err, k4_t = check_phase(
        "policy phase (2 action dims)", cuda_update.policy_phase_kernel,
        cuda_update.policy_phase_plain,
        (pol["mlp"], pol["log_std"], kts.opt_policy, kts.opt_log_std), pcols,
        kcfg, kcfg.lr_policy, [(kcfg.clip_eps, kcfg.ent_coeff),
                               (kcfg.clip_eps, 0.01)], WHOLE_RATIO["K4"],
        lean=True)
    n_k4 = kcfg.n_epochs_policy * kcfg.num_minibatches
    k4_b = phase_bound(mlp.dims(pol["mlp"]), n_k4, 256, 4)
    print(f"  K4 at two action dims ({n_k4} steps x 256; not on a main "
          f"path): device time kernel {k4_t['ms']:.4f} ms, plain "
          f"{k4_t['plain_ms']:.4f} ms; bound {k4_b[0]:.4f} ms ({k4_b[1]})",
          flush=True)

    for lane in small:
        header(f"[{lane} path: bench shape, "
               + ("solve(0.5, max_epochs=10)]" if lane == "simple"
                  else "2 epochs]"))
        d = small[lane]
        _, n, _ = small_lane_path(lane, dev, counters)
        scfg = d["cfg"]
        E, T, L = scfg.n_envs, scfg.rollout_len, scfg.eval_len
        path = f"{lane}, {E} envs x {T} steps, mb {scfg.minibatch_size}"
        record(f"rollout[{lane}]", path + " (training rollouts)", [T, E],
               n[f"rollout[{lane}]/values"], *d["rollout"],
               rollout_bound(d["pw"], d["vw"], d["raw"]))
        record(f"rollout[{lane}]", path + " (evaluation rollouts)", [L, E],
               n[f"rollout[{lane}]/metrics"], *d["metrics"],
               rollout_bound(d["pw"], None, d["raw_m"]))

    header(f"[reacher regime: Trainer(reacher, 4096 envs x 150, mb 16384 in "
           f"blocks of 4096, 2x256), evaluate, {REACHER_EPOCHS} epochs, "
           f"evaluate(deterministic=True)]")
    _, by, _ = reacher_path(dev, counters)
    E, T, mb = rcfg.n_envs, rcfg.rollout_len, rcfg.minibatch_size
    path = f"reacher regime, {E} envs x {T} steps, mb {mb}"
    record("rollout_global[reacher]", path + " (training rollouts)", [T, E],
           by["rollout"]["rollout_global[reacher]/values"], r_err, r_t,
           rollout_bound(pw, vw, raw))
    record("rollout_global[reacher]", path + " (evaluation rollouts)",
           [rcfg.eval_len, rcfg.eval_envs],
           by["evaluation"]["rollout_global[reacher]/metrics"], rm_err, rm_t,
           rollout_bound(pw, None, raw_m))
    record("gae_norm", path, [T, E], by["GAE"]["gae_norm"], rg_err, rg_t,
           gae_bound(T, E))
    for ph, name, (err, fwd, bwd), w in (
            ("value phase", "value net", k5v, vw),
            ("policy phase", "policy net", k5p, pw)):
        fb, bb = mlp_bounds(w, mb)
        record("mlp_forward_global", f"{path}, {name}", [mb] + w,
               by[ph]["mlp_forward_global"], err, fwd, fb)
        record("mlp_backward_global", f"{path}, {name}", [mb] + w,
               by[ph]["mlp_backward_global"], err, bwd, bb)
    record("mlp_forward_global", "reacher mean-policy evaluation",
           [rcfg.eval_envs] + pw,
           by["mean-policy evaluation"]["mlp_forward_global"], k5e[0],
           k5e[1], mlp_bounds(pw, rcfg.eval_envs)[0])

    header(f"[MountainCarContinuous recipe: Trainer(mountain_car_norm, 512 "
           f"envs x 999, mb 8192, ent_coeff 0.005).train({MCC_EPOCHS}, "
           f"stop_at_R={MCC_SOLVED}), seeds by the declared rule]")
    _, n, hist, _ = mcc_path(dev, counters)
    E, T, mb = mcfg.n_envs, mcfg.rollout_len, mcfg.minibatch_size
    path = f"MountainCarContinuous recipe (seed 0), {E} envs x {T} steps, " \
        f"mb {mb}"
    record("rollout[mountain_car_norm]", path + " (training rollouts)",
           [T, E], n["rollout[mountain_car_norm]/values"], c_err, c_t,
           rollout_bound(mpw, mw, rawc))
    record("rollout[mountain_car_norm]", path + " (evaluation rollouts)",
           [mcfg.eval_len, mcfg.eval_envs],
           n["rollout[mountain_car_norm]/metrics"], cm_err, cm_t,
           rollout_bound(mpw, None, rawcm))
    record("gae_norm", path, [T, E], n["gae_norm"], cg_err, cg_t,
           gae_bound(T, E))
    fb, bb = mlp_bounds(mw, mb)
    # the policy net [2,128,128,1] has the value net's widths
    record("mlp_forward", path + ", value and policy nets", [mb] + mw,
           n["mlp_forward"], k5c[0], k5c[1], fb)
    record("mlp_backward", path + ", value and policy nets", [mb] + mw,
           n["mlp_backward"], k5c[0], k5c[2], bb)


# --- K3, K4 and K6 past one block's shared memory (slice 6) -----------------

# the reference schedule (15 envs x 200 steps, minibatch 64: 46
# minibatches, 10 value and 4 policy epochs, 10 fits an epoch) at the
# reacher regime's 2x256 width, and the discrete path at that width: both
# under the fused gate, with nets past one block's shared memory
REACHER_REF = dict(env="reacher", hidden=(256, 256), kernel_backend="pallas")
REACHER_REF_EPOCHS = 3
CARTPOLE_WIDE = dict(env="cartpole", hidden=(256, 256), eval_len=500,
                     kernel_backend="pallas")
WIDE_SOLVE_EPOCHS = 10
# K3 at the fused gate's edge (ppo.MAX_FUSED_MB rows a minibatch)
GATE_MB, GATE_STEPS = 2048, 20
# a width between the replicated cluster's boundary ([3,h,h,1]: h 140) and
# 2x256, which the sharded cluster takes
MID_HIDDEN = (192, 192)


def wide_config(env: str, hidden=(256, 256), seed: int = 0):
    """REACHER_REF's schedule (CARTPOLE_WIDE's for a discrete env) for
    ``env`` at ``hidden``: REACHER_REF and CARTPOLE_WIDE themselves at
    2x256."""
    from ppoc_tpu_torch import PPOConfig

    base = CARTPOLE_WIDE if env in DISCRETE_SOLVE_R else REACHER_REF
    return PPOConfig(**dict(base, env=env, hidden=tuple(hidden), seed=seed))


def wide_launches(cfg, epochs: int):
    """The launches ``epochs`` epochs of a 2x256 fused path make, by phase:
    per fit one K1 rollout with the V planes, one K2, one K3 and one K4
    (K6 for a discrete env), all but K2 in their second variant;
    per evaluation one K1 rollout with the metrics; the host's row draws
    none."""
    lane, f = cfg.env, cfg.fits_per_epoch * epochs
    policy = ("policy_phase_categorical_global" if lane in DISCRETE_SOLVE_R
              else "policy_phase_global")
    return {"rollout": {f"rollout_global[{lane}]/values": f},
            "GAE": {"gae_norm": f},
            "value phase": {"value_phase_global": f},
            "policy phase": {policy: f}, "draws": {},
            "evaluation": {f"rollout_global[{lane}]/metrics": epochs}}


def check_global_phase(counter_g, counter_s, *args, **kw):
    """:func:`check_phase`, and every launch it made took the second
    variant (``counter_g``: the sharded cluster), none the shared-memory
    one (``counter_s``)."""
    g0, s0 = counter_g.n, counter_s.n
    out = check_phase(*args, **kw)
    if counter_s.n != s0 or counter_g.n == g0:
        raise AssertionError(f"{args[0]}: the net must take the second "
                             f"variant ({counter_g.kernel} "
                             f"{counter_g.n - g0}, {counter_s.kernel} "
                             f"{counter_s.n - s0} launches)")
    return out


def wide_rows(cfg, ts, seed, draw_seed: int, dev):
    """One fit's value and policy rows of ``cfg``'s lane at the reference
    shape: K1 (the global-memory variant) with the V planes, K2 as
    :func:`check_gae` holds it, then :func:`phase_rows`.  At seed 0 these
    are tools/policy_phase_drift.py's rows of its first draw."""
    from ppoc_tpu_torch.ops import cuda_rollout

    pol = ts.policy_params
    raw = cuda_rollout.rollout_kernel(
        pol["mlp"], pol.get("log_std"), ts.v_params, seed, cfg.n_envs,
        cfg.rollout_len, cfg.activation, None, None, 0.99, cfg.env)
    adv, tgt, _, _ = check_gae(cfg, raw, dev)
    return raw, tgt, phase_rows(cfg, raw, adv, tgt, dev, draw_seed=draw_seed)


def generic_times(fn):
    """(wall ms, device ms) of ``fn``, a generic phase (ppo.value_phase or
    ppo.policy_phase past the fused gate: per minibatch a K5 forward, the
    loss, autograd through K5's backward, Adam) at GATE_MB rows a
    minibatch, with ppo.MAX_FUSED_MB lowered below GATE_MB for the call
    alone."""
    from ppoc_tpu_torch.algo import ppo

    fused = ppo.MAX_FUSED_MB
    ppo.MAX_FUSED_MB = GATE_MB - 1
    try:
        return timed_ms(fn, 3), device_ms(fn, 1)
    finally:
        ppo.MAX_FUSED_MB = fused


def gate_edge_line(label: str, times: dict, wall: float, dev_ms: float):
    """Print a phase at the gate's edge beside the generic phases; returns
    ``times`` with theirs."""
    print(f"  {label}, {GATE_STEPS} steps x {GATE_MB}: the cluster kernel "
          f"{times['ms']:.4f} ms device; the generic phases {wall:.4f} ms "
          f"wall, {dev_ms:.4f} ms device; the plain version "
          f"{times['plain_ms']:.4f} ms device", flush=True)
    return dict(times, generic_wall_ms=wall, generic_ms=dev_ms)


def gate_edge_ids(dev):
    """The row ids of one epoch of GATE_STEPS minibatches of GATE_MB rows,
    in order."""
    import torch

    return torch.arange(GATE_STEPS * GATE_MB, device=dev).reshape(
        1, GATE_STEPS, GATE_MB)


def check_gate_edge(cfg, ts, raw, tgt, dev):
    """K3 with the 2x256 value net at the fused gate's edge: GATE_STEPS
    steps of GATE_MB rows (drawn from one fit's rows with replacement),
    held as :func:`check_phase` holds a phase (the whole phase's distance
    from float64 printed only: no reading sets a limit at this shape), and
    the generic phases on the same rows, wall and device time
    (:func:`generic_times`), the path a minibatch past the gate takes;
    returns (max abs error, timings)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.ops import cuda_update as cu

    idx = torch.randint(0, tgt.numel(), (GATE_STEPS * GATE_MB,),
                        generator=torch.Generator().manual_seed(6)).to(dev)
    cols = (raw.obs.reshape(tgt.numel(), -1)[idx].contiguous(),
            tgt.reshape(-1)[idx].contiguous())
    edge = cfg.replace(minibatch_size=GATE_MB)
    err, times = check_global_phase(
        cu.value_global_launches, cu.value_launches,
        f"value phase (2x256, mb {GATE_MB})", cu.value_phase_kernel,
        cu.value_phase_plain, (ts.v_params, ts.opt_v), cols, edge,
        cfg.lr_v, [()], None)
    zero = torch.zeros(idx.numel(), device=dev)
    buf = buffer.RowBuffer(cols[0], zero[:, None], zero, zero, cols[1])
    ids = gate_edge_ids(dev)
    return err, gate_edge_line("value phase (2x256)", times, *generic_times(
        lambda: ppo.value_phase(edge, ts, buf, ids)))


def check_categorical_gate_edge(cfg, ts, pcols, dev):
    """K6 with CARTPOLE_WIDE's 2x256 policy net at the fused gate's edge:
    GATE_STEPS steps of GATE_MB rows drawn with replacement from one fit's
    policy rows ``pcols``, held and timed beside the generic phases as
    :func:`check_gate_edge` holds K3; returns (max abs error, timings)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.ops import cuda_update as cu

    idx = torch.randint(0, pcols[0].shape[0], (GATE_STEPS * GATE_MB,),
                        generator=torch.Generator().manual_seed(9)).to(dev)
    cols = tuple(c[idx].contiguous() for c in pcols)
    edge = cfg.replace(minibatch_size=GATE_MB)
    err, times = check_global_phase(
        cu.categorical_global_launches, cu.categorical_launches,
        f"categorical policy phase (2x256, mb {GATE_MB})",
        cu.policy_phase_categorical_kernel, cu.policy_phase_categorical_plain,
        (ts.policy_params["mlp"], ts.opt_policy), cols, edge, cfg.lr_policy,
        [(cfg.clip_eps, cfg.ent_coeff), (cfg.clip_eps, 0.01)], None)
    buf = buffer.RowBuffer(*cols, torch.zeros(idx.numel(), device=dev))
    ids = gate_edge_ids(dev)
    return err, gate_edge_line(
        "categorical policy phase (2x256)", times, *generic_times(
            lambda: ppo.policy_phase(edge, ts, buf, ids, discrete=True)))


def reacher_ref_path(counters):
    """Trainer(REACHER_REF) on the card by default: REACHER_REF_EPOCHS
    epochs by phase (:func:`epochs_by_phase`), each fit's K3 and K4 in
    their global-memory variants and no shared-memory phase, eval R up by
    more than REACHER_GAIN.  Returns {phase: {kernel: launches}}."""
    from ppoc_tpu_torch.algo.trainer import Trainer

    tr = Trainer(wide_config("reacher"))
    check_on_card(tr)
    per_epoch = wide_launches(tr.cfg, 1)
    by_phase, _ = epochs_by_phase(tr, REACHER_REF_EPOCHS, per_epoch,
                                  counters, "REACHER_REF")
    return by_phase


def cartpole_wide_path(counters):
    """Trainer(CARTPOLE_WIDE).solve(475, WIDE_SOLVE_EPOCHS) on the card by
    default, timed by phase with the evaluations as a phase of their own
    (:class:`PhaseClock`), every launch counter read around each phase and
    held to the config's count for the epochs it ran (K6 and K3 in their
    global-memory variants, no K4, no shared-memory phase); it must solve.
    Returns {phase: {kernel: launches}}."""
    import torch

    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp

    tr = Trainer(wide_config("cartpole"))
    check_on_card(tr)
    target = DISCRETE_SOLVE_R["cartpole"]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    clock = PhaseClock(counters, PhaseClock.MLP_SOLVE)
    gc.collect()            # earlier runs' garbage, collected outside
    t0 = time.perf_counter()
    with clock:
        res = tr.solve(target, max_epochs=WIDE_SOLVE_EPOCHS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = clock.split(wall)
    got = {ph: {k: v for k, v in clock.launches[ph].items() if v}
           for ph in clock.phases}
    want = wide_launches(tr.cfg, res["epochs"])
    print(f"  epochs {res['epochs']}, final R {res['R']:.3f}, wall "
          f"{wall:.3f} s, split (s) "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; {clock.busy} calls found the stream busy; launches by phase "
          f"{got}", flush=True)
    if got != want:
        raise AssertionError(f"CARTPOLE_WIDE launches {got} differ from the "
                             f"config's {want}")
    if not (math.isfinite(res["R"]) and res["R"] >= target):
        raise AssertionError(f"CARTPOLE_WIDE not solved in "
                             f"{WIDE_SOLVE_EPOCHS} epochs: R {res['R']}")
    if not all(torch.isfinite(mlp.flatten(t)).all() for t in (
            tr.state.v_params, tr.state.policy_params["mlp"])):
        raise AssertionError("non-finite weights after the CARTPOLE_WIDE "
                             "solve")
    return got


def wide_phases(dev, counters, record):
    """K3 and K4 on REACHER_REF's rows and K3 and K6 on CARTPOLE_WIDE's,
    each as :func:`check_phase` holds a phase and in its second variant
    (the sharded cluster); K3 and K6 at the gate's edge beside the generic
    phases; the sharded cluster's registers, a step's time of K3 and K6 by
    cluster size and K3 at MID_HIDDEN; then the two paths, with their
    launches; records every kernel row."""
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    rcfg, ccfg = wide_config("reacher"), wide_config("cartpole")
    rts, cts = Trainer(rcfg, dev).state, Trainer(ccfg, dev).state
    pw, vw = mlp.dims(rts.policy_params["mlp"]), mlp.dims(rts.v_params)
    cpw, cvw = mlp.dims(cts.policy_params["mlp"]), mlp.dims(cts.v_params)
    mb = rcfg.minibatch_size
    n_v = rcfg.n_epochs_value * rcfg.num_minibatches
    n_p = rcfg.n_epochs_policy * rcfg.num_minibatches
    header(f"[fused phases past shared memory: REACHER_REF's rows, K3 on "
           f"{vw} ({n_v} steps x {mb}), K4 on {pw} ({n_p} steps)]")
    raw, tgt, (vcols, pcols) = wide_rows(rcfg, rts, (0x01234567, 0x89ABCDEF),
                                         1, dev)
    pol = rts.policy_params
    k3 = check_global_phase(
        cu.value_global_launches, cu.value_launches, "value phase (2x256)",
        cu.value_phase_kernel, cu.value_phase_plain, (rts.v_params, rts.opt_v),
        vcols, rcfg, rcfg.lr_v, [()], WHOLE_RATIO["K3 2x256"], lean=True)
    k4 = check_global_phase(
        cu.policy_global_launches, cu.policy_launches,
        "policy phase (2x256, 2 action dims)", cu.policy_phase_kernel,
        cu.policy_phase_plain,
        (pol["mlp"], pol["log_std"], rts.opt_policy, rts.opt_log_std), pcols,
        rcfg, rcfg.lr_policy, [(rcfg.clip_eps, rcfg.ent_coeff),
                               (rcfg.clip_eps, 0.01)], WHOLE_RATIO["K4 2x256"],
        lean=True)
    header(f"[K3 at the fused gate's edge: {GATE_STEPS} steps x {GATE_MB}, "
           f"{vw}]")
    edge = check_gate_edge(rcfg, rts, raw, tgt, dev)
    header("[the sharded cluster: registers, a step's time of K3 and K6 by "
           "cluster size, K3 past the replicated cluster's boundary]")
    for kind, res in cluster_resources("shard").items():
        print(f"  nvcc: the {kind} sharded cluster kernel: {res}", flush=True)
    cluster_grid_times(dev, 20, tuple(vw), (mb, GATE_MB), "global")
    cluster_grid_times(dev, 20, (4, 256, 256, 2), (mb,), "global",
                       "categorical policy")
    hcfg = wide_config("pendulum", MID_HIDDEN)
    hts = Trainer(hcfg, dev).state
    hw = mlp.dims(hts.v_params)
    _, _, (hcols, _) = wide_rows(hcfg, hts, (0x510E527F, 0x9B05688C), 7, dev)
    k3h = check_global_phase(
        cu.value_global_launches, cu.value_launches,
        f"value phase ({hw})", cu.value_phase_kernel, cu.value_phase_plain,
        (hts.v_params, hts.opt_v), hcols, hcfg, hcfg.lr_v, [()], None)
    header(f"[fused phases past shared memory: CARTPOLE_WIDE's rows, K3 "
           f"on {cvw}, K6 on {cpw}]")
    _, _, (cvcols, cpcols) = wide_rows(ccfg, cts, (0x2545F491, 0x9E3779B9),
                                       2, dev)
    # on these rows one step of the one-block kernel this slot had (of 460)
    # parted from float64 by 1.35e-6 where cuBLAS's parts by 2.8e-8, a ReLU
    # gate within rounding: the walk holds such a step to the float64 steps
    # with those gates either way
    k3c = check_global_phase(
        cu.value_global_launches, cu.value_launches,
        "value phase (2x256, cartpole rows)", cu.value_phase_kernel,
        cu.value_phase_plain, (cts.v_params, cts.opt_v), cvcols, ccfg,
        ccfg.lr_v, [()], WHOLE_RATIO["K3 2x256"])
    k6 = check_global_phase(
        cu.categorical_global_launches, cu.categorical_launches,
        "categorical policy phase (2x256)", cu.policy_phase_categorical_kernel,
        cu.policy_phase_categorical_plain,
        (cts.policy_params["mlp"], cts.opt_policy), cpcols, ccfg,
        ccfg.lr_policy, [(ccfg.clip_eps, ccfg.ent_coeff),
                         (ccfg.clip_eps, 0.01)], WHOLE_RATIO["K6 2x256"],
        lean=True)
    header(f"[K6 at the fused gate's edge: {GATE_STEPS} steps x {GATE_MB}, "
           f"{cpw}]")
    k6e = check_categorical_gate_edge(ccfg, cts, cpcols, dev)

    header(f"[REACHER_REF: Trainer(reacher, 2x256, the reference schedule), "
           f"evaluate, {REACHER_REF_EPOCHS} epochs]")
    rn = reacher_ref_path(counters)
    header(f"[CARTPOLE_WIDE: Trainer(cartpole, 2x256, eval_len 500)"
           f".solve({DISCRETE_SOLVE_R['cartpole']}, "
           f"max_epochs={WIDE_SOLVE_EPOCHS})]")
    cn = cartpole_wide_path(counters)

    path = f"REACHER_REF, {rcfg.n_envs} envs x {rcfg.rollout_len} steps, mb {mb}"
    record("value_phase_global", path, [n_v, mb] + vw,
           rn["value phase"]["value_phase_global"], *k3,
           phase_bound(vw, n_v, mb, 1))
    record("policy_phase_global", path, [n_p, mb] + pw,
           rn["policy phase"]["policy_phase_global"], *k4,
           phase_bound(pw, n_p, mb, pw[-1] + 2))
    record("value_phase_global", f"the fused gate's edge (not on a path; "
           f"REACHER_REF's rows)", [GATE_STEPS, GATE_MB] + vw, 0, *edge,
           phase_bound(vw, GATE_STEPS, GATE_MB, 1))
    record("value_phase_global", f"pendulum at {list(MID_HIDDEN)}, the "
           f"reference schedule's rows (not run by a path here)",
           [n_v, mb] + hw, 0, *k3h, phase_bound(hw, n_v, mb, 1))
    path = (f"CARTPOLE_WIDE solve, {ccfg.n_envs} envs x {ccfg.rollout_len} "
            f"steps, mb {mb}")
    record("value_phase_global", path, [n_v, mb] + cvw,
           cn["value phase"]["value_phase_global"], *k3c,
           phase_bound(cvw, n_v, mb, 1))
    record("policy_phase_categorical_global", path, [n_p, mb] + cpw,
           cn["policy phase"]["policy_phase_categorical_global"], *k6,
           phase_bound(cpw, n_p, mb, 3))
    record("policy_phase_categorical_global", "the fused gate's edge (not "
           "on a path; CARTPOLE_WIDE's rows)", [GATE_STEPS, GATE_MB] + cpw,
           0, *k6e, phase_bound(cpw, GATE_STEPS, GATE_MB, 3))


# --- the bf16 backend: K7's bf16 variant, RECALL_XL_BF16, REACHER_BF16 -----

# the two paths of the JAX package's kernel_backend "bf16" at full width
RECALL_XL_BF16 = dict(RECALL_XL, kernel_backend="bf16")
REACHER_BF16 = dict(REACHER, kernel_backend="bf16")
REACHER_BF16_EPOCHS = 3
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W): the
# bound of K7's bf16 rows, with their bytes at 2 B a bf16 element
PEAK_BF16 = 989e12
# K7's bf16 variant against its plain versions (the forward with the
# kernel's BF16_CHUNK) on the same bf16 inputs: every output within two bf16
# roundoffs (2^-7) of the leaf's largest magnitude (at least 1), and at
# most BF16_SHARE of the elements apart by more than 1e-5 of it: the two
# sum in another order, so a p, ds or w on a bf16 rounding boundary, or a
# bf16 output, now and then rounds the other way; a kernel that skipped a
# rounding would part on nearly all (tests/test_torch_cuda.py holds the
# same); lse is float32 throughout, FLASH_OUT_TOL
BF16_TOL, BF16_SHARE = 2.0 ** -7, 0.01
# apply_seq "bf16" through K7 against the same through its plain versions:
# the trunk carries each such flip on through every later product, and a
# gradient sums 4096 rows of them, so the two part on most elements by a
# little.  Held per output and gradient leaf by the relative two-norm: the
# kernel's path parts from the plain one by at most SEQ_RATIO of what bf16
# rounding itself moves the leaf (the plain bf16 path against the float32
# "pallas" path; the first card reading: at most 0.157)
SEQ_RATIO = 0.25
# K7 bf16's signed lean against its plain versions: per output, the sum of
# (kernel - plain) * sign(plain) over the sum of |plain|, pooled over the
# inputs of LEAN_SEEDS (added to each timed case's seed); below zero is
# toward zero.  mma.sync rounds its sums toward zero, so a kernel that
# chains every k-step of a product into its running sum leans every output
# toward zero: bf16_agree does not see that (the first build of the
# tensor-core design passed it).  The kernel's largest |lean| must stay
# within LEAN_TOL at the recall_xl value pass and at X-ray.  Its control,
# the plain versions with every running sum rounded toward zero 16 keys (or
# queries) at a time (toward_zero=True), must lean past it at the value
# pass, where a row sums up to 1024 keys; at X-ray's ~50-step episodes a
# chain is a few steps long and the control leans little, so there its
# reading is printed only.  The minibatch (B 4) holds too few elements for
# a lean of its bf16 outputs: some tens of them round the other way, so a
# sound kernel's lean there moves by more than LEAN_TOL from input to input
LEAN_TOL = 2.5e-7
LEAN_SEEDS = (0, 100, 200)
# the decode (float32, as the JAX package's rollout) against the bf16
# replay at the initial weights: bf16-sized by design; a replay over the
# wrong attention sets parts by order 1
BF16_GAP_TOL = 0.25


def kernel_resources(stem: str):
    """{"name<hd>": "N registers, S B spill stores, L B spill loads"} of the
    K7 kernels whose name ends in ``stem``, from the build's nvcc.log (the
    compiler's -Xptxas -v report)."""
    import re

    from ppoc_tpu_torch.ops import _build

    res, name = {}, None
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?\d+(flash_\w+?)ILi(\d+)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>" if m.group(1).endswith(
                stem) else None
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            res[name] = f"{spill.group(1)} B spill stores, " \
                        f"{spill.group(2)} B spill loads"
        if name and regs:
            res[name] = f"{regs.group(1)} registers, " + res.get(name, "")
    if len(res) != 12:
        raise AssertionError(f"nvcc.log reports {len(res)} K7 kernels "
                             f"ending in {stem!r}, not 3 x 4 head dims")
    return res


def bf16_bound_ms(ops: float, nbytes: float):
    """(least ms, what sets it): operations over the bf16 tensor-core peak
    or bytes over the memory peak, the larger."""
    t_ops, t_bytes = ops / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bounds_bf16(case, rel: int, H: int):
    """K7's bf16 bounds for ``case``, as :func:`flash_bounds` counts its
    operations, with q, k, v, dout, dq, dk, dv at 2 B an element and out,
    lse, dsum at 4 B."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, _, _, _, _, ep_q, ep_k = case
    BH, T, hd = q.shape
    pairs = int(ca.valid_mask(ep_q, ep_k, rel, 1).sum()) * H
    e2, f4 = 2 * BH * T * hd, 4 * BH * T * hd
    ids, vec = 4 * 2 * ep_q.numel(), 4 * BH * T
    return (bf16_bound_ms(pairs * (4 * hd + 4), 3 * e2 + ids + f4 + vec),
            bf16_bound_ms(pairs * (6 * hd + 4), 4 * e2 + ids + 2 * vec + e2),
            bf16_bound_ms(pairs * (8 * hd + 4), 4 * e2 + ids + 2 * vec
                          + 2 * e2)), pairs


def bf16_agree(label: str, got, want, tol: float = BF16_TOL,
               share: float = BF16_SHARE) -> float:
    """Hold ``got`` to ``want`` as BF16_TOL says; returns the max |diff|."""
    top = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    apart = float((diff > 1e-5 * top).double().mean()) if diff.numel() \
        else 0.0
    print(f"  {label}: max |diff| {err:.3e}, over the plain max (at least 1) "
          f"{err / top:.3e} (tolerance {tol:.1e}); {apart:.2%} of elements "
          f"apart by more than 1e-5 of it (at most {share:.0%})", flush=True)
    if not (err <= tol * top and apart <= share):
        raise AssertionError(f"{label}: {err} over {top}, {apart} apart")
    return err


def check_flash_bf16(label: str, case, rel: int, H: int, dev,
                     time_it=False):
    """K7's bf16 forward (out, lse) and its bf16 dq and dk/dv kernels
    against their plain versions (the forward chunked as the kernel,
    ``BF16_CHUNK``) on ``case`` rounded to bf16; rows with no valid key out 0
    and lse NEG exactly; the backward twice, bit for bit.  Returns
    ({name: max abs error}, {kernel: timings} or None)."""
    import torch

    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, dout, g_lse, ep_q, ep_k = case
    bf = torch.bfloat16
    kargs = (q.to(bf), k.to(bf), v.to(bf), ep_q, ep_k, rel, H)
    out, lse = ca.flash_fwd_kernel(*kargs)
    dsum = ca.dsum_of(dout, out, g_lse).contiguous()
    bargs = kargs + (dout.to(bf), dsum, lse)
    got = (ca.flash_dq_kernel(*bargs),) + ca.flash_dkv_kernel(*bargs)
    again = (ca.flash_dq_kernel(*bargs),) + ca.flash_dkv_kernel(*bargs)
    out_p, lse_p = ca.attention_plain_bf16(*kargs, chunk=ca.BF16_CHUNK)
    want = ((ca.flash_dq_plain_bf16(*bargs),)
            + ca.flash_dkv_plain_bf16(*bargs))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two runs of K7's bf16 backward "
                             f"differ")
    if not (out.dtype == lse.dtype == torch.float32
            and all(g.dtype == bf for g in got)):
        raise AssertionError(f"{label}: out and lse must be float32, dq, "
                             f"dk, dv bf16")
    empty = lse_p <= ca.NEG / 2
    if not (torch.equal(lse[empty], lse_p[empty])
            and (out[empty] == 0).all()):
        raise AssertionError(f"{label}: rows with no valid key are not out "
                             f"0 and lse NEG")
    errs = {"out": bf16_agree(f"{label}, out", out, out_p)}
    lse_err = max_err(lse[~empty], lse_p[~empty]) if (~empty).any() else 0.0
    top = max(1.0, float(lse_p[~empty].abs().max())) if (~empty).any() \
        else 1.0
    errs["lse"] = check(f"{label}, lse over the plain max", lse_err / top,
                        FLASH_OUT_TOL, what="ratio") * top
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[name] = bf16_agree(f"{label}, {name}", a, b)
    print(f"  {label}: backward twice, bit for bit; {int(empty.sum())} rows "
          f"with no valid key", flush=True)
    if not time_it:
        return errs, None
    control, _ = ca.attention_plain_bf16(*kargs, chunk=ca.BF16_CHUNK,
                                         round_l=True)
    try:
        bf16_agree(f"{label}, control: l summed from bf16(p), out", control,
                   out_p)
    except AssertionError:
        print(f"  {label}: the control fails the check, as it must",
              flush=True)
    else:
        raise AssertionError(f"{label}: the check passes a forward that "
                             f"sums l from bf16(p)")
    print(f"  {label}: {visit_shares(case, rel, ca.BF16_ROWS)}", flush=True)
    import torch.nn.functional as F

    B = ep_q.shape[0]
    T, hd = q.shape[1], q.shape[2]
    mask = ca.valid_mask(ep_q, ep_k, rel, 1)[:, None]              # [B, 1, T, T]
    q4, k4, v4 = (t.reshape(B, H, T, hd).requires_grad_()
                  for t in kargs[:3])
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    d4 = bargs[7].reshape(B, H, T, hd)

    def lib_bwd(wrt):
        return lambda: torch.autograd.grad(lib_out, wrt, d4,
                                           retain_graph=True)

    times = {
        "flash_fwd_bf16": timings(
            lambda: ca.flash_fwd_kernel(*kargs),
            lambda: ca.attention_plain_bf16(*kargs, chunk=ca.BF16_CHUNK),
            20, 3),
        "flash_bwd_dq_bf16": timings(
            lambda: ca.flash_dq_kernel(*bargs),
            lambda: ca.flash_dq_plain_bf16(*bargs), 20, 3),
        "flash_bwd_dkv_bf16": timings(
            lambda: ca.flash_dkv_kernel(*bargs),
            lambda: ca.flash_dkv_plain_bf16(*bargs), 20, 3),
    }
    times["flash_fwd_bf16"]["library_ms"] = queued_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
        20)
    times["flash_bwd_dq_bf16"]["library_ms"] = queued_ms(lib_bwd((q4,)), 20)
    times["flash_bwd_dkv_bf16"]["library_ms"] = queued_ms(
        lib_bwd((k4, v4)), 20)
    parts = "; ".join(f"{k} {t['ms']:.4f} / {t['plain_ms']:.4f} / "
                      f"{t['library_ms']:.4f}" for k, t in times.items())
    print(f"  {label}: device ms, kernel / plain / SDPA in bf16 (its output "
          f"bf16; timed, not compared): {parts}", flush=True)
    return errs, times


def lean_bf16(make, seed: int, rel: int, H: int):
    """K7 bf16's lean and its control's (see LEAN_TOL), each output's
    pooled over LEAN_SEEDS: ({"kernel" | "control": [out, dq, dk, dv]},
    [per-seed line])."""
    import torch

    from ppoc_tpu_torch.ops import cuda_attn as ca

    bf = torch.bfloat16
    num = {"kernel": [0.0] * 4, "control": [0.0] * 4}
    den, lines = [0.0] * 4, []
    for d in LEAN_SEEDS:
        q, k, v, dout, g_lse, ep_q, ep_k = make(seed + d)
        kargs = (q.to(bf), k.to(bf), v.to(bf), ep_q, ep_k, rel, H)
        out, lse = ca.flash_fwd_kernel(*kargs)
        dsum = ca.dsum_of(dout, out, g_lse).contiguous()
        bargs = kargs + (dout.to(bf), dsum, lse)
        runs = {"kernel": (out, ca.flash_dq_kernel(*bargs))
                + ca.flash_dkv_kernel(*bargs)}
        for name, tz in (("plain", False), ("control", True)):
            runs[name] = ((ca.attention_plain_bf16(
                *kargs, chunk=ca.BF16_CHUNK, toward_zero=tz)[0],
                ca.flash_dq_plain_bf16(*bargs, toward_zero=tz))
                + ca.flash_dkv_plain_bf16(*bargs, toward_zero=tz))
        parts = {}
        for i, b in enumerate(runs["plain"]):
            b = b.double()
            mag = float(b.abs().sum())
            den[i] += mag
            for name in num:
                x = float(((runs[name][i].double() - b) * b.sign()).sum())
                num[name][i] += x
                parts.setdefault(name, []).append(x / mag)
        lines.append(f"seed {seed + d}: " + "; ".join(
            f"{name} " + ", ".join(f"{o} {x:+.3e}" for o, x in zip(
                ("out", "dq", "dk", "dv"), xs)) for name, xs in parts.items()))
    return {name: [n / m for n, m in zip(xs, den)]
            for name, xs in num.items()}, lines


def check_lean_bf16(label: str, make, seed: int, rel: int, H: int,
                    control_sees: bool):
    """Hold K7 bf16's pooled lean within LEAN_TOL; where ``control_sees``,
    its control must lean past it."""
    leans, lines = lean_bf16(make, seed, rel, H)
    for line in lines:
        print(f"  {label}, lean {line}", flush=True)
    worst = {name: max(abs(x) for x in xs) for name, xs in leans.items()}
    print(f"  {label}: lean pooled over {len(LEAN_SEEDS)} inputs, kernel "
          + ", ".join(f"{o} {x:+.3e}" for o, x in zip(
              ("out", "dq", "dk", "dv"), leans["kernel"]))
          + f" (|lean| at most {LEAN_TOL:.1e}); control "
          + ", ".join(f"{o} {x:+.3e}" for o, x in zip(
              ("out", "dq", "dk", "dv"), leans["control"])), flush=True)
    if not worst["kernel"] <= LEAN_TOL:
        raise AssertionError(f"{label}: K7 bf16 leans {leans['kernel']}")
    if control_sees:
        if worst["control"] <= LEAN_TOL:
            raise AssertionError(f"{label}: the lean check passes sums "
                                 f"rounded toward zero: {leans['control']}")
        print(f"  {label}: the control fails the lean check, as it must",
              flush=True)


def check_flash_bf16_all(dev):
    """K7's bf16 variant at every shape phase 9 holds the f32 one at, on
    the same inputs, and its lean (LEAN_TOL) at the value pass and X-ray;
    returns {shape name: (case, rel, H, errors, timings)}."""
    T, B, H, hd = 1024, 4, 4, 8
    xl = dones_of_rollout("recall_xl", T, 32, dev)
    xray_dones = random_dones(2048, 16, 0.02, 7, dev)
    runs = {}
    # (name, case of a seed, seed, H, timed, lean held: the kernel's, or
    # also that its control fails)
    for name, make, seed, Hn, time_it, lean in (
            ("recall_xl minibatch (T 1024, B 4, H 4, hd 8), rollout "
             "episodes", lambda s: flash_case(T, B, H, hd, xl[:, :B], s, dev),
             1, H, True, None),
            ("recall_xl minibatch, p_done 0.02",
             lambda s: flash_case(T, B, H, hd, random_dones(T, B, 0.02, 2,
                                                            dev), s, dev),
             3, H, False, None),
            ("recall_xl value pass (T 1024, B 32, H 4, hd 8)",
             lambda s: flash_case(T, 32, H, hd, xl, s, dev), 4, H, True,
             "kernel and control"),
            ("ragged T 1030 (B 4, H 4, hd 8), p_done 0.02",
             lambda s: flash_case(1030, B, H, hd, random_dones(
                 1030, B, 0.02, 5, dev), s, dev), 6, H, False, None),
            ("X-ray (T 2048, B 16, H 8, hd 64), p_done 0.02",
             lambda s: flash_case(2048, 16, 8, 64, xray_dones, s, dev), 8, 8,
             True, "kernel")):
        case = make(seed)
        errs, times = check_flash_bf16(name, case, 0, Hn, dev, time_it)
        if lean:
            check_lean_bf16(name, make, seed, 0, Hn,
                            lean == "kernel and control")
        runs[name] = (case, 0, Hn, errs, times)
    q_d = random_dones(T, B, 0.02, 9, dev)
    k_d = random_dones(T, B, 0.02, 10, dev)
    for rel in (-1, 0, 1):
        name = f"ring block rel {rel:+d} (T 1024, B 4, H 4, hd 8)"
        errs, _ = check_flash_bf16(name, flash_case(T, B, H, hd, q_d, 11,
                                                    dev, k_dones=k_d),
                                   rel, H, dev)
        runs[name] = (None, rel, H, errs, None)
    return runs


class PlainK7Bf16:
    """Within the block, K7's bf16 wrappers run their plain versions on
    CUDA tensors (the forward chunked as the kernel): ``FlashAttention``
    looks the three wrappers up at call time, so apply_seq's path is the
    same but for the kernels."""

    def __enter__(self):
        from ppoc_tpu_torch.ops import cuda_attn as ca

        self.saved = (ca.flash_fwd_kernel, ca.flash_dq_kernel,
                      ca.flash_dkv_kernel)
        ca.flash_fwd_kernel = lambda *a: ca.attention_plain_bf16(
            *a, chunk=ca.BF16_CHUNK)
        ca.flash_dq_kernel = ca.flash_dq_plain_bf16
        ca.flash_dkv_kernel = ca.flash_dkv_plain_bf16
        return self

    def __exit__(self, *exc):
        from ppoc_tpu_torch.ops import cuda_attn as ca

        (ca.flash_fwd_kernel, ca.flash_dq_kernel,
         ca.flash_dkv_kernel) = self.saved


def check_apply_seq_bf16(dev):
    """apply_seq(backend="bf16") through K7's bf16 variant against the same
    through its plain versions (:class:`PlainK7Bf16`) at recall_xl's
    widths, on check_apply_seq's inputs: the output and every parameter
    gradient of sum(out * c), each leaf within SEQ_RATIO of the float32
    path's distance (apply_seq "pallas"); the kernel run launches each
    bf16 kernel once a layer, the plain run none.  Returns the largest
    ratio."""
    import torch

    from ppoc_tpu_torch.models import attn
    from ppoc_tpu_torch.ops import adam, cuda_attn as ca

    T, E = 1024, 4
    g = torch.Generator().manual_seed(12)
    p = attn.init(2, 32, 2, 4, 128, T + 1, (32, 32, 1), g, dev)
    xs = torch.randn(T, E, 2, generator=g).to(dev)
    dones = torch.cat([dones_of_rollout("recall_xl", T, 2, dev),
                       random_dones(T, 2, 0.02, 13, dev)], dim=1)
    c = torch.randn(T, E, 1, generator=g).to(dev)
    counters = (ca.fwd_bf16_launches, ca.dq_bf16_launches,
                ca.dkv_bf16_launches)
    res, launches = {}, {}
    for name, backend in (("kernel", "bf16"), ("plain", "bf16"),
                          ("float32", "pallas")):
        n0 = [x.n for x in counters]
        with (PlainK7Bf16() if name == "plain" else
              contextlib.nullcontext()):
            leaves = adam.tree_map(lambda t: t.detach().requires_grad_(), p)
            out = attn.apply_seq(leaves, xs, dones, "relu", backend=backend)
            res[name] = [out.detach()] + list(torch.autograd.grad(
                (out * c).sum(), adam.tree_leaves(leaves)))
        torch.cuda.synchronize()
        launches[name] = [x.n - n for x, n in zip(counters, n0)]
    if launches != {"kernel": [2, 2, 2], "plain": [0, 0, 0],
                    "float32": [0, 0, 0]}:
        raise AssertionError(f"apply_seq bf16 launches {launches}")
    ratios = []
    for k, pl, f in zip(res["kernel"], res["plain"], res["float32"]):
        apart, bf16_move = float((k - pl).norm()), float((pl - f).norm())
        ratios.append(apart / bf16_move if bf16_move else
                      (0.0 if apart == 0 else math.inf))
    worst = max(ratios)
    print(f"  apply_seq bf16, K7 against its plain versions: the output and "
          f"{len(ratios) - 1} parameter gradients part by at most "
          f"{worst:.3f} of the bf16-against-float32 distance (output "
          f"{ratios[0]:.3f}; max |diff| of the output "
          f"{max_err(res['kernel'][0], res['plain'][0]):.3e})", flush=True)
    if not worst <= SEQ_RATIO:
        raise AssertionError(f"apply_seq bf16 through K7 parts from its plain "
                             f"versions: ratios {ratios}")
    return worst


def check_bf16_products(dev, v_params, rows: int):
    """The bf16 MLP product on the card (``mlp.bf16_dot``: bf16 tensor
    cores, float32 output) against the CPU form run on the card with TF32
    off (float32 products of the bf16 values), at REACHER_BF16's widest
    layer ([rows, 256] x [256, 256]): the forward within 1e-5 of the sum of
    |products| (exact products summed in another order); the gradients
    are the same float32 products rounded to bf16, so equal but for a
    rounding flip (within 2^-7 of the element) on at most 1% of them.
    Returns the forward's and the gradients' max |diff| and the device ms
    of each form's forward."""
    import torch

    from ppoc_tpu_torch.models import mlp

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the CPU form is held with TF32 off")
    w0 = v_params[1][0].detach()
    g = torch.Generator().manual_seed(21)
    a = torch.randn(rows, w0.shape[0], generator=g).to(dev).requires_grad_()
    w = w0.clone().requires_grad_()
    c = torch.randn(rows, w0.shape[1], generator=g).to(dev)
    out = mlp.bf16_dot(a, w)
    ga, gw = torch.autograd.grad((out * c).sum(), (a, w))
    ab, wb = (t.detach().to(torch.bfloat16).float().requires_grad_()
              for t in (a, w))
    ref = ab @ wb
    ra, rw = (x.to(torch.bfloat16).float() for x in torch.autograd.grad(
        (ref * c).sum(), (ab, wb)))
    bound = 1e-5 * (ab.detach().abs() @ wb.detach().abs()) + 1e-6
    apart = (out.detach() - ref.detach()).abs()
    fwd_err = float(apart.max())
    print(f"  bf16_dot forward ({rows} x {list(w0.shape)}): max |diff| "
          f"{fwd_err:.3e}, worst over 1e-5 of sum |products| "
          f"{float((apart / bound).max()):.3f} (at most 1)", flush=True)
    if not (apart <= bound).all():
        raise AssertionError("bf16_dot forward parts from the CPU form")
    grad_err = 0.0
    for name, x, y in (("d input", ga, ra), ("d weight", gw, rw)):
        diff = (x - y).abs()
        apart = float((diff > 0).double().mean())
        grad_err = max(grad_err, float(diff.max()))
        print(f"  bf16_dot {name}: max |diff| {float(diff.max()):.3e}, "
              f"{apart:.3%} of elements apart (at most 1%)", flush=True)
        if not ((diff <= 2.0 ** -7 * y.abs()).all() and apart <= 0.01):
            raise AssertionError(f"bf16_dot {name} parts from the CPU form")
    ms = {"bf16 tensor cores": device_ms(lambda: mlp.bf16_dot(a, w), 20),
          "CPU form (float32)": device_ms(lambda: ab @ wb, 20)}
    print(f"  bf16_dot forward device ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return fwd_err, grad_err, ms


def reacher_bf16_path(dev, counters):
    """Trainer(REACHER_BF16) on the card by default: evaluate, then
    REACHER_BF16_EPOCHS epochs by phase (:func:`epochs_by_phase`; a fit is
    one K1 launch without the V planes, in the global variant and counted
    under "metrics", and one K2: the value forwards and both phases are
    bf16 library products, no K3, K4, K5 or K6), eval R up by more than
    REACHER_GAIN; then evaluate(deterministic=True), which launches no
    kernel.  Returns (trainer, {phase: {kernel: launches}}, rows)."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo.trainer import Trainer

    cfg = PPOConfig(**REACHER_BF16)
    tr = Trainer(cfg)
    check_on_card(tr)
    f = cfg.fits_per_epoch
    per_epoch = {"rollout": {"rollout_global[reacher]/metrics": f},
                 "GAE": {"gae_norm": f}, "value phase": {},
                 "policy phase": {}, "draws": {},
                 "evaluation": {"rollout_global[reacher]/metrics": 1}}
    by_phase, rows = epochs_by_phase(tr, REACHER_BF16_EPOCHS, per_epoch,
                                     counters, "REACHER_BF16")
    n0 = read_counts(counters)
    t0 = time.perf_counter()
    evd = tr.evaluate(deterministic=True)
    torch.cuda.synchronize()
    det = count_diff(n0, read_counts(counters))
    print(f"  evaluate(deterministic=True): R {evd.R:.4f}, episodes "
          f"{int(evd.episodes)}, {time.perf_counter() - t0:.3f} s; launches "
          f"{det}", flush=True)
    if det or not math.isfinite(evd.R):
        raise AssertionError(f"the REACHER_BF16 mean-policy evaluation must "
                             f"launch no kernel: {det}, {evd}")
    return tr, by_phase, rows


def bf16_phases(dev, counters, record):
    """The bf16 backend: K7's bf16 variant against its plain versions at
    every shape, apply_seq "bf16" through it against the plain bf16 core,
    RECALL_XL_BF16 (1 epoch by phase, every K7 launch the bf16 variant),
    the bf16 product check and REACHER_BF16 (3 epochs by phase); records
    the three K7 bf16 rows."""
    header("[K7 bf16 variant: forward, dq, dk/dv against their plain "
           "versions]")
    for kernel, res in kernel_resources("_bf16").items():
        print(f"  {kernel}: {res} (nvcc.log)", flush=True)
    runs = check_flash_bf16_all(dev)
    header("[apply_seq 'bf16' through K7's bf16 variant against its plain "
           "versions, recall_xl widths]")
    seq_ratio = check_apply_seq_bf16(dev)
    header(f"[RECALL_XL_BF16: Trainer(recall_xl, kernel_backend 'bf16'), "
           f"{RECALL_XL_EPOCHS} epochs, then evaluate(deterministic=True)]")
    _, by_phase, per_fit, gap, xl_rows = recall_xl_path(
        dev, counters, RECALL_XL_BF16, K7_BF16_NAMES, BF16_GAP_TOL)
    for key, path, shape in (
            ("recall_xl minibatch (T 1024, B 4, H 4, hd 8), rollout "
             "episodes", "RECALL_XL_BF16 update phases, minibatch of 4 env "
             "columns", [1024, 4, 4, 8]),
            ("recall_xl value pass (T 1024, B 32, H 4, hd 8)",
             "RECALL_XL_BF16 value pass of the V planes", [1024, 32, 4, 8])):
        case, rel, H, errs, times = runs[key]
        bounds, pairs = flash_bounds_bf16(case, rel, H)
        value_pass = "value pass" in key
        for i, name in enumerate(K7_BF16_NAMES):
            if value_pass and i:
                continue      # the value pass runs no backward
            launches = (by_phase["values + GAE"][name] if value_pass else
                        by_phase["value phase"][name]
                        + by_phase["policy phase"][name])
            err = (max(errs["out"], errs["lse"]), errs["dq"],
                   max(errs["dk"], errs["dv"]))[i]
            record(name, path + f" ({pairs} valid pairs)", shape, launches,
                   err, times[name], bounds[i], times[name]["library_ms"])
    case, rel, H, errs, times = runs[
        "X-ray (T 2048, B 16, H 8, hd 64), p_done 0.02"]
    bounds, pairs = flash_bounds_bf16(case, rel, H)
    xray = {name: dict(times[name], bound_ms=bounds[i][0],
                       bound_by=bounds[i][1])
            for i, name in enumerate(K7_BF16_NAMES)}
    print(f"  K7 bf16 at the X-ray shape (T 2048, B 16, H 8, hd 64, {pairs} "
          f"valid pairs; not on the path): {json.dumps(xray)}", flush=True)
    mb_t = runs["recall_xl minibatch (T 1024, B 4, H 4, hd 8), rollout "
                "episodes"][4]
    vp_t = runs["recall_xl value pass (T 1024, B 32, H 4, hd 8)"][4]
    k7_s = 1e-3 * (by_phase["values + GAE"][K7_BF16_NAMES[0]]
                   * vp_t[K7_BF16_NAMES[0]]["ms"]
                   + sum((by_phase["value phase"][n]
                          + by_phase["policy phase"][n]) * mb_t[n]["ms"]
                         for n in K7_BF16_NAMES))
    xl_wall = sum(sum(r["split"].values()) for r in xl_rows)
    print(f"  RECALL_XL_BF16: K7 bf16 {k7_s:.4f} s of the {xl_wall:.3f} s "
          f"wall of {RECALL_XL_EPOCHS} epochs ({k7_s / xl_wall:.2%}; its "
          f"launches times its device ms at the timed shapes)", flush=True)
    print(f"  apply_seq bf16 through K7 against its plain versions, largest "
          f"norm ratio {seq_ratio:.3f}; decode against the bf16 replay, largest "
          f"log-prob gap {gap:.3e}; K7 launches a fit by phase {per_fit}; "
          f"epoch R {[round(r['R'], 4) for r in xl_rows]}", flush=True)

    header(f"[REACHER_BF16: Trainer(reacher regime, kernel_backend 'bf16'), "
           f"evaluate, {REACHER_BF16_EPOCHS} epochs, then "
           f"evaluate(deterministic=True)]")
    tr, _, rows = reacher_bf16_path(dev, counters)
    header(f"[the bf16 MLP product on the card against the CPU form, "
           f"{tr.cfg.minibatch_size} rows]")
    check_bf16_products(dev, tr.state.v_params, tr.cfg.minibatch_size)
    fits = [r["wall"] for r in rows]
    print(f"  REACHER_BF16 fit walls (s) {[round(x, 3) for x in fits]}, "
          f"{tr.cfg.steps_per_epoch / min(fits):.0f} training env-steps/s "
          f"at the fastest", flush=True)


# --- K3 bf16 and K4 bf16: the bf16 big-tile phases --------------------------

# the draws of the phases' row streams (10 value and 4 policy epochs of 37
# minibatches in blocks of 4096): the main path runs on the first, every
# distance check on each (the readings on streams 8-12 set the limits below)
BIGMB_SEEDS = (8, 9)
# The rounding points, held at one step.  The kernel's state after one step
# against its plain version summing in the kernel's own order (row tiles of
# the kernel's rows a block, in block order), leaf by leaf (each W and b of
# the net, of Adam's m and of v; K4 also log_std and its moments): the
# largest relative two-norm distance of a leaf at most BIGMB_STEP_REL[kind].
# Two controls go through the same comparison and must fail it, or the run
# fails: the plain version with the cotangent left float32
# (round_cotangent=False: a kernel that skipped that rounding), and the
# generic bf16 phase (autodiff, float32 cotangents) in the kernel's place.
# After one step Adam moves every weight by about lr whatever the gradient,
# so m and v carry the test.  Set from the readings on streams 8-12 (NVIDIA
# H100 80GB HBM3, 700 W): K3 the kernel 3.07e-7, the float32-cotangent
# control 2.09e-4 to 2.72e-4, the generic phase 3.27e-3 to 3.43e-3; K4 the
# kernel 2.91e-5 to 2.93e-5 (its log_std leaf: a float32 sum of terms that
# cancel), the controls 1.94e-3 to 3.54e-3 and 3.98e-3 to 5.47e-3.  Each
# limit lies about midway between, on a log scale.
BIGMB_STEP_REL = {"K3": 1e-5, "K4": 2.5e-4}
# tests/test_bigmb.py's tolerances (the kernel against the bf16 scan over
# its two steps): weights rtol 5e-2, atol 2e-4; the mean loss rel 2e-2
# (plus 1e-4).  They hold the first two steps elementwise.  Over a whole
# phase (370 or 148 Adam steps) a float32 sum order alone moves some
# weights past them (the plain version at row tiles of 1024 against 4096),
# and a kernel without the cotangent rounding lands as near its plain
# version as the kernel does: a whole phase cannot tell the rounding points
# apart, the one-step check does.  So a whole phase holds the trajectory,
# by distance: the kernel's relative two-norm distance from its plain
# version summing in the kernel's order within BIGMB_NOISE times the plain
# version's own between that order and the JAX package's (row tiles of
# 4096), and its distance from the generic bf16 phase within BIGMB_GENERIC
# times the plain version's; the mean loss at test_bigmb's tolerance
# throughout.  The plain version without the cotangent rounding
# is read beside them, and not held.  Streams 8-12 read: K3 0.71 to 2.24
# of the yardstick and 0.82 to 1.23 of the generic distance, K4 0.98 to
# 1.45 and 0.85 to 1.05; the control 1.46 to 6.39 (K3) and 1.16 to 1.30
# (K4) of the yardstick.
BIGMB_TOL = dict(rtol=5e-2, atol=2e-4)
BIGMB_LOSS_REL = 2e-2
BIGMB_NOISE = 3.0
BIGMB_GENERIC = 1.5


def bigmb_bound(widths, n_steps: int, mb: int, extra_cols: int):
    """K3 bf16 / K4 bf16: per step 2 FLOP a row per multiply-add on the
    bf16 tensor cores for each of the forward, dW and dX (no dX of the
    input layer), plus ~12 float32 operations an Adam parameter; reads
    each row once (d0 + extra_cols float32), reads and writes params and
    both moments once."""
    flop_row = 6.0 * products(widths) - 2.0 * widths[0] * widths[1]
    t_mma = n_steps * mb * flop_row / PEAK_BF16
    t_adam = 12.0 * n_steps * n_params(widths) / PEAK_FP32
    nbytes = 4.0 * (n_steps * mb * (widths[0] + extra_cols)
                    + 6 * n_params(widths))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = t_mma + t_adam
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bigmb_state(out):
    """The trained state of a bf16 phase's results as flat tensors (net,
    moments; K4 also log_std and its moments), and the mean loss."""
    from ppoc_tpu_torch.models import mlp

    if len(out) == 3:
        params, opt, loss = out
        return [mlp.flatten(params), mlp.flatten(opt.m),
                mlp.flatten(opt.v)], loss
    params, ls, op, ols, loss, _ = out
    return [mlp.flatten(params), ls, mlp.flatten(op.m), mlp.flatten(op.v),
            ols.m, ols.v], loss


def bigmb_leaves(out):
    """[(name, tensor)] of a bf16 phase's trained state, a leaf per W and b
    of the net, of m and of v (K4: and log_std, its m and v)."""
    if len(out) == 3:
        params, opt, _ = out
        trees = (("", params), ("m ", opt.m), ("v ", opt.v))
        extra = []
    else:
        params, ls, op, ols, _, _ = out
        trees = (("", params), ("m ", op.m), ("v ", op.v))
        extra = [("log_std", ls), ("m log_std", ols.m), ("v log_std", ols.v)]
    return [(f"{pre}{n}{l}", t) for pre, tree in trees
            for l, wb in enumerate(tree) for n, t in zip("Wb", wb)] + extra


def bigmb_leaf_dist(got, want):
    """(the largest relative two-norm distance of a leaf, its name, the
    largest |diff|) of ``got``'s leaves from ``want``'s."""
    top, name, err = -1.0, "", 0.0
    for (n, x), (_, y) in zip(bigmb_leaves(got), bigmb_leaves(want)):
        x, y = x.double(), y.double()
        d = float((x - y).norm()) / max(float(y.norm()), 1e-30)
        if d > top:
            top, name = d, n
        err = max(err, float((x - y).abs().max()))
    return top, name, err


def bigmb_dist(got, want, tol=BIGMB_TOL):
    """(the largest |diff| over (atol + rtol |want|), the share of elements
    beyond it, the relative two-norm distance) over the weight leaves."""
    worst, beyond, n, num, den = 0.0, 0, 0, 0.0, 0.0
    for x, y in zip(got, want):
        x, y = x.double(), y.double()
        r = (x - y).abs() / (tol["atol"] + tol["rtol"] * y.abs())
        worst = max(worst, float(r.max()))
        beyond += int((r > 1).sum())
        n += r.numel()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return worst, beyond / n, math.sqrt(num / den)


def bigmb_loss(label: str, loss_got, loss_want) -> None:
    gap = abs(float(loss_got) - float(loss_want))
    lim = BIGMB_LOSS_REL * abs(float(loss_want)) + 1e-4
    if not gap <= lim:
        raise AssertionError(f"{label}: mean loss {float(loss_got)} against "
                             f"{float(loss_want)}")


def bigmb_apart(label: str, got, want, loss_got, loss_want) -> float:
    """Hold the trained weights (the net, and log_std) to ``want``
    elementwise at BIGMB_TOL and the mean loss at BIGMB_LOSS_REL; returns
    the largest |diff| of the weights."""
    worst, share, rel = bigmb_dist(got, want)
    print(f"  {label}: weights at most {worst:.3f} of the tolerance (rtol "
          f"{BIGMB_TOL['rtol']}, atol {BIGMB_TOL['atol']}), relative "
          f"distance {rel:.3e}; mean loss {float(loss_got):.6g} against "
          f"{float(loss_want):.6g}", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"{label}: weights {worst} of the tolerance")
    bigmb_loss(label, loss_got, loss_want)
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(got, want))


def bigmb_near(label: str, got, want, loss_got, loss_want, yard: float,
               ratio: float) -> float:
    """Hold the weights' relative two-norm distance from ``want`` within
    ``ratio`` times the yardstick distance ``yard`` (plus 1e-7), and the
    mean loss at BIGMB_LOSS_REL; returns the distance."""
    worst, share, rel = bigmb_dist(got, want)
    print(f"  {label}: relative distance {rel:.3e}, {rel / max(yard, 1e-30):.3f}"
          f" of the yardstick {yard:.3e} (at most {ratio}); elementwise at "
          f"most {worst:.3f} of test_bigmb's tolerance, {share:.4%} of the "
          f"weights beyond it; mean loss {float(loss_got):.6g} against "
          f"{float(loss_want):.6g}", flush=True)
    if not rel <= ratio * yard + 1e-7:
        raise AssertionError(f"{label}: distance {rel} over {ratio} x {yard}")
    bigmb_loss(label, loss_got, loss_want)
    return rel


def bigmb_rounding(label: str, lim: float, kernel_out, plain_out,
                   controls) -> float:
    """The one-step check of the rounding points: the kernel's leaves
    within ``lim`` (BIGMB_STEP_REL) of its plain version's, every control's
    (name, results) beyond it; returns the kernel's largest |diff|."""
    d, leaf, err = bigmb_leaf_dist(kernel_out, plain_out)
    ctl = [(name, *bigmb_leaf_dist(out, plain_out)[:2])
           for name, out in controls]
    print(f"  {label}: the largest leaf distance from the plain version "
          f"{d:.3e} ({leaf}; at most {lim:.1e}), max |diff| "
          f"{err:.3e}; controls, which must exceed it: "
          + "; ".join(f"{n} {c:.3e} ({cl}, {c / max(d, 1e-30):.0f}x)"
                      for n, c, cl in ctl), flush=True)
    if not d <= lim:
        raise AssertionError(f"{label}: leaf {leaf} at {d}")
    for n, c, cl in ctl:
        if not c > lim:
            raise AssertionError(f"{label}: the control '{n}' passes the "
                                 f"check ({cl} at {c}): it cannot tell")
    return err


def bigmb_grid_times(dev, steps: int = 37) -> None:
    """Where K3 bf16's device time goes, by grid and cluster size: a step's
    device time (a launch of ``steps`` steps less one of none, over the
    steps; queued_ms) with every block on its own 128 rows, so each block
    does the same work at every grid size and what grows with it is the
    partials' traffic through L2 and the barriers: the reacher value net
    at 1, 8, 32 and 128 blocks in the plan's clusters, then at 16 and 128
    blocks in each cluster size that runs them in one round; a
    [10,16,16,1] net, whose products and partials nearly vanish, at 1 and
    128."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import AdamState

    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    wide = [10, 256, 256, 1]
    for widths, grids, clusters in (
            (wide, (1, 8, 32, 128), (None,)), (wide, (16,), (1, 2, 4, 8, 16)),
            (wide, (128,), (1, 2)), ([10, 16, 16, 1], (1, 128), (None,))):
        g = torch.Generator().manual_seed(0)
        params = mlp.init(widths, g, dev)
        zeros = [(torch.zeros_like(w), torch.zeros_like(b))
                 for w, b in params]
        opt = AdamState(zeros, zeros, 0)
        for grid in grids:
            mb = 128 * grid
            x = torch.randn(steps * mb, widths[0], generator=g).to(dev)
            tgt = torch.randn(steps * mb, generator=g).to(dev)
            for c in clusters:
                plan = cu.phase_bf16_plan("value", widths, mb, dev, c)
                ms = [queued_ms(lambda n=n: cu.value_phase_bf16_kernel(
                    x[:n * mb], tgt[:n * mb], params, opt, n, mb, "relu", h,
                    c), 3) for n in (0, steps)]
                print(f"  K3 bf16 {widths}, grid {plan['grid']} in "
                      f"clusters of {plan['cluster']} (minibatch {mb}, "
                      f"{plan['rounds']} round(s)): {steps} steps "
                      f"{ms[1]:.4f} ms, none {ms[0]:.4f} ms, "
                      f"{1e3 * (ms[1] - ms[0]) / steps:.2f} us a step",
                      flush=True)


def bigmb_phases(dev, counters, record, seeds=BIGMB_SEEDS):
    """K3 bf16 and K4 bf16 on REACHER_BF16's fit buffer at full width: the
    main path (ppo.value_phase_fused / policy_phase_fused with bf16, one
    launch each, every counter read around it) on the first stream, the
    split and repeated launches, two steps and the timings on it, then on
    every stream the one-step rounding check with its controls and the
    whole phase against the plain version and the generic bf16 phase; a
    second value phase; the step time by grid size; records both rows."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    header("[K3 bf16 and K4 bf16: REACHER_BF16's fit buffer, minibatch "
           "16384, 2x256]")
    cfg = PPOConfig(**REACHER_BF16)
    tr = Trainer(cfg)
    check_on_card(tr)
    ts, env = tr.state, tr.env
    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(seeds[0]), dev)
    traj, _, vpair = ppo.rollout(cfg, env, ts.policy_params, draws.seed,
                                 cfg.n_envs, cfg.rollout_len,
                                 v_params=ts.v_params)
    adv, tgt = ppo.compute_advantages(cfg, env, traj, vpair, ts.v_params)
    buf = buffer.from_rollout(traj, adv, tgt)
    torch.cuda.synchronize()
    mb, blk = cfg.minibatch_size, cfg.shuffle_block
    vidx, pidx = draws.value_idx, draws.policy_idx
    n_v = vidx.shape[0] * vidx.shape[1]
    n_p = pidx.shape[0] * pidx.shape[1]
    vw, pw = mlp.dims(ts.v_params), mlp.dims(ts.policy_params["mlp"])
    tile = cu.bf16_tile(mb)
    plans = {k: cu.phase_bf16_plan(k, w, mb, dev)
             for k, w in (("value", vw), ("policy", pw))}
    for k, pl in plans.items():
        print(f"  {k} phase: cooperative grid {pl['grid']} blocks x "
              f"{pl['threads']} threads ({pl['rows']} rows a block, "
              f"{pl['rounds']} tile(s) a block, thread-block clusters of "
              f"{pl['cluster']}, {pl['blocks_per_sm']} block(s) per SM on "
              f"{pl['sms']} SMs, {pl['smem']} B shared memory, "
              f"{pl['scratch_bytes']} B scratch); products: {pl['route']} "
              f"(wgmma.mma_async m64nNk16 from shared memory, bf16 operands, "
              f"float32 accumulators), W by bulk copies multicast to the "
              f"cluster through a ring of {pl['stages']} x "
              f"{pl['stage_bytes']} B; the partials summed in groups of "
              f"{pl['group']}", flush=True)
        if pl["grid"] < 2:
            raise AssertionError(f"the {k} phase launches one block")
    print(f"  buffer {buf.obs.shape[0]} rows; value {n_v} steps, policy "
          f"{n_p} steps; the JAX tile {tile}", flush=True)

    # the main path: the two public entries, one launch each
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts_v, loss_v = ppo.value_phase_fused(cfg, ts, buf, vidx, bf16=True)
    ts_p, loss_p, ent_p = ppo.policy_phase_fused(cfg, ts, buf, pidx,
                                                 bf16=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts(counters).items() if v}
    print(f"  value_phase_fused + policy_phase_fused (bf16): {wall:.3f} s "
          f"wall, mean losses {float(loss_v):.6g} and {float(loss_p):.6g}, "
          f"entropy {float(ent_p):.6g}; launches {launches}", flush=True)
    if launches != {"value_phase_bf16": 1, "policy_phase_bf16": 1}:
        raise AssertionError(f"the bf16 phases must be one launch of each "
                             f"kernel: {launches}")
    for t in (mlp.flatten(ts_v.v_params), mlp.flatten(ts_p.policy_params[
            "mlp"]), ts_p.policy_params["log_std"], loss_v, loss_p, ent_p):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite result of a bf16 phase")

    h_v, h_p = ppo._hyper(cfg, cfg.lr_v), ppo._hyper(cfg, cfg.lr_policy)
    pol = ts.policy_params

    def streams(vi, pi):
        """(args, generic) of each kind on the id streams vi, pi: args(n,
        s0, state) the arguments of a kernel call of n steps from step s0;
        generic(idx) the generic bf16 phase's results on ids idx."""
        vcols = buffer.gather_mb((buf.obs, buf.target), vi, blk)
        pcols = buffer.gather_mb((buf.obs, buf.action, buf.log_prob,
                                  buf.advantage), pi, blk)

        def v_args(n, s0=0, state=(ts.v_params, ts.opt_v)):
            rows = slice(s0 * mb, (s0 + n) * mb)
            return (*(c[rows] for c in vcols), *state, n, mb,
                    cfg.activation, h_v)

        def p_args(n, s0=0, state=(pol["mlp"], pol["log_std"],
                                    ts.opt_policy, ts.opt_log_std)):
            rows = slice(s0 * mb, (s0 + n) * mb)
            return (*(c[rows] for c in pcols), *state, n, mb,
                    cfg.activation, h_p, cfg.clip_eps, cfg.ent_coeff)

        def v_gen(idx):
            gts, loss = ppo.value_phase(cfg, ts, buf, idx)
            return gts.v_params, gts.opt_v, loss

        def p_gen(idx):
            gts, loss, ent = ppo.policy_phase(cfg, ts, buf, idx)
            return (gts.policy_params["mlp"], gts.policy_params["log_std"],
                    gts.opt_policy, gts.opt_log_std, loss, ent)

        return {"K3": (v_args, lambda idx=vi: v_gen(idx), vi),
                "K4": (p_args, lambda idx=pi: p_gen(idx), pi)}

    kinds = {"K3": (cu.value_phase_bf16_kernel, cu.value_phase_bf16_plain,
                    n_v, plans["value"]),
             "K4": (cu.policy_phase_bf16_kernel, cu.policy_phase_bf16_plain,
                    n_p, plans["policy"])}
    whole = {"K3": (ts_v.v_params, ts_v.opt_v, loss_v),
             "K4": (ts_p.policy_params["mlp"], ts_p.policy_params["log_std"],
                    ts_p.opt_policy, ts_p.opt_log_std, loss_p, ent_p)}
    on = streams(vidx, pidx)
    errs, times = {}, {}
    for kind, (kernel, plain, n, _) in kinds.items():
        args, generic, idx = on[kind]
        header(f"[{kind} bf16 on stream {seeds[0]}: {n // 2} + {n - n // 2} "
               f"against {n} steps, two identical launches, two steps, "
               f"the timings]")
        one, _ = bigmb_state(whole[kind])
        again, _ = bigmb_state(kernel(*args(n)))
        first = kernel(*args(n // 2))
        rest = first[:2] if kind == "K3" else first[:4]
        split, _ = bigmb_state(kernel(*args(n - n // 2, n // 2, rest)))
        for label, other in (("two identical launches", again),
                             (f"{n // 2} + {n - n // 2} steps in two "
                              f"launches", split)):
            same = all(torch.equal(x, y) for x, y in zip(one, other))
            print(f"  {kind} bf16, {label} against one launch of {n}: "
                  f"{'the same bits' if same else 'DIFFERENT'}", flush=True)
            if not same:
                raise AssertionError(f"{kind} bf16: {label} differ")
        n_w = 1 if kind == "K3" else 2     # the weights: net, log_std
        # two steps, test_bigmb's own length: elementwise at its tolerances
        two, loss2 = bigmb_state(kernel(*args(2)))
        two_p, loss2_p = bigmb_state(plain(*args(2)))
        errs[kind] = bigmb_apart(f"{kind} bf16, 2 steps, against its plain "
                                 f"version", two[:n_w], two_p[:n_w], loss2,
                                 loss2_p)
        two_g, loss2_g = bigmb_state(generic(idx[:1, :2]))
        bigmb_apart(f"{kind} bf16, 2 steps, against the generic bf16 phase",
                    two[:n_w], two_g[:n_w], loss2, loss2_g)
        ms = queued_ms(lambda: kernel(*args(n)), 3)
        plain_ms = device_ms(lambda: plain(*args(n)), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generic()
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        gen_ms = device_ms(generic, 1, warm=False)
        times[kind] = {"ms": ms, "plain_ms": plain_ms,
                       "generic_wall_ms": 1e3 * gen_wall,
                       "generic_ms": gen_ms}
        print(f"  {kind} bf16 device ms {ms:.4f}; plain device ms "
              f"{plain_ms:.4f}; the generic bf16 phase on the same stream "
              f"{1e3 * gen_wall:.1f} ms wall, {gen_ms:.4f} ms device",
              flush=True)

    for seed in seeds:
        if seed == seeds[0]:
            vi, pi, results = vidx, pidx, whole
        else:
            d = ppo.draw_fit(cfg, torch.Generator().manual_seed(seed), dev)
            vi, pi, results = d.value_idx, d.policy_idx, None
        on = streams(vi, pi)
        for kind, (kernel, plain, n, plan) in kinds.items():
            args, generic, idx = on[kind]
            n_w = 1 if kind == "K3" else 2
            rows, group = plan["rows"], plan["group"]
            header(f"[{kind} bf16 on stream {seed}: one step against its "
                   f"plain version and the controls, the whole phase "
                   f"against its plain version and the generic bf16 "
                   f"phase]")
            # one step: the rounding points
            a1 = args(1)
            err = bigmb_rounding(
                f"{kind} bf16, one step", BIGMB_STEP_REL[kind], kernel(*a1),
                plain(*a1, rows, group=group),
                (("the float32 cotangent", plain(*a1, rows, group=group,
                                                 round_cotangent=False)),
                 ("the generic bf16 phase", generic(idx[:1, :1]))))
            errs[kind] = max(errs[kind], err)
            # the whole phase: the plain version in the kernel's order, its
            # own sum-order noise (against the JAX package's order), the
            # generic bf16 phase, the control
            out = results[kind] if results else kernel(*args(n))
            got, loss_k = bigmb_state(out)
            want, loss_pl = bigmb_state(plain(*args(n), rows, group=group))
            jax_order, _ = bigmb_state(plain(*args(n)))
            noise = bigmb_dist(jax_order[:n_w], want[:n_w])[2]
            ctl = bigmb_dist(bigmb_state(plain(
                *args(n), rows, group=group, round_cotangent=False))[0][:n_w],
                want[:n_w])[2]
            print(f"  {kind} bf16 plain version in the JAX package's order "
                  f"(row tiles of {tile}) against the kernel's ({rows}-row "
                  f"tiles in groups of {group}): relative distance "
                  f"{noise:.3e} (the yardstick); without the cotangent "
                  f"rounding {ctl:.3e} ({ctl / max(noise, 1e-30):.3f} of it;"
                  f" not held)", flush=True)
            bigmb_near(f"{kind} bf16 whole phase against its plain version",
                       got[:n_w], want[:n_w], loss_k, loss_pl, noise,
                       BIGMB_NOISE)
            gen_state, gen_loss = bigmb_state(generic())
            plain_gen = bigmb_dist(want[:n_w], gen_state[:n_w])[2]
            bigmb_near(f"{kind} bf16 whole phase against the generic bf16 "
                       f"phase", got[:n_w], gen_state[:n_w], loss_k,
                       gen_loss, plain_gen, BIGMB_GENERIC)

    header("[K3 bf16: a second value phase on the same buffer]")
    ts_v2, loss_v2 = ppo.value_phase_fused(cfg, ts_v, buf, vidx, bf16=True)
    print(f"  mean loss {float(loss_v):.6g}, then {float(loss_v2):.6g}",
          flush=True)
    if not float(loss_v2) < float(loss_v):
        raise AssertionError("the second value phase did not lower the "
                             "mean loss")
    header("[K3 bf16: a step's device time by grid size]")
    bigmb_grid_times(dev)
    path = (f"REACHER_BF16 fit buffer ({buf.obs.shape[0]} rows), "
            f"ppo.value_phase_fused / policy_phase_fused with bf16, grid "
            f"{plans['value']['grid']} x {plans['value']['threads']}, wgmma")
    for name, kind, n, w, cols in (("value_phase_bf16", "K3", n_v, vw, 1),
                                   ("policy_phase_bf16", "K4", n_p, pw, 3)):
        record(name, path, [n, mb] + w, launches[name], errs[kind],
               times[kind], bigmb_bound(w, n, mb, cols))
        print(f"  {name}: generic bf16 phase on the same stream "
              f"{times[kind]['generic_wall_ms']:.1f} ms wall, "
              f"{times[kind]['generic_ms']:.4f} ms device", flush=True)


# --- K3 and K4 as one thread-block cluster (slice 10) ------------------------

# cluster_grid_times: the cluster sizes timed at each minibatch size
CLUSTER_SIZES = (4, 8, 16)
CLUSTER_MBS = (64, 256, 2048)


def cluster_line(label: str, kind: str, widths, mb: int, dev,
                 sharded: bool = False, cluster=None) -> dict:
    """Print and return how K3 (``kind`` "value"), K4 ("policy") or K6
    ("categorical policy") launches on ``widths`` at minibatch ``mb``:
    with the weights in shared memory (cuda_update.phase_cluster_plan), or
    ``sharded`` over the cluster (phase_shard_plan, each layer's kind from
    shard_layout)."""
    from ppoc_tpu_torch.ops import cuda_update as cu

    if not sharded:
        plan = cu.phase_cluster_plan(kind, widths, mb, cluster, device=dev)
        print(f"  {label}: a cluster of {plan['cluster']} blocks x "
              f"{plan['rows']} rows ({plan['sub_tiles']} sub-tiles of 32), "
              f"{plan['threads']} threads and {plan['smem']} B of shared "
              f"memory a block; the card holds "
              f"{plan['max_active_clusters']} such clusters", flush=True)
        return plan
    plan = cu.phase_shard_plan(kind, widths, mb, cluster, device=dev)
    lay = cu.shard_layout(widths, cluster)
    print(f"  {label}: a sharded cluster of {plan['cluster']} blocks "
          f"(layers {'/'.join(lay.kinds)}{', spilled' * lay.spill}), each "
          f"walking all {mb} rows in {plan['sub_tiles']} sub-tiles of "
          f"{plan['sub_rows']}, {plan['threads']} threads and "
          f"{plan['smem']} B of shared memory a block; the card holds "
          f"{plan['max_active_clusters']} such clusters", flush=True)
    return plan


def cluster_resources(kernel: str = "cluster") -> dict:
    """{"value" | "policy" | "categorical": "N registers, S B spill
    stores, L B spill loads"} of the three kinds of the cluster kernel
    (csrc/update_cluster.cu), or with ``kernel`` "shard" of the sharded
    one (csrc/update_shard.cuh; "value spilled", ... for the instances with
    the weights in global memory), from the build's nvcc.log (the
    compiler's -Xptxas -v report)."""
    import re

    from ppoc_tpu_torch.ops import _build

    res, name = {}, None
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        m = re.search(rf"Compiling entry function '\S*{kernel}_phase_kernel"
                      r"ILi(\d)E(?:Lb(\d)E)?", line)
        if m:
            name = ("value", "policy", "categorical")[int(m.group(1))] + (
                " spilled" if m.group(2) == "1" else "")
            continue
        if re.search(r"Compiling entry function", line):
            name = None
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            res[name] = (f"{spill.group(1)} B spill stores, "
                         f"{spill.group(2)} B spill loads")
        if name and regs:
            res[name] = f"{regs.group(1)} registers, " + res.get(name, "")
    kinds = ["categorical", "policy", "value"]
    want = kinds + ([f"{k} spilled" for k in kinds] if kernel == "shard"
                    else [])
    if sorted(res) != sorted(want):
        raise AssertionError(f"nvcc.log reports the {kernel} kernels {res}")
    return res


def cluster_grid_times(dev, steps: int = 40, widths=(3, 128, 128, 1),
                       mbs=CLUSTER_MBS, variant: str = "smem",
                       kind: str = "value") -> dict:
    """A step's device time of K3 (``kind`` "value", on ``widths``, by
    default the bench's value net) or K6 ("categorical policy", on seeded
    class ids) by cluster size (CLUSTER_SIZES, forced) at each of ``mbs``,
    in ``variant`` ("smem": the replicated cluster, "global": the sharded
    one): a launch of ``steps`` steps less one of none, over the steps
    (queued_ms); the size the kernels take (cuda_update.CLUSTER or
    SHARDS) is marked.  Returns {(mb, cluster): us a step}."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import AdamState

    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    own = cu.CLUSTER if variant == "smem" else cu.SHARDS
    g = torch.Generator().manual_seed(0)
    params = mlp.init(widths, g, dev)
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    opt = AdamState(zeros, zeros, 0)
    out = {}
    for mb in mbs:
        rows = steps * mb
        x = torch.randn(rows, widths[0], generator=g).to(dev)
        if kind == "value":
            cols = (x, (10 * torch.randn(rows, generator=g)).to(dev))

            def launch(n, c):
                return cu.value_phase_kernel(
                    *(t[:n * mb] for t in cols), params, opt, n, mb, "relu",
                    h, variant=variant, cluster=c)
        else:
            K = widths[-1]
            cols = (x, torch.randint(0, K, (rows, 1), generator=g,
                                     dtype=torch.int32).to(dev),
                    (0.3 * torch.randn(rows, generator=g)
                     - math.log(K)).to(dev),
                    torch.randn(rows, generator=g).to(dev))

            def launch(n, c):
                return cu.policy_phase_categorical_kernel(
                    *(t[:n * mb] for t in cols), params, opt, n, mb, "relu",
                    h, 0.2, 0.01, variant=variant, cluster=c)
        row = []
        for c in CLUSTER_SIZES:
            ms = [queued_ms(lambda n=n: launch(n, c), 3) for n in (0, steps)]
            out[mb, c] = 1e3 * (ms[1] - ms[0]) / steps
            rule = "*" if c == own else ""
            row.append(f"{c}{rule}: {out[mb, c]:.2f}")
        print(f"  {'K3' if kind == 'value' else 'K6'} {list(widths)} "
              f"({variant} variant), minibatch {mb}, us a step by cluster "
              f"size ({steps} steps less none; * the kernels' own): "
              f"{', '.join(row)}", flush=True)
    return out


def cluster_gate_edge(cfg, ts, dev):
    """K3 on the bench's value net at the fused gate's edge: GATE_STEPS
    steps of GATE_MB rows, drawn with replacement from one fit's value
    rows, held as :func:`check_phase` holds a phase (the whole phase's
    distance from float64 printed only), and the generic phases
    (ppo.value_phase past the gate: per minibatch K5 forward, autograd
    through K5's backward, Adam) on the same rows, wall and device time.
    A reading for re-deriving ppo.MAX_FUSED_MB; no path runs it.  Returns
    (max abs error, timings)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.ops import cuda_update as cu

    raw, tgt, _ = wide_rows(cfg, ts, (0x3C6EF372, 0xA54FF53A), 3, dev)
    n = GATE_STEPS * GATE_MB
    idx = torch.randint(0, tgt.numel(), (n,),
                        generator=torch.Generator().manual_seed(8)).to(dev)
    obs = raw.obs.reshape(tgt.numel(), -1)[idx].contiguous()
    tgt = tgt.reshape(-1)[idx].contiguous()
    edge = cfg.replace(minibatch_size=GATE_MB)
    err, times = check_phase(
        f"value phase (mb {GATE_MB})", cu.value_phase_kernel,
        cu.value_phase_plain, (ts.v_params, ts.opt_v), (obs, tgt), edge,
        cfg.lr_v, [()], None)
    zero = torch.zeros(n, device=dev)
    buf = buffer.RowBuffer(obs, zero[:, None], zero, zero, tgt)
    ids = gate_edge_ids(dev)
    return err, gate_edge_line("value phase", times, *generic_times(
        lambda: ppo.value_phase(edge, ts, buf, ids)))


def cluster_phases(dev, record):
    """The cluster kernels' registers and spills, a step's time by cluster
    size and minibatch size, and K3 at the fused gate's edge beside the
    generic phases; records the gate's row."""
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp

    header("[K3, K4 and K6 as a thread-block cluster: registers, a step's "
           "time by cluster size, the fused gate's edge]")
    for kind, res in cluster_resources().items():
        print(f"  nvcc: the {kind} cluster kernel: {res}", flush=True)
    cluster_grid_times(dev)
    cluster_grid_times(dev, 40, (4, 128, 128, 2), (256,),
                       kind="categorical policy")
    cfg = bench_config()
    ts = Trainer(cfg, dev).state
    vw = mlp.dims(ts.v_params)
    err, times = cluster_gate_edge(cfg, ts, dev)
    record("value_phase", "the fused gate's edge (not on a path; the "
           "bench's rows)", [GATE_STEPS, GATE_MB] + vw, 0, err, times,
           phase_bound(vw, GATE_STEPS, GATE_MB, 1))


SERVE_ROWS = 256   # rows a serving call acts on (the bench's observations)


def checkpoint_phases(tr, dev, counters, record):
    """The port's front door on the card, from the solved bench trainer
    ``tr``: save and Trainer.from_checkpoint (every leaf and the config
    equal); a resumed bench epoch bit for bit equal to the uninterrupted
    one, with one epoch's launches; serve.load_policy acting on
    SERVE_ROWS bench observations through K5's forward (one launch a call,
    the plain version never run, the actions mlp.apply(..., "pallas")'s
    bits and within K5's tolerance of the plain version; an act call's
    wall and device us), the same rows through POST /act of make_server
    and a 400 for a wrong obs width; the reference format out and back
    bitwise; the CLI in process: --save, --resume, --eval-only, each
    returning 0 with its launches counted."""
    import io
    import shutil
    import threading
    import urllib.error
    import urllib.request
    from pathlib import Path

    import torch

    from ppoc_tpu_torch import cli, serve
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.envs import vector_reset
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_mlp as cm
    from ppoc_tpu_torch.utils import ref_interop

    t0 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "checkpoint_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    names = [c.kernel for c in counters]

    def reset():
        for c in counters:
            c.reset()
        torch.cuda.synchronize()

    def launched():
        torch.cuda.synchronize()
        return {k: v for k, v in zip(names, (c.n for c in counters)) if v}

    # 1. save, then rebuild from the file alone, on the card by default
    p = str(work / "bench.bin")
    tr.save(p)
    back = Trainer.from_checkpoint(p)
    check_on_card(back)
    if back.cfg != tr.cfg:
        raise AssertionError(f"config differs after load: {back.cfg}")
    same_leaves("save, Trainer.from_checkpoint", tr.state, back.state)

    # 2. resume: A trains 2 epochs, checkpointing after the first; B
    # resumes from that file and trains the second
    pa = str(work / "resume.bin")
    a = Trainer(bench_config(), dev)
    a.train(1, log=False, checkpoint_path=pa)
    a.train(1, log=False, initial_eval=False)
    b = Trainer.from_checkpoint(pa)
    reset()
    b.train(1, log=False, initial_eval=False)
    n = launched()
    same_leaves("a resumed epoch against the uninterrupted one", a.state,
                b.state)
    fits = b.cfg.fits_per_epoch
    want = {"rollout[pendulum]/values": fits, "gae_norm": fits,
            "value_phase": fits, "policy_phase": fits,
            "rollout[pendulum]/metrics": 1}
    print(f"  the resumed epoch's launches {n}", flush=True)
    if n != want:
        raise AssertionError(f"a resumed bench epoch must launch {want}")

    # 3. serving through K5's forward; 4. the same rows over HTTP
    pp = tr.state.policy_params["mlp"]
    act_name = tr.cfg.activation
    obs = vector_reset(tr.env, torch.Generator().manual_seed(17),
                       SERVE_ROWS, dev)[1].contiguous()
    plain_calls, real_plain = [0], cm.mlp_forward_plain

    def counting_plain(*args, **kw):
        plain_calls[0] += 1
        return real_plain(*args, **kw)

    cm.mlp_forward_plain = counting_plain
    server = None
    try:
        reset()
        act = serve.load_policy(p)
        acts = act(obs)
        server = serve.make_server(p, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = "http://%s:%d" % server.server_address[:2]
        with urllib.request.urlopen(url + "/spec", timeout=30) as r:
            spec = json.loads(r.read().decode())

        def post(rows):
            req = urllib.request.Request(
                url + "/act", data=json.dumps({"obs": rows}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read().decode())

        http_acts = post(obs.cpu().tolist())["action"]
        serve_n = launched()
        try:
            post([[0.0, 1.0]])
            raise AssertionError("POST /act took a wrong obs width")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
            print(f"  POST /act with a wrong obs width: {e.code}",
                  flush=True)
    finally:
        cm.mlp_forward_plain = real_plain
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    print(f"  GET /spec {spec}; serving launches {serve_n}, plain "
          f"versions run {plain_calls[0]}", flush=True)
    if serve_n != {"mlp_forward": 2} or plain_calls[0]:
        raise AssertionError("serving must launch K5's forward once a call "
                             "(act, POST /act) and never its plain version")
    direct = mlp.apply(pp, obs, act_name, "pallas")
    if not torch.equal(acts, direct):
        raise AssertionError("served actions differ from mlp.apply's bits")
    if not torch.equal(torch.tensor(http_acts, dtype=torch.float32),
                       acts.cpu()):
        raise AssertionError("POST /act's actions differ from act's")
    print(f"  served actions: mlp.apply(..., 'pallas')'s bits, over HTTP "
          f"too", flush=True)
    err = check(f"served actions, {SERVE_ROWS} rows, against K5's plain "
                f"forward", max_err(acts, real_plain(pp, obs, act_name)[0]),
                1e-5)
    wall_us = 1e3 * timed_ms(lambda: act(obs), 200)
    dev_us = 1e3 * device_ms(lambda: act(obs), 50)
    print(f"  an act call on {SERVE_ROWS} rows: {wall_us:.1f} us wall, "
          f"{dev_us:.1f} us device", flush=True)
    times = timings(lambda: cm.mlp_forward_kernel(pp, obs, act_name),
                    lambda: cm.mlp_forward_plain(pp, obs, act_name), 50, 20)
    plan = cm.last_launch["forward"]
    times.update(tile=plan["tile"], blocks=plan["blocks"])
    pw = mlp.dims(pp)
    record("mlp_forward", "serving: serve.load_policy act and POST /act",
           [SERVE_ROWS] + pw, serve_n["mlp_forward"], err, times,
           mlp_bounds(pw, SERVE_ROWS)[0])

    # 5. the reference ppo.c format, out and back on the card
    pr = str(work / "ref.bin")
    ref_interop.export_trainer(tr, pr)
    cfg = tr.cfg
    imp = ref_interop.load_trainer(
        pr, cfg.env, n_envs=cfg.n_envs, rollout_len=cfg.rollout_len,
        minibatch_size=cfg.minibatch_size, fits_per_epoch=cfg.fits_per_epoch,
        eval_envs=cfg.eval_envs, eval_len=cfg.eval_len,
        kernel_backend=cfg.kernel_backend)
    check_on_card(imp)
    same_leaves("export_trainer, load_trainer (weights, log_std, three "
                "Adams)", tr.state, imp.state)

    # 6. the CLI in process, on the card (PPOC_PLATFORM unset)
    q = str(work / "cli.bin")
    rcfg = cli.config_from_args(cli.build_parser().parse_args([]))
    f = rcfg.fits_per_epoch
    train = {"rollout[pendulum]/values": f, "gae_norm": f,
             "value_phase": f, "policy_phase": f}
    for argv, want in (
            (["--preset", "reference", "--n-epochs", "1", "--save", q,
              "--jsonl"], dict(train, **{"rollout[pendulum]/metrics": 2})),
            (["--resume", q, "--n-epochs", "1"],
             dict(train, **{"rollout[pendulum]/metrics": 1})),
            (["--eval-only", "--load", q], {"rollout[pendulum]/metrics": 1})):
        out = io.StringIO()
        reset()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(out):
            rc = cli.main(argv)
        n = launched()
        last = out.getvalue().strip().splitlines()[-1]
        print(f"  cli.main({argv}): {rc}; launches {n}; {last!r}",
              flush=True)
        if rc != 0 or n != want:
            raise AssertionError(f"the CLI must return 0 and launch {want}")
    shutil.rmtree(work)
    print(f"  the phase took {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# slice 18: the stabilisers, the mixture of experts, the affine env, "jnp"
# ---------------------------------------------------------------------------

# one generic step on the card (K5) and the same step on the plain path
# (float32 products, TF32 off), each against the step in float64 on the
# CPU from the same state and rows: per leaf, the kernel's largest distance
# from float64 within STEP_F64_FACTOR times the plain step's, or within
# a limit of its own: an Adam moment within STEP_MOMENT_REL of the leaf's
# largest float64 magnitude (m is the clipped gradient scaled, v its
# square), a weight within STEP_LR_SHARE of a learning rate (a first Adam
# step moves an element by lr * g / (|g| + eps), so where |g| is near eps
# the step's share of lr is set by the gradient's rounding).  A gradient
# summed over 256 rows whose signs follow the advantages cancels: on the
# first STAB_BENCH policy step K5's head gradient was 1.4e-4 of the leaf's
# largest from float64, the plain step's 5x closer (an H100 80GB HBM3 at
# 700 W); the clipped control parts by 1e10 of these limits
STEP_F64_FACTOR = 4.0
STEP_MOMENT_REL = {"m": 5e-4, "v": 1e-3}
STEP_LR_SHARE = 1e-2
# the mixture on the card against float64 on the CPU: within MOE_F64_FACTOR
# times the plain CPU float32 form's own error, or within MOE_REL of the
# leaf's largest magnitude (a weight gradient sums 12,800 rows, in
# cuBLAS's order on the card: float32 sums of that length part by about
# sqrt(12800) roundoffs, 7e-6 of the sum's scale)
MOE_F64_FACTOR = 4.0
MOE_REL = 1e-5
MOE_ROWS = 12800
# calibrate on the card against the CPU on the same draws: each statistic
# within CALIB_REL of the CPU's scale for its dimension (the env steps'
# float32 rounding differs between the two, and 200 steps of a driven
# pendulum can carry a difference along; a fault -- draws not moved, the
# wrong env, a dropped dimension -- is off by the scale itself)
CALIB_REL = 5e-2


def _leaf_pairs(a_ts, b_ts, part):
    from ppoc_tpu_torch.ops import adam

    def get(tree):
        for name in part.split("."):
            tree = getattr(tree, name)
        return adam.tree_leaves(tree)

    return list(zip(get(a_ts), get(b_ts)))


def step_apart(got, plain, ref, parts, lr: float):
    """(the largest ratio of a leaf's distance from ``ref`` over its limit,
    that leaf, the kernel's and the plain step's distances there); over 1
    is outside the limits above.  ``lr``: the step's learning rate."""
    worst = (0.0, "", 0.0, 0.0)
    for part in parts:
        for i, ((a, b), (_, r)) in enumerate(zip(_leaf_pairs(got, plain, part),
                                                 _leaf_pairs(got, ref, part))):
            if r.numel() == 0:
                continue
            r = r.double()
            e_k, e_p = max_err(a.cpu(), r), max_err(b.cpu(), r)
            kind = part.rsplit(".", 1)[-1]
            own = (STEP_MOMENT_REL[kind] * float(r.abs().max())
                   if kind in STEP_MOMENT_REL else STEP_LR_SHARE * lr)
            lim = max(STEP_F64_FACTOR * e_p, own, 1e-30)
            if e_k / lim > worst[0]:
                worst = (e_k / lim, f"{part}[{i}]", e_k, e_p)
    return worst


def to_cpu64(ts):
    """A TrainState's tensors as float64 on the CPU."""
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.ops import adam

    def tree(t):
        return adam.tree_map(lambda x: x.detach().cpu().double(), t)

    def opt(o):
        return adam.AdamState(m=tree(o.m), v=tree(o.v), t=o.t)

    return ppo.TrainState(tree(ts.policy_params), tree(ts.v_params),
                          opt(ts.opt_policy), opt(ts.opt_v),
                          opt(ts.opt_log_std))


def grad_norm(ts_noclip, opt: str) -> float:
    """The global norm of a first step's unclipped gradient (the policy's
    ``{"mlp", "log_std"}`` as one tree), from the first moments of the
    step taken with the clip off, m = (1 - beta1) g."""
    import torch

    from ppoc_tpu_torch.ops import adam

    m = adam.tree_leaves(getattr(ts_noclip, opt).m)
    if opt == "opt_policy" and ts_noclip.opt_log_std.m.numel():
        m = m + [ts_noclip.opt_log_std.m]
    return float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in m))) / 0.1


def check_first_steps(label, cfg, env, ts, draws, dev):
    """The first fit's first value step and first policy step through K5
    (the main path's backend) held to float64 beside the same steps on the
    plain path (backend "jnp": float32 products), from ``ts`` on the same
    rows (:func:`step_apart`): the rollout is K1's with the V planes
    (V_old), the advantages K2's.  Each step is held with the clip engaged:
    at cfg.max_grad_norm where it engages there, else also at half the
    step's own unclipped norm.  Where it engaged, the kernel step with the
    clip switched off, and for a Gaussian policy the step with log_std
    outside the clip (the policy net clipped alone), are controls that
    must fail the same check."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.models import mlp, policy as policy_mod
    from ppoc_tpu_torch.ops import adam

    traj, _, vpair = ppo.rollout(cfg, env, ts.policy_params, draws.seed,
                                 cfg.n_envs, cfg.rollout_len,
                                 v_params=ts.v_params)
    adv, tgt = ppo.compute_advantages(cfg, env, traj, vpair)
    buf = buffer.from_rollout(traj, adv, tgt, v_old=vpair[0])
    n_mb, discrete = cfg.num_minibatches, env.spec.discrete
    o, t, vo = buffer.gather_mb((buf.obs, buf.target, buf.v_old),
                                draws.value_idx[0, 0])
    pb = buffer.gather_mb((buf.obs, buf.action, buf.log_prob, buf.advantage),
                          draws.policy_idx[0, 0])

    def cpu64(x):
        return x.cpu().double() if x.is_floating_point() else x.cpu()

    def value_step(c, backend, state=ts, rows=(o, t, vo)):
        return ppo.value_steps(c, state, [(*rows, None)], lambda p, b: (
            mlp.apply(p, b[0], c.activation, backend)[..., 0]), n_mb,
            backend)[0]

    def policy_step(c, backend, state=ts, rows=pb):
        def log_probs(p, b):
            return (policy_mod.log_prob(p, b[0], b[1], c.activation,
                                        backend, discrete),
                    policy_mod.entropy(p, b[0], c.activation, backend,
                                       discrete))

        return ppo.policy_steps(c, state, [rows], log_probs, n_mb,
                                backend, discrete)[0]

    def apart_step(c):
        # a faulty clip for a control: the policy net's gradient clipped
        # alone and log_std's left as it is, the two kept apart
        real = adam.clip_by_global_norm
        adam.clip_by_global_norm = lambda g, n: dict(g, mlp=real(g["mlp"], n))
        try:
            return policy_step(c, "pallas")
        finally:
            adam.clip_by_global_norm = real

    ts64 = to_cpu64(ts)
    for name, step, parts, opt, rows, lr in (
            ("value", value_step, ("v_params", "opt_v.m", "opt_v.v"),
             "opt_v", (o, t, vo), cfg.lr_v),
            ("policy", policy_step,
             ("policy_params", "opt_policy.m", "opt_policy.v",
              "opt_log_std.m", "opt_log_std.v"), "opt_policy", pb,
             cfg.lr_policy)):
        bare = step(cfg.replace(max_grad_norm=0.0), "pallas")
        norm = grad_norm(bare, opt)
        held = [cfg]
        if cfg.max_grad_norm >= 0.99 * norm:
            held.append(cfg.replace(max_grad_norm=norm / 2))
            print(f"  the clip does not engage on the first {name} step at "
                  f"max_grad_norm {cfg.max_grad_norm} (norm {norm:.4f}): "
                  f"held again at max_grad_norm {norm / 2:.4f}", flush=True)
        for c in held:
            scale = min(1.0, c.max_grad_norm / max(norm, 1e-12))
            got, plain = step(c, "pallas"), step(c, "jnp")
            ref = step(c, "jnp", ts64, tuple(cpu64(x) for x in rows))
            torch.cuda.synchronize()
            ratio, leaf, e_k, e_p = step_apart(got, plain, ref, parts, lr)
            check(f"{label}: the first {name} step through K5 at "
                  f"max_grad_norm {c.max_grad_norm:.4f} against float64 "
                  f"(clip scale {scale:.4f}; worst leaf {leaf}: kernel "
                  f"{e_k:.3e}, plain {e_p:.3e})", ratio, 1.0,
                  what="distance over the limit")
            if scale >= 0.99:
                continue
            controls = [("the clip off", bare)]
            if name == "policy" and not discrete:
                controls.append(("log_std outside the clip", apart_step(c)))
            for what, wrong in controls:
                ctrl = step_apart(wrong, plain, ref, parts, lr)
                print(f"  control, the {name} step with {what}: "
                      f"{ctrl[0]:.3e} of the limit ({ctrl[1]})", flush=True)
                if ctrl[0] <= 1.0:
                    raise AssertionError(
                        f"{label}: the {name} step with {what} passes the "
                        f"check at max_grad_norm {c.max_grad_norm:.4f}; it "
                        f"cannot see the clip")


def replay_first_fit(cfg, env, ts, gen_state, dev):
    """The epoch's first fit again, from the trainer's state and generator
    position before the epoch: on the card, counting the steps on which
    the clip engaged; then its GAE and policy phase on the CPU from the
    card's rollout (the plain versions; the policy phase reads neither
    the value phase's params nor its Adam state), for the freeze point.
    Returns (card state, CPU policy phase's state, clip engagements: value
    steps, policy steps, policy steps taken)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.ops import adam
    from ppoc_tpu_torch.utils import params as conv

    gen = torch.Generator()
    gen.set_state(gen_state)
    draws = ppo.draw_fit(cfg, gen, dev, env)
    traj, _, vpair = ppo.rollout(cfg, env, ts.policy_params, draws.seed,
                                 cfg.n_envs, cfg.rollout_len,
                                 v_params=ts.v_params)
    engaged = []
    real = adam.clip_by_global_norm

    def counted(grads, max_norm):
        norm = torch.sqrt(sum(torch.sum(g * g)
                              for g in adam.tree_leaves(grads)))
        engaged.append(norm > max_norm)
        return real(grads, max_norm)

    adam.clip_by_global_norm = counted
    try:
        card, _ = ppo.update_step(cfg, env, ts, traj, draws, vpair)
    finally:
        adam.clip_by_global_norm = real
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    flags = [bool(x) for x in engaged]
    traj = ppo.Transition(*(x.cpu() for x in traj))
    adv, tgt = ppo.compute_advantages(cfg, env, traj,
                                      tuple(v.cpu() for v in vpair))
    cpu, _, _ = ppo.policy_phase(
        cfg, conv.train_state_from_numpy(conv.train_state_to_numpy(ts),
                                         "cpu"),
        buffer.from_rollout(traj, adv, tgt), draws.policy_idx.cpu(),
        env.spec.discrete)
    return card, cpu, (sum(flags[:n_v]), sum(flags[n_v:]), len(flags) - n_v)


def same_leaves(label, a, b) -> None:
    """Every leaf of two trees (a TrainState: params and the three Adam
    states) equal bit for bit."""
    import torch

    from ppoc_tpu_torch.ops import adam

    la, lb = adam.tree_leaves(a), adam.tree_leaves(b)
    if len(la) != len(lb) or not all(
            (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
            for x, y in zip(la, lb)):
        raise AssertionError(f"{label}: the states differ")
    print(f"  {label}: {len(la)} leaves equal bit for bit", flush=True)


def counted_run(counters, fn):
    """(fn's result, the launch counts it made, its wall in s)."""
    import torch

    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(counters), time.perf_counter() - t0


def expect_counts(label, counts, want):
    """Every counter equal to ``want``'s (absent: 0)."""
    bad = {k: (v, want.get(k, 0)) for k, v in counts.items()
           if v != want.get(k, 0)}
    bad.update({k: (0, v) for k, v in want.items() if k not in counts})
    print(f"  {label}: launches {count_diff({k: 0 for k in counts}, counts)}",
          flush=True)
    if bad:
        raise AssertionError(f"{label}: launch counts (got, want) {bad}")


def on_card(tree) -> bool:
    from ppoc_tpu_torch.ops import adam

    # a TrainState's leaves include the Adam steps, Python ints
    return all(t.is_cuda for t in adam.tree_leaves(tree)
               if hasattr(t, "is_cuda") and t.numel())


def stab_path(cfg, label, dev, counters, record, bench_k1, bench_k2):
    """One epoch of ``cfg`` (the five stabilisers) through Trainer on the
    card: per fit one K1 with the V planes and one K2, no K3/K4/K6, and
    K5's forwards and backwards as the minibatch counts and the policy's
    steps imply; then the first fit replayed on the card and the CPU (the
    target_kl freeze point of each, the clip's engagements), the first
    value and policy steps held to the plain path, the last lr factor."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.models import mlp

    tr = Trainer(cfg)
    check_on_card(tr)
    ts0, gen0 = tr.state, tr.generator.get_state()
    discrete, lane = tr.env.spec.discrete, tr.env.spec.name
    fits = cfg.fits_per_epoch
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    n_p = cfg.n_epochs_policy * cfg.num_minibatches
    m, counts, wall = counted_run(counters, tr.train_epoch)
    steps = tr.state.opt_policy.t
    fwd_p = 2 if discrete else 1   # log-prob (+ entropy) forwards a step
    step_ms = wall / (fits * (n_v + n_p)) * 1e3
    print(f"  one epoch: {wall:.3f} s wall, {step_ms:.3f}"
          f" ms a minibatch step; value loss {float(m.value_loss):.3f}, "
          f"policy steps taken {steps} of {fits * n_p}", flush=True)
    expect_counts(label, counts, {
        f"rollout[{lane}]/values": fits, "gae_norm": fits,
        "mlp_forward": fits * (n_v + fwd_p * n_p),
        "mlp_backward": fits * n_v + fwd_p * steps})
    if discrete and tr.state.opt_log_std.m.numel():
        raise AssertionError("a categorical policy's log_std moments grew")
    if discrete and tr.state.opt_log_std.t:
        raise AssertionError("the categorical policy stepped its empty "
                             "log_std Adam")
    if not bool(torch.isfinite(mlp.flatten(tr.state.v_params)).all()):
        raise AssertionError(f"{label}: non-finite value net")
    factors = [float(ppo._anneal_factor(cfg, getattr(tr.state, o),
                                        cfg.num_minibatches, e))
               for o, e in (("opt_v", cfg.n_epochs_value),
                            ("opt_policy", cfg.n_epochs_policy))]
    print(f"  last lr factor: value {factors[0]:.6f}, policy {factors[1]:.6f}"
          f" (Adam steps {tr.state.opt_v.t} and {steps})", flush=True)
    ev, ev_counts, _ = counted_run(counters, tr.evaluate)
    expect_counts(f"{label} evaluate()", ev_counts,
                  {f"rollout[{lane}]/metrics": 1})
    print(f"  evaluate(): R {ev.R:.3f}, episodes {int(ev.episodes)}",
          flush=True)

    card, cpu, (v_eng, p_eng, p_steps) = replay_first_fit(
        cfg, tr.env, ts0, gen0, dev)
    print(f"  first fit replayed: the clip engaged on {v_eng} of {n_v} value "
          f"steps and {p_eng} of {p_steps} policy steps; target_kl froze the "
          f"policy after minibatch {card.opt_policy.t} of {n_p} on the card, "
          f"{cpu.opt_policy.t} on the CPU (its update on the card's "
          f"rollout)", flush=True)
    gen = torch.Generator()
    gen.set_state(gen0)
    draws = ppo.draw_fit(cfg, gen, dev, tr.env)
    check_first_steps(label, cfg, tr.env, ts0, draws, dev)

    traj, _ = ppo.rollout(cfg, tr.env, ts0.policy_params, draws.seed,
                          cfg.n_envs, cfg.rollout_len)
    x, = buffer.gather_mb((traj.obs.reshape(-1, traj.obs.shape[-1]),),
                          draws.value_idx[0, 0])
    vw = mlp.dims(ts0.v_params)
    err, fwd, bwd = check_mlp(ts0.v_params, x, cfg.activation, dev)
    path = (f"{label} generic phases, {cfg.n_envs} envs x "
            f"{cfg.rollout_len} steps, mb {cfg.minibatch_size}")
    fb, bb = mlp_bounds(vw, cfg.minibatch_size)
    record("mlp_forward", path, [cfg.minibatch_size] + vw,
           counts["mlp_forward"], err, fwd, fb)
    record("mlp_backward", path, [cfg.minibatch_size] + vw,
           counts["mlp_backward"], err, bwd, bb)
    if not discrete:
        T, E = cfg.rollout_len, cfg.n_envs
        record(f"rollout[{lane}]", path + " (training rollouts)", [T, E],
               counts[f"rollout[{lane}]/values"], *bench_k1)
        record("gae_norm", path, [T, E], counts["gae_norm"], *bench_k2,
               gae_bound(T, E))


def check_moe(params, x, dev):
    """The mixture (float32, TF32 off) on the card against float64 on the
    CPU, forward and the gradients of a seeded projection of its output,
    beside the plain CPU float32 form's error; the top-2 gate's rows."""
    import torch

    from ppoc_tpu_torch.models import moe
    from ppoc_tpu_torch.ops import adam

    g = torch.Generator().manual_seed(5)
    w = torch.randn(x.shape[0], params["experts"][-1][0].shape[-1],
                    generator=g)

    def run(p, xx, ww):
        q = adam.tree_map(lambda t: t.detach().clone().requires_grad_(), p)
        out = moe.apply(q, xx, "relu", topk=2)
        grads = torch.autograd.grad(torch.sum(out * ww), adam.tree_leaves(q))
        return [out.detach()] + list(grads)

    cpu = adam.tree_map(lambda t: t.detach().cpu(), params)
    ref = run(adam.tree_map(lambda t: t.double(), cpu), x.cpu().double(),
              w.double())
    card = run(params, x, w.to(dev))
    plain = run(cpu, x.cpu(), w)
    torch.cuda.synchronize()
    for i, (a, b, r) in enumerate(zip(card, plain, ref)):
        e_card, e_cpu = max_err(a.cpu(), r), max_err(b, r)
        what = "forward" if i == 0 else f"gradient leaf {i - 1}"
        check(f"mixture {what} on {x.shape[0]} rows, card vs float64 "
              f"(CPU float32 {e_cpu:.3e})", e_card,
              max(MOE_F64_FACTOR * e_cpu, MOE_REL * float(r.abs().max())))
    gate = moe.gate_weights(params, x, topk=2)
    nz = (gate > 0).sum(dim=-1)
    if not (bool((nz == 2).all())
            and float((gate.sum(dim=-1) - 1).abs().max()) <= 1e-6):
        raise AssertionError("a top-2 gate row is not two weights summing "
                             "to 1")
    print(f"  top-2 gate: every one of {x.shape[0]} rows two non-zero "
          f"weights summing to 1 (within 1e-6)", flush=True)


def slice18_phases(dev, counters, record, bench_k1, bench_k2):
    """The paths slice 18 opens, each one epoch on the card through
    Trainer with every launch counter read around it: STAB_BENCH and
    STAB_CARTPOLE (the five stabilisers: K1, K2, K5, no whole-phase
    kernel), the mixture of experts (no kernel under "moe:0", K2 alone
    under "moe:2:bf16"), an affine env (the env loop through K5, then K2,
    K3, K4; no K1) and "jnp" (no kernel)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.envs import wrappers
    from ppoc_tpu_torch.models import mlp

    t_phase = time.perf_counter()
    header("[STAB_BENCH: bench_config with max_grad_norm 0.5, clip_value "
           "0.2, target_kl 0.02, lr and entropy annealing, ent_coeff 0.01]")
    stab_path(stab_config(0), "STAB_BENCH", dev, counters, record, bench_k1,
              bench_k2)
    header("[STAB_CARTPOLE: the same stabilisers on cartpole, eval_len 500]")
    stab_path(stab_config(0, "cartpole"), "STAB_CARTPOLE", dev, counters,
              record, bench_k1, bench_k2)

    header("[MOE: examples/moe_expert_parallel.py's single-device mixture, "
           "4 experts, dense gating ('moe:0'), one epoch of one fit]")
    tr = Trainer(moe_config(fits_per_epoch=1))   # no kernel: depth cut
    check_on_card(tr)
    assert tr.backend == "moe:0", tr.backend
    m, counts, wall = counted_run(counters, tr.train_epoch)
    ev, ev_counts, _ = counted_run(counters, tr.evaluate)
    print(f"  one epoch {wall:.3f} s, value loss {float(m.value_loss):.3f}; "
          f"evaluate() R {ev.R:.3f}", flush=True)
    expect_counts("MOE moe:0 epoch", counts, {})
    expect_counts("MOE moe:0 evaluate()", ev_counts, {})
    if not (on_card(tr.state.v_params) and on_card(tr.state.policy_params)):
        raise AssertionError("the mixture's state left the card")
    header(f"[MOE: the mixture on {MOE_ROWS} rows against float64, the top-2 "
           f"gate]")
    x = torch.randn(MOE_ROWS, tr.env.spec.obs_dim,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    check_moe(tr.state.policy_params["mlp"], x, dev)
    header("[MOE: moe_topk 2, moe_aux_coeff 0.01 under 'bf16' "
           "('moe:2:bf16'), one epoch]")
    tr = Trainer(moe_config(moe_topk=2, moe_aux_coeff=0.01,
                            kernel_backend="bf16"))
    assert tr.backend == "moe:2:bf16", tr.backend
    m, counts, wall = counted_run(counters, tr.train_epoch)
    print(f"  one epoch {wall:.3f} s, value loss {float(m.value_loss):.3f}",
          flush=True)
    expect_counts("MOE moe:2:bf16 epoch", counts,
                  {"gae_norm": tr.cfg.fits_per_epoch})
    if not math.isfinite(float(m.value_loss)):
        raise AssertionError("non-finite loss on the bf16 mixture")

    header("[AFFINE: calibrate(bench_config(0)) on the card, one epoch "
           "under 'pallas']")
    t0 = time.perf_counter()
    cfg = wrappers.calibrate(bench_config(0))
    t_cal = time.perf_counter() - t0
    cpu = wrappers.calibrate(bench_config(0), device="cpu")
    apart = max(abs(a - b) / s for a, b, s in zip(
        cfg.obs_loc + cfg.obs_scale, cpu.obs_loc + cpu.obs_scale,
        cpu.obs_scale * 2))
    print(f"  obs_loc {cfg.obs_loc}, obs_scale {cfg.obs_scale} ({t_cal:.3f} s "
          f"on the card)", flush=True)
    check("calibrate on the card against the CPU on the same draws",
          apart, CALIB_REL, what="largest difference over the CPU's scale")
    tr = Trainer(cfg)
    assert tr.env.spec.name == "pendulum#affine"
    fits = cfg.fits_per_epoch
    m, counts, wall = counted_run(counters, tr.train_epoch)
    print(f"  one epoch {wall:.3f} s, value loss {float(m.value_loss):.3f}",
          flush=True)
    expect_counts("AFFINE epoch", counts, {
        "mlp_forward": fits * (cfg.rollout_len + 2), "gae_norm": fits,
        "value_phase": fits, "policy_phase": fits})
    ev, ev_counts, _ = counted_run(counters, tr.evaluate)
    expect_counts("AFFINE evaluate()", ev_counts,
                  {"mlp_forward": cfg.eval_len})
    pp = tr.state.policy_params["mlp"]
    pw = mlp.dims(pp)
    draws = ppo.draw_eval(cfg, tr.env, torch.Generator().manual_seed(4), dev)
    traj = ppo.rollout_env_loop(cfg, tr.env, tr.state.policy_params, draws)
    err, fwd, _ = check_mlp(pp, traj.obs[0].contiguous(), cfg.activation, dev)
    record("mlp_forward", f"AFFINE env-loop rollout, {cfg.n_envs} envs",
           [cfg.n_envs] + pw, counts["mlp_forward"], err, fwd,
           mlp_bounds(pw, cfg.n_envs)[0])

    header("[JNP: bench_config(0) with kernel_backend 'jnp', one epoch of "
           "one fit]")
    tr = Trainer(bench_config(0).replace(kernel_backend="jnp",
                                         fits_per_epoch=1))  # no kernel
    m, counts, wall = counted_run(counters, tr.train_epoch)
    ev, ev_counts, _ = counted_run(counters, tr.evaluate)
    print(f"  one epoch {wall:.3f} s, value loss {float(m.value_loss):.3f}; "
          f"evaluate() R {ev.R:.3f}", flush=True)
    expect_counts("JNP epoch", counts, {})
    expect_counts("JNP evaluate()", ev_counts, {})
    if not (on_card(tr.state.v_params) and on_card(tr.state.policy_params)):
        raise AssertionError("the jnp trainer's state left the card")
    print(f"  slice 18 phases: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --- slice 19: the recurrent family, the transplant, the aux value head ----

# examples/recurrent_memory.py's GRU (docs/RESULTS.md: R 1.0 by epoch 2)
RNN_RECALL = dict(env="recall", n_envs=128, rollout_len=6,
                  minibatch_size=192, fits_per_epoch=8, eval_envs=256,
                  eval_len=6, hidden=(32,), seed=0, lr_policy=1e-3,
                  lr_v=1e-3, rnn_hidden=16)
RNN_RECALL_EPOCHS = 5


def rnn_recall_config(seed: int = 0):
    """RNN_RECALL with ``seed`` (tools/seed_parity.py's rnn_recall)."""
    from ppoc_tpu_torch import PPOConfig

    return PPOConfig(**dict(RNN_RECALL, seed=seed))
# docs/RESULTS.md's pendulum_po schedule at full width, its depth cut to
# one fit (fits_per_epoch 4 there) of 4 value epochs (10 there): 64 envs x
# 200, minibatch 800 (4 sequences), rnn_hidden 32, head (64,).  No kernel
# runs; its wall is the host's, ~130 ms a minibatch step
PO_GRU = dict(env="pendulum_po", n_envs=64, rollout_len=200,
              minibatch_size=800, fits_per_epoch=1, eval_envs=64,
              eval_len=200, rnn_hidden=32, hidden=(64,), seed=0,
              n_epochs_value=4)
# the same on cartpole_po (the categorical head)
CARTPOLE_PO_GRU = dict(PO_GRU, env="cartpole_po", eval_len=500)
# the memoryless route to the same task: 4 stacked frames into a (64, 64)
# MLP on the same schedule, "pallas", one epoch of 4 fits
PO_STACK = dict(env="pendulum_po_stack", n_envs=64, rollout_len=200,
                minibatch_size=800, fits_per_epoch=4, eval_envs=64,
                eval_len=200, hidden=(64, 64), seed=0,
                kernel_backend="pallas")
# the epoch-0 replay against the rollout, over a fit's rows, fixed before
# the first chip run: |exp(logp_replay - logp_rollout) - 1| at most this.
# The replay takes every step's input product in one matmul where the
# rollout takes one a step, and the head over the window at once, so the
# two sum in other orders: float32 roundings of the gates carried through
# 6 cell steps, about 1e-6 of a log-prob near 1
REPLAY_TOL = 1e-5
# the GRU/LSTM on the card against float64 on the card: within
# RNN_F64_FACTOR times the CPU float32 form's own error, or within RNN_REL
# of the leaf's largest magnitude (a gradient sums 800 rows through 200
# steps of the chain, in cuBLAS's order on the card)
RNN_F64_FACTOR = 4.0
RNN_REL = 1e-5
# a served step on the card against the CPU's cell from the same state:
# actions and states within this of the larger of 1 and their magnitude
SERVE_REL = 1e-5
SERVE_STEPS = 200


def ratio_gap(cfg, tr, dev, seed: int = 11) -> float:
    """The largest |exp(logp_replay - logp_rollout) - 1| over one fit's
    rollout: the update's replay of the window from a zero state against
    the log-probs the rollout stored, both on the card."""
    import torch

    from ppoc_tpu_torch.algo import ppo, recurrent

    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(seed), dev,
                         tr.env)
    pp = tr.state.policy_params
    traj, _ = recurrent.rollout_rnn(cfg, tr.env, pp, draws.seq)
    with torch.no_grad():
        logp, _ = recurrent.policy_log_probs_rnn(
            cfg, pp, traj.obs, traj.action, traj.terminated | traj.truncated,
            tr.env.spec.discrete, ppo.backend_of(cfg))
    return float((torch.exp(logp - traj.log_prob) - 1).abs().max())


def check_rnn_f64(label, cfg, tr, dev, seed: int = 21):
    """One fit's rollout on the card, then on its first value minibatch
    (``seqs`` env columns, the whole window) the value loss's BPTT
    gradient and, on the whole window, compute_values_rnn: float32 on the
    card against float64 on the card, beside the CPU float32 form's error
    (:data:`RNN_F64_FACTOR`, :data:`RNN_REL`)."""
    import torch

    from ppoc_tpu_torch.algo import ppo, recurrent
    from ppoc_tpu_torch.models import gru
    from ppoc_tpu_torch.ops import adam, losses

    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(seed), dev,
                         tr.env)
    vp = tr.state.v_params
    traj, _ = recurrent.rollout_rnn(cfg, tr.env, tr.state.policy_params,
                                    draws.seq)
    vpair = recurrent.compute_values_rnn(cfg, vp, traj, "jnp")
    _, target = ppo._seq_advantages(cfg, tr.env, traj, vpair)
    cols = draws.value_idx[0, 0]
    done = traj.terminated | traj.truncated
    o, d, t = (x.index_select(1, cols) for x in (traj.obs, done, target))

    def run(p, tj, o, d, t):
        q = adam.tree_map(lambda x: x.detach().clone().requires_grad_(), p)
        v = gru.apply_seq(q, o, d, cfg.activation)[..., 0]
        grads = torch.autograd.grad(losses.value_loss(v, t),
                                    adam.tree_leaves(q))
        return list(grads) + list(recurrent.compute_values_rnn(
            cfg, p, tj, "jnp"))

    def cast(dt, where):
        return (adam.tree_map(lambda x: x.detach().to(where, dt), vp),
                ppo.Transition(*(x.to(where, dt) if x.is_floating_point()
                                 else x.to(where) for x in traj)),
                o.to(where, dt), d.to(where), t.to(where, dt))

    card = run(vp, traj, o, d, t)
    ref = [x.cpu() for x in run(*cast(torch.float64, dev))]
    plain = run(*cast(torch.float32, "cpu"))
    torch.cuda.synchronize()
    names = [f"gradient leaf {i}" for i in range(len(card) - 2)] + [
        "V(s)", "V(s')"]
    worst = 0.0
    for name, a, b, r in zip(names, card, plain, ref):
        e_card, e_cpu = max_err(a.cpu(), r), max_err(b, r)
        lim = max(RNN_F64_FACTOR * e_cpu, RNN_REL * float(r.abs().max()))
        worst = max(worst, e_card / lim)
        if e_card > lim:
            raise AssertionError(
                f"{label}: {name} on the card is {e_card:.3e} from float64, "
                f"the CPU's float32 {e_cpu:.3e} (limit {lim:.3e})")
    print(f"  {label}: {gru.cell_kind(vp)} BPTT gradient ({len(names) - 2} "
          f"leaves, {o.shape[1]} sequences x {o.shape[0]} steps) and V(s), "
          f"V(s') on {traj.obs.shape[1]} x {traj.obs.shape[0]}, card vs "
          f"float64: worst {worst:.3e} of the limit; largest |diff| card "
          f"{max(max_err(a.cpu(), r) for a, r in zip(card, ref)):.3e}, CPU "
          f"float32 {max(max_err(b, r) for b, r in zip(plain, ref)):.3e}",
          flush=True)
    return worst


def rnn_fit(label, cfg, dev, counters, epochs: int = 1, **train):
    """Trainer(cfg) on the card, ``epochs`` epochs (``train``: stop_at_R)
    with every counter read around them and held to none, then
    evaluate(deterministic=True) likewise; prints the wall, the ms a
    minibatch step and an env step's rate.  Returns (trainer, history)."""
    from ppoc_tpu_torch.algo import ppo, recurrent
    from ppoc_tpu_torch.algo.trainer import Trainer

    tr = Trainer(cfg)
    check_on_card(tr)
    assert tr.backend == "jnp" and ppo.kernel_fit(cfg, 232448) == []
    hist, counts, wall = counted_run(
        counters, lambda: tr.train(epochs, log=False, **train))
    seqs, n_mb = recurrent.seq_minibatch_plan(cfg.n_envs, cfg.rollout_len,
                                              cfg.minibatch_size)
    fits = len(hist) * cfg.fits_per_epoch
    steps = fits * n_mb * (cfg.n_epochs_value + cfg.n_epochs_policy)
    fit_s = sum(h["time_s"] for h in hist)
    print(f"  {label}: {len(hist)} epochs ({fits} fits) in {wall:.3f} s with "
          f"evaluation, {fit_s:.3f} s fitting: {fit_s / steps * 1e3:.3f} ms "
          f"a minibatch step ({seqs} sequences x {cfg.rollout_len} steps), "
          f"{fits * cfg.steps_per_fit / fit_s:.0f} env-steps/s; R "
          f"{[round(h['R'], 4) for h in hist]}", flush=True)
    expect_counts(label, counts, {})
    ev, ev_counts, ev_wall = counted_run(
        counters, lambda: tr.evaluate(deterministic=True))
    print(f"  {label} evaluate(deterministic=True): R {ev.R:.3f}, episodes "
          f"{int(ev.episodes)}, {ev_wall:.3f} s", flush=True)
    expect_counts(f"{label} evaluate()", ev_counts, {})
    if not (on_card(tr.state.v_params) and on_card(tr.state.policy_params)):
        raise AssertionError(f"{label}: the state left the card")
    if not all(math.isfinite(h[k]) for h in hist
               for k in ("value_loss", "policy_loss")):
        raise AssertionError(f"{label}: non-finite loss {hist}")
    return tr, hist


def check_transplant(label, tr):
    """transplant_value_trunk on the card: the policy's encoder (cell or
    attn) equal to the critic's bit for bit, the action head and log_std
    as they were, the policy Adam restarted, the state on the card."""
    import torch

    from ppoc_tpu_torch.ops import adam

    pol = tr.state.policy_params
    part = "attn" if "attn" in pol["mlp"] else "cell"
    head = [t.clone() for t in adam.tree_leaves(pol["mlp"]["head"])]
    log_std = pol["log_std"].clone()
    if all(torch.equal(a, b) for a, b in zip(
            adam.tree_leaves(pol["mlp"][part]),
            adam.tree_leaves(tr.state.v_params[part]))):
        raise AssertionError(f"{label}: policy and critic encoders already "
                             f"equal before the transplant")
    tr.transplant_value_trunk()
    pol = tr.state.policy_params
    same = [torch.equal(a, b) for a, b in zip(
        adam.tree_leaves(pol["mlp"][part]),
        adam.tree_leaves(tr.state.v_params[part]))]
    kept = [torch.equal(a, b) for a, b in zip(
        adam.tree_leaves(pol["mlp"]["head"]), head)]
    if not (all(same) and all(kept) and torch.equal(pol["log_std"], log_std)
            and tr.state.opt_policy.t == 0
            and not any(bool(x.any()) for x in adam.tree_leaves(
                tr.state.opt_policy.m))
            and on_card(tr.state.policy_params)
            and on_card(tr.state.opt_policy.m)):
        raise AssertionError(f"{label}: transplant: encoder equal {same}, "
                             f"head kept {kept}, Adam t "
                             f"{tr.state.opt_policy.t}")
    print(f"  {label}: the policy's {part} ({len(same)} leaves) equals the "
          f"critic's bit for bit, the head ({len(kept)} leaves) and log_std "
          f"kept, the policy Adam at t 0 with zero moments, all on the card",
          flush=True)


def check_aux_hidden(tr, dev):
    """The trained AUX_XL policy trunk at its window, T 1024 (recall_xl's
    rollout episodes and random ones): apply_seq(return_hidden=True) through K7
    ("pallas") against the materialised core ("jnp") -- the outputs and
    the hidden plane to FLASH_OUT_TOL, the aux loss's gradients over every
    leaf to FLASH_GRAD_TOL of the leaf's largest magnitude (at least 1) --
    and the aux head's gradient non-zero and finite.  Returns the largest
    difference."""
    import torch

    from ppoc_tpu_torch.models import attn, mlp
    from ppoc_tpu_torch.ops import adam

    cfg = tr.cfg
    p = tr.state.policy_params["mlp"]
    T, E = attn.window(p) - 1, 4           # recall_xl's 1024
    g = torch.Generator().manual_seed(14)
    xs = torch.randn(T, E, tr.env.spec.obs_dim, generator=g).to(dev)
    dones = torch.cat([dones_of_rollout("recall_xl", T, 2, dev),
                       random_dones(T, 2, 0.02, 15, dev)], dim=1)
    tgt = torch.randn(T, E, generator=g).to(dev)
    res = {}
    for backend in ("pallas", "jnp"):
        q = adam.tree_map(lambda t: t.detach().requires_grad_(), p)
        out, hid = attn.apply_seq(q, xs, dones, cfg.activation,
                                  backend=backend, return_hidden=True)
        vhat = mlp.apply(q["aux_head"], hid, cfg.activation, "jnp")[..., 0]
        loss = cfg.aux_value_coeff * torch.mean(torch.square(vhat - tgt))
        # what the aux loss reaches: the encoder, then the aux head
        res[backend] = (out.detach(), hid.detach(), torch.autograd.grad(
            loss, adam.tree_leaves(q["attn"]) + adam.tree_leaves(
                q["aux_head"])))
    torch.cuda.synchronize()
    err = max(max_err(res["pallas"][i], res["jnp"][i]) for i in (0, 1))
    check("apply_seq(return_hidden=True): outputs and hidden plane, K7 vs "
          "the materialised core", err, FLASH_OUT_TOL)
    ratio = max(max_err(a, b) / max(1.0, float(b.abs().max())) for a, b in
                zip(res["pallas"][2], res["jnp"][2]))
    check(f"the aux loss's {len(res['jnp'][2])} gradient leaves, K7 vs the "
          f"materialised core, over the leaf's max (at least 1)", ratio,
          FLASH_GRAD_TOL, what="ratio")
    n_aux = len(adam.tree_leaves(p["aux_head"]))
    aux = res["pallas"][2][-n_aux:]
    norm = math.sqrt(sum(float((x * x).sum()) for x in aux))
    if not (math.isfinite(norm) and norm > 0):
        raise AssertionError(f"the aux head's gradient: norm {norm}")
    print(f"  the aux head's gradient through K7: norm {norm:.4e} over "
          f"{n_aux} leaves, finite and non-zero", flush=True)
    return max(err, *(max_err(a, b) for a, b in
                      zip(res["pallas"][2], res["jnp"][2])))


def serve_rnn(label, tr, dev, work):
    """Save ``tr`` (a GRU or LSTM trainer), load_recurrent_policy on the
    card and on the CPU, and step SERVE_STEPS batches of 64 random
    observations, lanes zeroed at random: each card step held to the
    CPU's cell from the card's state (:data:`SERVE_REL`); the us of an act
    call (its action read back to the host)."""
    import torch

    from ppoc_tpu_torch import serve
    from ppoc_tpu_torch.models import gru

    path = str(work / f"{label}.bin")
    tr.save(path)
    act = serve.load_recurrent_policy(path)
    cpu = serve.load_recurrent_policy(path, device="cpu")
    width = act.state_size
    if width != gru.state_size(tr.state.policy_params["mlp"]):
        raise AssertionError(f"{label}: served state width {width}")
    g = torch.Generator().manual_seed(8)
    B, d = 64, tr.env.spec.obs_dim
    obs = torch.randn(SERVE_STEPS, B, d, generator=g)
    reset = torch.rand(SERVE_STEPS, B, 1, generator=g) < 0.1
    h = act.initial_state(B)
    worst = 0.0
    torch.cuda.synchronize()
    t_total = 0.0
    for t in range(SERVE_STEPS):
        t0 = time.perf_counter()
        a, h2 = act(obs[t], h)
        a_host = a.cpu()
        t_total += time.perf_counter() - t0
        a_ref, h_ref = cpu(obs[t], h.cpu())
        for x, r in ((a_host, a_ref), (h2.cpu(), h_ref)):
            worst = max(worst, max_err(x, r) / max(1.0, float(r.abs().max())))
        h = torch.where(reset[t].to(dev), 0.0, h2)
    check(f"{label}: {SERVE_STEPS} served steps of {B} rows, card vs the CPU's "
          f"cell from the same state (actions and states, over max(1, |x|))",
          worst, SERVE_REL, what="ratio")
    print(f"  {label}: an act call {t_total / SERVE_STEPS * 1e6:.1f} us "
          f"({B} rows, state {width} wide, the action read back)",
          flush=True)


def slice19_phases(dev, counters, record):
    """The paths slice 19 opens, each through Trainer on the card with
    every launch counter read around it: the GRU/LSTM family (no kernel)
    on recall, pendulum_po and cartpole_po; pendulum_po_stack's
    memoryless route (the env loop through K5, K2, K3, K4); the transplant;
    the aux value head on recall_xl (K7); recurrent serving."""
    import shutil
    from pathlib import Path

    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "slice19_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    header(f"[RNN_RECALL: examples/recurrent_memory.py's GRU (rnn_hidden "
           f"16), up to {RNN_RECALL_EPOCHS} epochs to R > {RECALL_LEARNED}]")
    cfg = PPOConfig(**RNN_RECALL)
    gap = ratio_gap(cfg, Trainer(cfg), dev)
    print(f"  epoch-0 replay against the rollout over a fit's "
          f"{cfg.steps_per_fit} rows: largest |ratio - 1| {gap:.3e}",
          flush=True)
    check("epoch-0 replay ratio, |exp(logp_replay - logp_rollout) - 1|", gap,
          REPLAY_TOL, what="largest")
    gru_tr, hist = rnn_fit("RNN_RECALL", cfg, dev, counters,
                           RNN_RECALL_EPOCHS, stop_at_R=RECALL_LEARNED)
    if not hist[-1]["R"] > RECALL_LEARNED:
        raise AssertionError(f"RNN_RECALL: R {hist[-1]['R']} after "
                             f"{len(hist)} epochs")

    header("[PENDULUM_PO_GRU: pendulum_po, 64 envs x 200, mb 800, rnn_hidden "
           "32, head (64,), one fit of 4 value epochs]")
    cfg = PPOConfig(**PO_GRU)
    tr, _ = rnn_fit("PENDULUM_PO_GRU", cfg, dev, counters)
    check_rnn_f64("PENDULUM_PO_GRU", cfg, tr, dev)

    header("[CARTPOLE_PO_GRU: the same schedule on cartpole_po (categorical), "
           "eval_len 500, one fit of 4 value epochs]")
    rnn_fit("CARTPOLE_PO_GRU", PPOConfig(**CARTPOLE_PO_GRU), dev, counters)

    header("[LSTM_RECALL: RNN_RECALL with rnn_cell 'lstm', one epoch]")
    cfg = PPOConfig(**dict(RNN_RECALL, rnn_cell="lstm"))
    lstm_tr, _ = rnn_fit("LSTM_RECALL", cfg, dev, counters)
    check_rnn_f64("LSTM_RECALL", cfg, lstm_tr, dev)

    header("[PO_STACK: pendulum_po_stack (4 frames), hidden (64, 64), the same "
           "schedule, 'pallas', one epoch]")
    cfg = PPOConfig(**PO_STACK)
    tr = Trainer(cfg)
    check_on_card(tr)
    ts0 = tr.state
    fits, T = cfg.fits_per_epoch, cfg.rollout_len
    m, counts, wall = counted_run(counters, tr.train_epoch)
    print(f"  one epoch ({fits} fits) {wall:.3f} s, value loss "
          f"{float(m.value_loss):.3f}", flush=True)
    expect_counts("PO_STACK epoch", counts, {
        "mlp_forward": fits * (T + 2), "gae_norm": fits,
        "value_phase": fits, "policy_phase": fits})
    ev, ev_counts, _ = counted_run(counters, tr.evaluate)
    print(f"  evaluate(): R {ev.R:.3f}, episodes {int(ev.episodes)}",
          flush=True)
    expect_counts("PO_STACK evaluate()", ev_counts,
                  {"mlp_forward": cfg.eval_len})
    pp, vp = ts0.policy_params, ts0.v_params
    pw, vw = mlp.dims(pp["mlp"]), mlp.dims(vp)
    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(4), dev, tr.env)
    traj = ppo.rollout_env_loop(cfg, tr.env, pp, draws.seq)
    err, fwd, _ = check_mlp(pp["mlp"], traj.obs[0].contiguous(),
                            cfg.activation, dev)
    path = f"PO_STACK env-loop rollout, {cfg.n_envs} envs"
    record("mlp_forward", path, [cfg.n_envs] + pw, counts["mlp_forward"],
           err, fwd, mlp_bounds(pw, cfg.n_envs)[0])
    traj = ppo._force_truncate_last(traj)
    adv, tgt = ppo.compute_advantages(cfg, tr.env, traj, None, vp)
    vcols, pcols = phase_rows(cfg, traj, adv, tgt, dev)
    header(f"[K3 value phase, K4 policy phase on PO_STACK's rows, widths {vw} "
           f"and {pw}, mb {cfg.minibatch_size}]")
    k3 = check_value_phase(cfg, ts0, vcols)
    k4 = check_phase(
        "policy phase", cu.policy_phase_kernel, cu.policy_phase_plain,
        (pp["mlp"], pp["log_std"], ts0.opt_policy, ts0.opt_log_std), pcols,
        cfg, cfg.lr_policy, [(cfg.clip_eps, cfg.ent_coeff),
                             (cfg.clip_eps, 0.01)], WHOLE_RATIO["K4"])
    mb = cfg.minibatch_size
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    n_p = cfg.n_epochs_policy * cfg.num_minibatches
    path = f"PO_STACK, {cfg.n_envs} envs x {T} steps, mb {mb}"
    record("value_phase", path, [n_v, mb] + vw, counts["value_phase"], *k3,
           phase_bound(vw, n_v, mb, 1))
    record("policy_phase", path, [n_p, mb] + pw, counts["policy_phase"], *k4,
           phase_bound(pw, n_p, mb, 3))

    header("[TRANSPLANT: transplant_value_trunk on the trained RNN_RECALL "
           "trainer and on an attention recall trainer after one fit]")
    check_transplant("RNN_RECALL", gru_tr)
    atr = Trainer(PPOConfig(**dict(RECALL, fits_per_epoch=1)))
    atr.train_epoch()
    check_transplant("attention RECALL", atr)
    if not math.isfinite(float(atr.train_epoch().value_loss)):
        raise AssertionError("the attention trainer after its transplant")

    header("[AUX_XL: recall_xl with aux_value_coeff 0.5, one fit, K7 launches "
           "by phase]")
    xl = dict(RECALL_XL, aux_value_coeff=0.5, fits_per_epoch=1)
    aux_tr, by_phase, _, _, _ = recall_xl_path(dev, counters, config=xl)
    if not all(by_phase["policy phase"][k] for k in K7_NAMES):
        raise AssertionError(f"AUX_XL: K7 in the policy phase "
                             f"{by_phase['policy phase']}")
    check_aux_hidden(aux_tr, dev)

    header(f"[SERVE_RNN: the GRU and the LSTM served on the card, "
           f"{SERVE_STEPS} steps against the CPU's cell]")
    serve_rnn("RNN_RECALL", gru_tr, dev, work)
    serve_rnn("LSTM_RECALL", lstm_tr, dev, work)
    shutil.rmtree(work, ignore_errors=True)
    print(f"  slice 19 phases: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --- slice 20: the host actor, the sweeps, profiling and NaN tooling ---------

# HOST_SOLVE's stop: the bench's solve target within 40 epochs
HOST_SOLVE_EPOCHS = 40
# HOST_SIDECAR: served actions on the card against HostPolicy's numpy
# forward on the normalised observations, relative to the larger of 1 and
# the largest |action| (K5's 3xTF32 products against numpy's float32 dot)
SIDECAR_REL = 1e-6
# the overlap's timing: fits timed for the wall, fits profiled for device
# time
OVERLAP_FITS = 8
OVERLAP_PROFILED = 4
# the profiler's names for K3's and K4's replicated cluster instances
# (demangled, with or without the enum's cast, or mangled)
PHASE_KERNEL = re.compile(r"cluster_phase_kernel(?:<(?:\(Kind\))?|IL4Kind)"
                          r"(\d|VALUE|POLICY)")


def host_trainer(cfg, actor="device", overlap=False, venv=None,
                 eval_venv=None):
    """HostTrainer(cfg) on the C++ engine's env of cfg's name, on CUDA
    device 0 by default (the train venv seed 0, the eval venv seed 1)."""
    from ppoc_tpu_torch.envs import host

    venv = venv or host.NativeHostVecEnv(cfg.env, cfg.n_envs)
    eval_venv = eval_venv or host.NativeHostVecEnv(cfg.env, cfg.eval_envs,
                                                   seed=1)
    tr = host.HostTrainer(cfg, venv, eval_venv, actor=actor, overlap=overlap)
    check_on_card(tr)
    return tr


def host_fit_rows(cfg, tr, dev):
    """The first host fit of ``tr`` (a fresh trainer), its kernels against
    their plain versions: the device actor's window, K5 on its first
    step's observations (the actor's forward), the two value-plane
    forwards, K2 on those planes, then K3 and K4 on the fit's rows
    (check_phases' holds).  Returns {kernel: (err, timings)} and the
    widths."""
    import types

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    ts = tr.state
    traj = tr._collect()
    pp = ts.policy_params
    k5 = check_mlp(pp["mlp"], traj.obs[0].contiguous(), cfg.activation, dev)
    v, vn = ppo.value_planes(cfg, ts.v_params, traj)
    raw = types.SimpleNamespace(**traj._asdict(), value=v, next_value=vn)
    adv, tgt, k2_err, k2_t = check_gae(cfg, raw, dev)
    vcols, pcols = phase_rows(cfg, raw, adv, tgt, dev, draw_seed=5)
    k3 = check_value_phase(cfg, ts, vcols)
    k4 = check_phase(
        "policy phase", cu.policy_phase_kernel, cu.policy_phase_plain,
        (pp["mlp"], pp["log_std"], ts.opt_policy, ts.opt_log_std), pcols,
        cfg, cfg.lr_policy, [(cfg.clip_eps, cfg.ent_coeff),
                             (cfg.clip_eps, 0.01)], WHOLE_RATIO["K4"])
    return ({"mlp_forward": k5[:2], "gae_norm": (k2_err, k2_t),
             "value_phase": k3, "policy_phase": k4},
            mlp.dims(pp["mlp"]), mlp.dims(ts.v_params))


def stale_windows(tr, fits: int):
    """``fits`` overlapped fits, each window the host actor collects while
    an update runs held to the weights before that update: its stored
    log-probs are HostPolicy(those weights).log_prob of its actions, bit
    for bit (the primed first window too).  Returns the windows held."""
    import numpy as np

    def held(policy, traj, what):
        obs = traj.obs.numpy().reshape(-1, traj.obs.shape[-1])
        act = traj.action.numpy().reshape(-1, traj.action.shape[-1])
        if not np.array_equal(policy.log_prob(obs, act),
                              traj.log_prob.numpy().reshape(-1)):
            raise AssertionError(f"HOST_OVERLAP: {what}'s log-probs are not "
                                 f"those of the weights that collected it")

    pre = tr.host_policy()
    tr._pending = tr._collect(device="cpu")
    held(pre, tr._pending, "the primed window")
    for i in range(fits):
        pre = tr.host_policy()
        tr._train_fit_overlapped()
        held(pre, tr._pending, f"window {i + 1}")
    return fits + 1


def fit_wall(tr, fit, dev):
    """(wall s a fit, device ms a fit, idle share) of ``fit`` on ``tr``,
    after one warm fit: OVERLAP_FITS fits timed between syncs, then
    OVERLAP_PROFILED under the profiler for the device's kernel time."""
    import torch

    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OVERLAP_FITS):
        fit()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / OVERLAP_FITS
    dev_ms = device_ms(fit, OVERLAP_PROFILED, warm=False)
    return wall, dev_ms, 1.0 - dev_ms / 1e3 / wall


def trace_names(trace_dir) -> set:
    """Every event name in the Chrome traces under ``trace_dir``."""
    from pathlib import Path

    names = set()
    for f in Path(trace_dir).glob("*.json"):
        names |= {e.get("name", "") for e in
                  json.loads(f.read_text()).get("traceEvents", [])}
    return names


def slice20_phases(dev, counters, record):
    """The paths slice 20 opens, each on the card with every launch counter
    read around it: the host actor (HOST_SOLVE, HOST_OVERLAP,
    HOST_CARTPOLE, HOST_SIDECAR) on the C++ engine, the sweeps (SWEEP) and
    the tooling (PROFILE / NAN).  Gymnasium is not used."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from ppoc_tpu_torch import serve, sweep
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.envs import host, wrappers
    from ppoc_tpu_torch.utils import debug, profiling

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "slice20_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = bench_config(0)
    fits, T = cfg.fits_per_epoch, cfg.rollout_len

    header(f"[HOST_SOLVE: HostTrainer(bench_config) on the C++ engine's "
           f"pendulum, the device actor, train(stop_at_R={SOLVE_R}, "
           f"n_epochs={HOST_SOLVE_EPOCHS})]")
    tr = host_trainer(cfg)
    assert tr.backend == "pallas", tr.backend
    hist, counts, wall = counted_run(counters, lambda: tr.train(
        n_epochs=HOST_SOLVE_EPOCHS, log=False, stop_at_R=SOLVE_R))
    n = len(hist)
    print(f"  epochs {n} (the bench solve: 7), final R {hist[-1]['R']:.3f}, "
          f"R {[round(h['R'], 3) for h in hist]}, wall {wall:.3f} s, "
          f"{sum(h['time_s'] for h in hist) / (n * fits):.4f} s a fit",
          flush=True)
    if not (math.isfinite(hist[-1]["R"]) and hist[-1]["R"] >= SOLVE_R):
        raise AssertionError(f"HOST_SOLVE: not solved in "
                             f"{HOST_SOLVE_EPOCHS} epochs: {hist}")
    expect_counts("HOST_SOLVE", counts, {
        "mlp_forward": n * (fits * (T + 2) + cfg.eval_len),
        "gae_norm": n * fits, "value_phase": n * fits,
        "policy_phase": n * fits})
    header("[HOST_SOLVE's first fit: K5, K2, K3, K4 against their plain "
           "versions]")
    rows, pw, vw = host_fit_rows(cfg, host_trainer(cfg), dev)
    mb = cfg.minibatch_size
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    n_p = cfg.n_epochs_policy * cfg.num_minibatches
    path = f"HOST_SOLVE, the device actor, {cfg.n_envs} envs x {T} steps"
    record("mlp_forward", path + " (the actors' and the value planes' "
           "forwards, evaluation included)", [cfg.n_envs] + pw,
           counts["mlp_forward"],
           *rows["mlp_forward"], mlp_bounds(pw, cfg.n_envs)[0])
    record("gae_norm", path, [T, cfg.n_envs], counts["gae_norm"],
           *rows["gae_norm"], gae_bound(T, cfg.n_envs))
    record("value_phase", path, [n_v, mb] + vw, counts["value_phase"],
           *rows["value_phase"], phase_bound(vw, n_v, mb, 1))
    record("policy_phase", path, [n_p, mb] + pw, counts["policy_phase"],
           *rows["policy_phase"], phase_bound(pw, n_p, mb, 3))

    header("[HOST_OVERLAP: the host actor overlapped with the learner, 2 "
           "epochs]")
    tr = host_trainer(cfg, actor="host", overlap=True)
    held, counts, wall = counted_run(counters,
                                     lambda: stale_windows(tr, 2 * fits))
    print(f"  {held} windows' log-probs those of the weights before the "
          f"update each overlapped, bit for bit ({wall:.3f} s)", flush=True)
    expect_counts("HOST_OVERLAP, 2 epochs", counts, {
        "mlp_forward": 2 * fits * 2, "gae_norm": 2 * fits,
        "value_phase": 2 * fits, "policy_phase": 2 * fits})
    ev, counts, _ = counted_run(counters, tr.evaluate)
    print(f"  evaluate(): R {ev.R:.3f} (the host actor's numpy policy)",
          flush=True)
    expect_counts("HOST_OVERLAP evaluate()", counts, {})
    serial = host_trainer(cfg, actor="host")
    over = host_trainer(cfg, actor="host", overlap=True)
    s_wall, s_dev, s_idle = fit_wall(serial, serial.train_fit, dev)
    o_wall, o_dev, o_idle = fit_wall(over, over._train_fit_overlapped, dev)
    print(f"  a fit, seed 0, the host actor: serial {s_wall * 1e3:.2f} ms "
          f"wall, {s_dev:.2f} ms device, idle {s_idle:.1%}; overlapped "
          f"{o_wall * 1e3:.2f} ms wall, {o_dev:.2f} ms device, idle "
          f"{o_idle:.1%} ({s_wall / o_wall:.2f}x)", flush=True)

    header("[HOST_CARTPOLE: one fit on the C++ engine's cartpole, eval_len "
           "500]")
    ccfg = cfg.replace(env="cartpole", eval_len=500)
    tr = host_trainer(ccfg)
    m, counts, wall = counted_run(counters, tr.train_fit)
    print(f"  one fit {wall:.3f} s, value loss {float(m.value_loss):.3f}, "
          f"entropy {float(m.entropy):.4f}", flush=True)
    expect_counts("HOST_CARTPOLE fit", counts, {
        "mlp_forward": T + 2, "gae_norm": 1, "value_phase": 1,
        "policy_phase_categorical": 1})

    header("[HOST_SIDECAR: RunningObsNorm and RunningRewardNorm, one epoch, "
           "save, serve on the card, load]")

    def normed():
        venv = wrappers.RunningRewardNorm(wrappers.RunningObsNorm(
            host.NativeHostVecEnv("pendulum", cfg.n_envs)), gamma=0.99)
        eval_venv = wrappers.RunningObsNorm(
            host.NativeHostVecEnv("pendulum", cfg.eval_envs, seed=1),
            stats=venv.stats, update=False)
        return host_trainer(cfg, actor="host", venv=venv,
                            eval_venv=eval_venv)

    tr = normed()
    m, counts, wall = counted_run(counters, tr.train_epoch)
    expect_counts("HOST_SIDECAR epoch", counts, {
        "mlp_forward": 2 * fits, "gae_norm": fits, "value_phase": fits,
        "policy_phase": fits})
    ck = str(work / "sidecar.bin")
    tr.save(ck)
    raw = host.NativeHostVecEnv("pendulum", SERVE_ROWS, seed=7).reset()
    act, counts, _ = counted_run(counters,
                                 lambda: serve.load_policy(ck)(raw))
    expect_counts("HOST_SIDECAR act", counts, {"mlp_forward": 1})
    z = tr.venv.stats.normalize(raw, clip=10.0)
    want, _ = tr.host_policy().sample(z, np.random.default_rng(0),
                                      deterministic=True)
    if act.device != dev:
        raise AssertionError(f"HOST_SIDECAR: the served actions are on "
                             f"{act.device}, not the card")
    check(f"HOST_SIDECAR: {SERVE_ROWS} served actions against HostPolicy on "
          f"the normalised observations", float(np.abs(
              act.cpu().numpy() - want).max()) / max(1.0, float(np.abs(
                  want).max())), SIDECAR_REL, what="max |diff| / max(1, "
                                                   "|action|)")
    fresh = normed()
    fresh.load(ck)
    for mine, theirs, what in ((fresh.venv.stats, tr.venv.stats, "obs"),
                               (fresh.venv.ret_stats, tr.venv.ret_stats,
                                "return")):
        if not (mine.count == theirs.count
                and np.array_equal(mine.mean, theirs.mean)
                and np.array_equal(mine.m2, theirs.m2)):
            raise AssertionError(f"HOST_SIDECAR: the {what} statistics did "
                                 f"not load exactly")
    print(f"  one epoch {wall:.3f} s; the obs statistics over "
          f"{int(tr.venv.stats.count)} rows and the return statistics over "
          f"{int(tr.venv.ret_stats.count)} restored exactly", flush=True)

    header("[SWEEP: solve_many(bench_config(0), [0, 1, 2], -200, 40), lane 0 "
           "against Trainer(bench_config(0)).solve]")
    lanes = []
    for seed in (0, 1, 2):
        out, counts, wall = counted_run(counters, lambda: sweep.solve_many(
            cfg, [seed], SOLVE_R, 40))
        e = out["epochs"][0]
        expect_counts(f"SWEEP lane {seed}", counts, {
            "rollout[pendulum]/values": e * fits,
            "rollout[pendulum]/metrics": e, "gae_norm": e * fits,
            "value_phase": e * fits, "policy_phase": e * fits})
        print(f"  lane {seed}: epochs {e}, R {out['R'][0]:.3f}, wall "
              f"{wall:.3f} s", flush=True)
        lanes.append((e, out["R"][0]))
    out, counts, wall = counted_run(counters, lambda: sweep.solve_many(
        cfg, [0, 1, 2], SOLVE_R, 40))
    tr = Trainer(cfg)
    res = tr.solve(SOLVE_R, 40)
    print(f"  three lanes {wall:.3f} s: epochs {out['epochs']}, R "
          f"{[round(r, 3) for r in out['R']]}; Trainer.solve epochs "
          f"{res['epochs']}, R {res['R']:.3f}", flush=True)
    if list(zip(out["epochs"], out["R"])) != lanes:
        raise AssertionError(f"SWEEP: the three-lane run {out['epochs']} "
                             f"{out['R']} is not its lanes' {lanes}")
    if (out["epochs"][0], out["R"][0]) != (res["epochs"], res["R"]):
        raise AssertionError(f"SWEEP: lane 0 {out['epochs'][0]} "
                             f"{out['R'][0]} is not Trainer.solve's {res}")
    from ppoc_tpu_torch.ops import adam
    for a, b in zip(adam.tree_leaves(tuple(out["states"])),
                    adam.tree_leaves(tuple(tr.state))):
        if not torch.equal(torch.as_tensor(a)[0].to(dev),
                           torch.as_tensor(b).to(dev)):
            raise AssertionError("SWEEP: lane 0's state is not "
                                 "Trainer.solve's bit for bit")
    if not all(r >= SOLVE_R for r in out["R"]):
        raise AssertionError(f"SWEEP: a lane did not solve: {out}")

    header("[PROFILE / NAN: profiling.trace of a bench epoch; nan_guard over "
           "a bench fit and an update on one NaN observation]")
    tr = Trainer(cfg)
    trace_dir = work / "trace"
    with profiling.trace(str(trace_dir)):
        tr.train_epoch()
        profiling.sync(tr.state)
    found = {m.group(1) for name in trace_names(trace_dir)
             for m in [PHASE_KERNEL.search(name)] if m}
    print(f"  trace: K3/K4 cluster instances named {sorted(found)}",
          flush=True)
    if not ({"0", "VALUE"} & found and {"1", "POLICY"} & found):
        raise AssertionError(f"PROFILE: the trace names no K3 or no K4 "
                             f"kernel: {sorted(found)}")
    env, ts = tr.env, tr.state
    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(6), dev, env)
    t0 = time.perf_counter()
    with debug.nan_guard():
        _, m = ppo.fit_step(cfg, env, ts, draws)
    print(f"  nan_guard over a bench fit: clean, value loss "
          f"{float(m.value_loss):.3f} ({time.perf_counter() - t0:.3f} s)",
          flush=True)
    traj, _, _ = ppo.rollout(cfg, env, ts.policy_params, draws.seed,
                             cfg.n_envs, T, v_params=ts.v_params)
    obs = traj.obs.clone()
    obs[17, 5, 1] = float("nan")
    try:
        with debug.nan_guard():
            ppo.update_step(cfg, env, ts, traj._replace(obs=obs), draws,
                            None)
    except FloatingPointError as e:
        print(f"  the NaN control raised: {e}", flush=True)
    else:
        raise AssertionError("NAN: an update on a NaN observation passed "
                             "the guard")
    err, _ = debug.checked(lambda: ppo.fit_step(cfg, env, ts, draws))()
    if err.get() is not None:
        raise AssertionError(f"NAN: checked(fit_step) found {err.get()}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"  slice 20 phases: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# slice 21: the relief valves and the single-device examples
VALVE_EPOCHS = 2              # VALVES (a): bench epochs a side
VALVE_CHUNK = 256             # VALVES (b): rollout_chunk on the 1024 file
CURRICULUM_RUNGS = (512, 1024, 2048)
CURRICULUM_R = 0.9            # the script's own bar on the last rung
# the rungs' stochastic R on the CPU (the port's plain versions, generator
# seed 0, 64 episodes): a card evaluation draws other samples
CURRICULUM_CPU_R = {1024: 0.969, 2048: 0.953}


def load_example(name: str):
    """examples_torch/<name>.py as a module of its own."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv, cwd, counters):
    """``mod.main(argv)`` in ``cwd`` with its standard output captured and
    echoed indented: (exit code, the output, launches, wall in s)."""
    import io

    buf = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        rc, counts, wall = counted_run(counters, lambda: mod.main(argv))
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    | {line}", flush=True)
    return rc, out, counts, wall


def nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def slice21_phases(dev, counters, record):
    """The paths slice 21 opens, on the card with every launch counter read
    around each: VALVES (the relief valves as the no-ops they are in an
    eager port: a valved bench run and a valved run of the committed 1024
    rung bit for bit as without them, with equal launches; the 8192 and
    16384 rungs built on the card with their own valves), CURRICULUM
    (examples_torch/recall_xl_curriculum.py resuming the committed 512,
    1024 and 2048 rungs by evaluation) and TRAIN_PENDULUM
    (examples_torch/train_pendulum.py at full size, its file reloaded).
    ``record`` is unused: no kernel here is new, each is checked and timed
    against its plain version where its path first runs."""
    import filecmp
    import shutil
    from pathlib import Path

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer, check_kernel_fit
    from ppoc_tpu_torch.models import attn
    from ppoc_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    work = root / "build" / "slice21_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    cfg = bench_config(0)
    header(f"[VALVES (a): bench_config and bench_config with "
           f"fits_per_program=2, {VALVE_EPOCHS} epochs each from seed 0]")
    runs = {}
    for label, kw in (("fused", {}),
                      ("fits_per_program=2", dict(fits_per_program=2))):
        tr = Trainer(cfg.replace(**kw))
        check_on_card(tr)
        metrics, counts, wall = counted_run(counters, lambda: [
            tuple(float(x) for x in tr.train_epoch())
            for _ in range(VALVE_EPOCHS)])
        runs[label] = (tr, metrics, counts)
        print(f"  {label}: wall {wall:.3f} s, metrics {metrics}, launches "
              f"{nonzero(counts)}", flush=True)
    (a, m_a, n_a), (b, m_b, n_b) = runs.values()
    same_leaves("VALVES (a)", a.state, b.state)
    if m_a != m_b or n_a != n_b:
        raise AssertionError(f"VALVES (a): metrics or launches differ: "
                             f"{m_a} {m_b} {n_a} {n_b}")
    fits = VALVE_EPOCHS * cfg.fits_per_epoch
    expect_counts("VALVES (a), each side", n_b, {
        "rollout[pendulum]/values": fits, "gae_norm": fits,
        "value_phase": fits, "policy_phase": fits})

    rung = root / "recall_curriculum_1024_s0.bin"
    header(f"[VALVES (b): Trainer.from_checkpoint({rung.name}) and the same "
           f"with fit_dispatch='phased', rollout_chunk={VALVE_CHUNK}; one "
           f"epoch each, cut to one fit]")
    runs = {}
    for label, kw in (("fused", {}),
                      ("phased", dict(fit_dispatch="phased",
                                      rollout_chunk=VALVE_CHUNK))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a JAX file: no draw stream
            tr = Trainer.from_checkpoint(str(rung), fits_per_epoch=1, **kw)
        check_on_card(tr)
        metrics, counts, wall = counted_run(
            counters, lambda: tuple(float(x) for x in tr.train_epoch()))
        runs[label] = (tr, metrics, counts)
        print(f"  {label}: wall {wall:.3f} s, metrics {metrics}, launches "
              f"{nonzero(counts)}", flush=True)
    (a, m_a, n_a), (b, m_b, n_b) = runs.values()
    same_leaves("VALVES (b)", a.state, b.state)
    if m_a != m_b or n_a != n_b:
        raise AssertionError(f"VALVES (b): metrics or launches differ: "
                             f"{m_a} {m_b} {n_a} {n_b}")
    if min(n_b[k] for k in K7_NAMES) < 1:
        raise AssertionError(f"VALVES (b): the fit launched no K7: {n_b}")
    expect_counts("VALVES (b), each side: K7 alone", n_b,
                  {k: n_b[k] for k in K7_NAMES})

    header("[VALVES (c): the 8192 and 16384 rungs with their own valves, "
           "built on the card; no fit]")
    for T in (8192, 16384):
        path = root / f"recall_curriculum_{T}_s0.bin"
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tr = Trainer.from_checkpoint(str(path))
        check_on_card(tr)
        check_kernel_fit(tr.cfg, tr.env, _build.smem_optin(dev))
        c = tr.cfg
        window = attn.window(tr.state.policy_params["mlp"])
        if window != T + 1 or not on_card(tr.state):
            raise AssertionError(f"VALVES (c): {path.name}: table {window}")
        fit = [(k.kernel, k.variant)
               for k in ppo.kernel_fit(c, _build.smem_optin(dev), tr.env)]
        print(f"  {path.name}: fit_dispatch {c.fit_dispatch!r}, "
              f"rollout_chunk {c.rollout_chunk}, fits_per_program "
              f"{c.fits_per_program}; pos table {window} slots; on "
              f"{tr.device}; kernel_fit {fit} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)

    header(f"[CURRICULUM: examples_torch/recall_xl_curriculum.py 0 "
           f"{CURRICULUM_RUNGS[-1]}, resuming the committed rungs "
           f"{list(CURRICULUM_RUNGS)} by evaluation]")
    cur = work / "curriculum"
    cur.mkdir()
    for T in CURRICULUM_RUNGS:
        shutil.copy(root / f"recall_curriculum_{T}_s0.bin", cur)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc, out, counts, wall = run_example(
            load_example("recall_xl_curriculum"),
            ["recall_xl_curriculum.py", "0", str(CURRICULUM_RUNGS[-1])],
            cur, counters)
    rs = {int(t): float(r) for t, r in re.findall(
        r"T=(\d+) \(\w+\): resumed from \S+, evaluated R ([\d.]+)", out)}
    print(f"  exit {rc}, wall {wall:.3f} s; R by rung {rs} (the CPU's "
          f"{CURRICULUM_CPU_R}); launches {nonzero(counts)} (the decode "
          f"loop: PyTorch ops, no kernel)", flush=True)
    if rc != 0 or sorted(rs) != list(CURRICULUM_RUNGS[1:]) or min(
            rs.values()) < CURRICULUM_R:
        raise AssertionError(f"CURRICULUM: exit {rc}, R {rs}")
    expect_counts("CURRICULUM", counts, {})
    for T in CURRICULUM_RUNGS:
        name = f"recall_curriculum_{T}_s0.bin"
        if not filecmp.cmp(cur / name, root / name, shallow=False):
            raise AssertionError(f"CURRICULUM rewrote {name}")
    if len(list(cur.iterdir())) != len(CURRICULUM_RUNGS):
        raise AssertionError(f"CURRICULUM wrote {list(cur.iterdir())}")

    header("[TRAIN_PENDULUM: examples_torch/train_pendulum.py at full size, "
           "then its ppo_model.bin reloaded]")
    mod = load_example("train_pendulum")
    made = []

    class Recorded(mod.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    mod.Trainer = Recorded
    tp = work / "train_pendulum"
    tp.mkdir()
    rc, out, counts, wall = run_example(mod, ["train_pendulum.py"], tp,
                                        counters)
    m = re.search(r"solved=(\w+) after (\d+) epochs, R=(-?[\d.]+)", out)
    if rc != 0 or m is None or m.group(1) != "True":
        raise AssertionError(f"TRAIN_PENDULUM: exit {rc}, {out!r}")
    n = int(m.group(2))
    tr = made[0]
    check_on_card(tr)
    fits = n * tr.cfg.fits_per_epoch
    print(f"  exit {rc}, {n} epochs, wall {wall:.3f} s", flush=True)
    expect_counts("TRAIN_PENDULUM", counts, {
        "rollout[pendulum]/values": fits, "rollout[pendulum]/metrics": n,
        "gae_norm": fits, "value_phase": fits, "policy_phase": fits})
    back = Trainer.from_checkpoint(str(tp / "ppo_model.bin"))
    check_on_card(back)
    same_leaves("TRAIN_PENDULUM's file", tr.state, back.state)
    ev, ev_back = (t.evaluate(deterministic=True) for t in (tr, back))
    print(f"  deterministic evaluation: saving trainer {ev}, reloaded "
          f"{ev_back}", flush=True)
    if ev != ev_back or not ev.episodes:
        raise AssertionError(f"TRAIN_PENDULUM: the reloaded trainer's "
                             f"evaluation {ev_back} != {ev}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"  slice 21 phases: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def launch_counters():
    """Every kernel wrapper's launch counter (K1 by lane, mode and
    variant; the rest by kernel and variant)."""
    from ppoc_tpu_torch.ops import (cuda_attn, cuda_gae, cuda_mlp,
                                    cuda_rollout, cuda_update)

    return [*cuda_rollout.lane_launches.values(),
            *cuda_rollout.global_launches.values(), cuda_gae.launches,
            cuda_update.value_launches, cuda_update.policy_launches,
            cuda_update.categorical_launches,
            cuda_update.value_global_launches,
            cuda_update.policy_global_launches,
            cuda_update.categorical_global_launches, cuda_mlp.fwd_launches,
            cuda_mlp.bwd_launches, cuda_mlp.fwd_global_launches,
            cuda_mlp.bwd_global_launches, cuda_attn.fwd_launches,
            cuda_attn.dq_launches, cuda_attn.dkv_launches,
            cuda_attn.fwd_bf16_launches, cuda_attn.dq_bf16_launches,
            cuda_attn.dkv_bf16_launches, cuda_update.value_bf16_launches,
            cuda_update.policy_bf16_launches]


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ppoc_tpu_torch import PPOConfig, tpu_preset
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import (_build, cuda_attn, cuda_gae, cuda_mlp,
                                    cuda_rollout, cuda_update)

    header("[build]", flush=True)
    info = _build.build()
    print(f"  {info['path']}: {'built' if info['built'] else 'up to date'} "
          f"in {info['seconds']:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print("  nvcc:", line.strip(), flush=True)
    _build.load()
    counters = launch_counters()
    results = []

    def record(name, path, shape, launches, err, times, bound, library=None):
        # library_ms: the one PyTorch call that computes the same function
        # (K7: scaled_dot_product_attention with the mask), else None
        src, replaces = KERNELS[name]
        results.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library, "path": path,
            "shape": shape})
        tile = ""
        if "tile" in times:
            results[-1].update(tile=times["tile"], blocks=times["blocks"])
            tile = f", tile {times['tile']} ({times['blocks']} blocks)"
        lib = "" if library is None else f", library {library:.4f} ms"
        # K5's and K7 f32's products run on the tensor cores as 3xTF32
        tf32 = times.get("tf32x3_bound_ms")
        if name.startswith("mlp_"):
            ops = (2 if "forward" in name else 4) * shape[0] * products(
                shape[1:])
            tf32 = 1e3 * 3 * ops / PEAK_TF32
        if tf32 is not None:
            results[-1]["tf32x3_bound_ms"] = tf32
            lib += f"; 3xTF32 bound {tf32:.4f} ms"
        print(f"  {name} ({path}, {shape}{tile}): device time kernel "
              f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms"
              f"{lib}; bound {bound[0]:.4f} ms ({bound[1]}); launches "
              f"{launches}", flush=True)

    cfg = bench_config()
    tr = Trainer(cfg, dev)
    widths = mlp.dims(tr.state.v_params)
    header("[K1 rollout]", flush=True)
    (raw, k1_err, k1_t), (raw_m, k1m_err, k1m_t) = check_rollout(
        cfg, tr.state, tr.env, dev)
    k1_bound = rollout_bound(widths, widths, raw)
    k1m_bound = rollout_bound(widths, None, raw_m)
    header(f"[K1 by tile: {cfg.n_envs} envs x {cfg.rollout_len} steps]")
    rollout_grid_times(tr.state, dev, cfg.n_envs, cfg.rollout_len)
    header("[K2 gae]", flush=True)
    adv, tgt, k2_err, k2_t = check_gae(cfg, raw, dev)
    header("[K3 value phase, K4 policy phase]", flush=True)
    (k3_err, k3_t), (k4_err, k4_t) = check_phases(cfg, tr.state, raw, adv,
                                                  tgt, dev)
    rcfg = PPOConfig(env="pendulum")
    header(f"[K3, K4 on the reference schedule's rows: {rcfg.n_envs} envs x "
           f"{rcfg.rollout_len} steps, mb {rcfg.minibatch_size}]")
    rts = Trainer(rcfg, dev).state
    _, _, (rv, rp) = wide_rows(rcfg, rts, (0x6A09E667, 0xBB67AE85), 4, dev)
    rpol = rts.policy_params
    k3r = check_value_phase(rcfg, rts, rv)
    k4r = check_phase(
        "policy phase (mb 64)", cuda_update.policy_phase_kernel,
        cuda_update.policy_phase_plain,
        (rpol["mlp"], rpol["log_std"], rts.opt_policy, rts.opt_log_std), rp,
        rcfg, rcfg.lr_policy, [(rcfg.clip_eps, rcfg.ent_coeff),
                               (rcfg.clip_eps, 0.01)], WHOLE_RATIO["K4"])

    header("[bench path: Trainer(bench_config).solve(-200, max_epochs=40)]",
          flush=True)
    tr = Trainer(bench_config(), dev)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.solve(SOLVE_R, max_epochs=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.kernel: c.n for c in counters}
    steps = res["epochs"] * cfg.steps_per_epoch
    print(f"  epochs {res['epochs']}, final R {res['R']:.3f}, wall "
          f"{wall:.3f} s, {steps / wall:.0f} env-steps/s (training), "
          f"launches {launches}", flush=True)
    if not (math.isfinite(res["R"]) and res["R"] >= SOLVE_R):
        raise AssertionError(f"not solved in 40 epochs: R {res['R']}")
    if min(launches[k] for k in ("rollout[pendulum]/values",
                                 "rollout[pendulum]/metrics", "gae_norm",
                                 "value_phase", "policy_phase")) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    fits = res["epochs"] * cfg.fits_per_epoch
    print(f"  wall per epoch {wall / res['epochs']:.3f} s; K3 (cluster) "
          f"{launches['value_phase']}, K4 (cluster) "
          f"{launches['policy_phase']} launches for {fits} fits", flush=True)
    if (launches["value_phase"], launches["policy_phase"],
            launches["value_phase_global"],
            launches["policy_phase_global"]) != (fits, fits, 0, 0):
        raise AssertionError(f"the bench solve must launch one cluster K3 "
                             f"and one cluster K4 a fit: {launches}")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]),
            tr.state.policy_params["log_std"])):
        raise AssertionError("non-finite weights after the solve")
    T, E, mb = cfg.rollout_len, cfg.n_envs, cfg.minibatch_size
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    n_p = cfg.n_epochs_policy * cfg.num_minibatches
    bench = f"bench, {E} envs x {T} steps, mb {mb}"
    record("rollout[pendulum]", bench + " (training rollouts)", [T, E],
           launches["rollout[pendulum]/values"], k1_err, k1_t, k1_bound)
    record("rollout[pendulum]", bench + " (evaluation rollouts)",
           [cfg.eval_len, cfg.eval_envs],
           launches["rollout[pendulum]/metrics"], k1m_err, k1m_t, k1m_bound)
    record("gae_norm", bench, [T, E], launches["gae_norm"], k2_err, k2_t,
           gae_bound(T, E))
    record("value_phase", bench, [n_v, mb], launches["value_phase"], k3_err,
           k3_t, phase_bound(widths, n_v, mb, 1))
    record("policy_phase", bench, [n_p, mb], launches["policy_phase"],
           k4_err, k4_t, phase_bound(widths, n_p, mb, 3))

    header("[checkpoint, resume and serving: the solved bench trainer]",
           flush=True)
    checkpoint_phases(tr, dev, counters, record)

    header("[reference schedule: PPOConfig(env='pendulum'), 2 epochs]",
          flush=True)
    ref = Trainer(rcfg, dev)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    hist = ref.train(n_epochs=2, log=False)
    torch.cuda.synchronize()
    ref_n = read_counts(counters)
    print(f"  R {[round(h['R'], 3) for h in hist]}, wall "
          f"{time.perf_counter() - t0:.3f} s, launches "
          f"{count_diff({k: 0 for k in ref_n}, ref_n)}", flush=True)
    if not all(math.isfinite(h["R"]) for h in hist):
        raise AssertionError("non-finite eval return on the reference run")
    ref_fits = 2 * rcfg.fits_per_epoch
    if (ref_n["value_phase"], ref_n["policy_phase"]) != (ref_fits, ref_fits):
        raise AssertionError(f"the reference schedule must launch one "
                             f"cluster K3 and one K4 a fit: {ref_n}")
    n_v = rcfg.n_epochs_value * rcfg.num_minibatches
    n_p = rcfg.n_epochs_policy * rcfg.num_minibatches
    ref_path = (f"reference schedule, {rcfg.n_envs} envs x "
                f"{rcfg.rollout_len} steps, mb {rcfg.minibatch_size}")
    record("value_phase", ref_path, [n_v, rcfg.minibatch_size],
           ref_n["value_phase"], *k3r,
           phase_bound(widths, n_v, rcfg.minibatch_size, 1))
    record("policy_phase", ref_path, [n_p, rcfg.minibatch_size],
           ref_n["policy_phase"], *k4r,
           phase_bound(widths, n_p, rcfg.minibatch_size, 3))

    tcfg = tpu_preset("pendulum")
    T, E, mb = tcfg.rollout_len, tcfg.n_envs, tcfg.minibatch_size
    tr = Trainer(tcfg)
    header(f"[K1 at the throughput shape: {E} envs x {T} steps]", flush=True)
    (raw, t1_err, t1_t), (raw_m, t1m_err, t1m_t) = check_rollout(
        tcfg, tr.state, tr.env, dev)
    t1_bound = rollout_bound(widths, widths, raw)
    t1m_bound = rollout_bound(widths, None, raw_m)
    header(f"[K2 at {T} x {E}: past one block, a cluster]", flush=True)
    adv, tgt, t2_err, t2_t = check_gae(tcfg, raw, dev)
    header(f"[K5 mlp_forward at {mb} and {tcfg.eval_envs} rows, widths "
          f"{widths}]", flush=True)
    draws = ppo.draw_fit(tcfg, torch.Generator().manual_seed(3), dev)
    x_mb, = buffer.gather_mb((raw.obs.reshape(-1, 3),), draws.value_idx[0, 0],
                             tcfg.shuffle_block)
    k5_err, k5_fwd, k5_bwd = check_mlp(tr.state.v_params, x_mb,
                                       tcfg.activation, dev)
    for name, res in mlp_resources().items():
        print(f"  K5 {name} kernel (nvcc): {res}", flush=True)
    check_mlp_lean(f"K5 at {mb} rows, widths {widths}", tr.state.v_params,
                   x_mb, tcfg.activation, dev)
    x_ev = raw.obs[0, : tcfg.eval_envs].contiguous()
    k5e_err, k5e_fwd, _ = check_mlp(tr.state.policy_params["mlp"], x_ev,
                                    tcfg.activation, dev)

    header(f"[throughput path: Trainer(tpu_preset('pendulum')), "
          f"{THROUGHPUT_EPOCHS} epochs, then evaluate(deterministic=True)]",
          flush=True)
    tr, train_n, eval_n, act_err = throughput_path(tcfg, dev, counters)
    thr = f"throughput, {E} envs x {T} steps, mb {mb}"
    fwd_b, bwd_b = mlp_bounds(widths, mb)
    record("rollout[pendulum]", thr + " (training rollouts)", [T, E],
           train_n["rollout[pendulum]/values"], t1_err, t1_t, t1_bound)
    record("rollout[pendulum]", thr + " (evaluation rollouts)",
           [tcfg.eval_len, tcfg.eval_envs],
           train_n["rollout[pendulum]/metrics"], t1m_err, t1m_t, t1m_bound)
    record("gae_norm", thr, [T, E], train_n["gae_norm"], t2_err, t2_t,
           gae_bound(T, E))
    record("mlp_forward", thr, [mb] + widths, train_n["mlp_forward"], k5_err,
           k5_fwd, fwd_b)
    record("mlp_backward", thr, [mb] + widths, train_n["mlp_backward"],
           k5_err, k5_bwd, bwd_b)
    pwidths = mlp.dims(tr.state.policy_params["mlp"])
    record("mlp_forward", "mean-policy evaluation",
           [tcfg.eval_envs] + pwidths, eval_n["mlp_forward"],
           max(k5e_err, act_err), k5e_fwd,
           mlp_bounds(pwidths, tcfg.eval_envs)[0])

    discrete = {}
    for i, (lane, ent) in enumerate((("cartpole", 0.0), ("acrobot", 0.01))):
        dcfg = bench_config().replace(env=lane, eval_len=500)
        T, E, L = dcfg.rollout_len, dcfg.n_envs, dcfg.eval_len
        ds = Trainer(dcfg, dev).state
        pw, vw = mlp.dims(ds.policy_params["mlp"]), mlp.dims(ds.v_params)
        header(f"[K1 {lane} lane: {E} envs x {T} steps with the V planes]",
              flush=True)
        raw, r_err, r_t = check_discrete_rollout(
            lane, ds, E, T, True, (0x2545F491 + i, 0x9E3779B9), dev)
        header(f"[K1 {lane} lane: {E} envs x {L} steps with the metrics]",
              flush=True)
        raw_m, m_err, m_t = check_discrete_rollout(
            lane, ds, E, L, False, (0x632BE59B + i, 0x85EBCA6B), dev)
        header(f"[K2 on the {lane} rollout's planes: "
              f"{int(raw.terminated.sum())} terminations]", flush=True)
        adv, tgt, g_err, g_t = check_gae(dcfg, raw, dev)
        vcols, pcols = phase_rows(dcfg, raw, adv, tgt, dev, draw_seed=2 + i)
        header(f"[K3 value phase on the {lane} rows, widths {vw}]", flush=True)
        k3 = check_value_phase(dcfg, ds, vcols)
        header(f"[K6 categorical policy phase, widths {pw}, ent_coeff {ent}]",
              flush=True)
        k6 = check_phase(
            "categorical policy phase",
            cuda_update.policy_phase_categorical_kernel,
            cuda_update.policy_phase_categorical_plain,
            (ds.policy_params["mlp"], ds.opt_policy), pcols, dcfg,
            dcfg.lr_policy, [(dcfg.clip_eps, ent), (dcfg.clip_eps, 0.01)],
            WHOLE_RATIO["K6"], lean=True)
        discrete[lane] = dict(
            cfg=dcfg, pw=pw, vw=vw,
            rollout=(r_err, r_t, rollout_bound(pw, vw, raw)),
            metrics=(m_err, m_t, rollout_bound(pw, None, raw_m)),
            gae=(g_err, g_t), k3=k3, k6=k6,
            terminated=bool(raw.terminated.any()))
    if not discrete["cartpole"]["terminated"]:
        raise AssertionError("the cartpole rollout fed K2 no termination")

    for lane in discrete:
        header(f"[discrete path: Trainer(bench_config, env {lane!r}, eval_len "
              f"500).solve({DISCRETE_SOLVE_R[lane]}, max_epochs=40)]",
              flush=True)
        d = discrete[lane]
        d["trainer"], res, _, n = discrete_path(lane, dev, counters)
        dcfg, pw, vw = d["cfg"], d["pw"], d["vw"]
        T, E, L = dcfg.rollout_len, dcfg.n_envs, dcfg.eval_len
        mb = dcfg.minibatch_size
        n_v = dcfg.n_epochs_value * dcfg.num_minibatches
        n_p = dcfg.n_epochs_policy * dcfg.num_minibatches
        path = f"{lane} solve, {E} envs x {T} steps, mb {mb}"
        record(f"rollout[{lane}]", path + " (training rollouts)", [T, E],
               n[f"rollout[{lane}]/values"], *d["rollout"])
        record(f"rollout[{lane}]", path + " (evaluation rollouts)", [L, E],
               n[f"rollout[{lane}]/metrics"], *d["metrics"])
        record("gae_norm", path, [T, E], n["gae_norm"], *d["gae"],
               gae_bound(T, E))
        record("value_phase", path, [n_v, mb] + vw, n["value_phase"],
               *d["k3"], phase_bound(vw, n_v, mb, 1))
        record("policy_phase_categorical", path, [n_p, mb] + pw,
               n["policy_phase_categorical"], *d["k6"],
               phase_bound(pw, n_p, mb, 3))

    header("[cartpole: evaluate(deterministic=True) on the trained policy]",
          flush=True)
    ctr = discrete["cartpole"]["trainer"]
    ccfg = ctr.cfg
    cp = ctr.state.policy_params["mlp"]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = ctr.evaluate(deterministic=True)
    torch.cuda.synchronize()
    ev_n = {c.kernel: c.n for c in counters}
    print(f"  R {ev.R:.3f}, J {ev.J:.3f}, episodes {int(ev.episodes)}, "
          f"{time.perf_counter() - t0:.3f} s; launches {ev_n}", flush=True)
    if not (math.isfinite(ev.R) and ev.episodes >= 1):
        raise AssertionError(f"cartpole mean-policy evaluation failed: {ev}")
    if (ev_n["mlp_forward"] != ccfg.eval_len
            or ev_n["rollout[cartpole]/values"]
            or ev_n["rollout[cartpole]/metrics"]):
        raise AssertionError(f"the mean-policy evaluation must be "
                             f"{ccfg.eval_len} K5 forwards: {ev_n}")
    traj = ppo.rollout_env_loop(ccfg, ctr.env, ctr.state.policy_params,
                                ppo.draw_eval(ccfg, ctr.env,
                                              torch.Generator().manual_seed(9),
                                              dev, deterministic=True))
    argmax = mlp.apply(cp, traj.obs, ccfg.activation).argmax(-1)
    if not torch.equal(traj.action[..., 0].long(), argmax):
        raise AssertionError("mean-policy actions differ from the plain "
                             "argmax on the recorded obs")
    x_ev = traj.obs[0].contiguous()
    c_err, c_fwd, _ = check_mlp(cp, x_ev, ccfg.activation, dev)
    cpw = mlp.dims(cp)
    record("mlp_forward", "cartpole mean-policy evaluation",
           [ccfg.eval_envs] + cpw, ev_n["mlp_forward"], c_err, c_fwd,
           mlp_bounds(cpw, ccfg.eval_envs)[0])

    attention_phases(dev, counters, record)
    reacher_mcc_phases(dev, counters, record)
    wide_phases(dev, counters, record)
    bf16_phases(dev, counters, record)
    bigmb_phases(dev, counters, record)
    cluster_phases(dev, record)
    slice18_phases(dev, counters, record, (k1_err, k1_t, k1_bound),
                   (k2_err, k2_t))
    slice19_phases(dev, counters, record)
    slice20_phases(dev, counters, record)
    slice21_phases(dev, counters, record)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"build included", flush=True)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

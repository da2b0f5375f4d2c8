"""K3 and K4 with the weights in shared memory run as one thread-block
cluster (csrc/update_cluster.cu).  Without a card this holds what the
launch takes from Python: the cluster block's shared memory
(cuda_update.cluster_bytes, the same as the C side's size function, which
tests/test_torch_cuda.py holds on the card), the variant ppo.kernel_fit
gives every trainer path at the H100's 232,448 B, and the plain versions
the card checks hold the cluster kernels to, at the bench's width and the
reference schedule's minibatch, against the JAX package's Pallas kernels
in interpret mode (tolerances as tests/test_torch_update.py).
"""
import math

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.ops import cuda_update
from ppoc_tpu_torch.utils import params as conv

from test_torch_update import W_TOL, _close_adam, _close_tree, _setup, _stream

torch.set_num_threads(1)

H100_OPTIN = 232448


def _bench(**kw):
    """bench.py's bench_config (64 envs x 200 steps, minibatch 256, 4 fits
    an epoch, the fused kernels), with ``kw`` replaced."""
    base = dict(env="pendulum", n_envs=64, rollout_len=200,
                minibatch_size=256, fits_per_epoch=4, eval_envs=64,
                eval_len=200, kernel_backend="pallas")
    base.update(kw)
    return PPOConfig(**base)


TRAINER_PATHS = {
    "bench": (_bench(), "K4", (3, 128, 128, 1), (3, 128, 128, 1)),
    "reference schedule": (PPOConfig(env="pendulum"), "K4",
                           (3, 128, 128, 1), (3, 128, 128, 1)),
    "cartpole bench": (_bench(env="cartpole", eval_len=500), "K6",
                       (4, 128, 128, 1), (4, 128, 128, 2)),
    "acrobot bench": (_bench(env="acrobot", eval_len=500), "K6",
                      (6, 128, 128, 1), (6, 128, 128, 3)),
    "reacher hidden 64": (_bench(env="reacher", hidden=(64, 64)), "K4",
                          (10, 64, 64, 1), (10, 64, 64, 2)),
}


@pytest.mark.parametrize("path", sorted(TRAINER_PATHS))
def test_kernel_fit_keeps_the_trainer_paths_in_shared_memory(path):
    """Every net that ran its fused phases with the weights in shared
    memory before the cluster kernels still does: K3 and K4 as the
    cluster (its block's bytes), K6 as one block (its padded weights)."""
    cfg, policy_kernel, vw, pw = TRAINER_PATHS[path]
    fits = {k.kernel[:2]: k for k in ppo.kernel_fit(cfg, H100_OPTIN)}
    k3, kp = fits["K3"], fits[policy_kernel]
    assert (k3.widths, kp.widths) == ((vw,), (pw,))
    assert k3.variant == kp.variant == "smem"
    assert k3.nbytes[0] == cuda_update.cluster_bytes(vw) + 1024
    kind = "policy" if policy_kernel == "K4" else "categorical policy"
    assert kp.nbytes == tuple(cuda_update.variant_bytes(pw, kind))
    if policy_kernel == "K4":
        assert kp.nbytes[0] == cuda_update.cluster_bytes(pw) + 1024


@pytest.mark.parametrize("env,policy_kernel", [("pendulum", "K4"),
                                               ("reacher", "K4"),
                                               ("cartpole", "K6")])
def test_kernel_fit_keeps_2x256_in_global_memory(env, policy_kernel):
    """At 2x256 the cluster block needs ~680 KB (twice the weights, and
    they alone pass 227 KB): K3 and K4 take the second variant (the
    sharded cluster), as K6 takes its global-memory one."""
    cfg = PPOConfig(env=env, hidden=(256, 256))
    fits = {k.kernel[:2]: k for k in ppo.kernel_fit(cfg, H100_OPTIN)}
    assert fits["K3"].variant == fits[policy_kernel].variant == "global"
    assert fits["K3"].nbytes[0] > 2 * H100_OPTIN


def test_cluster_bytes_follow_the_layout():
    """[3,128,128,1] in a cluster of 16: the weights and their gradient
    partial, 18,196 padded floats each (W0 4 x 132 + b0 128, W1 128 x 132
    + b1 128, W2 128 x 4 + b2 4); the 32-row activation tile (128 + 128 +
    4 columns, + 8); two sub-tiles of x (4 columns) and of the extras
    (12); the row stats (32 x 12), the block's stats (12) and log_std's
    state (32); m and v of a sixteenth of the padded float4s (285 of
    4,549)."""
    w = (3, 128, 128, 1)
    floats = (2 * 18196 + 32 * 260 + 8 + 2 * 32 * 4 + 2 * 32 * 12 + 32 * 12
              + 12 + 32 + 8 * 285)
    assert cuda_update.cluster_bytes(w) == 4 * floats == 193808
    assert cuda_update.CLUSTER == 16 and math.ceil(4549 / 16) == 285
    # the head's width is padded to 4 columns: K4's nets at one and two
    # action dims take the same bytes
    assert cuda_update.cluster_bytes((10, 64, 64, 1)) == (
        cuda_update.cluster_bytes((10, 64, 64, 2)))


def test_variant_bytes_take_the_kind():
    """K3 and K4 size their shared-memory variant by the replicated
    cluster's block and the other by the sharded cluster's, K6 by its one
    block's padded weights and its staged slice."""
    w = (4, 128, 128, 2)
    value, policy = (cuda_update.variant_bytes(w, k) for k in ("value",
                                                                "policy"))
    cat = cuda_update.variant_bytes(w, "categorical policy")
    assert value == policy == [cuda_update.cluster_bytes(w) + 1024,
                               cuda_update.shard_bytes(w) + 1024]
    assert cat == [4 * (4 * 129 + 128 + 128 * 129 + 128 + 128 * 3 + 2)
                   + 1024, 4 * 32 * 129 + 1024]


def _jcfg(**kw):
    base = dict(env="pendulum", n_envs=8, rollout_len=16, minibatch_size=64,
                n_epochs_value=1, n_epochs_policy=1, hidden=(128, 128))
    base.update(kw)
    return JPPOConfig(**base)


def test_value_phase_at_the_cluster_shape_matches_jax():
    """The plain K3 the card holds the cluster kernel to, at the bench's
    width and the reference schedule's minibatch (64), two phases."""
    cfg = _jcfg()
    jts, jbuf, buf = _setup(cfg)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    fused = jax.jit(lambda vp, ov, key: jpu.value_phase_fused(
        cfg, vp, ov, jbuf, key))
    for k in (jax.random.PRNGKey(11), jax.random.PRNGKey(12)):
        idx = _stream(cfg, k, cfg.n_epochs_value)
        v2, o2, jloss = fused(jts.v_params, jts.opt_v, k)
        jts = jts._replace(v_params=v2, opt_v=o2)
        ts, loss = ppo.value_phase(cfg, ts, buf, idx)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        _close_tree(ts.v_params, jts.v_params, W_TOL)
        _close_adam(ts.opt_v, jts.opt_v)


@pytest.mark.parametrize("ent_coeff", [0.0, 0.01])
def test_policy_phase_at_the_cluster_shape_matches_jax(ent_coeff):
    """The plain K4 likewise, with and without the entropy bonus."""
    cfg = _jcfg(ent_coeff=ent_coeff)
    jts, jbuf, buf = _setup(cfg, seed=2)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    fused = jax.jit(lambda pp, a, b, key: jpu.policy_phase_fused(
        cfg, pp, a, b, jbuf, key))
    for k in (jax.random.PRNGKey(13), jax.random.PRNGKey(14)):
        idx = _stream(cfg, k, cfg.n_epochs_policy)
        pol, op, ols, jloss, jent = fused(
            jts.policy_params, jts.opt_policy, jts.opt_log_std, k)
        jts = jts._replace(policy_params=pol, opt_policy=op, opt_log_std=ols)
        ts, loss, ent = ppo.policy_phase(cfg, ts, buf, idx)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4, abs=1e-6)
        assert float(ent) == pytest.approx(float(jent), rel=1e-5)
        _close_tree(ts.policy_params["mlp"], jts.policy_params["mlp"], W_TOL)
        np.testing.assert_allclose(
            ts.policy_params["log_std"].numpy(),
            np.asarray(jts.policy_params["log_std"]), **W_TOL)
        _close_adam(ts.opt_policy, jts.opt_policy)
        _close_adam(ts.opt_log_std, jts.opt_log_std)

"""K3 and K4 with the weights in shared memory run as one thread-block
cluster (csrc/update_cluster.cu).  Without a card this holds what the
launch takes from Python: the cluster block's shared memory
(cuda_update.cluster_bytes, the same as the C side's size function, which
tests/test_torch_cuda.py holds on the card), the variant ppo.kernel_fit
gives every trainer path at the H100's 232,448 B, and the plain versions
the card checks hold the cluster kernels to, at the bench's width and the
reference schedule's minibatch, and K6's at the discrete solves' and
CARTPOLE_WIDE's shapes, against the JAX package's Pallas kernels in
interpret mode (tolerances as tests/test_torch_update.py and
tests/test_torch_categorical_update.py).
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

import test_torch_categorical_update as tcat
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
    memory before the cluster kernels still does: K3, K4 and K6 as the
    replicated cluster (its block's bytes)."""
    cfg, policy_kernel, vw, pw = TRAINER_PATHS[path]
    fits = {k.kernel[:2]: k for k in ppo.kernel_fit(cfg, H100_OPTIN)}
    k3, kp = fits["K3"], fits[policy_kernel]
    assert (k3.widths, kp.widths) == ((vw,), (pw,))
    assert k3.variant == kp.variant == "smem"
    assert k3.nbytes[0] == cuda_update.cluster_bytes(vw) + 1024
    assert kp.nbytes == tuple(cuda_update.variant_bytes(pw))
    assert kp.nbytes[0] == cuda_update.cluster_bytes(pw) + 1024


@pytest.mark.parametrize("env,policy_kernel", [("pendulum", "K4"),
                                               ("reacher", "K4"),
                                               ("cartpole", "K6")])
def test_kernel_fit_keeps_2x256_in_global_memory(env, policy_kernel):
    """At 2x256 the cluster block needs ~680 KB (twice the weights, and
    they alone pass 227 KB): K3, K4 and K6 take the second variant (the
    sharded cluster)."""
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
    """K3, K4 and K6 size their shared-memory variant by the replicated
    cluster's block and the other by the sharded cluster's: the three
    kinds share both maps, so kernel_fit gives a value net, a Gaussian and
    a categorical policy of one width the same bytes.  The plans refuse a
    kind no kernel has before they reach the card."""
    w = (4, 128, 128, 2)
    both = [cuda_update.cluster_bytes(w) + 1024,
            cuda_update.shard_bytes(w) + 1024]
    assert cuda_update.variant_bytes(w) == both
    got = {}
    for env, hidden in (("cartpole", (128, 128)), ("pendulum", (128, 128))):
        for k in ppo.kernel_fit(PPOConfig(env=env, hidden=hidden),
                                H100_OPTIN):
            if k.kernel[:2] in ("K3", "K4", "K6"):
                got[k.kernel[:2]] = (k.widths[0], k.nbytes)
    assert set(got) == {"K3", "K4", "K6"}
    for widths, nbytes in got.values():
        assert nbytes == tuple(cuda_update.variant_bytes(widths))
    assert got["K6"][1] == tuple(both)
    for plan in (cuda_update.phase_cluster_plan,
                 cuda_update.phase_shard_plan):
        with pytest.raises(ValueError, match="no 'gaussian' phase"):
            plan("gaussian", w, 64)


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


@pytest.mark.parametrize("ent_coeff", [0.0, 0.01])
@pytest.mark.parametrize("hidden,n_envs,mb,n_epochs", [
    ((128, 128), 16, 256, 2), ((256, 256), 8, 64, 1)])
def test_categorical_phase_at_the_cluster_shapes_matches_jax(
        hidden, n_envs, mb, n_epochs, ent_coeff):
    """The plain K6 the card holds both cluster bodies to: cartpole's
    [4,128,128,2] at the discrete solves' minibatch (256, the replicated
    cluster) and CARTPOLE_WIDE's [4,256,256,2] at minibatch 64 (the
    sharded cluster), two phases of two steps, with and without the
    entropy bonus."""
    cfg = tcat._cfg("cartpole", hidden=hidden, n_envs=n_envs,
                    minibatch_size=mb, n_epochs_policy=n_epochs,
                    ent_coeff=ent_coeff)
    jts, jbuf, buf = tcat._setup(cfg, seed=3)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    fused = jax.jit(lambda pp, op, key: jpu.policy_phase_fused_categorical(
        cfg, pp, op, jbuf, key))
    for k in (jax.random.PRNGKey(15), jax.random.PRNGKey(16)):
        idx = tcat._stream(cfg, k)
        assert idx.shape[0] * idx.shape[1] == 2
        pol, op, jloss, jent = fused(jts.policy_params, jts.opt_policy, k)
        jts = jts._replace(policy_params=pol, opt_policy=op)
        ts, loss, ent = ppo.policy_phase(cfg, ts, buf, idx, discrete=True)
        assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
        assert float(ent) == pytest.approx(float(jent), rel=1e-4)
        tcat._close_tree(ts.policy_params["mlp"], jts.policy_params["mlp"],
                         tcat.W_TOL)
        assert ts.opt_policy.t == int(jts.opt_policy.t)
        tcat._close_tree(ts.opt_policy.m, jts.opt_policy.m, tcat.W_TOL)
        tcat._close_tree(ts.opt_policy.v, jts.opt_policy.v, tcat.V_TOL)

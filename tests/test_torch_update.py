"""Port parity: the fused update phases' plain versions (ops/cuda_update.py)
against the JAX Pallas kernels in interpret mode (value_phase_fused,
policy_phase_fused), on the same buffer and the same row-id stream, over
one and two epochs per phase.  Tolerances follow tests/test_pallas_update.py: weights rtol
1e-4 / atol 1e-6 and Adam's second moment rtol 1e-3 / atol 1e-7 -- the
float32 products sum in another order, and Adam divides by sqrt(v), which
turns last-bit gradient differences into relative weight noise.
"""
import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.data import buffer as jbuffer
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-4, atol=1e-6)
V_TOL = dict(rtol=1e-3, atol=1e-7)
JENV = jenvs.make("pendulum")


def _cfg(**kw):
    base = dict(env="pendulum", n_envs=8, rollout_len=16, minibatch_size=32,
                n_epochs_value=1, n_epochs_policy=1, hidden=(16, 16))
    base.update(kw)
    return PPOConfig(**base)


def _setup(cfg, seed=0):
    key = jax.random.PRNGKey(seed)
    ts = jppo.init_train_state(cfg, JENV, key)
    traj, _ = jppo.rollout(cfg, JENV, ts.policy_params, key, cfg.n_envs,
                           cfg.rollout_len, "jnp")
    adv, tgt = jppo.compute_advantages(cfg, JENV, ts.v_params, traj, None,
                                       "jnp")
    jbuf = jbuffer.from_rollout(traj, adv, tgt)
    buf = buffer.RowBuffer(*(torch.tensor(np.asarray(x)) for x in jbuf[:5]))
    return ts, jbuf, buf


def _stream(cfg, key, n_epochs):
    flat, _ = jpu._stream_ids(cfg, key, cfg.steps_per_fit,
                              cfg.num_minibatches, cfg.minibatch_size,
                              n_epochs)
    return torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
        n_epochs, cfg.num_minibatches, cfg.minibatch_size)


def _close_tree(got, want, tol):
    got, want = jax.tree.leaves(conv.tree_to_numpy(got)), jax.tree.leaves(
        jax.device_get(want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _close_adam(got, want):
    assert got.t == int(want.t)
    _close_tree(got.m, want.m, W_TOL)
    _close_tree(got.v, want.v, V_TOL)


@pytest.mark.parametrize("n_epochs", [1, 2])
def test_value_phase_matches_jax(n_epochs):
    """Two consecutive phases, so the second starts from Adam t > 0."""
    cfg = _cfg(n_epochs_value=n_epochs)
    jts, jbuf, buf = _setup(cfg)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    fused = jax.jit(lambda vp, ov, key: jpu.value_phase_fused(
        cfg, vp, ov, jbuf, key))
    for k in (jax.random.PRNGKey(7), jax.random.PRNGKey(8)):
        idx = _stream(cfg, k, cfg.n_epochs_value)
        v2, o2, jloss = fused(jts.v_params, jts.opt_v, k)
        jts = jts._replace(v_params=v2, opt_v=o2)
        ts, loss = ppo.value_phase(cfg, ts, buf, idx)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        _close_tree(ts.v_params, jts.v_params, W_TOL)
        _close_adam(ts.opt_v, jts.opt_v)


@pytest.mark.parametrize("n_epochs", [1, 2])
@pytest.mark.parametrize("ent_coeff", [0.0, 0.01])
def test_policy_phase_matches_jax(n_epochs, ent_coeff):
    cfg = _cfg(ent_coeff=ent_coeff, n_epochs_policy=n_epochs)
    jts, jbuf, buf = _setup(cfg, seed=1)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    fused = jax.jit(lambda pp, a, b, key: jpu.policy_phase_fused(
        cfg, pp, a, b, jbuf, key))
    for k in (jax.random.PRNGKey(3), jax.random.PRNGKey(4)):
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


def test_gather_keeps_stream_order():
    """Pre-gathered rows follow the stream: step s holds rows
    idx[e, j] for s = e * n_mb + j."""
    rows = torch.arange(12, dtype=torch.float32)[:, None]
    idx = torch.tensor([[[3, 1], [0, 2]], [[5, 4], [7, 6]]])
    (got,) = buffer.gather_mb((rows,), idx)
    torch.testing.assert_close(got[:, 0], torch.tensor(
        [3., 1., 0., 2., 5., 4., 7., 6.]))


def test_permutation_minibatches_drops_the_tail():
    g = torch.Generator().manual_seed(0)
    idx = buffer.permutation_minibatches(g, 100, 3, 32)
    assert idx.shape == (3, 32)
    assert len(set(idx.reshape(-1).tolist())) == 96

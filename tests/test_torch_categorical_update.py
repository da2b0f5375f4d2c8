"""Port parity for K6: the categorical policy phase's plain version
(ops/cuda_update.py ``policy_phase_categorical_plain``, through
``ppo.policy_phase(..., discrete=True)``) against the JAX Pallas kernel
``policy_phase_fused_categorical`` in interpret mode, on the same buffer
(a JAX rollout of the env) and the same row-id stream, over two
consecutive phases so the second starts from Adam t > 0.

Tolerances as tests/test_pallas_update.py: loss abs 1e-5, entropy rel
1e-4, weights rtol 1e-4 / atol 1e-6 and Adam's second moment rtol 1e-3 /
atol 1e-7 -- float32 products sum in another order, and Adam divides by
sqrt(v), which turns last-bit gradient differences into relative weight
noise.
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
from ppoc_tpu_torch.ops import cuda_update
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-4, atol=1e-6)
V_TOL = dict(rtol=1e-3, atol=1e-7)


def _cfg(env, **kw):
    base = dict(env=env, n_envs=8, rollout_len=16, minibatch_size=32,
                n_epochs_value=1, n_epochs_policy=1, hidden=(16, 16))
    base.update(kw)
    return PPOConfig(**base)


def _setup(cfg, seed):
    jenv = jenvs.make(cfg.env)
    key = jax.random.PRNGKey(seed)
    ts = jppo.init_train_state(cfg, jenv, key)
    traj, _ = jppo.rollout(cfg, jenv, ts.policy_params, key, cfg.n_envs,
                           cfg.rollout_len, "jnp")
    adv, tgt = jppo.compute_advantages(cfg, jenv, ts.v_params, traj, None,
                                       "jnp")
    jbuf = jbuffer.from_rollout(traj, adv, tgt)
    buf = buffer.RowBuffer(*(torch.tensor(np.asarray(x)) for x in jbuf[:5]))
    assert buf.action.dtype == torch.int32
    return ts, jbuf, buf


def _stream(cfg, key):
    flat, _ = jpu._stream_ids(cfg, key, cfg.steps_per_fit,
                              cfg.num_minibatches, cfg.minibatch_size,
                              cfg.n_epochs_policy)
    return torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
        cfg.n_epochs_policy, cfg.num_minibatches, cfg.minibatch_size)


def _close_tree(got, want, tol):
    got = jax.tree.leaves(conv.tree_to_numpy(got))
    want = jax.tree.leaves(jax.device_get(want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("env,ent_coeff,n_epochs", [("cartpole", 0.0, 1),
                                                    ("acrobot", 0.01, 2)])
def test_categorical_policy_phase_matches_jax(env, ent_coeff, n_epochs):
    cfg = _cfg(env, ent_coeff=ent_coeff, n_epochs_policy=n_epochs)
    jts, jbuf, buf = _setup(cfg, seed=1)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    fused = jax.jit(lambda pp, op, key: jpu.policy_phase_fused_categorical(
        cfg, pp, op, jbuf, key))
    for k in (jax.random.PRNGKey(3), jax.random.PRNGKey(4)):
        idx = _stream(cfg, k)
        pol, op, jloss, jent = fused(jts.policy_params, jts.opt_policy, k)
        jts = jts._replace(policy_params=pol, opt_policy=op)
        ts, loss, ent = ppo.policy_phase(cfg, ts, buf, idx, discrete=True)
        assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
        assert float(ent) == pytest.approx(float(jent), rel=1e-4)
        assert set(ts.policy_params) == {"mlp"}
        _close_tree(ts.policy_params["mlp"], jts.policy_params["mlp"], W_TOL)
        assert ts.opt_policy.t == int(jts.opt_policy.t)
        _close_tree(ts.opt_policy.m, jts.opt_policy.m, W_TOL)
        _close_tree(ts.opt_policy.v, jts.opt_policy.v, V_TOL)
        assert ts.opt_log_std.t == 0


def test_categorical_phase_in_float64_tracks_float32():
    """The plain version runs in float64 too (the card's step-by-step
    check uses it so); the class ids stay int32 and the two precisions
    agree to float32 rounding over 4 steps."""
    cfg = _cfg("acrobot", ent_coeff=0.01)
    jts, _, buf = _setup(cfg, seed=2)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    idx = _stream(cfg, jax.random.PRNGKey(5))
    o, a, lp, ad = buffer.gather_mb(
        (buf.obs, buf.action, buf.log_prob, buf.advantage), idx)
    h = cuda_update.Hyper.of(cfg.lr_policy, cfg.adam_beta1, cfg.adam_beta2,
                             cfg.adam_eps)
    args = (cfg.num_minibatches, cfg.minibatch_size, "relu", h, 0.2, 0.01)
    p32, o32, l32, e32 = cuda_update.policy_phase_categorical(
        o, a, lp, ad, ts.policy_params["mlp"], ts.opt_policy, *args)

    def dbl(tree):
        return [tuple(t.double() for t in pair) for pair in tree]

    opt64 = ts.opt_policy._replace(m=dbl(ts.opt_policy.m),
                                   v=dbl(ts.opt_policy.v))
    p64, o64, l64, e64 = cuda_update.policy_phase_categorical_plain(
        o.double(), a, lp.double(), ad.double(),
        dbl(ts.policy_params["mlp"]), opt64, *args)
    assert p64[0][0].dtype == torch.float64 and o64.t == o32.t == 4
    for x, y in zip(p32, p64):
        for s, d in zip(x, y):
            torch.testing.assert_close(s.double(), d, rtol=1e-4, atol=1e-6)
    assert float(l32) == pytest.approx(float(l64), abs=1e-6)
    assert float(e32) == pytest.approx(float(e64), rel=1e-6)

"""Port parity for the Gymnasium host bridge (``ppoc_tpu_torch/envs/
gym_bridge.py``), held to the JAX package's; mirrors
tests/test_gym_bridge.py.

The port's GymVecEnv against the JAX one on Pendulum-v1 and CartPole-v1:
the spec, and the whole stream (resets, steps, the SAME_STEP autoreset's
true successors) on the same seeds and actions, bit for bit.  The window
semantics (force-truncation, true successors, stored log-probs against
the JAX ``policy.log_prob`` within 1e-6 and 1e-6 of their magnitude),
the refusal of asymmetric
action bounds with the JAX message, the missing-package error, the async
mode and GymTrainer end to end with each actor and with the normalisers.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

import jax  # noqa: E402

from ppoc_tpu.envs import gym_bridge as jgym  # noqa: E402
from ppoc_tpu.models import policy as jpolicy  # noqa: E402
from ppoc_tpu_torch import PPOConfig  # noqa: E402
from ppoc_tpu_torch.envs import gym_bridge, host  # noqa: E402
from ppoc_tpu_torch.models import mlp, policy  # noqa: E402
from ppoc_tpu_torch.utils import params as conv  # noqa: E402

torch.set_num_threads(1)

# a log-prob sums the trunk's products in each package's order (the port's
# torch or numpy matmul, XLA's dot): 1e-6, and 1e-6 of its magnitude
LOGP_TOL = dict(rtol=1e-6, atol=1e-6)


def _cfg(**kw):
    base = dict(env="pendulum", n_envs=4, rollout_len=64, minibatch_size=32,
                fits_per_epoch=1, n_epochs=1, eval_envs=4, eval_len=64,
                hidden=(32, 32), kernel_backend="pallas", seed=0)
    base.update(kw)
    return PPOConfig(**base)


def _params(obs_dim, n_act, discrete, seed=0):
    g = torch.Generator().manual_seed(seed)
    return policy.init(obs_dim, n_act, (32, 32), 1.0, discrete, g, "cpu")


@pytest.mark.parametrize("env_id", ["Pendulum-v1", "CartPole-v1"])
def test_spec_and_stream_match_the_jax_bridge(env_id):
    """Spec field for field, then 260 steps (past Pendulum's 200-step
    truncation; CartPole terminates under random actions) of both
    packages' bridges on one seed and one action stream: every output bit
    for bit."""
    a = gym_bridge.GymVecEnv(env_id, 3, seed=5)
    b = jgym.GymVecEnv(env_id, 3, seed=5)
    assert dataclasses.asdict(a.spec) == dataclasses.asdict(b.spec)
    np.testing.assert_array_equal(a.reset(), b.reset())
    rng = np.random.default_rng(0)
    dones = 0
    for _ in range(260):
        if a.spec.discrete:
            act = rng.integers(0, 2, (3, 1)).astype(np.int32)
        else:
            act = rng.uniform(-2, 2, (3, 1)).astype(np.float32)
        got, want = a.step(act), b.step(act)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        dones += int((got[3] | got[4]).sum())
    assert dones > 0
    a.close()
    b.close()


def test_reference_env_id_table():
    assert gym_bridge.ENV_IDS == jgym.ENV_IDS
    venv = gym_bridge.GymVecEnv(0, 1)      # id 0 = Pendulum-v1
    assert venv.spec.name == "gym:Pendulum-v1" and venv.spec.horizon == 200
    venv.close()


@pytest.mark.parametrize("env_id,discrete", [("Pendulum-v1", False),
                                             ("CartPole-v1", True)])
def test_collect_window_semantics(env_id, discrete):
    """The device actor through the bridge: the window force-truncated,
    next_obs the following obs wherever no episode ended, the stored
    log-probs the JAX package's policy.log_prob of the actions within
    LOGP_TOL; the host actor's alike."""
    cfg = _cfg(rollout_len=48)
    obs_dim = 4 if discrete else 3
    params = _params(obs_dim, 2 if discrete else 1, discrete)
    jlog_prob = jax.jit(lambda p, o, a: jpolicy.log_prob(
        p, o, a, "relu", "jnp", discrete))
    for actor in ("device", "host"):
        venv = gym_bridge.GymVecEnv(env_id, cfg.n_envs, seed=1)
        if actor == "device":
            traj, last = gym_bridge.collect_host(
                cfg, venv, params, torch.Generator().manual_seed(2),
                cfg.rollout_len)
        else:
            traj, last = host.collect_host_np(
                cfg, venv, host.HostPolicy(params, "relu", discrete),
                np.random.default_rng(2), cfg.rollout_len)
        venv.close()
        assert traj.obs.shape == (cfg.rollout_len, cfg.n_envs, obs_dim)
        assert last.shape == (cfg.n_envs, obs_dim)
        assert bool((traj.terminated[-1] | traj.truncated[-1]).all())
        done = (traj.terminated | traj.truncated).numpy()
        keep = ~done[:-1]
        np.testing.assert_array_equal(traj.next_obs.numpy()[:-1][keep],
                                      traj.obs.numpy()[1:][keep])
        want = jlog_prob(conv.tree_to_numpy(params), traj.obs.numpy(),
                         traj.action.numpy())
        np.testing.assert_allclose(traj.log_prob.numpy(), np.asarray(want),
                                   **LOGP_TOL)


def test_host_policy_matches_the_device_policy():
    """HostPolicy's mean is the port's policy forward, its log-probs the
    port's log_prob; categorical action frequencies track the softmax."""
    params = _params(3, 2, False, seed=5)
    hp = host.HostPolicy(params, "relu", False)
    obs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    o = torch.as_tensor(obs)
    np.testing.assert_allclose(
        hp.forward(obs), mlp.apply(params["mlp"], o, "relu").numpy(),
        rtol=1e-5, atol=1e-6)
    a, lp = hp.sample(obs, np.random.default_rng(1))
    np.testing.assert_allclose(
        lp, policy.log_prob(params, o, torch.as_tensor(a), "relu",
                            "jnp").numpy(), rtol=1e-5, atol=1e-6)
    cat = _params(4, 3, True, seed=6)
    hp = host.HostPolicy(cat, "relu", True)
    obs = np.random.default_rng(2).normal(size=(256, 4)).astype(np.float32)
    a, lp = hp.sample(obs, np.random.default_rng(3))
    assert a.shape == (256, 1) and a.dtype == np.int32
    logits = hp.forward(obs)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(np.bincount(a[:, 0], minlength=3) / 256,
                               p.mean(0), atol=0.12)


class _Lopsided(gymnasium.Env):
    """A Box action space whose dimensions have different bounds."""
    observation_space = gymnasium.spaces.Box(-1.0, 1.0, (2,), np.float32)
    action_space = gymnasium.spaces.Box(np.array([-1.0, -2.0], np.float32),
                                        np.array([1.0, 2.0], np.float32))

    def reset(self, seed=None, options=None):
        super().reset(seed=seed)
        return np.zeros(2, np.float32), {}

    def step(self, action):
        return np.zeros(2, np.float32), 0.0, False, False, {}


def test_asymmetric_action_bounds_are_refused_as_in_jax():
    gymnasium.register("PortLopsided-v0", entry_point=_Lopsided,
                       max_episode_steps=10)
    with pytest.raises(ValueError) as want:
        jgym.GymVecEnv("PortLopsided-v0", 1)
    with pytest.raises(ValueError) as got:
        gym_bridge.GymVecEnv("PortLopsided-v0", 1)
    assert str(got.value) == str(want.value)
    assert "per-dimension action bounds differ" in str(got.value)


def test_missing_gymnasium_names_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="'gymnasium' package"):
        gym_bridge.GymVecEnv("Pendulum-v1", 1)


def test_gym_vec_env_async_mode():
    """AsyncVectorEnv: a worker process an env, the same protocol and the
    sync mode's bits."""
    a = gym_bridge.GymVecEnv("Pendulum-v1", 2, seed=0, vector_mode="async")
    b = gym_bridge.GymVecEnv("Pendulum-v1", 2, seed=0)
    np.testing.assert_array_equal(a.reset(), b.reset())
    act = np.zeros((2, 1), np.float32)
    for x, y in zip(a.step(act), b.step(act)):
        np.testing.assert_array_equal(x, y)
    a.close()
    b.close()
    with pytest.raises(ValueError, match="vector_mode"):
        gym_bridge.GymVecEnv("Pendulum-v1", 1, vector_mode="threads")


@pytest.mark.parametrize("actor,norm", [("device", False), ("host", True)])
def test_gym_trainer_end_to_end(actor, norm):
    """GymTrainer: an evaluation and one epoch through the learner with
    either actor; with the normalisers the eval venv shares (never writes)
    the obs statistics, the return statistics ride on the train side, the
    config names the gym env."""
    cfg = _cfg(eval_len=200, eval_envs=2)
    tr = gym_bridge.GymTrainer(cfg, "Pendulum-v1", actor=actor,
                               obs_norm=norm, reward_norm=norm, device="cpu")
    assert tr.cfg.env == "gym:Pendulum-v1" and tr.backend == "pallas"
    assert tr.evaluate().episodes > 0
    w0 = tr.state.policy_params["mlp"][0][0].clone()
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["R"]) and np.isfinite(hist[0]["entropy"])
    assert (tr.state.policy_params["mlp"][0][0] - w0).abs().max() > 0
    if norm:
        assert tr.venv.stats is tr.eval_venv.stats
        assert tr.venv.venv.update and not tr.eval_venv.update
        assert tr.venv.stats.count >= cfg.n_envs * cfg.rollout_len
        assert tr.venv.ret_stats.count == cfg.n_envs * cfg.rollout_len


def test_gym_trainer_cartpole_is_categorical():
    cfg = _cfg(eval_len=500, eval_envs=2, n_envs=4, rollout_len=32)
    tr = gym_bridge.GymTrainer(cfg, "CartPole-v1", actor="host",
                               device="cpu")
    assert tr.env.spec.discrete and "log_std" not in tr.state.policy_params
    tr.train_fit()
    assert tr.state.opt_policy.t == cfg.n_epochs_policy * cfg.num_minibatches

"""The port's batched PyTorch envs in lockstep with the C++ oracle.

``ppoc_tpu.native.NativeVecEnv`` is an independent implementation of the
same physics (the role the reference's CPU twins play for its CUDA
paths).  As tests/test_native.py holds the JAX envs to it, this file holds
the port's envs (``ppoc_tpu_torch.envs``, stepped on the CPU): from the
same start states, on the same action draws, every env's obs and reward
within rtol/atol 1e-5 and its done flags exactly, step by step until the
first done (the step counters part there).
"""
import numpy as np
import pytest
import torch

from ppoc_tpu import native
from ppoc_tpu_torch import envs
from ppoc_tpu_torch.envs import (acrobot, cartpole, mountain_car, pendulum,
                                 reacher, recall, simple)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++)")

N = 8
T = 50
NAMES = ["pendulum", "cartpole", "mountain_car", "simple", "acrobot",
         "reacher", "recall", "recall_long", "recall_xl", "recall_xxl",
         "recall_4k", "recall_8k", "recall_16k"]


def _states(name, n):
    """Matched (port state, native state matrix), tests/test_native.py's
    draws."""
    rng = np.random.default_rng(0)
    t = torch.zeros(n, dtype=torch.int32)

    def ts(x):
        return torch.as_tensor(x)

    if name == "pendulum":
        th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        thd = rng.uniform(-1, 1, n).astype(np.float32)
        return pendulum.PendulumState(ts(th), ts(thd), t), np.stack([th, thd], 1)
    if name == "cartpole":
        v = rng.uniform(-0.05, 0.05, (n, 4)).astype(np.float32)
        return cartpole.CartPoleState(*[ts(v[:, i].copy()) for i in range(4)],
                                      t), v
    if name == "mountain_car":
        p = rng.uniform(-0.6, -0.4, n).astype(np.float32)
        vel = np.zeros(n, np.float32)
        return mountain_car.MountainCarState(ts(p), ts(vel), t), \
            np.stack([p, vel], 1)
    if name == "simple":
        s = np.zeros(n, np.float32)
        return simple.SimpleState(ts(s), t), s[:, None]
    if name == "acrobot":
        s = rng.uniform(-0.1, 0.1, (n, 4)).astype(np.float32)
        return acrobot.AcrobotState(ts(s), t), s
    if name.startswith("recall"):
        b = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0).astype(np.float32)
        return recall.RecallState(ts(b), t), \
            np.stack([b, np.ones(n, np.float32)], 1)
    if name == "reacher":
        q = rng.uniform(-np.pi, np.pi, (n, 2)).astype(np.float32)
        qd = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        tgt = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
        return reacher.ReacherState(ts(q), ts(qd), ts(tgt), t), \
            np.concatenate([q, qd, tgt], 1)
    raise KeyError(name)


@pytest.mark.parametrize("name", NAMES)
def test_port_env_matches_native_physics(name):
    env = envs.make(name)
    state, nstate = _states(name, N)
    nat = native.NativeVecEnv(name, N)
    nat.reset(seed=0)
    nat.set_state(nstate)
    rng = np.random.default_rng(1)
    walked = 0
    for t in range(T):
        if env.spec.discrete:
            a = rng.integers(0, env.spec.action_dim, (N, 1)).astype(np.int32)
        else:
            a = rng.uniform(-2, 2, (N, env.spec.action_dim)).astype(np.float32)
        state, obs, rew, term, trunc = env.step(state, torch.as_tensor(a))
        obs_n, rew_n, term_n, trunc_n = nat.step(a.astype(np.float32))
        np.testing.assert_allclose(obs.numpy(), obs_n, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} obs diverged at t={t}")
        np.testing.assert_allclose(rew.numpy(), rew_n, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(term.numpy(), term_n)
        np.testing.assert_array_equal(trunc.numpy(), trunc_n)
        walked += 1
        if bool(np.any(term_n | trunc_n)):
            break   # the done flags part the step counters
    assert walked >= 1

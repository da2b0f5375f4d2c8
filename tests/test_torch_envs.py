"""Port parity: the batched Pendulum env (ppoc_tpu_torch/envs) against the
JAX env on the same states and actions.

Tolerance rtol 1e-5 / atol 1e-6: the same float32 equations; sin/cos and
the float modulo may differ in the last bit between the two libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.envs import pendulum as jpend
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.envs import pendulum

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ENV = envs.make("pendulum")


def _states(n=64, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-4, 4, n).astype(np.float32)
    thd = rng.uniform(-8, 8, n).astype(np.float32)
    t = rng.integers(0, 200, n).astype(np.int32)
    act = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    return th, thd, t, act


@pytest.mark.parametrize("seed", [0, 1])
def test_pendulum_step_matches_jax(seed):
    th, thd, t, act = _states(seed=seed)
    js = jpend.PendulumState(jnp.asarray(th), jnp.asarray(thd), jnp.asarray(t))
    keys = jax.random.split(jax.random.PRNGKey(0), len(th))
    js2, jobs, jr, jterm, jtrunc = jax.vmap(jpend._step)(js, jnp.asarray(act),
                                                        keys)
    s = pendulum.PendulumState(torch.tensor(th), torch.tensor(thd),
                               torch.tensor(t))
    s2, obs, r, term, trunc = ENV.step(s, torch.tensor(act))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.theta.numpy(), np.asarray(js2.theta), **TOL)
    np.testing.assert_array_equal(s2.t.numpy(), np.asarray(js2.t))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))


def test_reset_ranges_and_obs():
    g = torch.Generator().manual_seed(0)
    s, obs = envs.vector_reset(ENV, g, 4096, "cpu")
    assert s.theta.min() >= -np.pi and s.theta.max() <= np.pi
    assert s.theta_dot.abs().max() <= 1.0 and (s.t == 0).all()
    torch.testing.assert_close(obs, pendulum.obs_of(s))
    assert obs.shape == (4096, 3)


def test_autoreset_step_resets_done_envs_only():
    """Envs at the horizon truncate and restart; next_obs stays the true
    successor, obs' is the fresh reset obs where done."""
    g = torch.Generator().manual_seed(1)
    s = pendulum.PendulumState(torch.zeros(4), torch.zeros(4),
                               torch.tensor([0, 198, 199, 5], dtype=torch.int32))
    s2, obs2, next_obs, _, term, trunc = envs.vector_autoreset_step(
        ENV, s, torch.zeros(4, 1), fresh=envs.vector_reset(ENV, g, 4, "cpu"))
    assert trunc.tolist() == [False, False, True, False] and not term.any()
    assert s2.t.tolist() == [1, 199, 0, 6]
    torch.testing.assert_close(obs2[[0, 1, 3]], next_obs[[0, 1, 3]])
    torch.testing.assert_close(obs2[2], pendulum.obs_of(s2)[2])
    torch.testing.assert_close(next_obs[2], torch.tensor([1.0, 0.0, 0.0]))


def test_make_unknown_env_and_unported_wrapper():
    with pytest.raises(KeyError, match="pendulum"):
        envs.make("nope")
    wrapped = envs.make_for(PPOConfig(env="pendulum", obs_loc=(0.0,) * 3,
                                      obs_scale=(2.0,) * 3))
    assert wrapped.spec.name == "pendulum#affine"
    assert envs.make_for(PPOConfig(env="pendulum")).spec.gamma == 0.99

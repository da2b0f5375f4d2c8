"""Port parity: the rollout kernel's plain version (ops/cuda_rollout.py)
against the JAX whole-rollout Pallas kernel in interpret mode.

Both draw from the same counter RNG, so given the JAX kernel's seed words
the port reproduces its random bits exactly and its trajectories up to
float rounding.  Tolerances: the RNG is integer arithmetic and must match
bit for bit; trajectories use rtol 1e-4 / atol 1e-5 because the MLP's
float32 sums run in another order in PyTorch than in XLA and the pendulum
carries those last-bit differences through 16 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import pendulum as jpend
from ppoc_tpu.ops import pallas_rollout as jpr
from ppoc_tpu_torch import envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.envs.pendulum import PendulumState
from ppoc_tpu_torch.models import policy
from ppoc_tpu_torch.ops import cuda_rollout
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

CFG = PPOConfig(env="pendulum", n_envs=8, rollout_len=16, hidden=(16, 16))
T, E = 16, 8
JENV = jenvs.make("pendulum")
ENV = envs.make("pendulum")
JTS = jax.device_get(jppo.init_train_state(CFG, JENV, jax.random.PRNGKey(0)))
TS = conv.train_state_from_numpy(JTS, "cpu")
TOL = dict(rtol=1e-4, atol=1e-5)


def jax_seed_words(key):
    """The seed words rollout_fused derives from its key."""
    kd = jax.random.fold_in(key, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)[:2]
    return int(w[0]), int(w[1])


def jax_carry(theta, theta_dot, t):
    st = jpend.PendulumState(jnp.asarray(theta, jnp.float32),
                             jnp.asarray(theta_dot, jnp.float32),
                             jnp.asarray(t, jnp.int32))
    return st, jax.vmap(jpend._obs)(st)


def port_carry(theta, theta_dot, t):
    st = PendulumState(torch.tensor(theta, dtype=torch.float32),
                       torch.tensor(theta_dot, dtype=torch.float32),
                       torch.tensor(t, dtype=torch.int32))
    return st, None


@pytest.mark.parametrize("s0,s1,t,draw", [
    (0, 0, 0, 0), (0xDEADBEEF, 0x12345678, 7, 1),
    (0xFFFFFFFF, 0xFFFFFFFF, cuda_rollout.T_INIT, 50),
    (123456789, 987654321, 199, 51),
])
def test_rng_bits_and_uniforms_match_jax(s0, s1, t, draw):
    n = 300
    lanes = jnp.arange(n, dtype=jnp.uint32)
    x = (jnp.uint32(s0) + jnp.uint32(t) * jnp.uint32(0x632BE59B)
         + jnp.uint32(draw) * jnp.uint32(0x9E3779B9)
         + (lanes ^ jnp.uint32(s1)) * jnp.uint32(0x2545F491))
    want_bits = np.asarray(jpr._fmix32(x)).astype(np.int64)
    want_u = np.asarray(jpr._uniform01((1, n), jnp.uint32(s0), jnp.uint32(s1),
                                       jnp.uint32(t), draw))[0]
    got_lanes = torch.arange(n, dtype=torch.int64)
    got_bits = cuda_rollout.rng_bits(s0, s1, t, draw, got_lanes).numpy()
    got_u = cuda_rollout.uniform01(s0, s1, t, draw, got_lanes).numpy()
    np.testing.assert_array_equal(got_bits, want_bits)
    np.testing.assert_array_equal(got_u, want_u)


def test_fmix32_matches_jax_on_random_words():
    z = np.random.default_rng(0).integers(0, 1 << 32, 4096, dtype=np.uint64)
    want = np.asarray(jpr._fmix32(jnp.asarray(z.astype(np.uint32))))
    got = cuda_rollout.fmix32(torch.as_tensor(z.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _compare_traj(got, want):
    for name in ("obs", "next_obs", "action", "log_prob", "reward"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("carry_t", [None, 0, 195])
def test_plain_rollout_matches_pallas_kernel(carry_t):
    """Fresh reset, a carried state, and a carry that crosses the 200-step
    horizon inside the window (truncation + auto-reset draws), with the
    in-kernel V(s) / V(s') planes."""
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(3)
    jcarry = pcarry = None
    if carry_t is not None:
        th = rng.uniform(-3, 3, E).astype(np.float32)
        thd = rng.uniform(-1, 1, E).astype(np.float32)
        t = np.full(E, carry_t, np.int32)
        jcarry, pcarry = jax_carry(th, thd, t), port_carry(th, thd, t)
    jtraj, (jst, jobs_after), (jv, jnv) = jpr.rollout_fused(
        "pendulum", JTS.policy_params, key, E, T, "relu", jcarry,
        gamma=0.99, v_params=JTS.v_params)
    traj, (st, obs_after), (v, nv) = cuda_rollout.rollout_fused(
        "pendulum", TS.policy_params, jax_seed_words(key), E, T, "relu",
        pcarry, gamma=0.99, v_params=TS.v_params)
    _compare_traj(traj, jtraj)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), **TOL)
    np.testing.assert_allclose(st.theta.numpy(), np.asarray(jst.theta), **TOL)
    np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
    np.testing.assert_allclose(obs_after.numpy(), np.asarray(jobs_after),
                               **TOL)
    if carry_t == 195:
        assert traj.truncated[4].all() and not traj.truncated[:4].any()


def test_plain_rollout_metrics_match_pallas_kernel():
    """return_metrics: completed-episode R / J sums and the episode count."""
    key = jax.random.PRNGKey(5)
    th = np.linspace(-3, 3, E).astype(np.float32)
    thd = np.zeros(E, np.float32)
    t = np.arange(190, 190 + E, dtype=np.int32) % 200
    _, _, jm = jpr.rollout_fused(
        "pendulum", JTS.policy_params, key, E, T, "relu",
        jax_carry(th, thd, t), gamma=0.99, return_metrics=True)
    _, _, m = cuda_rollout.rollout_fused(
        "pendulum", TS.policy_params, jax_seed_words(key), E, T, "relu",
        port_carry(th, thd, t), gamma=0.99, return_metrics=True)
    assert float(m[2]) == float(jm[2]) > 0
    np.testing.assert_allclose([float(m[0]), float(m[1])],
                               [float(jm[0]), float(jm[1])], rtol=1e-4)


def test_ppo_rollout_force_truncates_window_end():
    """ppo.rollout marks the last step truncated on top of the kernel's
    flags, as the JAX wrapper does outside its kernel."""
    key = jax.random.PRNGKey(2)
    jtraj, _ = jppo.rollout(CFG, JENV, JTS.policy_params, key, E, T, "pallas")
    k_seed = jax_seed_words(key)
    traj, _ = ppo.rollout(CFG, ENV, TS.policy_params, k_seed, E, T)
    assert traj.truncated[-1].all()
    _compare_traj(traj, jtraj)


def test_plain_rollout_sampling_is_standard_normal():
    """eps = (a - mu) / sigma over many draws is a standard normal, and the
    stream is deterministic per seed."""
    traj, _ = cuda_rollout.rollout_fused("pendulum", TS.policy_params,
                                         (17, 99), 64, 200)
    mu = policy.mode(TS.policy_params, traj.obs, "relu", "jnp")[0]
    eps = ((traj.action - mu) / torch.exp(TS.policy_params["log_std"])).ravel()
    assert abs(float(eps.mean())) < 0.02
    assert abs(float(eps.std()) - 1.0) < 0.02
    again, _ = cuda_rollout.rollout_fused("pendulum", TS.policy_params,
                                          (17, 99), 64, 200)
    torch.testing.assert_close(again.action, traj.action, rtol=0, atol=0)


def test_rollout_refuses_unported_lane():
    with pytest.raises(NotImplementedError, match="cartpole"):
        cuda_rollout.rollout_fused("cartpole", TS.policy_params, (0, 0), E, T)

"""K1's work layout, held on the CPU: the premise of taking V(s') from the
next step's V(s), and the tile rule.  (The split rule lives in the kernel
alone; the card tests query it.)

The kernel computes the value net's V(s') pass only at a step where an
env of its tile is done, and at the last step; elsewhere it writes the
next step's V(s) as V(s').  That is exact because a step that does not
end hands its next obs on as the next step's obs, bit for bit, and the
same net summing in the same order on the same obs gives the same bits.
The JAX package's whole-rollout Pallas kernel (interpret mode) computes
V(s') at every step: there next_obs[t] equals obs[t + 1] bit for bit
wherever step t is not done, and its V(s') equals its next V(s) to float
rounding only (up to 1.8e-7 apart here), as XLA compiles the loop's two
value forwards with different summation orders.  The port's plain
version, which also computes V(s') at every step, gives the same bits
for both (one PyTorch forward on the same shapes).  The card tests
(tests/test_torch_cuda.py) hold the kernel's two ways of getting V(s')
equal bit for bit, and an env's outputs equal at any env count and tile.
Tolerance: JAX's two forwards rtol 1e-5 / atol 1e-6, float32 sums of 16
products in two orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import cartpole as jcp, pendulum as jpend
from ppoc_tpu.ops import pallas_rollout as jpr
from ppoc_tpu_torch.envs import cartpole as cp, pendulum as pd
from ppoc_tpu_torch.ops import cuda_rollout as cr
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

T, E = 16, 8


def jax_seed_words(key):
    """The seed words rollout_fused derives from its key."""
    kd = jax.random.fold_in(key, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)[:2]
    return int(w[0]), int(w[1])


def _carry(env, rng):
    """(JAX carry, port carry) of E envs: pendulum 8 steps before its
    200-step horizon, so the window truncates and resets inside; cartpole
    from fresh-sized states with termination inside the window."""
    if env == "pendulum":
        th = rng.uniform(-3, 3, E).astype(np.float32)
        thd = rng.uniform(-1, 1, E).astype(np.float32)
        t = np.full(E, 192, np.int32)
        js = jpend.PendulumState(*map(jnp.asarray, (th, thd, t)))
        ps = pd.PendulumState(*map(torch.tensor, (th, thd, t)))
        return (js, jax.vmap(jpend._obs)(js)), (ps, None)
    mat = rng.uniform(-0.05, 0.05, (E, 4)).astype(np.float32)
    t = rng.integers(0, 100, E).astype(np.int32)
    js = jcp.CartPoleState(*(jnp.asarray(c) for c in mat.T), jnp.asarray(t))
    ps = cp.CartPoleState(*(torch.tensor(c) for c in mat.T), torch.tensor(t))
    return (js, jax.vmap(jcp._obs)(js)), (ps, None)


@pytest.mark.parametrize("env", ["pendulum", "cartpole"])
def test_next_value_is_the_next_steps_value_where_not_done(env):
    """Where step t did not end, next_obs[t] is obs[t + 1] bit for bit in
    the JAX kernel (interpret mode) and in the port's plain version; the
    port's V(s') there is its next V(s) bit for bit, JAX's to rounding.
    The window crosses the horizon (pendulum) or terminates episodes
    (cartpole)."""
    jcfg = JPPOConfig(env=env, n_envs=E, rollout_len=T, hidden=(16, 16))
    jts = jax.device_get(jppo.init_train_state(jcfg, jenvs.make(env),
                                               jax.random.PRNGKey(0)))
    ts = conv.train_state_from_numpy(jts, "cpu")
    key = jax.random.PRNGKey(3)
    jcarry, pcarry = _carry(env, np.random.default_rng(4))
    jtraj, _, (jv, jnv) = jpr.rollout_fused(
        env, jts.policy_params, key, E, T, "relu", jcarry, gamma=0.99,
        v_params=jts.v_params)
    traj, _, (v, nv) = cr.rollout_fused(
        env, ts.policy_params, jax_seed_words(key), E, T, "relu", pcarry,
        gamma=0.99, v_params=ts.v_params)
    jdone = np.asarray(jtraj.terminated) | np.asarray(jtraj.truncated)
    done = (traj.terminated | traj.truncated).numpy()
    np.testing.assert_array_equal(done, jdone)
    assert done[:-1].any() and not done[:-1].all()
    if env == "cartpole":
        assert traj.terminated.any()
    else:
        assert traj.truncated[7].all() and not traj.terminated.any()
    keep = ~done[:-1]
    for obs, next_obs in ((jtraj.obs, jtraj.next_obs),
                          (traj.obs, traj.next_obs)):
        np.testing.assert_array_equal(np.asarray(next_obs)[:-1][keep],
                                      np.asarray(obs)[1:][keep])
    np.testing.assert_allclose(np.asarray(jnv)[:-1][keep],
                               np.asarray(jv)[1:][keep], rtol=1e-5,
                               atol=1e-6)
    v, nv = v.numpy(), nv.numpy()
    np.testing.assert_array_equal(nv[:-1][keep], v[1:][keep])
    # where the step ended, V(s') is of the terminal obs, not of the reset
    assert (nv[:-1][~keep] != v[1:][~keep]).all()


@pytest.mark.parametrize("resident,want", [
    (132, {1: 1, 7: 1, 64: 1, 129: 1, 132: 1, 133: 2, 256: 2, 264: 2,
           265: 4, 512: 4, 1024: 8, 1056: 8, 4096: 8}),
    (264, {1: 1, 7: 1, 129: 1, 264: 1, 265: 2, 512: 2, 1024: 4, 2048: 8}),
    (1, {1: 1, 7: 8, 129: 8, 1024: 8}),
])
def test_tile_is_the_smallest_whose_grid_fits_one_wave(resident, want):
    """E -> envs a block for a card that holds ``resident`` blocks at once:
    the smallest of 1, 2, 4, 8 with ceil(E / tile) <= resident, else 8
    (more waves).  The H100 holds 132 blocks of the bench's launch (one a
    SM: its 137 KB of nets fill an SM's shared memory)."""
    for n_envs, tile in want.items():
        assert cr.tile_for(n_envs, resident) == tile, n_envs
        blocks = -(-n_envs // tile)
        assert blocks <= resident or tile == cr.TILES[-1]


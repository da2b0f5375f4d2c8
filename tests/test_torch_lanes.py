"""Port parity for K1's last four lanes and their envs: simple,
mountain_car, mountain_car_norm and reacher, each against the JAX package
(its envs, and its whole-rollout Pallas kernel in interpret mode) on the
same states, actions and seed words.

Tolerances.  Env steps rtol/atol 1e-6: the same float32 equations; sin,
cos, sqrt and the norm may differ in the last bit between the libraries;
flags and step counters exactly.  The lane rollouts, as
tests/test_torch_rollout.py holds the pendulum lane: the float planes rtol
1e-4 / atol 1e-5 because the policy MLP's float32 sums run in another
order in PyTorch than in XLA and the physics carries those last-bit
differences through 16 steps; done flags and step counters exactly.  The
metrics sums rtol 1e-4, the episode count exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import mountain_car as jmc, reacher as jrc, simple as jsp
from ppoc_tpu.ops import pallas_rollout as jpr
from ppoc_tpu_torch import envs
from ppoc_tpu_torch.envs import mountain_car as mc, reacher as rc
from ppoc_tpu_torch.envs import simple as sp
from ppoc_tpu_torch.ops import cuda_rollout
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

ENV_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
T, E = 16, 8
NEW = ("simple", "mountain_car", "mountain_car_norm", "reacher")
JENV = {n: jenvs.make(n) for n in NEW}
ENV = {n: envs.make(n) for n in NEW}


def jax_seed_words(key):
    """The seed words rollout_fused derives from its key."""
    kd = jax.random.fold_in(key, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)[:2]
    return int(w[0]), int(w[1])


def _states(name, n, rng, t_hi):
    """(JAX state, port state) of ``n`` valid states: the lane's state
    matrix drawn in numpy, step counters below ``t_hi``."""
    t = rng.integers(0, t_hi, n).astype(np.int32)
    if name == "simple":
        s = rng.uniform(-2.0, 4.9, n).astype(np.float32)
        return (jsp.SimpleState(jnp.asarray(s), jnp.asarray(t)),
                sp.SimpleState(torch.tensor(s), torch.tensor(t)))
    if name == "reacher":
        q = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
        qd = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
        tg = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
        return (jrc.ReacherState(*map(jnp.asarray, (q, qd, tg, t))),
                rc.ReacherState(*map(torch.tensor, (q, qd, tg, t))))
    pos = rng.uniform(-1.2, 0.6, n).astype(np.float32)
    vel = rng.uniform(-0.07, 0.07, n).astype(np.float32)
    # the edges: at the left wall moving left, and at the goal, from both
    # sides of it and with velocity 0
    pos[:4] = [-1.2, -1.19, 0.45, 0.449]
    vel[:4] = [-0.05, -0.02, 0.0, 0.01]
    return (jmc.MountainCarState(*map(jnp.asarray, (pos, vel, t))),
            mc.MountainCarState(*map(torch.tensor, (pos, vel, t))))


def _jstep(name):
    return jax.vmap(JENV[name].step)


# --- envs --------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("seed", [0, 1])
def test_env_step_matches_jax(name, seed):
    """One step from the same states and actions (actions past the clip
    range included), MountainCar's left wall and goal edges included."""
    rng = np.random.default_rng(seed)
    n = 256
    horizon = ENV[name].spec.horizon
    js, ps = _states(name, n, rng, horizon)
    act = rng.uniform(-1.5, 1.5, (n, ENV[name].spec.action_dim)
                      ).astype(np.float32)
    if name.startswith("mountain_car"):
        act[:4] = [[-1.0], [-0.5], [1.0], [0.8]]
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    js2, jobs, jr, jterm, jtrunc = _jstep(name)(js, jnp.asarray(act), keys)
    s2, obs, r, term, trunc = ENV[name].step(ps, torch.tensor(act))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **ENV_TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **ENV_TOL)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    for got, want in zip(s2, js2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENV_TOL)
    if name.startswith("mountain_car"):
        # the wall zeroes a leftward velocity; the goal terminates
        assert s2.velocity[0] == 0 and s2.position[0] == np.float32(-1.2)
        assert term[2] and not term[1]


@pytest.mark.parametrize("name", NEW)
def test_env_reset_layout_matches_jax(name):
    """Reset: the JAX env's state layout, dtypes and ranges, and the obs
    the JAX obs function gives on the port's reset state."""
    n = 512
    js, jobs = jax.vmap(JENV[name].reset)(
        jax.random.split(jax.random.PRNGKey(3), n))
    ps, obs = ENV[name].reset(n, torch.Generator().manual_seed(3),
                              torch.device("cpu"))
    assert type(ps)._fields == type(js)._fields
    for got, want in zip(ps, js):
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == {np.dtype(np.float32): torch.float32,
                             np.dtype(np.int32): torch.int32}[want.dtype]
    assert obs.shape == tuple(jobs.shape) and (ps.t == 0).all()
    if name == "reacher":
        assert ps.q.abs().max() <= np.pi and (ps.qd == 0).all()
        radius = ps.target.norm(dim=-1)
        assert radius.min() >= 0.1 - 1e-6 and radius.max() <= 0.9 + 1e-6
    elif name != "simple":
        assert (-0.6 <= ps.position).all() and (ps.position <= -0.4).all()
        assert (ps.velocity == 0).all()
    jst = type(js)(*(jnp.asarray(x.numpy()) for x in ps))
    if name == "mountain_car_norm":
        # the wrapper maps the raw obs, as the JAX wrapper does
        raw = jax.vmap(jmc._obs)(jst)
        mid = (np.float32(0.6) + np.float32(-1.2)) / np.float32(2)
        want = (np.asarray(raw) - np.array([mid, 0], np.float32)) / np.array(
            [(np.float32(0.6) - np.float32(-1.2)) / np.float32(2),
             np.float32(0.07)], np.float32)
    else:
        mod = {"simple": None, "mountain_car": jmc, "reacher": jrc}[name]
        want = (np.asarray(jst.s)[:, None] if mod is None
                else np.asarray(jax.vmap(mod._obs)(jst)))
    np.testing.assert_allclose(obs.numpy(), want, **ENV_TOL)


def test_obs_norm_wrapper_lockstep():
    """mountain_car_norm steps as the raw env does, its obs the raw obs
    mapped into [-1, 1] (tests/test_envs.py's lockstep)."""
    raw, wrapped = ENV["mountain_car"], ENV["mountain_car_norm"]
    s_r, o_r = raw.reset(4, torch.Generator().manual_seed(0), "cpu")
    s_w, o_w = wrapped.reset(4, torch.Generator().manual_seed(0), "cpu")
    lo = np.array([mc.MIN_POSITION, -mc.MAX_SPEED])
    hi = np.array([mc.MAX_POSITION, mc.MAX_SPEED])
    mid, half = (hi + lo) / 2, (hi - lo) / 2
    np.testing.assert_allclose(o_w.numpy(), (o_r.numpy() - mid) / half,
                               rtol=1e-6, atol=1e-6)
    for t in range(50):
        a = torch.full((4, 1), 0.7 if t % 3 else -1.0)
        s_r, o_r, r_r, te_r, tr_r = raw.step(s_r, a)
        s_w, o_w, r_w, te_w, tr_w = wrapped.step(s_w, a)
        assert torch.equal(r_r, r_w)
        assert torch.equal(te_r, te_w) and torch.equal(tr_r, tr_w)
        np.testing.assert_allclose(o_w.numpy(), (o_r.numpy() - mid) / half,
                                   rtol=1e-5, atol=1e-6)
        assert float(o_w.abs().max()) <= 1.0 + 1e-5


def test_simple_env_terminates_and_resets():
    """Reward 1 and termination at s >= 5; the autoreset returns to 0."""
    env = ENV["simple"]
    st = sp.SimpleState(torch.tensor([4.5, 0.0, 4.2]),
                        torch.tensor([3, 14, 2], dtype=torch.int32))
    st2, obs2, next_obs, r, term, trunc = envs.vector_autoreset_step(
        env, st, torch.tensor([[1.0], [0.0], [0.5]]),
        fresh=env.reset(3, None, torch.device("cpu")))
    assert term.tolist() == [True, False, False]
    assert trunc.tolist() == [False, True, False]
    assert r.tolist() == [1.0, 0.0, 0.0]
    assert next_obs[0, 0] == 5.5 and obs2[0, 0] == 0 and obs2[1, 0] == 0
    assert st2.t.tolist() == [0, 0, 3]


# --- K1's lanes --------------------------------------------------------------

def _jts(name, seed=0, hidden=(16, 16)):
    jcfg = JPPOConfig(env=name, n_envs=E, rollout_len=T, hidden=hidden)
    jts = jppo.init_train_state(jcfg, JENV[name], jax.random.PRNGKey(seed))
    return jts, conv.train_state_from_numpy(jax.device_get(jts), "cpu")


def _carry(name, rng, t0, n=E):
    """A carried (state, obs) pair on each side, at step counters t0."""
    js, ps = _states(name, n, rng, 1)
    js = js._replace(t=js.t + t0)
    ps = ps._replace(t=ps.t + t0)
    return (js, jax.vmap(lambda s: JENV[name].step(
        s, jnp.zeros(JENV[name].spec.action_dim), jax.random.PRNGKey(0)
    )[1])(js)), (ps, None)


def _compare_traj(got, want):
    for name in ("obs", "next_obs", "action", "log_prob", "reward"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _carry_t(name):
    """A counter that crosses the horizon inside the window."""
    return ENV[name].spec.horizon - 5


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("carried", [False, True])
def test_plain_lane_matches_pallas_kernel(name, carried):
    """Fresh reset, and a carried state whose counters cross the horizon
    inside the window (truncation and auto-reset draws), with the V(s) /
    V(s') planes."""
    jts, ts = _jts(name)
    key = jax.random.PRNGKey(11)
    jcarry = pcarry = None
    if carried:
        jcarry, pcarry = _carry(name, np.random.default_rng(2), _carry_t(name))
    jtraj, (jst, jobs_after), (jv, jnv) = jpr.rollout_fused(
        name, jts.policy_params, key, E, T, "relu", jcarry, gamma=0.99,
        v_params=jts.v_params)
    traj, (st, obs_after), (v, nv) = cuda_rollout.rollout_fused(
        name, ts.policy_params, jax_seed_words(key), E, T, "relu", pcarry,
        gamma=0.99, v_params=ts.v_params)
    _compare_traj(traj, jtraj)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), **TOL)
    assert type(st) is type(ENV[name].reset(1, torch.Generator(), "cpu")[0])
    np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
    for got, want in zip(st[:-1], jst[:-1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(obs_after.numpy(), np.asarray(jobs_after),
                               **TOL)
    if carried:
        assert traj.truncated.any() or traj.terminated.any()


@pytest.mark.parametrize("name", NEW)
def test_plain_lane_metrics_match_pallas_kernel(name):
    """return_metrics over a window in which episodes complete: by the
    horizon from carried counters (and for simple by reaching s >= 5)."""
    jts, ts = _jts(name, seed=1)
    key = jax.random.PRNGKey(5)
    jcarry, pcarry = _carry(name, np.random.default_rng(7), _carry_t(name))
    _, _, jm = jpr.rollout_fused(name, jts.policy_params, key, E, T, "relu",
                                 jcarry, gamma=0.99, return_metrics=True)
    _, _, m = cuda_rollout.rollout_fused(
        name, ts.policy_params, jax_seed_words(key), E, T, "relu", pcarry,
        gamma=0.99, return_metrics=True)
    assert float(m[2]) == float(jm[2]) >= E
    np.testing.assert_allclose([float(m[0]), float(m[1])],
                               [float(jm[0]), float(jm[1])], rtol=1e-4)


def test_mountain_car_lane_terminates_at_the_goal_on_the_last_step():
    """A carried car that reaches the goal on the window's last step, which
    is also its 999th (the horizon): terminated, not truncated, and the
    auto-reset draws the next start; as the JAX kernel does."""
    name = "mountain_car"
    jts, ts = _jts(name, seed=2)
    key = jax.random.PRNGKey(8)
    pos = np.full(E, 0.3, np.float32)
    vel = np.full(E, 0.07, np.float32)
    pos[1::2] = -0.9                      # these only truncate
    t = np.full(E, mc.HORIZON - 3, np.int32)
    jst = jmc.MountainCarState(*map(jnp.asarray, (pos, vel, t)))
    pst = mc.MountainCarState(*map(torch.tensor, (pos, vel, t)))
    jtraj, (jst2, _) = jpr.rollout_fused(
        name, jts.policy_params, key, E, 3, "relu",
        (jst, jax.vmap(jmc._obs)(jst)), gamma=0.99)
    traj, (st2, _) = cuda_rollout.rollout_fused(
        name, ts.policy_params, jax_seed_words(key), E, 3, "relu",
        (pst, None), gamma=0.99)
    _compare_traj(traj, jtraj)
    assert traj.terminated[2, 0::2].all() and not traj.terminated[:2].any()
    assert traj.truncated[2, 1::2].all() and not traj.truncated[2, 0::2].any()
    assert (traj.reward[2, 0::2] > 90).all()
    assert (st2.t == 0).all() and (st2.position <= -0.4).all()
    np.testing.assert_allclose(st2.position.numpy(),
                               np.asarray(jst2.position), **TOL)


def test_reacher_lane_chunked_pallas_kernel_matches_plain():
    """reacher at E = 256 against the JAX kernel with the env-chunked grid
    forced (n_chunks=2): its RNG lane counters are global, so the port,
    which does not chunk, draws the same stream."""
    jts, ts = _jts("reacher", seed=3)
    key = jax.random.PRNGKey(21)
    n, steps = 256, 8
    jtraj, _, (jv, jnv) = jpr.rollout_fused(
        "reacher", jts.policy_params, key, n, steps, "relu", None,
        gamma=0.99, v_params=jts.v_params, n_chunks=2)
    traj, _, (v, nv) = cuda_rollout.rollout_fused(
        "reacher", ts.policy_params, jax_seed_words(key), n, steps, "relu",
        None, gamma=0.99, v_params=ts.v_params)
    _compare_traj(traj, jtraj)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), **TOL)


@pytest.mark.parametrize("name", NEW)
def test_replay_reproduces_the_plain_rollout(name):
    """replay_plain on a plain rollout's own actions gives back its obs,
    next_obs, rewards, flags and final carry exactly (the same ops in the
    same order)."""
    ts = _jts(name)[1]
    pp = ts.policy_params
    raw = cuda_rollout.rollout_plain(pp["mlp"], pp["log_std"], None, (3, 4),
                                     E, 40, lane=name)
    rep = cuda_rollout.replay_plain(name, raw.action, (3, 4))
    for key in ("obs", "next_obs", "reward", "terminated", "truncated",
                "st_final", "steps_final"):
        assert torch.equal(rep[key], getattr(raw, key)), key


def test_lane_registry_carries_every_jax_lane():
    for name in NEW:
        ln, want = cuda_rollout.LANES[name], jpr.LANE_ENVS[name]()
        assert (ln.state_dim, ln.obs_dim, ln.n_actions, ln.horizon) == (
            want.state_dim, want.obs_dim, want.n_actions, want.horizon)
        assert ENV[name].spec.obs_dim == ln.obs_dim
        assert len({lane.code for lane in cuda_rollout.LANES.values()}) == 7

"""Port parity for the discrete-action path: the CartPole and Acrobot envs,
the categorical policy, K1's cartpole and acrobot lanes, a whole fit_step
on each side of the 2048-row fused gate and the mean-policy evaluation,
each against the JAX package (its Pallas kernels in interpret mode) on the
same inputs, drawn from numpy seeds or the JAX key stream.

Tolerances.  Env steps rtol/atol 1e-6: the same float32 equations; sin,
cos and the float modulo may differ in the last bit between the
libraries.  Acrobot is held there at angular velocities up to 4: near its
velocity clips (4 pi, 9 pi) one RK4 step cancels terms of ~400, and both
packages' float32 steps then sit up to 6e-4 from a float64 step, so there
the port is held to be no further from float64 than the JAX step is.  The policy: 1e-6.  Rollouts:
class ids exactly (no perturbed-logit near-tie occurs at these seeds),
the float planes rtol 1e-4 / atol 1e-5 as tests/test_torch_rollout.py, over
16 steps (acrobot is chaotic: a short window keeps last-bit differences
small).  Fits: as tests/test_torch_trainer.py and
tests/test_torch_throughput.py.  The evaluation: rtol 1e-4 on J and R, the
episode count exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import acrobot as jac, cartpole as jcp, core as jcore
from ppoc_tpu.models import policy as jpolicy
from ppoc_tpu.ops import pallas_rollout as jpr
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import EvalWindowWarning, Trainer
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs import acrobot, cartpole
from ppoc_tpu_torch.models import policy
from ppoc_tpu_torch.ops import cuda_rollout
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

ENV_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
W_TOL = dict(rtol=1e-4, atol=1e-5)
T, E = 16, 8
JENV = {n: jenvs.make(n) for n in ("cartpole", "acrobot")}
ENV = {n: envs.make(n) for n in ("cartpole", "acrobot")}
STATE = {"cartpole": (jcp.CartPoleState, cartpole.CartPoleState),
         "acrobot": (jac.AcrobotState, acrobot.AcrobotState)}


def _jcfg(env, **kw):
    base = dict(env=env, n_envs=E, rollout_len=T, minibatch_size=64,
                n_epochs_value=2, n_epochs_policy=1, fits_per_epoch=1,
                eval_envs=8, eval_len=120, hidden=(16, 16),
                kernel_backend="pallas")
    base.update(kw)
    return JPPOConfig(**base)


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


def _jts(env, seed=0, **kw):
    jcfg = _jcfg(env, **kw)
    jts = jppo.init_train_state(jcfg, JENV[env], jax.random.PRNGKey(seed))
    return jcfg, jts, conv.train_state_from_numpy(jax.device_get(jts), "cpu")


def _random_states(env, n, rng, t_hi, vel=(4.0, 4.0)):
    """Valid states in numpy: cartpole inside its bounds, acrobot at any
    angle with angular velocities within ``vel``; step counters below
    ``t_hi``."""
    if env == "cartpole":
        cols = [rng.uniform(-2.0, 2.0, n), rng.uniform(-2, 2, n),
                rng.uniform(-0.18, 0.18, n), rng.uniform(-2, 2, n)]
        mat = np.stack(cols, 1).astype(np.float32)
    else:
        mat = np.stack([rng.uniform(-np.pi, np.pi, n),
                        rng.uniform(-np.pi, np.pi, n),
                        rng.uniform(-vel[0], vel[0], n),
                        rng.uniform(-vel[1], vel[1], n)],
                       1).astype(np.float32)
    return mat, rng.integers(0, t_hi, n).astype(np.int32)


def _states(env, mat, t):
    """(JAX state, port state) from a numpy [n, 4] matrix and counters."""
    jcls, pcls = STATE[env]
    if env == "cartpole":
        return (jcls(*(jnp.asarray(c) for c in mat.T), jnp.asarray(t)),
                pcls(*(torch.tensor(c) for c in mat.T), torch.tensor(t)))
    return (jcls(jnp.asarray(mat), jnp.asarray(t)),
            pcls(torch.tensor(mat), torch.tensor(t)))


# --- envs -------------------------------------------------------------------

@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
@pytest.mark.parametrize("seed", [0, 1])
def test_env_step_matches_jax(env, seed):
    rng = np.random.default_rng(seed)
    mat, t = _random_states(env, 256, rng, 500)
    act = rng.integers(0, ENV[env].spec.action_dim, (256, 1)).astype(np.int32)
    js, ps = _states(env, mat, t)
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    mod = jcp if env == "cartpole" else jac
    js2, jobs, jr, jterm, jtrunc = jax.vmap(mod._step)(js, jnp.asarray(act),
                                                       keys)
    s2, obs, r, term, trunc = ENV[env].step(ps, torch.tensor(act))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **ENV_TOL)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(s2.t.numpy(), np.asarray(js2.t))
    for got, want in zip(s2[:-1], js2[:-1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENV_TOL)
    assert 0 < int(term.sum()) < 256


@pytest.mark.parametrize("seed", [0, 1])
def test_acrobot_step_near_the_velocity_clips_is_as_close_to_float64(seed):
    rng = np.random.default_rng(seed)
    mat, t = _random_states("acrobot", 256, rng, 500, vel=(4 * np.pi,
                                                           9 * np.pi))
    act = rng.integers(0, 3, (256, 1)).astype(np.int32)
    js, ps = _states("acrobot", mat, t)
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    _, jobs, _, jterm, _ = jax.vmap(jac._step)(js, jnp.asarray(act), keys)
    _, obs, _, term, _ = ENV["acrobot"].step(ps, torch.tensor(act))
    _, exact, _, _, _ = ENV["acrobot"].step(
        acrobot.AcrobotState(ps.s.double(), ps.t), torch.tensor(act))
    err = np.abs(obs.numpy() - exact.numpy()).max()
    jerr = np.abs(np.asarray(jobs) - exact.numpy()).max()
    assert err <= max(jerr, 1e-6), (err, jerr)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))


@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
def test_env_reset_layout_matches_jax(env):
    """Same state fields and shapes as the JAX env's vmapped reset, draws in
    the same ranges, counters at 0, and obs_of equal to the JAX obs of the
    same states."""
    js, jobs = jcore.vector_reset(JENV[env], jax.random.PRNGKey(3), 512)
    ps, obs = envs.vector_reset(ENV[env], torch.Generator().manual_seed(3),
                                512, "cpu")
    assert type(ps)._fields == type(js)._fields
    for got, want in zip(ps, js):
        assert tuple(got.shape) == tuple(np.shape(want))
        assert got.dtype == torch.tensor(np.asarray(want)).dtype
    bound = 0.05 if env == "cartpole" else 0.1
    vals = torch.stack(list(ps[:-1]), 1) if env == "cartpole" else ps.s
    assert vals.abs().max() <= bound and vals.abs().max() > 0.9 * bound
    assert (ps.t == 0).all() and obs.shape == jobs.shape
    jmod, pmod = (jcp, cartpole) if env == "cartpole" else (jac, acrobot)
    jst, pst = _states(env, np.asarray(vals), np.zeros(512, np.int32))
    np.testing.assert_allclose(pmod.obs_of(pst).numpy(),
                               np.asarray(jax.vmap(jmod._obs)(jst)),
                               **ENV_TOL)


def test_autoreset_step_resets_terminated_cartpoles():
    s = cartpole.CartPoleState(torch.tensor([0.0, 2.39, 0.0]),
                               torch.tensor([0.0, 1.0, 0.0]),
                               torch.zeros(3), torch.zeros(3),
                               torch.tensor([0, 3, 499], dtype=torch.int32))
    fresh = envs.vector_reset(ENV["cartpole"], torch.Generator(), 3, "cpu")
    s2, obs2, next_obs, r, term, trunc = envs.vector_autoreset_step(
        ENV["cartpole"], s, torch.ones(3, 1, dtype=torch.int32), fresh)
    assert term.tolist() == [False, True, False]
    assert trunc.tolist() == [False, False, True]
    assert s2.t.tolist() == [1, 0, 0] and r.tolist() == [1.0, 1.0, 1.0]
    torch.testing.assert_close(obs2[1:], fresh[1][1:])
    assert float(next_obs[1, 0]) > 2.4


# --- policy -----------------------------------------------------------------

@pytest.mark.parametrize("n_actions,obs_dim", [(2, 4), (3, 6)])
def test_categorical_policy_matches_jax(n_actions, obs_dim):
    jpp = jax.device_get(jpolicy.init_categorical(
        jax.random.PRNGKey(n_actions), obs_dim, n_actions, (16, 16)))
    pp = conv.tree_from_numpy(dict(jpp), "cpu")
    pp["mlp"] = [tuple(layer) for layer in pp["mlp"]]
    rng = np.random.default_rng(n_actions)
    x = (3 * rng.normal(size=(5, 7, obs_dim))).astype(np.float32)
    a = rng.integers(0, n_actions, (5, 7, 1)).astype(np.int32)
    jx, px = jnp.asarray(x), torch.tensor(x)
    np.testing.assert_allclose(
        policy.log_prob(pp, px, torch.tensor(a), "relu", "jnp", True).numpy(),
        np.asarray(jpolicy.log_prob(jpp, jx, jnp.asarray(a), "relu", "jnp",
                                    True)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(policy.entropy(pp, px, "relu", "jnp", True)),
        float(jpolicy.entropy(jpp, jx, "relu", "jnp", True)), rtol=1e-6)
    ja, jlp = jpolicy.mode(jpp, jx, "relu", "jnp", True)
    ma, mlp_ = policy.mode(pp, px, "relu", "pallas", True)
    assert ma.dtype == torch.int32 and ma.shape == (5, 7, 1)
    np.testing.assert_array_equal(ma.numpy(), np.asarray(ja))
    np.testing.assert_allclose(mlp_.numpy(), np.asarray(jlp), rtol=1e-6,
                               atol=1e-6)


def test_mode_takes_the_first_of_tied_logits():
    pp = {"mlp": [(torch.zeros(2, 3), torch.tensor([1.0, 1.0, 0.0]))]}
    a, lp = policy.mode(pp, torch.zeros(4, 2), "relu", "jnp", True)
    assert a.reshape(-1).tolist() == [0, 0, 0, 0]
    torch.testing.assert_close(lp, torch.log_softmax(
        torch.tensor([1.0, 1.0, 0.0]), 0)[0].expand(4))


def test_discrete_train_state_matches_jax_layout():
    """No log_std; the log_std optimizer holds empty moments, as the JAX
    package's adam.init(jnp.zeros((0,))); params cross over both ways."""
    _, jts, ts = _jts("acrobot")
    own = ppo.init_train_state(_port(_jcfg("acrobot")), ENV["acrobot"],
                               torch.Generator().manual_seed(0), "cpu")
    for st in (ts, own):
        assert set(st.policy_params) == {"mlp"}
        assert st.opt_log_std.m.shape == (0,) and st.opt_log_std.t == 0
        assert [tuple(w.shape) for w, _ in st.policy_params["mlp"]] == [
            (6, 16), (16, 16), (16, 3)]
    back = conv.train_state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back.policy_params),
                    jax.tree.leaves(jax.device_get(jts.policy_params))):
        np.testing.assert_array_equal(a, np.asarray(b))


# --- K1 lanes ---------------------------------------------------------------

def jax_seed_words(key):
    kd = jax.random.fold_in(key, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)
    return int(w[0]), int(w[1])


def _compare_traj(got, want):
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))
    assert got.action.dtype == torch.int32
    for name in ("obs", "next_obs", "log_prob", "reward"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
@pytest.mark.parametrize("carry_t", [None, 0, 495])
def test_plain_rollout_lane_matches_pallas_kernel(env, carry_t):
    """Fresh reset, a carried state, and a carry that crosses the 500-step
    horizon inside the window, with the in-kernel V(s) / V(s') planes."""
    _, jts, ts = _jts(env)
    key = jax.random.PRNGKey(11)
    jcarry = pcarry = None
    if carry_t is not None:
        rng = np.random.default_rng(carry_t + 1)
        mat, t = _random_states(env, E, rng, 1)
        if env == "cartpole":
            mat *= np.float32(0.02)     # far from the bounds: runs past 495
        js, ps = _states(env, mat, t + carry_t)
        mod = jcp if env == "cartpole" else jac
        jcarry, pcarry = (js, jax.vmap(mod._obs)(js)), (ps, None)
    jtraj, (jst, jobs_after), (jv, jnv) = jpr.rollout_fused(
        env, jts.policy_params, key, E, T, "relu", jcarry, gamma=0.99,
        v_params=jts.v_params)
    traj, (st, obs_after), (v, nv) = cuda_rollout.rollout_fused(
        env, ts.policy_params, jax_seed_words(key), E, T, "relu", pcarry,
        gamma=0.99, v_params=ts.v_params)
    _compare_traj(traj, jtraj)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), **TOL)
    np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
    np.testing.assert_allclose(obs_after.numpy(), np.asarray(jobs_after),
                               **TOL)
    assert type(st) is STATE[env][1]
    if carry_t == 495 and env == "cartpole":
        assert traj.truncated[4].all() and not traj.truncated[:4].any()
    if env == "cartpole" and carry_t is None:
        assert traj.terminated.any()    # episodes end inside the window


@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
def test_plain_rollout_lane_metrics_match_pallas_kernel(env):
    """return_metrics over a window in which episodes complete: cartpole by
    termination, acrobot by the horizon."""
    _, jts, ts = _jts(env, seed=1)
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(7)
    mat, t = _random_states(env, E, rng, 1)
    if env == "cartpole":
        mat *= np.float32(0.02)
    js, ps = _states(env, mat, t + 490)
    mod = jcp if env == "cartpole" else jac
    _, _, jm = jpr.rollout_fused(env, jts.policy_params, key, E, T, "relu",
                                 (js, jax.vmap(mod._obs)(js)), gamma=0.99,
                                 return_metrics=True)
    _, _, m = cuda_rollout.rollout_fused(
        env, ts.policy_params, jax_seed_words(key), E, T, "relu", (ps, None),
        gamma=0.99, return_metrics=True)
    assert float(m[2]) == float(jm[2]) >= E
    np.testing.assert_allclose([float(m[0]), float(m[1])],
                               [float(jm[0]), float(jm[1])], rtol=1e-4)


def test_gumbel_sampler_matches_the_pallas_kernel_draws():
    """The plain sampler on one step's logits: the JAX kernel's Gumbel-max
    with draws k, clip [1e-12, 1 - 1e-7] and a strict > (ties to the lower
    class), on logits that make near-ties and exact ties."""
    rng = np.random.default_rng(0)
    h = rng.normal(size=(4096, 3)).astype(np.float32)
    h[:64, 1] = h[:64, 0]                     # exact logit ties
    s0, s1, t = 0x9E3779B9, 0x7F4A7C15, 37
    best = best_idx = None
    for k in range(3):
        u = jnp.clip(jpr._uniform01((1, 4096), jnp.uint32(s0), jnp.uint32(s1),
                                    jnp.uint32(t), k)[0], 1e-12, 1.0 - 1e-7)
        y = jnp.asarray(h[:, k]) - jnp.log(-jnp.log(u))
        if best is None:
            best, best_idx = y, jnp.zeros(4096, jnp.int32)
        else:
            take = y > best
            best, best_idx = jnp.where(take, y, best), jnp.where(take, k,
                                                                 best_idx)
    idx, lp = cuda_rollout.gumbel_max_plain(torch.tensor(h), s0, s1, t,
                                            torch.arange(4096))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(best_idx))
    want_lp = jax.nn.log_softmax(jnp.asarray(h), -1)[np.arange(4096),
                                                      np.asarray(best_idx)]
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=1e-6,
                               atol=1e-6)
    counts = np.bincount(idx.numpy(), minlength=3) / 4096
    p = np.asarray(jax.nn.softmax(jnp.asarray(h), -1)).mean(0)
    np.testing.assert_allclose(counts, p, atol=0.03)


def test_rollout_lanes_mirror_the_jax_registry():
    for name, ln in cuda_rollout.LANES.items():
        want = jpr.LANE_ENVS[name]()
        assert (ln.state_dim, ln.obs_dim, ln.n_actions, ln.horizon) == (
            want.state_dim, want.obs_dim, want.n_actions, want.horizon)
    assert cuda_rollout.SUPPORTED == jpr.SUPPORTED


# --- the whole path ---------------------------------------------------------

def jax_fit_draws(cfg, key):
    k_roll, k_upd = jax.random.split(key)
    k_val, k_pol = jax.random.split(k_upd)

    def stream(k, n_epochs):
        flat, _ = jpu._stream_ids(cfg, k, cfg.steps_per_fit,
                                  cfg.num_minibatches, cfg.minibatch_size,
                                  n_epochs)
        return torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
            n_epochs, cfg.num_minibatches, -1)

    return ppo.FitDraws(jax_seed_words(k_roll),
                        stream(k_val, cfg.n_epochs_value),
                        stream(k_pol, cfg.n_epochs_policy))


def _check_fit(jcfg, env, jts, ts, key, moment_atol):
    jts2, jm = jax.jit(lambda s, k: jppo.fit_step(
        jcfg, JENV[env], s, k, backend="pallas"))(jts, key)
    ts2, m = ppo.fit_step(_port(jcfg), ENV[env], ts, jax_fit_draws(jcfg, key))
    got, want = conv.train_state_to_numpy(ts2), jax.device_get(jts2)
    for a, b in zip(jax.tree.leaves((got.policy_params, got.v_params)),
                    jax.tree.leaves((want.policy_params, want.v_params))):
        np.testing.assert_allclose(a, np.asarray(b), **W_TOL)
    for moment, rtol in (("m", 1e-4), ("v", 1e-3)):
        for a, b in zip(
                jax.tree.leaves([getattr(o, moment) for o in (
                    got.opt_policy, got.opt_v, got.opt_log_std)]),
                jax.tree.leaves([getattr(o, moment) for o in (
                    want.opt_policy, want.opt_v, want.opt_log_std)])):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=moment_atol(b))
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(want.opt_v.t), int(want.opt_policy.t), int(want.opt_log_std.t))
    assert got.opt_log_std.t == 0
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)
    return ts2


def test_fused_fit_step_matches_jax_pallas_fit_step(monkeypatch):
    """cartpole under the fused gate (mb 64): K1's cartpole lane, K2, K3 and
    K6, each as its plain version; K4 is never called."""
    from ppoc_tpu_torch.ops import cuda_update

    calls = []
    for name in ("policy_phase", "policy_phase_categorical"):
        real = getattr(cuda_update, name)
        monkeypatch.setattr(cuda_update, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    jcfg, jts, ts = _jts("cartpole", ent_coeff=0.01)
    _check_fit(jcfg, "cartpole", jts, ts, jax.random.PRNGKey(42),
               lambda b: 1e-7)
    assert calls == ["policy_phase_categorical"]


def test_generic_fit_step_matches_jax_pallas_fit_step():
    """cartpole above the gate (mb 4096 in blocks of 1024): the generic
    categorical phase, log-prob and entropy through K5's plain version,
    autograd and one Adam, against the JAX scan branch.  Adam moments as
    tests/test_torch_throughput.py: atol 1e-3 of the leaf's largest
    magnitude (4096-row sums in another order)."""
    jcfg, jts, ts = _jts("cartpole", seed=2, n_envs=32, rollout_len=128,
                         minibatch_size=4096, shuffle_block=1024,
                         n_epochs_value=1, ent_coeff=0.01)
    assert jcfg.minibatch_size > ppo.MAX_FUSED_MB
    _check_fit(jcfg, "cartpole", jts, ts, jax.random.PRNGKey(9),
               lambda b: 1e-3 * np.abs(b).max(initial=0.0))


def jax_loop_draws(env, cfg, key):
    """The start and reset states the JAX package's mean-policy env loop
    draws from ``key`` (see tests/test_torch_throughput.py)."""
    n, L = cfg.eval_envs, cfg.eval_len
    k_reset, k_scan = jax.random.split(key)
    js, jobs = jcore.vector_reset(JENV[env], k_reset, n)
    fresh_s, fresh_o = [], []
    for k_t in jax.random.split(k_scan, L):
        _, k_env = jax.random.split(k_t)
        _, k_rst = jax.random.split(k_env)
        fs, fo = jcore.vector_reset(JENV[env], k_rst, n)
        fresh_s.append(jax.device_get(fs))
        fresh_o.append(np.asarray(fo))
    pcls = STATE[env][1]
    fstate = pcls(*(torch.tensor(np.stack([np.asarray(getattr(s, f))
                                           for s in fresh_s]))
                    for f in pcls._fields))
    start = pcls(*(torch.tensor(np.asarray(x)) for x in js))
    return ppo.LoopDraws((start, torch.tensor(np.asarray(jobs))),
                         (fstate, torch.tensor(np.stack(fresh_o))))


def test_mean_policy_evaluation_matches_jax():
    """evaluate(deterministic=True) for cartpole: argmax through K5's plain
    forward in the env loop, on the states the JAX key stream draws."""
    jcfg, jts, ts = _jts("cartpole", seed=3)
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda p, k: jppo.evaluate(
        jcfg, JENV["cartpole"], p, k, backend="pallas",
        deterministic=True))(jts.policy_params, key)
    cfg = _port(jcfg)
    draws = jax_loop_draws("cartpole", cfg, key)
    got = ppo.evaluate(cfg, ENV["cartpole"], ts.policy_params, draws,
                       deterministic=True)
    assert float(got.episodes) == float(want.episodes) > cfg.eval_envs
    np.testing.assert_allclose([float(got.J), float(got.R)],
                               [float(want.J), float(want.R)], rtol=1e-4)
    traj = ppo.rollout_env_loop(cfg, ENV["cartpole"], ts.policy_params,
                                draws)
    assert traj.action.dtype == torch.int32 and traj.action.shape == (
        cfg.eval_len, cfg.eval_envs, 1)


def test_buffer_keeps_int32_class_ids():
    traj = ppo.Transition(
        obs=torch.zeros(4, 2, 3), action=torch.arange(8, dtype=torch.int32
                                                      ).reshape(4, 2, 1),
        log_prob=torch.zeros(4, 2), next_obs=torch.zeros(4, 2, 3),
        reward=torch.zeros(4, 2), terminated=torch.zeros(4, 2, dtype=bool),
        truncated=torch.zeros(4, 2, dtype=bool))
    buf = buffer.from_rollout(traj, torch.zeros(4, 2), torch.zeros(4, 2))
    assert buf.action.dtype == torch.int32 and buf.action.shape == (8, 1)
    (a,) = buffer.gather_mb((buf.action,), torch.tensor([[[5, 2]]]))
    assert a.dtype == torch.int32 and a.reshape(-1).tolist() == [5, 2]
    (b,) = buffer.gather_mb((buf.action,), torch.tensor([[1]]), 4)
    assert b.dtype == torch.int32 and b.reshape(-1).tolist() == [4, 5, 6, 7]


@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
def test_discrete_trainer_on_cpu(env):
    """Trainer(PPOConfig(env=...)) trains, evaluates and solves on the CPU;
    eval_len under the 500-step horizon warns, as in the JAX package."""
    cfg = PPOConfig(env=env, n_envs=8, rollout_len=32, minibatch_size=64,
                    fits_per_epoch=1, n_epochs_value=1, n_epochs_policy=1,
                    eval_envs=4, eval_len=200, hidden=(16, 16),
                    kernel_backend="pallas")
    with pytest.warns(EvalWindowWarning):
        tr = Trainer(cfg, "cpu")
    hist = tr.train(n_epochs=1, log=False)
    assert len(hist) == 1 and np.isfinite(hist[0]["entropy"])
    assert tr.state.opt_policy.t == 4 and tr.state.opt_log_std.t == 0
    ev = tr.evaluate(deterministic=True)
    assert ev.episodes >= 0
    res = tr.solve(-1e9, max_epochs=1)
    assert res["epochs"] == 1

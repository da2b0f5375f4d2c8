"""Port parity for the "jnp" backend and the env-loop training rollout,
and ``ppo.kernel_fit`` on every path this opens, against the JAX package
(the affine observation wrapper and ``calibrate``, which route through
this loop, are tests/test_torch_obsnorm.py).

* The stochastic env loop (``ppo.rollout`` where no rollout lane serves:
  "jnp", a mixture, an ``#affine`` env), Gaussian and categorical, on the
  JAX rollout's own draws: its start and reset states and action noise
  (normal(k_act), or gumbel(k_act) for ``jax.random.categorical``),
  taken from its key stream (:func:`_loop_draws`).

Both packages start from the same params (:func:`shared_start`: the
port's init from a seeded generator, given to the JAX package as its
TrainState).  The JAX side of each family of cases (the env loops, the
fits, the evaluators) is one jitted program that also makes the draws,
compiled once for the file.
* A whole "jnp" fit_step (env loop, doubling-scan GAE with Welford, the
  generic phases in plain PyTorch) and the "jnp" evaluators.

Tolerances.  Class ids and done flags exactly; float planes and the fit's
weights rtol 1e-4 / atol 1e-5, second Adam moments rtol 1e-3 / atol 1e-7,
metrics rtol 1e-4 / atol 1e-6 (as tests/test_torch_discrete.py).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import core as jcore
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer, check_kernel_fit
from ppoc_tpu_torch.envs.cartpole import CartPoleState
from ppoc_tpu_torch.envs.mountain_car import MountainCarState
from ppoc_tpu_torch.envs.pendulum import PendulumState
from ppoc_tpu_torch.ops import cuda_gae, cuda_mlp, cuda_rollout, cuda_update
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-7)
M_TOL = dict(rtol=1e-4, atol=1e-6)
STATE = {"pendulum": PendulumState, "cartpole": CartPoleState,
         "mountain_car": MountainCarState}
OPTIN = 232448   # an H100 block's opt-in shared memory


def _jcfg(env="pendulum", **kw):
    base = dict(env=env, n_envs=8, rollout_len=16, minibatch_size=32,
                n_epochs_value=2, n_epochs_policy=2, fits_per_epoch=1,
                eval_envs=8, eval_len=40, hidden=(16, 16),
                kernel_backend="jnp")
    base.update(kw)
    return JPPOConfig(**base)


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


def shared_start(jcfg, seed):
    """Params both packages start from: the port's ``init_train_state``
    from a seeded generator, and the same leaves as the JAX package's
    TrainState (its structure traced from its init, not run).  Returns
    (port state, JAX state)."""
    ts = ppo.init_train_state(_port(jcfg), envs.make_for(_port(jcfg)),
                              torch.Generator().manual_seed(seed), "cpu")
    shape = jax.eval_shape(lambda k: jppo.init_train_state(
        jcfg, jenvs.make_for(jcfg), k), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(conv.train_state_to_numpy(ts))
    want = jax.tree.leaves(shape)
    assert [np.shape(x) for x in leaves] == [w.shape for w in want]
    return ts, jax.tree.unflatten(jax.tree.structure(shape), [
        np.asarray(x, w.dtype) for x, w in zip(leaves, want)])


def _loop_draws(jenv, n, L, key):
    """The start states, reset states and action noise the JAX package's
    env-loop rollout (``ppo.rollout`` off the kernel) draws from ``key``,
    traceable: split -> (reset, scan); per step split -> (act, env); the
    noise is normal(k_act, [n, A]) or, for jax.random.categorical,
    gumbel(k_act, [n, K]); the autoreset's states come from the second
    half of split(k_env)."""
    spec = jenv.spec
    k_reset, k_scan = jax.random.split(key)
    start = jcore.vector_reset(jenv, k_reset, n)
    pairs = jax.vmap(jax.random.split)(jax.random.split(k_scan, L))
    draw = jax.random.gumbel if spec.discrete else jax.random.normal
    noise = jax.vmap(lambda k: draw(k, (n, spec.action_dim)))(pairs[:, 0])
    fresh = jax.vmap(lambda k: jcore.vector_reset(
        jenv, jax.random.split(k)[1], n))(pairs[:, 1])
    return start, fresh, noise


def _as_loop_draws(env, raw, deterministic=False):
    """:func:`_loop_draws`' arrays as the port's LoopDraws."""
    (js, jobs), (fs, fo), noise = raw
    cls = STATE[env]

    def state(s):
        return cls(*(torch.tensor(np.asarray(getattr(s, f)))
                     for f in cls._fields))

    return ppo.LoopDraws((state(js), torch.tensor(np.asarray(jobs))),
                         (state(fs), torch.tensor(np.asarray(fo))),
                         None if deterministic
                         else torch.tensor(np.asarray(noise)))


def _fit_draws(jcfg, jenv, key):
    """What the JAX package's fit_step draws from ``key`` off the rollout
    kernel, traceable: the env loop's draws from k_roll, the generic
    phases' row-id streams from k_upd (split -> value, policy)."""
    k_roll, k_upd = jax.random.split(key)
    streams = tuple(
        jpu._stream_ids(jcfg, k, jcfg.steps_per_fit, jcfg.num_minibatches,
                        jcfg.minibatch_size, n)[0]
        for k, n in zip(jax.random.split(k_upd),
                        (jcfg.n_epochs_value, jcfg.n_epochs_policy)))
    return streams, _loop_draws(jenv, jcfg.n_envs, jcfg.rollout_len, k_roll)


def _as_fit_draws(jcfg, raw):
    (s_val, s_pol), loop = raw

    def stream(flat, n_epochs):
        return torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
            n_epochs, jcfg.num_minibatches, -1)

    return ppo.FitDraws(None, stream(s_val, jcfg.n_epochs_value),
                        stream(s_pol, jcfg.n_epochs_policy),
                        _as_loop_draws(jcfg.env, loop))


def traj_close(got, want):
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        if a.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def fit_close(ts2, m, jts2, jm, w_tol=TOL):
    got, want = conv.train_state_to_numpy(ts2), jax.device_get(jts2)
    for a, b in zip(jax.tree.leaves((got.policy_params, got.v_params)),
                    jax.tree.leaves((want.policy_params, want.v_params))):
        np.testing.assert_allclose(a, np.asarray(b), **w_tol)
    for opt in ("opt_policy", "opt_v", "opt_log_std"):
        g, w = getattr(got, opt), getattr(want, opt)
        assert g.t == int(w.t), opt
        for a, b in zip(jax.tree.leaves(g.m), jax.tree.leaves(w.m)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=opt, **w_tol)
        for a, b in zip(jax.tree.leaves(g.v), jax.tree.leaves(w.v)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=opt, **V_TOL)
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), **M_TOL)


@pytest.fixture
def no_kernel(monkeypatch):
    """Every kernel wrapper raises: the path under test must launch (here:
    call the plain version of) none."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for mod, names in ((cuda_rollout, ("rollout_fused",)),
                       (cuda_gae, ("gae_norm_fused",)),
                       (cuda_mlp, ("mlp_forward",)),
                       (cuda_update, ("value_phase", "policy_phase",
                                      "policy_phase_categorical"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


# --- the env loop ----------------------------------------------------------------

LOOP_ENVS = ("pendulum", "cartpole")


def _loop_cfg(env):
    return _jcfg(env, eval_len=500 if env == "cartpole" else 40)


def _loop_program(params):
    """The env-loop cases' JAX side: for each env, the "jnp" rollout of
    key 7 (40 steps) with force_truncate on and off, and its draws; for
    the carry case, pendulum's rollout of key 3 (10 steps) continuing
    from the carry the force_truncate-off rollout left, and its draws."""
    out = {}
    for env in LOOP_ENVS:
        jenv, key = jenvs.make(env), jax.random.PRNGKey(7)
        out[env] = (tuple(
            jppo.rollout(_loop_cfg(env), jenv, params[env], key, 8, 40,
                         "jnp", force_truncate=ft)
            for ft in (True, False)), _loop_draws(jenv, 8, 40, key))
    jenv, key = jenvs.make("pendulum"), jax.random.PRNGKey(3)
    jcarry = out["pendulum"][0][1][1]
    want, _ = jppo.rollout(_loop_cfg("pendulum"), jenv, params["pendulum"],
                           key, 8, 10, "jnp", env_carry=jcarry)
    out["carry"] = (jcarry, want, _loop_draws(jenv, 8, 10, key))
    return out


@pytest.mark.parametrize("env", LOOP_ENVS)
@pytest.mark.parametrize("force_truncate", [True, False])
def test_stochastic_env_loop_matches_jax(env, force_truncate):
    """ppo.rollout under "jnp" is the env loop on the drawn noise: the JAX
    package's jnp rollout on the same params and draws."""
    states, out = _jax_side("loops")
    rollouts, raw = out[env]
    want, wcarry = rollouts[0 if force_truncate else 1]
    got, carry = ppo.rollout(_port(_loop_cfg(env)), envs.make(env),
                             states[env].policy_params,
                             _as_loop_draws(env, raw), 8, 40,
                             force_truncate=force_truncate)
    traj_close(got, want)
    np.testing.assert_allclose(carry[1].numpy(), np.asarray(wcarry[1]), **TOL)
    if env == "cartpole":
        assert got.action.dtype == torch.int32
        assert bool(got.terminated.any())


def test_env_loop_continues_a_carry():
    """reset_per_fit=False: the loop starts from the carry, not from the
    drawn start states, as the JAX rollout does."""
    states, out = _jax_side("loops")
    jcarry, want, raw = out["carry"]
    carry = (PendulumState(*(torch.tensor(np.asarray(x))
                             for x in jcarry[0])),
             torch.tensor(np.asarray(jcarry[1])))
    got, _ = ppo.rollout(_port(_loop_cfg("pendulum")), envs.make("pendulum"),
                         states["pendulum"].policy_params,
                         _as_loop_draws("pendulum", raw), 8, 10,
                         env_carry=carry)
    traj_close(got, want)


def _fit_cfg(env):
    return _jcfg(env, ent_coeff=0.01)


def _fit_program(states):
    """The "jnp" fit cases' JAX side: for each env, fit_step of key 42 and
    its draws."""
    key = jax.random.PRNGKey(42)
    return {env: (jppo.fit_step(_fit_cfg(env), jenvs.make(env), states[env],
                                key, backend="jnp"),
                  _fit_draws(_fit_cfg(env), jenvs.make(env), key))
            for env in LOOP_ENVS}


@pytest.mark.parametrize("env", LOOP_ENVS)
def test_jnp_fit_step_matches_jax(env, no_kernel):
    """One whole "jnp" fit: the env loop, the doubling-scan GAE with
    Welford moments, both generic phases in plain PyTorch; no kernel
    wrapper is called."""
    states, out = _jax_side("fits")
    (jts2, jm), raw = out[env]
    jcfg = _fit_cfg(env)
    ts2, m = ppo.fit_step(_port(jcfg), envs.make(env), states[env],
                          _as_fit_draws(jcfg, raw))
    fit_close(ts2, m, jts2, jm)


EVAL_CASES = ((False, "completed"), (False, "reference"), (True, "completed"))


EVAL_CFG = _jcfg("cartpole", eval_len=120)


def _eval_program(params):
    """The evaluator cases' JAX side: cartpole's evaluate of key 11 in
    each case, and the draws."""
    jenv, key = jenvs.make("cartpole"), jax.random.PRNGKey(11)
    return (tuple(jppo.evaluate(EVAL_CFG.replace(eval_estimator=est), jenv,
                                params, key, backend="jnp",
                                deterministic=det)
                  for det, est in EVAL_CASES),
            _loop_draws(jenv, EVAL_CFG.eval_envs, EVAL_CFG.eval_len, key))


@functools.lru_cache(maxsize=None)
def _jax_side(family):
    """One family's JAX side (the env loops, the fits or the evaluators)
    as one jitted program, compiled once for the file (one program for
    all three compiles slower than three); its params from
    :func:`shared_start` (loops seed 1, fits seed 2, evaluators seed
    3).  Returns (port states, outputs)."""
    if family == "loops":
        starts = {env: shared_start(_loop_cfg(env), 1) for env in LOOP_ENVS}
        program, take = _loop_program, (lambda j: j.policy_params)
    elif family == "fits":
        starts = {env: shared_start(_fit_cfg(env), 2) for env in LOOP_ENVS}
        program, take = _fit_program, (lambda j: j)
    else:
        starts = {"cartpole": shared_start(EVAL_CFG, 3)}
        program = lambda p: _eval_program(p["cartpole"])  # noqa: E731
        take = (lambda j: j.policy_params)
    out = jax.jit(program)({k: take(j) for k, (_, j) in starts.items()})
    return {k: ts for k, (ts, _) in starts.items()}, jax.device_get(out)


@pytest.mark.parametrize("deterministic,estimator", EVAL_CASES)
def test_jnp_evaluate_matches_jax(deterministic, estimator, no_kernel):
    states, (evals, raw) = _jax_side("evals")
    ts = states["cartpole"]
    want = evals[EVAL_CASES.index((deterministic, estimator))]
    jcfg = _jcfg("cartpole", eval_len=120, eval_estimator=estimator)
    got = ppo.evaluate(_port(jcfg), envs.make("cartpole"), ts.policy_params,
                       _as_loop_draws("cartpole", raw, deterministic),
                       deterministic=deterministic)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], rtol=1e-4)


def test_draws_follow_the_route():
    """draw_fit / draw_eval: K1's seed words where a lane serves the
    stochastic rollout, the env loop's LoopDraws (with noise) elsewhere."""
    g = torch.Generator().manual_seed(0)
    for kw, loop in ((dict(), False), (dict(kernel_backend="jnp"), True),
                     (dict(n_experts=2), True),
                     (dict(obs_loc=(0.0,) * 3, obs_scale=(2.0,) * 3), True)):
        cfg = _port(_jcfg(kernel_backend="pallas")).replace(**kw)
        env = envs.make_for(cfg)
        assert ppo.uses_rollout_kernel(cfg, env) is not loop
        d = ppo.draw_fit(cfg, g, "cpu", env)
        assert (d.seed is None) is loop and (d.seq is not None) is loop
        if loop:
            assert d.seq.noise.shape == (cfg.rollout_len, cfg.n_envs, 1)
        ev = ppo.draw_eval(cfg, env, g, "cpu")
        assert isinstance(ev, ppo.LoopDraws) is loop
        det = ppo.draw_eval(cfg, env, g, "cpu", deterministic=True)
        assert det.noise is None


def test_jnp_trainer_on_cpu(no_kernel):
    cfg = _port(_jcfg(fits_per_epoch=2, eval_len=200))
    tr = Trainer(cfg, "cpu")
    assert tr.backend == "jnp"
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"]) and hist[0]["episodes"] > 0
    assert tr.state.opt_v.t == 2 * 2 * cfg.num_minibatches
    assert np.isfinite(tr.evaluate(deterministic=True).R)


# --- kernel_fit on each path ----------------------------------------------------

@pytest.mark.parametrize("kw,kernels", [
    (dict(kernel_backend="jnp"), []),
    (dict(n_experts=4), []),
    (dict(n_experts=4, moe_topk=2, kernel_backend="bf16"), []),
    (dict(obs_loc=(0.0,) * 3, obs_scale=(1.0,) * 3), ["K5", "K5", "K3", "K4"]),
    (dict(obs_loc=(0.0,) * 3, obs_scale=(1.0,) * 3, kernel_backend="bf16"),
     []),
    (dict(max_grad_norm=0.5, clip_value=0.2, target_kl=0.02, lr_anneal=True,
          ent_anneal=True), ["K1", "K5", "K5"]),
    (dict(clip_value=0.2), ["K1", "K5", "K5", "K4"]),
    (dict(target_kl=0.02), ["K1", "K5", "K5", "K3"]),
    (dict(env="cartpole", max_grad_norm=0.5), ["K1", "K5", "K5"]),
    (dict(env="cartpole", ent_anneal=True), ["K1", "K5", "K5", "K3"]),
])
def test_kernel_fit_follows_the_path(kw, kernels):
    """kernel_fit lists the kernels the path launches: no K1 for a mixture,
    an affine env or "jnp"; no K3/K4/K6 where a stabiliser gates a phase
    off; nothing at all under "jnp" or for a mixture."""
    cfg = PPOConfig(kernel_backend="pallas").replace(**kw)
    got = [k.kernel.split(" ")[0] for k in ppo.kernel_fit(cfg, OPTIN)]
    assert got == kernels


def test_widths_no_kernel_sees_are_not_refused():
    """2x1024 takes no variant of K1 or K5; under "jnp" or as a mixture
    no kernel of the path takes the widths, so the check passes."""
    wide = PPOConfig(hidden=(1024, 1024), kernel_backend="pallas")
    with pytest.raises(NotImplementedError, match="K1"):
        check_kernel_fit(wide, envs.make_for(wide), OPTIN)
    for kw in (dict(kernel_backend="jnp"), dict(n_experts=2)):
        cfg = wide.replace(**kw)
        check_kernel_fit(cfg, envs.make_for(cfg), OPTIN)

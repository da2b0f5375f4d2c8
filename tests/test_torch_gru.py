"""Port parity for the recurrent family: ppoc_tpu_torch/models/gru.py, the
GRU/LSTM branches of algo/recurrent.py and algo/ppo.py, and the partially
observable envs (envs/wrappers.mask_obs, stack_obs), against the JAX
package on the same inputs.  Mirrors tests/test_rnn.py.

Params come from the JAX package's init (carried across leaf by leaf);
rollout noise and reset states are the JAX rollout's own draws, taken
from its key stream as tests/test_torch_jnp_backend.py takes them; the
update's env-column streams are the JAX update's permutations.  The JAX
side of the sequence cases is one jitted program, compiled once for the
file.

Tolerances.  The cell and apply_seq rtol 1e-5 / atol 1e-6 (one float32
step, in the JAX package's order of terms).  Env steps exactly (the same
float32 operations).  Rollouts: class ids and done flags exactly, float
planes rtol 1e-4 / atol 1e-5; value planes atol 1e-5; replayed log-probs
against stored ones rtol 1e-4 / atol 1e-5 (tests/test_torch_recurrent.py).
The fit: weights and first Adam moments rtol 1e-4 / atol 1e-5, second
moments rtol 1e-3 / atol 1e-7, metrics rtol 1e-4 / atol 1e-6
(tests/test_torch_jnp_backend.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo, recurrent as jrec
from ppoc_tpu.envs import core as jcore
from ppoc_tpu.models import gru as jgru
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo, recurrent
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.envs import wrappers
from ppoc_tpu_torch.envs.cartpole import CartPoleState
from ppoc_tpu_torch.envs.pendulum import PendulumState
from ppoc_tpu_torch.envs.recall import RecallState
from ppoc_tpu_torch.models import gru
from ppoc_tpu_torch.ops import cuda_rollout
from ppoc_tpu_torch.utils import params as conv
from test_torch_jnp_backend import _loop_draws, fit_close, no_kernel  # noqa

torch.set_num_threads(1)

CELL_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
STATE = {"recall": RecallState, "cartpole_po": CartPoleState,
         "pendulum_po": PendulumState, "pendulum": PendulumState,
         "cartpole": CartPoleState}


def _jcfg(env="recall", cell="gru", **kw):
    base = dict(env=env, n_envs=8, rollout_len=12, minibatch_size=24,
                n_epochs_value=2, n_epochs_policy=2, fits_per_epoch=1,
                eval_envs=8, eval_len=12, hidden=(16,), rnn_hidden=8,
                rnn_cell=cell, lr_policy=1e-3, lr_v=1e-3, ent_coeff=0.01,
                kernel_backend="jnp")
    base.update(kw)
    return JPPOConfig(**base)


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


# --- the cell -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model_side():
    """The cell cases' JAX side, one program: per kind, the init of key 0
    (obs 3, H 5, head (5, 4, 2)), one cell step and one masked window."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((7, 10)).astype(np.float32)
    x = rng.standard_normal((7, 3)).astype(np.float32)
    xs = rng.standard_normal((6, 5, 3)).astype(np.float32)
    done = rng.random((6, 5)) < 0.25
    done[2] = True                       # every lane ends at step 2

    def program(h, x, xs, done):
        out = {}
        for kind in ("gru", "lstm"):
            p = jgru.init(jax.random.PRNGKey(0), 3, 5, (5, 4, 2), cell=kind)
            s = h[:, :jgru.state_size(p)]
            out[kind] = (p, jgru.cell_step(p, s, x),
                         jgru.step(p, s, x, "tanh"),
                         jgru.apply_seq(p, xs, done, "relu"))
        return out

    out = jax.device_get(jax.jit(program)(h, x, xs, done))
    return (h, x, xs, done), out


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_cell_and_window_match_jax(kind):
    """cell_step, step and the masked apply_seq on the JAX package's
    params and the same inputs; after a done the outputs equal a replay
    from a fresh state (no memory leaks across the boundary), and without
    the mask they differ (memory flows)."""
    (h, x, xs, done), out = _model_side()
    jp, want_cell, (want_h, want_out), want_seq = out[kind]
    p = conv.trunk_from_numpy(jp, "cpu")
    assert gru.cell_kind(p) == kind and gru.state_size(p) == (
        10 if kind == "lstm" else 5)
    s = torch.from_numpy(h[:, :gru.state_size(p)])
    np.testing.assert_allclose(gru.cell_step(p, s, torch.from_numpy(x)),
                               want_cell, **CELL_TOL)
    h2, o = gru.step(p, s, torch.from_numpy(x), "tanh")
    np.testing.assert_allclose(h2, want_h, **CELL_TOL)
    np.testing.assert_allclose(o, want_out, **CELL_TOL)
    ys = gru.apply_seq(p, torch.from_numpy(xs), torch.from_numpy(done),
                       "relu")
    np.testing.assert_allclose(ys, want_seq, **CELL_TOL)
    fresh = gru.apply_seq(p, torch.from_numpy(xs[3:]),
                          torch.from_numpy(done[3:]), "relu")
    np.testing.assert_allclose(ys[3:], fresh, rtol=1e-6, atol=1e-7)
    nomask = gru.apply_seq(p, torch.from_numpy(xs),
                           torch.zeros(done.shape, dtype=torch.bool), "relu")
    assert not torch.allclose(nomask[3:], fresh)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_init_has_the_jax_layout_and_bounds(kind):
    """The port's own init: the JAX tree, shapes and leaf order; every
    draw inside the JAX bounds; an LSTM's forget bias shifted by +1."""
    _, out = _model_side()
    jp = out[kind][0]
    p = gru.init(3, 5, (5, 4, 2), torch.Generator().manual_seed(1), "cpu",
                 cell=kind)
    mine = jax.tree_util.tree_flatten_with_path(conv.tree_to_numpy(p))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [(jax.tree_util.keystr(k), np.shape(v)) for k, v in mine] == [
        (jax.tree_util.keystr(k), np.shape(v)) for k, v in theirs]
    g = 4 if kind == "lstm" else 3
    bound = np.sqrt(3.0) * np.sqrt(2.0 / (5 + g * 5))
    assert float(p["cell"]["wh"].abs().max()) <= bound
    b = p["cell"]["b"].clone()
    if kind == "lstm":
        assert bool((b[5:10] > 1.0 - 1.0 / np.sqrt(3.0)).all())
        b[5:10] -= 1.0
    assert float(b.abs().max()) <= 1.0 / np.sqrt(3.0)
    with pytest.raises(ValueError, match="gru' or 'lstm"):
        gru.init(3, 5, (5, 2), torch.Generator(), "cpu", cell="elman")


# --- the partially observable envs --------------------------------------------

PO_ENVS = ("pendulum_po", "cartpole_po", "pendulum_po_stack")


def _port_state(env, js):
    """A JAX env state (the stacked env's: (inner, window)) as the
    port's."""
    if env == "pendulum_po_stack":
        inner, window = js
        cls = wrappers._stacked_type(PendulumState)
        return cls(*(_t(getattr(inner, f)) for f in PendulumState._fields),
                   _t(window))
    cls = STATE[env]
    return cls(*(_t(getattr(js, f)) for f in cls._fields))


@pytest.mark.parametrize("env", PO_ENVS)
def test_po_env_specs_and_steps_match_jax(env):
    """Spec field for field; 50 autoreset steps of random actions, each
    from the JAX package's state and with its reset states: flags exactly,
    floats as tests/test_torch_envs.py holds the base envs (rtol 1e-5 /
    atol 1e-6; sin and cos may part in the last bit); the stacked window
    starts as the first frame repeated and shifts the newest frame in
    last."""
    jenv, penv = jenvs.make(env), envs.make(env)
    assert dataclasses.asdict(penv.spec) == dataclasses.asdict(jenv.spec)
    assert env not in cuda_rollout.SUPPORTED
    n, spec = 16, jenv.spec
    rng = np.random.default_rng(3)
    keys = jax.random.split(jax.random.PRNGKey(4), 51)
    jstep = jax.jit(lambda s, a, k: jcore.vector_autoreset_step(
        jenv, s, a, k) + jcore.vector_reset(jenv, jax.random.split(k)[1], n))
    js, jobs = jcore.vector_reset(jenv, keys[0], n)
    state, obs = penv.reset(n, torch.Generator().manual_seed(0), "cpu")
    assert type(state) is type(_port_state(env, js))
    if env == "pendulum_po_stack":
        w = state.window
        assert torch.equal(w, w[:, :1].expand_as(w))
        assert torch.equal(obs, w.reshape(n, -1))
    ends = 0
    for t in range(50):
        if spec.discrete:
            a = rng.integers(0, spec.action_dim, (n, 1)).astype(np.int32)
        else:
            a = rng.uniform(-2, 2, (n, spec.action_dim)).astype(np.float32)
        js0 = js
        js, jobs2, jnext, jr, jterm, jtrunc, fs, fo = jstep(
            js, jnp.asarray(a), keys[t + 1])
        state, obs2, nxt, r, term, trunc = envs.vector_autoreset_step(
            penv, _port_state(env, js0), torch.from_numpy(a),
            (_port_state(env, fs), _t(fo)))
        for got, want in ((term, jterm), (trunc, jtrunc)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in ((obs2, jobs2), (nxt, jnext), (r, jr),
                          *zip(state, jax.tree.leaves(js))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        if env == "pendulum_po_stack":
            kept = ~(term | trunc)
            assert torch.equal(state.window[kept, :-1],
                               _t(jobs).reshape(n, 4, 2)[kept, 1:])
        ends += int((term | trunc).sum())
        jobs = jobs2
    assert ends > 0 or env != "cartpole_po"


# --- rollout, values, the fit ---------------------------------------------------

# (env, cell, JAX init seed); each also runs a fit on JAX's own columns
SEQ_CASES = (("recall", "gru", 1), ("recall", "lstm", 2),
             ("cartpole_po", "gru", 3))


def _case_cfg(env, cell):
    return _jcfg(env, cell, eval_len=500 if env == "cartpole_po" else 12)


def _columns(jcfg, key, n_epochs):
    """value_phase_rnn's / policy_phase_rnn's env columns from ``key``,
    traceable: one permutation of the env axis per epoch key."""
    seqs, n_mb = jrec.seq_minibatch_plan(jcfg.n_envs, jcfg.rollout_len,
                                         jcfg.minibatch_size)
    return jax.vmap(lambda k: jax.random.permutation(k, jcfg.n_envs)[
        : n_mb * seqs].reshape(n_mb, seqs))(jax.random.split(key, n_epochs))


@functools.lru_cache(maxsize=None)
def _seq_side():
    """The sequence cases' JAX side, one program: per case its TrainState,
    the rollout of key 7 and its draws, the value planes, and one
    update_step of key 6 on that rollout with its columns; recall-gru's
    evaluations (key 11, stochastic and the mean policy) too."""
    def program():
        out = {}
        for env, cell, seed in SEQ_CASES:
            jcfg, jenv = _case_cfg(env, cell), jenvs.make(env)
            ts = jppo.init_train_state(jcfg, jenv, jax.random.PRNGKey(seed))
            key = jax.random.PRNGKey(7)
            traj, _ = jrec.rollout_rnn(jcfg, jenv, ts.policy_params, key,
                                       jcfg.n_envs, jcfg.rollout_len)
            vals = jrec.compute_values_rnn(jcfg, ts.v_params, traj)
            k_upd = jax.random.PRNGKey(6)
            k_val, k_pol = jax.random.split(k_upd)
            fit = jppo.update_step(jcfg, jenv, ts, traj, k_upd,
                                   backend="jnp")
            out[f"{env}-{cell}"] = (ts, traj, vals, fit,
                              _loop_draws(jenv, jcfg.n_envs,
                                          jcfg.rollout_len, key),
                              (_columns(jcfg, k_val, jcfg.n_epochs_value),
                               _columns(jcfg, k_pol, jcfg.n_epochs_policy)))
        jcfg, jenv = _case_cfg("recall", "gru"), jenvs.make("recall")
        pol = out["recall-gru"][0].policy_params
        key = jax.random.PRNGKey(11)
        out["evals"] = (tuple(jppo.evaluate(jcfg, jenv, pol, key, "jnp",
                                            deterministic=d)
                              for d in (False, True)),
                        _loop_draws(jenv, jcfg.eval_envs, jcfg.eval_len,
                                    key))
        return out

    return jax.device_get(jax.jit(program)())


def _draws(env, raw, deterministic=False):
    (js, jobs), (fs, fo), noise = raw
    return recurrent.SeqDraws((_port_state(env, js), _t(jobs)),
                              (_port_state(env, fs), _t(fo)),
                              None if deterministic else _t(noise))


def _traj_close(got, want):
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        if a.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def _case(env, cell):
    ts, traj, vals, fit, raw, cols = _seq_side()[f"{env}-{cell}"]
    return (conv.train_state_from_numpy(ts, "cpu"),
            ppo.Transition(*(_t(x) for x in traj)), vals, fit, raw, cols)


CASE_IDS = [f"{e}-{c}" for e, c, _ in SEQ_CASES]


@pytest.mark.parametrize("env,cell", [c[:2] for c in SEQ_CASES],
                         ids=CASE_IDS)
def test_rollout_rnn_matches_jax(env, cell, no_kernel):
    """The GRU/LSTM rollout on the JAX rollout's draws: obs, actions,
    stored log-probs, rewards and flags, the state zeroed in finished
    lanes; through ppo.rollout, with no kernel wrapper called."""
    ts, want, _, _, raw, _ = _case(env, cell)
    cfg = _port(_case_cfg(env, cell))
    got, _, vpair = ppo.rollout(cfg, envs.make(env), ts.policy_params,
                                _draws(env, raw), cfg.n_envs,
                                cfg.rollout_len, v_params=ts.v_params)
    _traj_close(got, want)
    assert vpair is None
    if env == "recall":
        assert bool(got.terminated[:-1].any())


@pytest.mark.parametrize("env,cell", [c[:2] for c in SEQ_CASES],
                         ids=CASE_IDS)
def test_values_and_replay_match(env, cell):
    """compute_values_rnn against the JAX package's on its trajectory
    (V(s'_t) from the state after s_t, the mask after both); the update's
    replay recomputes the stored log-probs (epoch-0 ratios 1)."""
    ts, traj, want, _, _, _ = _case(env, cell)
    cfg = _port(_case_cfg(env, cell))
    got = recurrent.compute_values_rnn(cfg, ts.v_params, traj, "jnp")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    logp, _ = recurrent.policy_log_probs_rnn(
        cfg, ts.policy_params, traj.obs, traj.action,
        traj.terminated | traj.truncated, envs.make(env).spec.discrete,
        "jnp")
    np.testing.assert_allclose(logp, traj.log_prob, **TOL)


@pytest.mark.parametrize("env,cell", [c[:2] for c in SEQ_CASES],
                         ids=CASE_IDS)
def test_update_step_matches_jax(env, cell, no_kernel):
    """One whole update_step of the GRU/LSTM branch -- the value planes,
    the doubling-scan GAE with Welford moments, both phases by
    backpropagation through time -- against ppoc_tpu's on the same
    trajectory and env columns."""
    ts, traj, _, (jts2, jm), _, (cv, cp) = _case(env, cell)
    draws = ppo.FitDraws(None, _t(cv, torch.int64), _t(cp, torch.int64))
    ts2, m = ppo.update_step(_port(_case_cfg(env, cell)), envs.make(env),
                             ts, traj, draws, None)
    fit_close(ts2, m, jts2, jm)


@pytest.mark.parametrize("deterministic", [False, True])
def test_evaluate_matches_jax(deterministic, no_kernel):
    """evaluate() of a GRU policy runs the cell loop either way, never
    K1, as the JAX package's evaluate does."""
    ts, *_ = _case("recall", "gru")
    evals, raw = _seq_side()["evals"]
    got = ppo.evaluate(_port(_case_cfg("recall", "gru")), envs.make("recall"),
                       ts.policy_params, _draws("recall", raw, deterministic),
                       deterministic=deterministic)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in evals[int(deterministic)]],
                               rtol=1e-5)


# --- the trainer ----------------------------------------------------------------

@pytest.mark.filterwarnings("ignore:eval_len")
@pytest.mark.parametrize("env", ["recall", "pendulum_po", "cartpole_po"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_trainer_trains_every_po_env(env, cell, no_kernel):
    """Trainer with a GRU or LSTM trunk on each env the JAX package runs
    them on: the "jnp" backend whatever the config asks, an epoch and both
    evaluations with no kernel wrapper called, no kernel on the path."""
    cfg = _port(_jcfg(env, cell, eval_len=12, kernel_backend="pallas"))
    tr = Trainer(cfg, "cpu")
    assert tr.backend == "jnp" and ppo.kernel_fit(cfg, 232448) == []
    assert not ppo.uses_rollout_kernel(cfg, tr.env)
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"])
    seqs, n_mb = recurrent.seq_minibatch_plan(8, 12, 24)
    assert tr.state.opt_v.t == 2 * n_mb and tr.state.opt_policy.t == 2 * n_mb
    ev = tr.evaluate(deterministic=True)
    assert ev.episodes >= 0


def test_recall_differentiator():
    """The capability the family exists for (tests/test_rnn.py): on recall
    the GRU solves (R > 0.9 within 6 epochs) where the best memoryless
    policy stays a coin flip."""
    base = PPOConfig(env="recall", n_envs=128, rollout_len=6,
                     minibatch_size=192, fits_per_epoch=8, eval_envs=256,
                     eval_len=6, kernel_backend="jnp", hidden=(32,),
                     seed=0, lr_policy=1e-3, lr_v=1e-3)
    mlp_hist = Trainer(base, "cpu").train(n_epochs=4, log=False)
    rnn_hist = Trainer(base.replace(rnn_hidden=16), "cpu").train(
        n_epochs=6, log=False, stop_at_R=0.9)
    assert max(h["R"] for h in mlp_hist) < 0.75
    assert rnn_hist[-1]["R"] > 0.9


def test_po_stack_fit_step_matches_jax_pallas(monkeypatch):
    """pendulum_po_stack, the memoryless route, under "pallas": no rollout
    lane takes it (K1 is never called), so the env loop runs through K5's
    plain version, then the two whole-buffer V forwards, K2, K3 and K4
    (their plain versions), against the JAX package's fit with its
    kernels in interpret mode."""
    from ppoc_tpu_torch.ops import cuda_update
    from test_torch_jnp_backend import _fit_draws, shared_start

    def refuse(*a, **k):
        raise AssertionError("K1 was called for pendulum_po_stack")

    monkeypatch.setattr(cuda_rollout, "rollout_fused", refuse)
    jcfg = JPPOConfig(env="pendulum_po_stack", n_envs=8, rollout_len=16,
                      minibatch_size=32, n_epochs_value=1, n_epochs_policy=1,
                      fits_per_epoch=1, eval_envs=8, eval_len=40,
                      hidden=(16, 16), kernel_backend="pallas")
    ts, jts = shared_start(jcfg, 4)
    jenv = jenvs.make(jcfg.env)

    def program(state):
        key = jax.random.PRNGKey(5)
        return (jppo.fit_step(jcfg, jenv, state, key, backend="pallas"),
                _fit_draws(jcfg, jenv, key))

    (jts2, jm), ((s_val, s_pol), loop) = jax.device_get(
        jax.jit(program)(jts))
    calls = []
    for name in ("value_phase", "policy_phase"):
        real = getattr(cuda_update, name)
        monkeypatch.setattr(cuda_update, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    draws = ppo.FitDraws(
        None, *(_t(s, torch.int64).reshape(n, jcfg.num_minibatches, -1)
                for s, n in ((s_val, 1), (s_pol, 1))),
        _draws(jcfg.env, loop))
    ts2, m = ppo.fit_step(_port(jcfg), envs.make(jcfg.env), ts, draws)
    assert calls == ["value_phase", "policy_phase"]
    fit_close(ts2, m, jts2, jm)


def test_config_validation():
    """The JAX package's refusals for a recurrent config, by message."""
    for kw, match in ((dict(reset_per_fit=False), "reset_per_fit"),
                      (dict(n_experts=4), "cannot combine"),
                      (dict(tp_size=2), "cannot combine")):
        with pytest.raises(ValueError, match=match):
            Trainer(PPOConfig(env="recall", rnn_hidden=8, **kw), "cpu")

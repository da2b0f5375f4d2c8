"""Port parity for the attention sequence path: the recall envs, the
KV-cache decode rollout, the value planes, the replayed log-probs, one
whole update_step and the carried-across train state, each against the
JAX package on the same inputs: parameters from its init, noise and reset
states drawn with ``jax.random`` from its own rollout keys, env-column
streams from its own update keys.

Tolerances.  Env steps exactly (the same float32 comparisons).  Rollouts:
class ids and done flags exactly, float planes rtol 1e-4 / atol 1e-5 (as
tests/test_torch_rollout.py).  Value planes atol 1e-5.  Replayed
log-probs against stored ones rtol 1e-4 / atol 1e-5 (as
tests/test_attn.py: decode and replay sum in another order).  The fit:
weights and Adam first moments rtol 1e-4 / atol 1e-5, second moments rtol
1e-3 / atol 1e-7, metrics rtol 1e-4 (as tests/test_torch_trainer.py); the
attention key bias, whose gradient is 0 in exact arithmetic, is held as
``_fit_leaves_close`` says.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo, recurrent as jrec
from ppoc_tpu.envs import core as jcore, recall as jrecall
from ppoc_tpu.models import attn as jattn
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo, recurrent
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.envs import cartpole, pendulum, recall
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-7)
STATE = {"recall": recall.RecallState, "cartpole": cartpole.CartPoleState,
         "cartpole_po": cartpole.CartPoleState,
         "pendulum_po": pendulum.PendulumState}


def _jcfg(env="recall", **kw):
    base = dict(env=env, n_envs=8, rollout_len=12, minibatch_size=24,
                n_epochs_value=2, n_epochs_policy=1, fits_per_epoch=1,
                eval_envs=8, eval_len=12, hidden=(16,), attn_dim=16,
                attn_layers=1, attn_heads=2, lr_policy=1e-3, lr_v=1e-3,
                kernel_backend="pallas")
    base.update(kw)
    return JPPOConfig(**base)


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


def _jts(env="recall", seed=0, **kw):
    jcfg = _jcfg(env, **kw)
    jts = jppo.init_train_state(jcfg, jenvs.make(env),
                                jax.random.PRNGKey(seed))
    return jcfg, jts, conv.train_state_from_numpy(jax.device_get(jts), "cpu")


def _pstate(env, js):
    return STATE[env](*(torch.tensor(np.asarray(x)) for x in js))


def jax_seq_draws(env, n, L, key, deterministic=False):
    """The start states, reset states and action noise that the JAX
    package's rollout_rnn draws from ``key``: split -> (reset, scan); per
    step split -> (act, env); the action noise is normal(k_act) or, for
    jax.random.categorical, gumbel(k_act); the autoreset's states come
    from the second half of split(k_env)."""
    jenv = jenvs.make(env)
    spec = jenv.spec
    k_reset, k_scan = jax.random.split(key)
    js, jobs = jcore.vector_reset(jenv, k_reset, n)
    fresh_s, fresh_o, noise = [], [], []
    for k_t in jax.random.split(k_scan, L):
        k_act, k_env = jax.random.split(k_t)
        draw = jax.random.gumbel if spec.discrete else jax.random.normal
        noise.append(np.asarray(draw(k_act, (n, spec.action_dim))))
        fs, fo = jcore.vector_reset(jenv, jax.random.split(k_env)[1], n)
        fresh_s.append(jax.device_get(fs))
        fresh_o.append(np.asarray(fo))
    cls = STATE[env]
    fstate = cls(*(torch.tensor(np.stack([np.asarray(getattr(s, f))
                                          for s in fresh_s]))
                   for f in cls._fields))
    return recurrent.SeqDraws(
        (_pstate(env, js), torch.tensor(np.asarray(jobs))),
        (fstate, torch.tensor(np.stack(fresh_o))),
        None if deterministic else torch.tensor(np.stack(noise)))


def _traj_close(got, want):
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        if a.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


# --- recall -------------------------------------------------------------------

@pytest.mark.parametrize("name,horizon", [
    ("recall", 6), ("recall_long", 512), ("recall_xl", 1024),
    ("recall_xxl", 2048), ("recall_4k", 4096), ("recall_8k", 8192),
    ("recall_16k", 16384)])
def test_recall_variants_match_jax_specs(name, horizon):
    spec, jspec = envs.make(name).spec, jenvs.make(name).spec
    assert spec.horizon == horizon
    for f in ("name", "obs_dim", "action_dim", "horizon", "gamma",
              "action_low", "action_high"):
        assert getattr(spec, f) == getattr(jspec, f)
    assert not spec.discrete


def test_recall_step_matches_jax():
    rng = np.random.default_rng(0)
    n = 64
    b = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    t = rng.integers(0, 7, n).astype(np.int32)
    act = rng.standard_normal((n, 1)).astype(np.float32)
    js = jrecall.RecallState(jnp.asarray(b), jnp.asarray(t))
    want = jax.vmap(jrecall._step)(js, jnp.asarray(act),
                                   jax.random.split(jax.random.PRNGKey(0), n))
    got = envs.make("recall").step(recall.RecallState(torch.tensor(b),
                                                      torch.tensor(t)),
                                   torch.tensor(act))
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_recall_reset_draws_a_cue_shown_once():
    s, obs = envs.make("recall").reset(4000, torch.Generator().manual_seed(0),
                                       "cpu")
    assert set(s.b.tolist()) == {-1.0, 1.0} and abs(float(s.b.mean())) < 0.05
    assert torch.equal(obs[:, 0], s.b) and (obs[:, 1] == 1).all()
    _, obs2, r, term, trunc = envs.make("recall").step(s, torch.ones(4000, 1))
    assert (obs2 == 0).all() and not term.any() and not trunc.any()


# --- rollout, values, replay ------------------------------------------------

@pytest.mark.parametrize("env,deterministic", [
    ("recall", False), ("cartpole", False), ("cartpole", True)])
def test_rollout_rnn_matches_jax(env, deterministic):
    """The decode rollout on the JAX rollout's own draws: obs, actions,
    stored log-probs, rewards and done flags; cartpole's class ids come
    from argmax(gumbel + logits), as jax.random.categorical draws them."""
    jcfg, jts, ts = _jts(env, seed=1)
    key = jax.random.PRNGKey(7)
    want, _ = jrec.rollout_rnn(jcfg, jenvs.make(env), jts.policy_params,
                               key, 8, 12, deterministic=deterministic)
    draws = jax_seq_draws(env, 8, 12, key, deterministic)
    got, (_, _, cache) = recurrent.rollout_rnn(
        _port(jcfg), envs.make(env), ts.policy_params, draws,
        deterministic=deterministic)
    _traj_close(got, want)
    assert cache["t"] == 12


def test_compute_values_rnn_matches_jax(monkeypatch):
    """V(s) through the flash path (FLASH_MIN_T lowered in both packages)
    and V(s') through decode_next, on a JAX trajectory with episode
    ends inside the window."""
    monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    jcfg, jts, ts = _jts("recall", seed=2)
    jtraj, _ = jrec.rollout_rnn(jcfg, jenvs.make("recall"),
                                jts.policy_params, jax.random.PRNGKey(3), 8,
                                12)
    want = jrec.compute_values_rnn(jcfg, jts.v_params, jtraj, "pallas")
    traj = ppo.Transition(*(torch.tensor(np.asarray(x)) for x in jtraj))
    assert traj.terminated[:-1].any()
    got = recurrent.compute_values_rnn(_port(jcfg), ts.v_params, traj,
                                       "pallas")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


TRUNKS = {"attn": dict(attn_dim=16, attn_layers=2, attn_heads=2),
          "gru": dict(rnn_hidden=8), "lstm": dict(rnn_hidden=8,
                                                  rnn_cell="lstm")}


@pytest.mark.parametrize("env,trunk", [
    pytest.param("recall", "attn", id="recall"),
    pytest.param("cartpole", "attn", id="cartpole"),
    pytest.param("recall", "gru", id="recall-gru"),
    pytest.param("cartpole_po", "gru", id="cartpole_po-gru"),
    pytest.param("recall", "lstm", id="recall-lstm"),
    pytest.param("pendulum_po", "lstm", id="pendulum_po-lstm")])
def test_replayed_log_probs_match_rollout(env, trunk):
    """The update's replay (the attention trunk's parallel pass, the
    GRU/LSTM time loop from a zero state) recomputes the log-probs the
    rollout stored: epoch-0 ratios are 1 to float noise."""
    cfg = PPOConfig(env=env, n_envs=16, rollout_len=12, minibatch_size=48,
                    hidden=(16,), eval_len=12, **TRUNKS[trunk])
    e = envs.make(env)
    g = torch.Generator().manual_seed(0)
    ts = ppo.init_train_state(cfg, e, g, "cpu")
    traj, _ = recurrent.rollout_rnn(
        cfg, e, ts.policy_params, recurrent.draw_seq(e, g, 16, 12, "cpu"))
    logp, _ = recurrent.policy_log_probs_rnn(
        cfg, ts.policy_params, traj.obs, traj.action,
        traj.terminated | traj.truncated, e.spec.discrete, "pallas")
    torch.testing.assert_close(logp, traj.log_prob, **TOL)


# --- the fit ------------------------------------------------------------------

def jax_columns(jcfg, key, n_epochs):
    """The env-column streams value_phase_rnn / policy_phase_rnn draw from
    ``key``: one permutation of the env axis per epoch key."""
    seqs, n_mb = jrec.seq_minibatch_plan(jcfg.n_envs, jcfg.rollout_len,
                                         jcfg.minibatch_size)
    return torch.stack([
        torch.tensor(np.asarray(jax.random.permutation(k, jcfg.n_envs)[
            : n_mb * seqs]).reshape(n_mb, seqs), dtype=torch.int64)
        for k in jax.random.split(key, n_epochs)])


def _get(tree, part):
    for name in part.split("."):
        tree = getattr(tree, name)
    return tree


def _fit_leaves_close(part, got, want, before, tol):
    """Leaf by leaf, except the key bias (bqkv[1]): its gradient is 0 in
    exact arithmetic (a bias on every key of a row shifts all the row's
    scores alike, and softmax ignores that), so each package's Adam steps
    it by its own normalised rounding noise, up to lr a step.  There both
    packages' first moments must stay at rounding size (1e-7, against
    1e-2 on the query and value biases), and each move within
    lr x steps."""
    leaves = jax.tree_util.tree_flatten_with_path(_get(want, part))[0]
    mine = jax.tree.leaves(_get(got, part))
    old = jax.tree.leaves(_get(before, part))
    assert len(leaves) == len(mine) == len(old)
    for (path, b), a, a0 in zip(leaves, mine, old):
        a, b, a0 = np.asarray(a), np.asarray(b), np.asarray(a0)
        where = part + jax.tree_util.keystr(path)
        if "bqkv" in where:
            if part.endswith(".m"):
                assert np.abs(a[1]).max() < 1e-7 and np.abs(b[1]).max() < 1e-7
            elif "params" in where:
                steps = int(_get(got, "opt_v" if part == "v_params"
                                 else "opt_policy").t)
                assert np.abs(a[1] - a0[1]).max() <= 1e-3 * steps
            a, b = a[[0, 2]], b[[0, 2]]
        np.testing.assert_allclose(a, b, err_msg=where, **tol)


def test_update_step_matches_jax(monkeypatch):
    """One whole update_step of the sequence branch -- value planes, jnp
    GAE + Welford normalisation, the value and policy phases through the
    flash path -- against ppoc_tpu's on the same trajectory and the same
    env-column streams."""
    monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    jcfg, jts, ts = _jts("recall", seed=4, ent_coeff=0.01)
    jenv = jenvs.make("recall")
    jtraj, _ = jrec.rollout_rnn(jcfg, jenv, jts.policy_params,
                                jax.random.PRNGKey(5), 8, 12)
    key = jax.random.PRNGKey(6)
    jts2, jm = jax.jit(lambda s, tr, k: jppo.update_step(
        jcfg, jenv, s, tr, k, backend="pallas"))(jts, jtraj, key)
    k_val, k_pol = jax.random.split(key)
    draws = ppo.FitDraws(None, jax_columns(jcfg, k_val, jcfg.n_epochs_value),
                         jax_columns(jcfg, k_pol, jcfg.n_epochs_policy))
    traj = ppo.Transition(*(torch.tensor(np.asarray(x)) for x in jtraj))
    ts2, m = ppo.update_step(_port(jcfg), envs.make("recall"), ts, traj,
                             draws, None)
    got = conv.train_state_to_numpy(ts2)
    want = jax.device_get(jts2)
    before = jax.device_get(jts)
    for part, tol in (("policy_params", TOL), ("v_params", TOL),
                      ("opt_policy.m", TOL), ("opt_v.m", TOL),
                      ("opt_log_std.m", TOL), ("opt_policy.v", V_TOL),
                      ("opt_v.v", V_TOL)):
        _fit_leaves_close(part, got, want, before, tol)
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(want.opt_v.t), int(want.opt_policy.t), int(want.opt_log_std.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)


def test_init_train_state_carries_across():
    """The JAX package's attention TrainState converts leaf by leaf and
    back; the port's own init has the same tree and shapes, positional
    tables of max(rollout_len, eval_len) + 1 rows."""
    jcfg, jts, ts = _jts("recall", eval_len=20)
    want = jax.device_get(jts)
    back = conv.train_state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    own = conv.train_state_to_numpy(ppo.init_train_state(
        _port(jcfg), envs.make("recall"), torch.Generator().manual_seed(0),
        "cpu"))

    def shapes(state):
        return [(jax.tree_util.keystr(k), np.shape(x)) for k, x in
                jax.tree_util.tree_flatten_with_path(tuple(state))[0]]

    assert shapes(own) == shapes(want)
    assert attn.window(ts.v_params) == 21
    assert attn.window(ts.policy_params["mlp"]) == 21


# --- the trainer ----------------------------------------------------------------

def test_attention_trainer_on_cpu(monkeypatch):
    """Trainer(attn_dim > 0) trains an epoch through the sequence path, the
    flash core engaged (FLASH_MIN_T lowered), and evaluates both ways;
    the Adam counts follow the column plan."""
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    cfg = _port(_jcfg(n_epochs_value=1, fits_per_epoch=2))
    tr = Trainer(cfg, "cpu")
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"]) and hist[0]["episodes"] == 16
    seqs, n_mb = recurrent.seq_minibatch_plan(8, 12, 24)
    assert tr.state.opt_v.t == 2 * 1 * n_mb
    assert tr.state.opt_policy.t == tr.state.opt_log_std.t == 2 * 1 * n_mb
    ev = tr.evaluate(deterministic=True)
    assert ev.episodes == 16 and 0.0 <= ev.R <= 1.0


@pytest.mark.parametrize("kw,match", [
    (dict(sp_size=2), "sp_size"),
    (dict(zero1=True), "zero1"), (dict(tp_size=2), "tp_size"),
    (dict(fit_dispatch="phased"), "fit_dispatch"),
    (dict(rollout_chunk=4), "rollout_chunk"),
    (dict(fits_per_program=1), "fits_per_program")])
def test_unported_sequence_options_are_refused(kw, match):
    cfg = dataclasses.replace(_port(_jcfg()), **kw)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        Trainer(cfg, "cpu")


def test_sequence_stabilizers_train(monkeypatch):
    """The stabilisers the sequence phases used to refuse train an epoch
    on the attention trunk (their parity: tests/test_torch_stabilizers.py)."""
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    cfg = dataclasses.replace(_port(_jcfg()), clip_value=0.2, target_kl=0.01,
                              max_grad_norm=0.5, lr_anneal=True)
    hist = Trainer(cfg, "cpu").train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"])


def test_bf16_sequence_trainer_is_ported():
    """kernel_backend="bf16" on an attention trunk: Trainer builds it,
    keeps "bf16" as its backend and trains an epoch (the sequence path's
    bf16 parity is tests/test_torch_bf16.py)."""
    cfg = dataclasses.replace(_port(_jcfg()), kernel_backend="bf16")
    tr = Trainer(cfg, "cpu")
    assert ppo.backend_of(tr.cfg) == "bf16"
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"])

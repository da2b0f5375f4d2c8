"""Port parity for the throughput path and the env-loop evaluators.

* Block shuffling: the port's gather_mb on the block ids the JAX package
  draws returns the JAX rows exactly.
* The fused-phase gate: K3/K4 at minibatch <= 2048, the generic phases
  (K5 forward and backward) above it.
* One whole fit_step on the generic path against the JAX package's
  ppo.fit_step(backend="pallas") (K1, K2 and K5 in interpret mode), on the
  same seed words and block streams: 32 envs x 128 steps, minibatch 4096 in
  blocks of 1024, hidden (32, 32), 2 value and 1 policy epoch.
* evaluate(deterministic=True) and eval_estimator="reference" against the
  JAX package's evaluate(backend="pallas"), with the randomness its key
  stream draws handed to the port: K1's seed words for the stochastic
  policy, the start and reset states for the mean policy's env loop.

Tolerances.  The fit: weights rtol 1e-4 / atol 1e-5 and metrics rtol
1e-4 / atol 1e-6, as tests/test_torch_trainer.py.  The Adam moments hold
gradients summed over 4096 rows: the value loss's terms are ~1e2 and
cancel, so float32 sums taken in another order differ by ~3e-5 of the
leaf's largest magnitude (measured: the weights still agree to 2e-7).  So
the first moments are held at rtol 1e-4, the second at rtol 1e-3, each
with atol 1e-3 of that leaf's largest magnitude.  The evaluations: rtol
1e-4 on J and R over 250 steps of closed-loop pendulum physics, and the
episode counts exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.data import buffer as jbuffer
from ppoc_tpu.envs import core as jcore
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer, score
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs.pendulum import PendulumState
from ppoc_tpu_torch.ops import cuda_update
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-4, atol=1e-5)
JENV, ENV = jenvs.make("pendulum"), envs.make("pendulum")


def _jcfg(**kw):
    base = dict(env="pendulum", n_envs=32, rollout_len=128,
                minibatch_size=4096, shuffle_block=1024, n_epochs_value=2,
                n_epochs_policy=1, fits_per_epoch=1, eval_envs=8,
                eval_len=250, hidden=(32, 32), kernel_backend="pallas")
    base.update(kw)
    return JPPOConfig(**base)


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


def _ids(x):
    return torch.tensor(np.asarray(x), dtype=torch.int64)


def test_gather_mb_returns_the_jax_block_rows():
    n_rows, n_mb, mb, blk = 4096, 2, 1024, 256
    rng = np.random.default_rng(0)
    cols = (rng.normal(size=(n_rows, 3)).astype(np.float32),
            rng.normal(size=(n_rows,)).astype(np.float32))
    idx = jbuffer.block_permutation_minibatches(jax.random.PRNGKey(5), n_rows,
                                                n_mb, mb, blk)
    assert idx.shape == (n_mb, mb // blk)
    for j in range(n_mb):
        want = jbuffer.gather_mb(cols, idx[j], blk)
        got = buffer.gather_mb(tuple(map(torch.tensor, cols)), _ids(idx[j]),
                               blk)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_block_permutation_deals_every_row_once():
    g = torch.Generator().manual_seed(0)
    ids = buffer.block_permutation_minibatches(g, 4096, 3, 1024, 256)
    assert ids.shape == (3, 4)
    assert len(set(ids.reshape(-1).tolist())) == 12
    rows, = buffer.gather_mb((torch.arange(4096),), ids, 256)
    assert len(set(rows.tolist())) == 3 * 1024
    with pytest.raises(ValueError, match="must divide"):
        buffer.block_permutation_minibatches(g, 4096, 3, 1000, 256)


@pytest.mark.parametrize("mb,fused", [(2048, True), (4096, False)])
def test_fused_gate_follows_the_jax_package(monkeypatch, mb, fused):
    """K3/K4 run exactly at minibatch <= 2048; above it the generic phases
    run and the whole-phase kernels are not called."""
    cfg = PPOConfig(env="pendulum", n_envs=32, rollout_len=128,
                    minibatch_size=mb, n_epochs_value=1, n_epochs_policy=1,
                    hidden=(8, 8))
    calls = []
    for name in ("value_phase", "policy_phase"):
        real = getattr(cuda_update, name)
        monkeypatch.setattr(cuda_update, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    ts = ppo.init_train_state(cfg, ENV, torch.Generator().manual_seed(0),
                              "cpu")
    ts2, _ = ppo.fit_step(cfg, ENV, ts, ppo.draw_fit(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    assert calls == (["value_phase", "policy_phase"] if fused else [])
    assert ts2.opt_v.t == cfg.num_minibatches


def jax_seed_words(key):
    """K1's two seed words for a rollout key: its fold_in(key, 0) key
    data."""
    kd = jax.random.fold_in(key, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)
    return int(w[0]), int(w[1])


def jax_fit_draws(cfg, key):
    """The seed words and block-id streams JAX's fit_step derives from its
    key (see tests/test_torch_trainer.py)."""
    k_roll, k_upd = jax.random.split(key)
    k_val, k_pol = jax.random.split(k_upd)

    def stream(k, n_epochs):
        flat, _ = jpu._stream_ids(cfg, k, cfg.steps_per_fit,
                                  cfg.num_minibatches, cfg.minibatch_size,
                                  n_epochs)
        return _ids(flat).reshape(n_epochs, cfg.num_minibatches, -1)

    return ppo.FitDraws(jax_seed_words(k_roll),
                        stream(k_val, cfg.n_epochs_value),
                        stream(k_pol, cfg.n_epochs_policy))


def test_generic_fit_step_matches_jax_pallas_fit_step():
    jcfg = _jcfg()
    assert jcfg.minibatch_size > ppo.MAX_FUSED_MB
    jts = jppo.init_train_state(jcfg, JENV, jax.random.PRNGKey(0))
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    key = jax.random.PRNGKey(42)
    jts2, jm = jax.jit(lambda s, k: jppo.fit_step(
        jcfg, JENV, s, k, backend="pallas"))(jts, key)
    draws = jax_fit_draws(jcfg, key)
    assert draws.value_idx.shape == (2, 1, 4)
    ts2, m = ppo.fit_step(_port(jcfg), ENV, ts, draws)
    got = conv.train_state_to_numpy(ts2)
    want = jax.device_get(jts2)
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
                                       atol=1e-3 * np.abs(b).max())
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(want.opt_v.t), int(want.opt_policy.t), int(want.opt_log_std.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)


def _pstate(js):
    return PendulumState(*(torch.tensor(np.asarray(f)) for f in js))


def jax_eval_draws(cfg, key, deterministic):
    """What the JAX package's evaluate(backend="pallas") draws from
    ``key``.  Stochastic: K1's seed words.  The mean policy's env loop
    (algo/ppo.py rollout): split -> reset, scan keys; per step split ->
    action, env; env -> step, reset."""
    if not deterministic:
        return jax_seed_words(key)
    E, T = cfg.eval_envs, cfg.eval_len
    k_reset, k_scan = jax.random.split(key)
    js, jobs = jcore.vector_reset(JENV, k_reset, E)
    fresh_s, fresh_o = [], []
    for k_t in jax.random.split(k_scan, T):
        _, k_env = jax.random.split(k_t)
        _, k_rst = jax.random.split(k_env)
        fs, fo = jcore.vector_reset(JENV, k_rst, E)
        fresh_s.append(fs)
        fresh_o.append(np.asarray(fo))
    fstate = PendulumState(*(torch.tensor(np.stack([np.asarray(
        getattr(s, f)) for s in fresh_s])) for f in PendulumState._fields))
    return ppo.LoopDraws((_pstate(js), torch.tensor(np.asarray(jobs))),
                         (fstate, torch.tensor(np.stack(fresh_o))))


@pytest.mark.parametrize("estimator,deterministic", [
    ("completed", True), ("reference", False), ("reference", True)])
def test_evaluate_matches_jax(estimator, deterministic):
    jcfg = _jcfg(eval_estimator=estimator)
    jts = jppo.init_train_state(jcfg, JENV, jax.random.PRNGKey(3))
    pp = conv.train_state_from_numpy(jax.device_get(jts), "cpu").policy_params
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, k: jppo.evaluate(
        jcfg, JENV, p, k, backend="pallas",
        deterministic=deterministic))(jts.policy_params, key)
    cfg = _port(jcfg)
    got = ppo.evaluate(cfg, ENV, pp, jax_eval_draws(cfg, key, deterministic),
                       deterministic=deterministic)
    assert float(got.episodes) == float(want.episodes)
    np.testing.assert_allclose([float(got.J), float(got.R)],
                               [float(want.J), float(want.R)], rtol=1e-4)


def test_env_loop_rollout_matches_jax_trajectory():
    """The mean-policy window step for step: actions, log-probs, rewards
    and the done flags of the resets inside the 250-step window."""
    jcfg = _jcfg()
    jts = jppo.init_train_state(jcfg, JENV, jax.random.PRNGKey(4))
    pp = conv.train_state_from_numpy(jax.device_get(jts), "cpu").policy_params
    key = jax.random.PRNGKey(12)
    jtraj, _ = jax.jit(lambda p, k: jppo.rollout(
        jcfg, JENV, p, k, jcfg.eval_envs, jcfg.eval_len, "pallas",
        force_truncate=False, deterministic=True))(jts.policy_params, key)
    cfg = _port(jcfg)
    traj = ppo.rollout_env_loop(cfg, ENV, pp, jax_eval_draws(cfg, key, True))
    np.testing.assert_array_equal(traj.truncated.numpy(),
                                  np.asarray(jtraj.truncated))
    assert int(traj.truncated.sum()) == cfg.eval_envs
    for name in ("obs", "action", "log_prob", "reward"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)),
                                   rtol=1e-4, atol=1e-4)


def test_throughput_trainer_on_cpu(capsys):
    """tpu_preset's structure at a small size: block-shuffled minibatches
    over 2048 rows (the generic phases), mean-policy evaluation per epoch,
    score over completed episodes."""
    cfg = _port(_jcfg(n_envs=16, rollout_len=256, hidden=(16, 16),
                      eval_envs=4, eval_len=200))
    tr = Trainer(cfg, "cpu")
    hist = tr.train(n_epochs=2, eval_deterministic=True)
    assert "Epoch: 1 Entropy:" in capsys.readouterr().out
    assert all(np.isfinite(r["R"]) and r["episodes"] == 4 for r in hist)
    assert tr.state.opt_v.t == 2 * 2 * 1 and tr.state.opt_policy.t == 2
    res = score(tr, episodes=10)
    assert res["episodes"] == 12 and res["rounds"] == 3
    assert np.isfinite(res["R"])

"""Port parity for the slice as a whole: one fit_step against the JAX
package's ppo.fit_step(backend="pallas") (kernels in interpret mode) with
the same seed words and row-id streams; the CPU Trainer; the no-jax import.

Tolerances: the fit's outputs go through a 16-step rollout, GAE and 16
serial Adam steps, each carrying float32 summation-order differences;
weights rtol 1e-4 / atol 1e-5, Adam's second moment rtol 1e-3 / atol 1e-7
(as tests/test_pallas_update.py).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer, check_ported
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(env="pendulum", n_envs=8, rollout_len=16, minibatch_size=32,
                n_epochs_value=2, n_epochs_policy=1, fits_per_epoch=2,
                eval_envs=4, eval_len=200, hidden=(16, 16),
                kernel_backend="pallas")
    base.update(kw)
    return PPOConfig(**base)


def jax_fit_draws(cfg, key):
    """The seed words and row-id streams JAX's fit_step derives from its
    key (single device): split -> (rollout, update); the rollout kernel's
    seed words are fold_in(k_roll, 0); update -> (value, policy) streams."""
    k_roll, k_upd = jax.random.split(key)
    kd = jax.random.fold_in(k_roll, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)
    k_val, k_pol = jax.random.split(k_upd)

    def stream(k, n_epochs):
        flat, _ = jpu._stream_ids(cfg, k, cfg.steps_per_fit,
                                  cfg.num_minibatches, cfg.minibatch_size,
                                  n_epochs)
        return torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
            n_epochs, cfg.num_minibatches, cfg.minibatch_size)

    return ppo.FitDraws((int(w[0]), int(w[1])),
                        stream(k_val, cfg.n_epochs_value),
                        stream(k_pol, cfg.n_epochs_policy))


def test_fit_step_matches_jax_pallas_fit_step():
    cfg = _cfg()
    jenv = jenvs.make("pendulum")
    jts = jppo.init_train_state(cfg, jenv, jax.random.PRNGKey(0))
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    key = jax.random.PRNGKey(42)
    jts2, jm = jax.jit(lambda s, k: jppo.fit_step(
        cfg, jenv, s, k, backend="pallas"))(jts, key)
    ts2, m = ppo.fit_step(cfg, envs.make("pendulum"), ts,
                          jax_fit_draws(cfg, key))
    got = conv.train_state_to_numpy(ts2)
    want = jax.device_get(jts2)
    for a, b in zip(jax.tree.leaves((got.policy_params, got.v_params,
                                     got.opt_policy.m, got.opt_v.m,
                                     got.opt_log_std.m)),
                    jax.tree.leaves((want.policy_params, want.v_params,
                                     want.opt_policy.m, want.opt_v.m,
                                     want.opt_log_std.m))):
        np.testing.assert_allclose(a, np.asarray(b), **W_TOL)
    for a, b in zip(jax.tree.leaves((got.opt_policy.v, got.opt_v.v)),
                    jax.tree.leaves((want.opt_policy.v, want.opt_v.v))):
        np.testing.assert_allclose(a, np.asarray(b), **V_TOL)
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(want.opt_v.t), int(want.opt_policy.t), int(want.opt_log_std.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)


def test_eval_metrics_match_jax_and_the_kernel_sums():
    """eval_metrics_from_traj equals the JAX estimator on the same
    trajectory, and equals the rollout kernel's in-kernel episode sums."""
    cfg = _cfg()
    env = envs.make("pendulum")
    ts = ppo.init_train_state(cfg, env, torch.Generator().manual_seed(0),
                              "cpu")
    from ppoc_tpu_torch.ops import cuda_rollout
    traj, _, (sum_r, sum_j, n) = cuda_rollout.rollout_fused(
        "pendulum", ts.policy_params, (3, 4), 4, 210, return_metrics=True)
    got = ppo.eval_metrics_from_traj(traj, 0.99)
    jtraj = jppo.Transition(*(np.asarray(x) for x in traj))
    want = jppo.eval_metrics_from_traj(jtraj, 0.99)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert float(n) == float(got.episodes) == 4
    np.testing.assert_allclose([float(sum_r / n), float(sum_j / n)],
                               [float(got.R), float(got.J)], rtol=1e-5)
    fused = ppo.evaluate(cfg, env, ts.policy_params, (3, 4), n_envs=4)
    assert float(fused.episodes) == 4
    np.testing.assert_allclose(float(fused.R), float(got.R), rtol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_trainer_runs_on_cpu(backend, capsys):
    tr = Trainer(_cfg(kernel_backend=backend), "cpu")
    hist = tr.train(n_epochs=2)
    out = capsys.readouterr().out
    assert "Epoch: 1 Entropy:" in out and "Episodes: 4" in out
    assert len(hist) == 2
    for row in hist:
        assert all(np.isfinite(row[k]) for k in (
            "entropy", "J", "R", "value_loss", "policy_loss"))
    assert tr.state.opt_v.t == 2 * 2 * 2 * 4   # epochs*fits*v_epochs*n_mb
    res = tr.solve(-1e9, max_epochs=3)
    assert res["epochs"] == 1 and np.isfinite(res["R"])


def test_trainer_reset_per_fit_false_carries_envs():
    tr = Trainer(_cfg(reset_per_fit=False), "cpu")
    m = tr.train_epoch()
    assert np.isfinite(float(m.value_loss))


def test_same_seed_same_training():
    a, b = (Trainer(_cfg(), "cpu") for _ in range(2))
    a.train_epoch(), b.train_epoch()
    for x, y in zip(conv.tree_to_numpy(a.state.v_params),
                    conv.tree_to_numpy(b.state.v_params)):
        np.testing.assert_array_equal(x[0], y[0])


def test_unported_options_are_refused():
    check_ported(_cfg())
    for kw, item in ((dict(tp_size=2), 16),
                     (dict(zero1=True), 16),
                     (dict(n_experts=2, ep_size=2), 16)):
        with pytest.raises(NotImplementedError,
                           match=f"{list(kw)[-1]}.*item {item}"):
            Trainer(_cfg(**kw), "cpu")


@pytest.mark.parametrize("kw,backend", [
    (dict(max_grad_norm=0.5), "pallas"), (dict(n_experts=2), "moe:0"),
    (dict(clip_value=0.2), "pallas"), (dict(lr_anneal=True), "pallas"),
    (dict(target_kl=0.01, ent_anneal=True), "pallas"),
    (dict(kernel_backend="jnp"), "jnp"),
    (dict(n_experts=2, moe_topk=1, moe_aux_coeff=0.01,
          kernel_backend="bf16"), "moe:1:bf16"),
])
def test_lifted_options_train(kw, backend):
    """What the port used to refuse (the stabilisers, a mixture, "jnp")
    builds a Trainer with the JAX package's backend string and trains."""
    tr = Trainer(_cfg(**kw), "cpu")
    assert tr.backend == backend
    assert np.isfinite(float(tr.train_epoch().value_loss))


def test_trainer_defaults_to_the_card():
    """No device means CUDA device 0; without CUDA, a RuntimeError naming
    device="cpu" rather than a quiet CPU run."""
    if torch.cuda.is_available():
        assert Trainer(_cfg()).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Trainer(_cfg())


def test_train_state_numpy_roundtrip():
    tr = Trainer(_cfg(), "cpu")
    back = conv.train_state_from_numpy(conv.train_state_to_numpy(tr.state),
                                       "cpu")
    for x, y in zip(jax.tree.leaves(conv.train_state_to_numpy(back)),
                    jax.tree.leaves(conv.train_state_to_numpy(tr.state))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_never_imports_jax():
    """Neither jax nor any module of the JAX package ppoc_tpu is loaded by
    importing the port's entry points, nor by building a GRU, an LSTM and
    an aux-head attention trainer and training the GRU a fit."""
    code = ("import sys; import ppoc_tpu_torch.algo.trainer, "
            "ppoc_tpu_torch.ops.cuda_update, ppoc_tpu_torch.ops.cuda_mlp, "
            "ppoc_tpu_torch.ops.cuda_attn, ppoc_tpu_torch.algo.recurrent, "
            "ppoc_tpu_torch.models.attn, ppoc_tpu_torch.envs.recall, "
            "ppoc_tpu_torch.utils.params, ppoc_tpu_torch.config, "
            "ppoc_tpu_torch.cli, ppoc_tpu_torch.serve, "
            "ppoc_tpu_torch.utils.checkpoint, "
            "ppoc_tpu_torch.utils.ref_interop, "
            "ppoc_tpu_torch.utils.supervisor, ppoc_tpu_torch.models.gru; "
            "from ppoc_tpu_torch import PPOConfig as C; "
            "T = ppoc_tpu_torch.algo.trainer.Trainer; "
            "k = dict(env='recall', n_envs=8, rollout_len=6, "
            "minibatch_size=24, fits_per_epoch=1, eval_len=6, hidden=(4,)); "
            "T(C(rnn_hidden=4, **k), 'cpu').train_epoch(); "
            "T(C(rnn_hidden=4, rnn_cell='lstm', **k), 'cpu'); "
            "T(C(attn_dim=4, attn_heads=2, aux_value_coeff=0.5, **k), 'cpu'); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'ppoc_tpu' "
            "or m.startswith('ppoc_tpu.')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)

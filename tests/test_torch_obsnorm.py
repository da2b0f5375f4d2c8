"""Port parity for the affine observation wrapper and ``calibrate``
(``ppoc_tpu_torch/envs/wrappers.py``): tests/test_obsnorm.py:19-123
mirrored (its sweep case is tests/test_torch_sweep.py's
``test_sweep_respects_affine``),
and an affine env under "pallas": the env loop through K5's plain
version, the two whole-buffer V forwards, K2, K3 and K4, against the JAX
package's fit on ``pendulum#affine`` with its kernels in interpret mode
(the draws and params as tests/test_torch_jnp_backend.py makes them).

Tolerances.  The affine map rtol 1e-6; calibrated statistics against the
JAX package's (other random draws) rtol 0.5; the fit as
tests/test_torch_jnp_backend.py (weights rtol 1e-4 / atol 1e-5, second
Adam moments rtol 1e-3 / atol 1e-7, metrics rtol 1e-4 / atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import wrappers as jwrappers
from ppoc_tpu_torch import PPOConfig, envs, serve
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.envs import wrappers
from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import cuda_rollout, cuda_update
from test_torch_jnp_backend import (_as_fit_draws, _fit_draws, _jcfg, _port,
                                    fit_close, shared_start)

torch.set_num_threads(1)


def test_affine_obs_maps_observations():
    env = envs.make("pendulum")
    loc, scale = (1.0, -2.0, 0.5), (2.0, 4.0, 8.0)
    wrapped = wrappers.affine_obs(env, loc, scale)
    s0, o0 = env.reset(4, torch.Generator().manual_seed(0), "cpu")
    s1, o1 = wrapped.reset(4, torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_allclose(
        o1.numpy(), (o0.numpy() - np.asarray(loc)) / np.asarray(scale),
        rtol=1e-6)
    a = torch.zeros(4, env.spec.action_dim)
    _, o0s, r0, t0, _ = env.step(s0, a)
    _, o1s, r1, t1, _ = wrapped.step(s1, a)
    np.testing.assert_allclose(
        o1s.numpy(), (o0s.numpy() - np.asarray(loc)) / np.asarray(scale),
        rtol=1e-6)
    assert torch.equal(r0, r1) and torch.equal(t0, t1)
    assert wrapped.spec.name == "pendulum#affine"
    assert wrapped.spec.name not in cuda_rollout.SUPPORTED
    jw = jwrappers.affine_obs(jenvs.make("pendulum"), loc, scale)
    assert dataclasses.asdict(jw.spec) == dataclasses.asdict(wrapped.spec)
    # the JAX wrapper's map on the same raw observations
    np.testing.assert_allclose(
        o1s.numpy(),
        np.asarray((jnp.asarray(o0s.numpy()) - jnp.asarray(loc, jnp.float32))
                   / jnp.asarray(scale, jnp.float32)), rtol=1e-6)


def test_calibrate_normalizes_mountain_car():
    """The raw scales differ ~26x; calibration brings both dimensions to
    O(1), and its statistics are those the JAX package's calibrate
    measures to within sampling error (other random draws)."""
    cfg = wrappers.calibrate(PPOConfig(env="mountain_car"), n_envs=32,
                             n_steps=64, device="cpu")
    assert len(cfg.obs_loc) == 2 and len(cfg.obs_scale) == 2
    env = envs.make_for(cfg)
    g = torch.Generator().manual_seed(1)
    state, obs = envs.vector_reset(env, g, 64, "cpu")
    seen = []
    for _ in range(32):
        a = torch.rand((64, 1), generator=g) * 2.0 - 1.0
        state, obs, *_ = envs.vector_autoreset_step(
            env, state, a, envs.vector_reset(env, g, 64, "cpu"))
        seen.append(obs)
    flat = torch.stack(seen).reshape(-1, 2).numpy()
    assert (np.abs(flat.mean(axis=0)) < 1.5).all()
    assert (flat.std(axis=0) < 5.0).all() and (flat.std(axis=0) > 0.05).all()
    want = jwrappers.calibrate(JPPOConfig(env="mountain_car"), n_envs=32,
                               n_steps=64)
    np.testing.assert_allclose(cfg.obs_loc, want.obs_loc, rtol=0.5,
                               atol=0.02)
    np.testing.assert_allclose(cfg.obs_scale, want.obs_scale, rtol=0.5)


def test_calibrate_discrete_and_the_std_floor():
    """cartpole's class actions; simple's constant-free obs; every scale
    positive (floored at 1e-6)."""
    for env in ("cartpole", "simple"):
        cfg = wrappers.calibrate(PPOConfig(env=env), n_envs=8, n_steps=16,
                                 device="cpu")
        assert len(cfg.obs_scale) == envs.make(env).spec.obs_dim
        assert min(cfg.obs_scale) >= 1e-6


def test_calibrate_runs_on_the_callers_device(monkeypatch):
    """calibrate steps the env where it is asked to: "cpu" pins the CPU
    (the same statistics as a torch.device), and with no device it means
    CUDA device 0, as Trainer does, so without CUDA it raises rather than
    run on the CPU unasked."""
    cfg = PPOConfig(env="pendulum")
    got = wrappers.calibrate(cfg, n_envs=4, n_steps=8, device="cpu")
    assert got == wrappers.calibrate(cfg, n_envs=4, n_steps=8,
                                     device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device 0"):
        wrappers.calibrate(cfg, n_envs=4, n_steps=8)


def test_trainer_checkpoint_and_serving_replay_the_affine(tmp_path):
    cfg = wrappers.calibrate(
        PPOConfig(env="pendulum", n_envs=8, rollout_len=16,
                  minibatch_size=32, fits_per_epoch=1, eval_envs=8,
                  eval_len=16, hidden=(16,), kernel_backend="jnp"),
        n_envs=8, n_steps=32, device="cpu")
    tr = Trainer(cfg, "cpu")
    assert tr.env.spec.name.endswith("#affine")
    tr.train(n_epochs=1, log=False, initial_eval=False)
    path = str(tmp_path / "norm.bin")
    tr.save(path)
    tr2 = Trainer.from_checkpoint(path, device="cpu")
    assert tr2.cfg.obs_loc == cfg.obs_loc
    assert tr2.env.spec.name.endswith("#affine")
    act = serve.load_policy(path, device="cpu")
    raw = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32)
    normed = (raw - np.asarray(cfg.obs_loc, np.float32)) \
        / np.asarray(cfg.obs_scale, np.float32)
    want = mlp.apply(tr.state.policy_params["mlp"], torch.tensor(normed),
                     cfg.activation, "jnp")
    torch.testing.assert_close(act(raw), want, rtol=1e-5, atol=1e-6)


def test_affine_fit_step_matches_jax_pallas(monkeypatch):
    """An affine env under "pallas": no rollout lane takes
    ``pendulum#affine`` (K1 is never called), so the env loop runs
    through K5's plain version, then the two whole-buffer V forwards, K2,
    K3 and K4 (their plain versions), against the JAX package's fit on the
    same env with its kernels in interpret mode."""
    def refuse(*a, **k):
        raise AssertionError("K1 was called for an affine env")

    monkeypatch.setattr(cuda_rollout, "rollout_fused", refuse)
    jcfg = _jcfg(kernel_backend="pallas", obs_loc=(0.1, -0.2, 0.3),
                 obs_scale=(0.9, 1.1, 4.0), n_epochs_value=1,
                 n_epochs_policy=1)
    ts, jts = shared_start(jcfg, 4)
    jenv = jenvs.make_for(jcfg)

    def program(state):
        key = jax.random.PRNGKey(5)
        return (jppo.fit_step(jcfg, jenv, state, key, backend="pallas"),
                _fit_draws(jcfg, jenv, key))

    (jts2, jm), raw = jax.device_get(jax.jit(program)(jts))
    calls = []
    for name in ("value_phase", "policy_phase"):
        real = getattr(cuda_update, name)
        monkeypatch.setattr(cuda_update, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    ts2, m = ppo.fit_step(_port(jcfg), envs.make_for(_port(jcfg)), ts,
                          _as_fit_draws(jcfg, raw))
    assert calls == ["value_phase", "policy_phase"]
    fit_close(ts2, m, jts2, jm)


def test_validation():
    with pytest.raises(ValueError, match="obs_dim"):
        Trainer(PPOConfig(env="pendulum", obs_loc=(0.0,), obs_scale=(1.0,)),
                "cpu")
    with pytest.raises(ValueError, match="together"):
        envs.make_for(PPOConfig(env="pendulum", obs_loc=(0.0,) * 3))
    with pytest.raises(ValueError, match="zero"):
        envs.make_for(PPOConfig(env="pendulum", obs_loc=(0.0,) * 3,
                                obs_scale=(1.0, 0.0, 1.0)))


def test_cli_parses_tuple_flags():
    from ppoc_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["--obs-loc", "0.5,-1.0", "--obs-scale", "2.0,3.0",
         "--env", "mountain_car"])
    cfg = config_from_args(args)
    assert cfg.obs_loc == (0.5, -1.0) and cfg.obs_scale == (2.0, 3.0)

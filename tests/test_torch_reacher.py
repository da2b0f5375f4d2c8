"""Port parity for the reacher regime and the MountainCarContinuous recipe
as wholes: one fused and one generic reacher fit_step against the JAX
package's ppo.fit_step(backend="pallas") (its kernels in interpret mode)
on the same seed words and row streams, K5's plain version at reacher's
2x256 widths against pallas_mlp.mlp_forward in interpret mode, the
parameter exchange at those widths, and the CPU Trainer on both configs.

Tolerances.  The fits: weights rtol 1e-4 / atol 1e-5 and metrics rtol
1e-4 / atol 1e-6, as tests/test_torch_trainer.py; Adam moments as
tests/test_torch_throughput.py (the generic fit's gradients sum 4096 rows
in another order: atol 1e-3 of the leaf's largest magnitude; the fused
fit's 64 rows: atol 1e-7).  K5 at 2x256: rtol 1e-5 / atol 1e-5 on the
forward, whose sums run over 256 inputs; the gradients sum 300 rows of
products over 256-wide layers in another order than XLA's, so rtol 1e-4
with atol 1e-5 of the leaf's largest magnitude.  The exchange is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.models import mlp as jmlp
from ppoc_tpu.ops import pallas_mlp as jpm
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.ops import cuda_mlp, cuda_update
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-4, atol=1e-5)
JENV = {n: jenvs.make(n) for n in ("reacher", "mountain_car_norm")}
ENV = {n: envs.make(n) for n in ("reacher", "mountain_car_norm")}

# the two full-width configurations this slice runs on the card
REACHER = dict(env="reacher", n_envs=4096, rollout_len=150,
               minibatch_size=16384, fits_per_epoch=1, hidden=(256, 256),
               eval_envs=256, eval_len=150, shuffle_block=4096,
               kernel_backend="pallas")
MCC = dict(env="mountain_car_norm", n_envs=512, rollout_len=999,
           minibatch_size=8192, fits_per_epoch=1, eval_envs=256,
           eval_len=999, ent_coeff=0.005, seed=0, kernel_backend="pallas")


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


def jax_seed_words(key):
    kd = jax.random.fold_in(key, 0)
    try:
        kd = jax.random.key_data(kd)
    except (AttributeError, TypeError):
        pass
    w = np.asarray(kd, np.uint32).reshape(-1)
    return int(w[0]), int(w[1])


def jax_fit_draws(cfg, key):
    """The seed words and row-id (block-id) streams JAX's fit_step derives
    from its key (see tests/test_torch_trainer.py)."""
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


def _check_fit(jcfg, key, moment_atol, seed=0):
    env = jcfg.env
    jts = jppo.init_train_state(jcfg, JENV[env], jax.random.PRNGKey(seed))
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
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
            np.testing.assert_allclose(a, b, rtol=rtol, atol=moment_atol(b))
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(want.opt_v.t), int(want.opt_policy.t), int(want.opt_log_std.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)
    return got


def test_fused_reacher_fit_step_matches_jax(monkeypatch):
    """reacher under the fused gate (mb 64): K1's reacher lane, K2, K3 and
    K4 at two action dims, each as its plain version; K6 never runs."""
    calls = []
    for name in ("policy_phase", "policy_phase_categorical"):
        real = getattr(cuda_update, name)
        monkeypatch.setattr(cuda_update, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    jcfg = JPPOConfig(env="reacher", n_envs=8, rollout_len=16,
                      minibatch_size=64, n_epochs_value=2, n_epochs_policy=1,
                      fits_per_epoch=1, hidden=(16, 16), ent_coeff=0.01,
                      kernel_backend="pallas")
    got = _check_fit(jcfg, jax.random.PRNGKey(42), lambda b: 1e-7)
    assert calls == ["policy_phase"]
    assert got.policy_params["log_std"].shape == (2,)
    assert got.opt_log_std.t == 2


def test_generic_reacher_fit_step_with_shuffle_block_matches_jax():
    """reacher above the gate (mb 4096 in blocks of 1024): the generic
    phases, K5's plain forward and backward, autograd and Adam, with the
    block shuffle, against the JAX scan branch.  Two minibatches a phase:
    a single one would hold every row, and its first policy loss, minus
    the mean of the whole-buffer-normalised advantages, would be rounding
    noise (~1e-8 here, ~1e-6 in XLA)."""
    jcfg = JPPOConfig(env="reacher", n_envs=64, rollout_len=128,
                      minibatch_size=4096, shuffle_block=1024,
                      n_epochs_value=2, n_epochs_policy=1, fits_per_epoch=1,
                      hidden=(32, 32), kernel_backend="pallas")
    assert jcfg.minibatch_size > ppo.MAX_FUSED_MB
    _check_fit(jcfg, jax.random.PRNGKey(9),
               lambda b: 1e-3 * np.abs(b).max(initial=0.0), seed=1)


@pytest.mark.parametrize("sizes", [(10, 256, 256, 2), (10, 256, 256, 1)])
def test_k5_plain_at_2x256_matches_jax_pallas(sizes):
    """K5's plain forward and its autograd backward (MLPForward) at the
    reacher regime's widths against pallas_mlp.mlp_forward's custom VJP."""
    jp = jax.device_get(jmlp.init(jax.random.PRNGKey(4), sizes))
    params = [tuple(t) for t in conv.tree_from_numpy(jp, "cpu")]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, sizes[0])).astype(np.float32)
    g = rng.normal(size=(300, sizes[-1])).astype(np.float32)
    out, vjp = jax.vjp(lambda p, xx: jpm.mlp_forward(p, xx, "relu"), jp,
                       jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_() for pair in params for t in pair]
    xt = torch.tensor(x, requires_grad=True)
    got = cuda_mlp.mlp_forward(cuda_mlp._pairs(leaves), xt, "relu")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got, leaves + [xt],
                                grad_outputs=torch.tensor(g))
    for a, b in zip(grads, jax.tree.leaves(jdp) + [jdx]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


def test_reacher_train_state_at_2x256_carries_across():
    """The JAX package's reacher TrainState at 2x256 (2-wide log_std, three
    Adam states) converts to the port's and back leaf for leaf, exactly."""
    jcfg = JPPOConfig(**REACHER)
    jts = jax.device_get(jppo.init_train_state(jcfg, JENV["reacher"],
                                               jax.random.PRNGKey(0)))
    ts = conv.train_state_from_numpy(jts, "cpu")
    assert ts.policy_params["log_std"].shape == (2,)
    assert [tuple(w.shape) for w, _ in ts.policy_params["mlp"]] == [
        (10, 256), (256, 256), (256, 2)]
    assert [tuple(w.shape) for w, _ in ts.v_params] == [
        (10, 256), (256, 256), (256, 1)]
    back = conv.train_state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("full", [REACHER, MCC])
def test_trainer_accepts_the_full_width_configs(full):
    """Trainer takes both configurations as they are, with no branch of
    their own: the MLP fit above the 2048-row gate.  The reacher regime's
    block stream is 37 minibatches of 4 blocks of 4096 rows (2 of its 150
    blocks dropped)."""
    cfg = PPOConfig(**full)
    tr = Trainer(cfg, "cpu")
    assert cfg.minibatch_size > ppo.MAX_FUSED_MB
    assert tr.env.spec.name == cfg.env
    assert [w.shape[1] for w, _ in tr.state.v_params] == [
        *cfg.hidden, 1]
    if cfg.env == "reacher":
        assert cfg.num_minibatches == 37
        d = ppo.draw_fit(cfg, torch.Generator().manual_seed(0), "cpu")
        assert d.value_idx.shape == (10, 37, 4)
        assert d.policy_idx.shape == (4, 37, 4)
        assert len(set(d.value_idx[0].reshape(-1).tolist())) == 148
    else:
        assert cfg.num_minibatches == 62


@pytest.mark.parametrize("env,hidden,eval_len", [
    ("reacher", (32, 32), 150), ("mountain_car_norm", (16, 16), 999)])
def test_trainer_runs_new_envs_on_cpu(env, hidden, eval_len):
    """The CPU Trainer trains and evaluates the new envs at a small size
    through the generic phases (minibatch 4096 > 2048), with the block
    shuffle, and evaluates the mean policy through the env loop."""
    cfg = PPOConfig(env=env, n_envs=32, rollout_len=128,
                    minibatch_size=4096, shuffle_block=1024, n_epochs_value=1,
                    n_epochs_policy=1, fits_per_epoch=1, eval_envs=4,
                    eval_len=eval_len, hidden=hidden, ent_coeff=0.005,
                    kernel_backend="pallas")
    tr = Trainer(cfg, "cpu")
    hist = tr.train(n_epochs=1, log=False)
    assert len(hist) == 1 and np.isfinite(hist[0]["entropy"])
    assert tr.state.opt_policy.t == 1 and tr.state.opt_v.t == 1
    ev = tr.evaluate()
    assert ev.episodes >= cfg.eval_envs and np.isfinite(ev.R)
    ev = tr.evaluate(deterministic=True)
    assert ev.episodes >= cfg.eval_envs and np.isfinite(ev.R)

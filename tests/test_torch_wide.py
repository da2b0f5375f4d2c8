"""Port parity for the fused update phases at 2x256, past one block's
shared memory on the card, and the Trainer's up-front check that every
kernel of a config's path takes its nets.

Two whole fused fit_steps at hidden (256, 256), minibatch 64 (two value
and two policy steps), against the JAX package's
ppo.fit_step(backend="pallas") with its kernels in interpret mode, on the
same seed words and row streams: reacher (K1's reacher lane, K2, K3 and K4
at two action dims) and cartpole (K1's cartpole lane, K2, K3 and K6), each
kernel as its plain version here.  Tolerances as
tests/test_torch_reacher.py's ``_check_fit``: weights rtol 1e-4 / atol
1e-5, Adam m rtol 1e-4 and v rtol 1e-3, both with atol 1e-7 (sums of 64
rows), the metrics rtol 1e-4 / atol 1e-6, the Adam steps exactly.

``ppo.kernel_fit`` is pure arithmetic on the widths, held here at the
H100's 232,448 B a block: the shared-memory bytes of each variant, the
variant each kernel of a path takes, and the first kernel that takes
none.  tests/test_torch_cuda.py holds its bytes to the kernels' own.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer, check_kernel_fit
from ppoc_tpu_torch.ops import cuda_mlp, cuda_rollout, cuda_update
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

H100_OPTIN = 232448
W_TOL = dict(rtol=1e-4, atol=1e-5)
JENV = {n: jenvs.make(n) for n in ("reacher", "cartpole")}
ENV = {n: envs.make(n) for n in ("reacher", "cartpole")}


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
    """The seed words and row-id streams JAX's fit_step derives from its
    key (see tests/test_torch_trainer.py)."""
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


def _wide_fit(env, key, monkeypatch):
    """One fused fit_step at 2x256 on both sides; returns the update-phase
    wrappers the port called, in order."""
    calls = []
    for name in ("value_phase", "policy_phase", "policy_phase_categorical"):
        real = getattr(cuda_update, name)
        monkeypatch.setattr(cuda_update, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    jcfg = JPPOConfig(env=env, n_envs=8, rollout_len=16, minibatch_size=64,
                      n_epochs_value=1, n_epochs_policy=1, fits_per_epoch=1,
                      hidden=(256, 256), ent_coeff=0.01,
                      kernel_backend="pallas")
    assert jcfg.num_minibatches == 2
    jts = jppo.init_train_state(jcfg, JENV[env], jax.random.PRNGKey(0))
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
            np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                                       atol=1e-7)
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(want.opt_v.t), int(want.opt_policy.t), int(want.opt_log_std.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)
    return calls, got


def test_fused_reacher_fit_step_at_2x256_matches_jax(monkeypatch):
    """The reference schedule's path at the reacher regime's width: K3 on
    [10,256,256,1] and K4 on [10,256,256,2], both past one block's shared
    memory on the card."""
    calls, got = _wide_fit("reacher", jax.random.PRNGKey(42), monkeypatch)
    assert calls == ["value_phase", "policy_phase"]
    assert got.policy_params["log_std"].shape == (2,)
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (2, 2, 2)


def test_fused_cartpole_fit_step_at_2x256_matches_jax(monkeypatch):
    """The discrete path at 2x256: K3 on [4,256,256,1] and K6 on
    [4,256,256,2]; K4 never runs."""
    calls, got = _wide_fit("cartpole", jax.random.PRNGKey(7), monkeypatch)
    assert calls == ["value_phase", "policy_phase_categorical"]
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (2, 2, 0)


@pytest.mark.parametrize("env,policy_kernel", [
    ("reacher", "K4"), ("cartpole", "K6"), ("pendulum", "K4"),
    ("acrobot", "K6")])
def test_kernel_fit_takes_every_kernel_at_2x256(env, policy_kernel):
    """At 2x256 under the fused gate every kernel of the path has a
    variant: K1 and K5 take their nets in global memory, and so do K3 and
    K4/K6."""
    fits = ppo.kernel_fit(PPOConfig(env=env, hidden=(256, 256)), H100_OPTIN)
    assert [k.kernel[:2] for k in fits] == ["K1", "K5", "K5", "K3",
                                            policy_kernel]
    assert [k.variant for k in fits] == ["global"] * 5
    check_kernel_fit(PPOConfig(env=env, hidden=(256, 256)), envs.make(env),
                     H100_OPTIN)


@pytest.mark.parametrize("env", ["pendulum", "reacher", "cartpole"])
def test_kernel_fit_refuses_512_and_names_k1(env):
    """At 2x512 K1's global variant alone needs ~264 KB (two nets' hidden
    tiles over 32 envs): the first kernel of the path that takes its nets
    in no variant is K1, and the check names it with its widths."""
    cfg = PPOConfig(env=env, hidden=(512, 512))
    fits = ppo.kernel_fit(cfg, H100_OPTIN)
    assert fits[0].kernel.startswith("K1") and fits[0].variant is None
    assert min(fits[0].nbytes) > H100_OPTIN
    with pytest.raises(NotImplementedError, match=r"K1 .*512, 512"):
        check_kernel_fit(cfg, envs.make(env), H100_OPTIN)


def test_kernel_fit_k3_boundary_on_3_h_h_1():
    """K3's cluster block (cuda_update.cluster_bytes: the weights and their
    gradient partial, a 32-row activation tile, the rows, its Adam slice)
    keeps [3,h,h,1] in shared memory up to h 140 (55,188 floats and the 1
    KB static share: 221,776 B) and takes the global variant at 141
    (59,196 floats: 237,808 B)."""
    for h, floats, variant in ((140, 55188, "smem"), (141, 59196, "global")):
        k3 = ppo.kernel_fit(PPOConfig(env="pendulum", hidden=(h, h)),
                            H100_OPTIN)[3]
        assert k3.kernel.startswith("K3") and k3.widths == ((3, h, h, 1),)
        assert k3.nbytes[0] == 4 * floats + 1024
        assert k3.variant == variant


def test_variant_bytes_follow_the_layouts():
    """The 2x256 nets (the H100 lets a block opt in to 232,448 B): the
    replicated cluster block of K3, K4 and K6 holds the weights and their
    gradient partial in a float4-padded layout (71,220 floats each) besides
    its tiles and Adam slice, 169,828 floats; their sharded cluster's block
    48,420 (tests/test_torch_shard.py); the head's width is padded to 4,
    so a 2-class head takes the replicated block of the value net, and
    the sharded block 32 floats more (the head's own m and v, 16 x 2).  K1
    as its card test's boundary formula, K5 at its card test's boundary
    widths, 192 in shared memory and 193 past it (tests/test_torch_cuda.py
    test_variant_is_chosen_by_size): its backward at the 16-row tile
    holds the weights (rows padded to 8, 8 mod 16 floats), two tiles, the
    8,192-float dW stage and the db column sums."""
    assert cuda_update.variant_bytes((10, 256, 256, 1)) == [
        4 * 169828 + 1024, 4 * 48420 + 1024]
    assert cuda_update.variant_bytes((10, 256, 256, 2)) == [
        4 * 169828 + 1024, 4 * (48420 + 32) + 1024]
    for h in (159, 160):
        w = (3, h, h, 1)
        assert cuda_rollout.variant_bytes(w, w)[0] == (
            4 * (2 * h * h + 44 * h + 42) + 1024)
    for h, floats in ((192, 56320), (193, 58504)):
        assert cuda_mlp.variant_bytes((3, h, h, 1))[0] == 4 * floats
    assert cuda_rollout.variant_bytes((3, 64, 64, 1))[0] < (
        cuda_rollout.variant_bytes((3, 64, 64, 1), (3, 64, 64, 1))[0])


def test_kernel_fit_lists_only_the_kernels_of_the_path():
    """Above the 2048-row gate the phases are the generic ones (K5, no
    K3/K4); an attention trunk's kernel, K7, takes no width-dependent
    shared memory."""
    big = PPOConfig(env="reacher", hidden=(256, 256), n_envs=64,
                    minibatch_size=4096)
    assert big.minibatch_size > ppo.MAX_FUSED_MB
    assert [k.kernel[:2] for k in ppo.kernel_fit(big, H100_OPTIN)] == [
        "K1", "K5", "K5"]
    seq = PPOConfig(env="recall", n_envs=32, rollout_len=12,
                    minibatch_size=48, eval_envs=32, eval_len=12,
                    hidden=(16,), attn_dim=16, attn_layers=1, attn_heads=2)
    assert ppo.kernel_fit(seq, H100_OPTIN) == []


def test_trainer_on_cpu_takes_any_width():
    """The check is the card's: on the CPU every kernel runs its plain
    version, which takes any width, so Trainer(cfg, "cpu") builds 2x512."""
    tr = Trainer(PPOConfig(env="pendulum", hidden=(512, 512)), "cpu")
    assert [w.shape[1] for w, _ in tr.state.v_params] == [512, 512, 1]

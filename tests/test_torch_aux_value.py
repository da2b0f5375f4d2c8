"""Port parity for the PPG-style auxiliary value head on an attention
policy trunk (cfg.aux_value_coeff): mirrors tests/test_aux_value.py.

The aux head is a scalar MLP over the trunk's final-LN hidden plane
(``attn.apply_seq(return_hidden=True)``), trained in the policy phase
against the fit's value targets, never used to act.  The hidden plane is
held to the JAX package's on every backend (the flash core with
FLASH_MIN_T lowered in both packages, so K7's plain version runs here and
the Pallas kernel in interpret mode there); one whole update_step with
the aux loss to the JAX package's on the same trajectory and columns.

Tolerances.  The hidden plane and outputs rtol 1e-4 / atol 1e-5 in
float32, under "bf16" within two bf16 ulps of the largest magnitude with
at most 5% of elements apart by more than float32 rounding
(tests/test_torch_bf16.py).  The fit as tests/test_torch_recurrent.py
(weights and first moments rtol 1e-4 / atol 1e-5, second moments rtol
1e-3 / atol 1e-7, metrics rtol 1e-4 / atol 1e-6), its key bias as that
file's ``_fit_leaves_close`` says.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import envs as jenvs, serve as jserve
from ppoc_tpu.algo import ppo as jppo, recurrent as jrec
from ppoc_tpu.models import attn as jattn
from ppoc_tpu.ops import pallas_attn
from ppoc_tpu_torch import PPOConfig, config as config_mod, envs, serve
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.ops import adam, cuda_attn
from ppoc_tpu_torch.utils import params as conv
from test_torch_bf16 import _bf16_close, _seq_inputs, _trunk
from test_torch_recurrent import (TOL, V_TOL, _fit_leaves_close, _jts,
                                  _port, jax_columns)

torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
                fits_per_epoch=2, eval_envs=16, eval_len=6, hidden=(16,),
                seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    base.update(kw)
    return PPOConfig(**base)


def _leaves_equal(a, b):
    """Every leaf equal (Adam timesteps too)."""
    la, lb = adam.tree_leaves(a), adam.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def test_default_off_is_identical():
    """aux_value_coeff 0 leaves the state as before the feature: no
    aux_head key, the same draws."""
    t0, t1 = Trainer(_cfg(), "cpu"), Trainer(_cfg(aux_value_coeff=0.0), "cpu")
    assert "aux_head" not in t0.state.policy_params["mlp"]
    assert _leaves_equal(t0.state, t1.state)


def test_aux_head_layout_and_draw_order():
    """With the coeff on, the policy trunk carries ``aux_head`` [d,
    *hidden, 1], the JAX package's tree and shapes; it is drawn right
    after the policy trunk, so that trunk equals the coeff-off one on the
    same seed while the value trunk, drawn after it, does not."""
    on, off = Trainer(_cfg(aux_value_coeff=1.0), "cpu"), Trainer(_cfg(), "cpu")
    aux = on.state.policy_params["mlp"]["aux_head"]
    assert [tuple(w.shape) for w, _ in aux] == [(8, 16), (16, 1)]
    trunk = {k: v for k, v in on.state.policy_params["mlp"].items()
             if k != "aux_head"}
    assert _leaves_equal(trunk, off.state.policy_params["mlp"])
    assert not _leaves_equal(on.state.v_params, off.state.v_params)
    jcfg = jppo.PPOConfig(**dataclasses.asdict(_cfg(aux_value_coeff=1.0)))
    shape = jax.eval_shape(lambda k: jppo.init_train_state(
        jcfg, jenvs.make("recall"), k), jax.random.PRNGKey(0))
    mine = conv.train_state_to_numpy(on.state)
    assert [np.shape(x) for x in jax.tree.leaves(mine)] == [
        x.shape for x in jax.tree.leaves(shape)]


@pytest.mark.parametrize("backend", ["jnp", "pallas", "bf16"])
def test_return_hidden_matches_jax(backend, monkeypatch):
    """apply_seq(return_hidden=True): the outputs and the final-LN plane
    the aux head reads, on each backend (the flash core, K7's plain
    version here, at T >= the lowered FLASH_MIN_T)."""
    T, E = 40, 4
    monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(cuda_attn, "BF16_CHUNK", pallas_attn._tiles(T)[1])
    jp, tp = _trunk(T)
    xs, done, _ = _seq_inputs(T, E)
    want = jax.device_get(jattn.apply_seq(jp, jnp.asarray(xs),
                                          jnp.asarray(done), "relu",
                                          backend=backend,
                                          return_hidden=True))
    got = attn.apply_seq(tp, torch.from_numpy(xs), torch.from_numpy(done),
                         "relu", backend=backend, return_hidden=True)
    assert got[1].shape == (T, E, 16)
    plain = attn.apply_seq(tp, torch.from_numpy(xs), torch.from_numpy(done),
                           "relu", backend=backend)
    assert torch.equal(plain, got[0])
    if backend == "bf16":
        _bf16_close(zip((g.numpy() for g in got), want), 0.05, "out, hidden")
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_update_step_with_aux_matches_jax(monkeypatch):
    """One whole update_step of the attention branch with aux_value_coeff
    0.5 -- the aux MSE on the hidden plane through the flash path added to
    every policy minibatch's loss -- against ppoc_tpu's on the same
    trajectory and env-column streams; the aux head moves."""
    monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    jcfg, jts, ts = _jts("recall", seed=4, ent_coeff=0.01,
                         aux_value_coeff=0.5)
    assert "aux_head" in ts.policy_params["mlp"]
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
    want, before = jax.device_get(jts2), jax.device_get(jts)
    for part, tol in (("policy_params", TOL), ("v_params", TOL),
                      ("opt_policy.m", TOL), ("opt_v.m", TOL),
                      ("opt_policy.v", V_TOL), ("opt_v.v", V_TOL)):
        _fit_leaves_close(part, got, want, before, tol)
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-6)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got.policy_params["mlp"]["aux_head"]),
        jax.tree.leaves(before.policy_params["mlp"]["aux_head"]))]
    assert all(moved)


def test_aux_head_trains_and_reaches_trunk():
    """With the coeff on, the aux head and the trunk receive auxiliary
    gradient: the aux head moves, and the trunk's trajectory parts from
    the coeff-0 run on the same seed."""
    tr_off, tr_on = (Trainer(_cfg(aux_value_coeff=c), "cpu")
                     for c in (0.0, 1.0))
    aux0 = [t.clone() for t in adam.tree_leaves(
        tr_on.state.policy_params["mlp"]["aux_head"])]
    tr_off.train_epoch()
    tr_on.train_epoch()
    aux1 = adam.tree_leaves(tr_on.state.policy_params["mlp"]["aux_head"])
    assert any(not torch.equal(a, b) for a, b in zip(aux0, aux1))
    assert all(bool(torch.isfinite(b).all()) for b in aux1)
    w_off = tr_off.state.policy_params["mlp"]["attn"]["embed"][0]
    w_on = tr_on.state.policy_params["mlp"]["attn"]["embed"][0]
    assert not torch.equal(w_off, w_on)
    assert np.isfinite(tr_on.evaluate().R)


def test_checkpoint_roundtrip_kind5(tmp_path):
    """A kind-5 trunk (attention + aux head) round-trips bit for bit with
    its Adam moments, and the resumed training stays bit-equal."""
    tr = Trainer(_cfg(aux_value_coeff=0.5), "cpu")
    tr.train_epoch()
    p = str(tmp_path / "aux.bin")
    tr.save(p)
    tr2 = Trainer.from_checkpoint(p, device="cpu")
    assert tr2.cfg.aux_value_coeff == 0.5
    assert "aux_head" in tr2.state.policy_params["mlp"]
    assert _leaves_equal(tr.state, tr2.state)
    tr.train_epoch()
    tr2.train_epoch()
    assert _leaves_equal(tr.state, tr2.state)


def test_serving_ignores_aux_head(tmp_path):
    """Serving acts through the action head only: the port's and the JAX
    package's load_attention_policy give the same actions on a kind-5
    file."""
    tr = Trainer(_cfg(aux_value_coeff=1.0), "cpu")
    tr.train_epoch()
    p = str(tmp_path / "aux_serve.bin")
    tr.save(p)
    act = serve.load_attention_policy(p, device="cpu")
    jact = jserve.load_attention_policy(p)
    s, js = act.initial_state(4), jact.initial_state(4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        obs = rng.standard_normal((4, 2)).astype(np.float32)
        a, s = act(obs, s)
        ja, js = jact(obs, js)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-6)
    assert a.shape == (4, tr.env.spec.action_dim)


def test_validation():
    with pytest.raises(ValueError, match="attention family"):
        config_mod.validate(PPOConfig(env="pendulum", aux_value_coeff=1.0))
    with pytest.raises(ValueError, match="sequence parallel"):
        config_mod.validate(_cfg(aux_value_coeff=1.0, sp_size=2,
                                 rollout_len=8))

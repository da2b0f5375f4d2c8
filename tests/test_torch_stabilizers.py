"""Port parity for the training stabilisers (max_grad_norm, clip_value,
target_kl, lr_anneal, ent_anneal): ppoc_tpu_torch/algo/ppo.py's generic
phases and ops/adam.clip_by_global_norm, held to the JAX package.

Mirrors tests/test_stabilizers.py case for case.  Where that file trains
a tiny fit (``_tiny_fit``), both packages take the same update here: the
same params (the port's init from a seeded generator, given to the JAX
package as its TrainState), the port's "jnp" rollout on them as the
trajectory, and the JAX update's streams (key 2) as the port's row-id
streams; each case asserts the JAX test's own property of the port's
fit and holds the fit to the JAX package's.  The JAX package's side of
every case is one jitted program, compiled once for the file.  The
recurrent pair runs on the attention trunk (the port has no GRU): the
same update on the port's rollout_rnn trajectory and the JAX update's
env-column streams.

Tolerances.  Weights and Adam first moments rtol 1e-4 / atol 1e-5,
second moments rtol 1e-3 / atol 1e-7, metrics rtol 1e-4 / atol 1e-6 (as
tests/test_torch_trainer.py); Adam step counters exactly.  The clip's
norm and scale rtol 1e-6 (float32 sums of a few leaves).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.ops import adam as jadam, losses as jlosses
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo, recurrent as precurrent
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.ops import adam, losses
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-7)
M_TOL = dict(rtol=1e-4, atol=1e-6)

BASE = JPPOConfig(env="pendulum", n_envs=8, rollout_len=32, minibatch_size=64,
                  hidden=(16, 16), n_epochs_value=2, n_epochs_policy=2)


def _port(jcfg, backend="jnp"):
    return PPOConfig(**dict(dataclasses.asdict(jcfg),
                            kernel_backend=backend))


def _shared_start(jcfg, seed):
    """Params both packages start from: the port's ``init_train_state``
    from a seeded generator, and the same leaves as the JAX package's
    TrainState (its structure traced from its init, not run)."""
    penv = envs.make(jcfg.env)
    ts = ppo.init_train_state(_port(jcfg), penv,
                              torch.Generator().manual_seed(seed), "cpu")
    shape = jax.eval_shape(lambda k: jppo.init_train_state(
        jcfg, jenvs.make(jcfg.env), k), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(conv.train_state_to_numpy(ts))
    want = jax.tree.leaves(shape)
    assert [np.shape(x) for x in leaves] == [w.shape for w in want]
    return ts, penv, jax.tree.unflatten(jax.tree.structure(shape), [
        np.asarray(x, w.dtype) for x, w in zip(leaves, want)])


_STAB_OFF = dict(max_grad_norm=0.0, clip_value=0.0, target_kl=0.0,
                 lr_anneal=False, ent_anneal=False, ent_coeff=0.0, n_epochs=10,
                 fits_per_epoch=10)

# every config whose whole fit the port is held to, each one JAX update
HELD = (
    BASE,
    BASE.replace(max_grad_norm=1e-3),
    BASE.replace(lr_anneal=True, n_epochs=1, fits_per_epoch=1),
    BASE.replace(clip_value=1e-3),
    BASE.replace(ent_coeff=0.01, ent_anneal=True, n_epochs=1,
                 fits_per_epoch=1),
    BASE.replace(target_kl=1e-4, ent_coeff=0.01),
    BASE.replace(target_kl=1e-3, ent_coeff=0.01),
    BASE.replace(max_grad_norm=0.5, clip_value=0.2, target_kl=0.02,
                 lr_anneal=True, ent_anneal=True, ent_coeff=0.01),
)


@functools.lru_cache(maxsize=None)
def _jax_side():
    """What every case shares: the params (:func:`_shared_start`, seed
    0); the port's "jnp" rollout from them on its own draws (seed 1),
    which no stabiliser changes, as the trajectory of both packages; then
    one jitted JAX program (one compile
    for the file) for the update streams of key 2 (split -> value,
    policy; one permutation per epoch key, as ``jpu._stream_ids``) and
    tests/test_stabilizers.py's update of key 2 for every HELD config.
    Returns (params, trajectory, streams, {config: (state, metrics)})."""
    env = jenvs.make(BASE.env)
    off = BASE.replace(**_STAB_OFF)
    ts, penv, jts = _shared_start(off, 0)
    pcfg = _port(off)
    traj, _ = ppo.rollout(
        pcfg, penv, ts.policy_params,
        ppo.draw_fit(pcfg, torch.Generator().manual_seed(1), "cpu",
                     penv).seq, off.n_envs, off.rollout_len)
    jtraj = jppo.Transition(*(x.numpy() for x in traj))

    def program(ts, traj):
        key = jax.random.PRNGKey(2)
        streams = tuple(
            jpu._stream_ids(off, k, off.steps_per_fit, off.num_minibatches,
                            off.minibatch_size, n)[0]
            for k, n in zip(jax.random.split(key),
                            (off.n_epochs_value, off.n_epochs_policy)))
        return streams, tuple(jppo.update_step(c, env, ts, traj, key,
                                               backend="jnp") for c in HELD)

    streams, fits = jax.device_get(jax.jit(program)(jts, jtraj))
    return jts, traj, streams, dict(zip(HELD, fits))


def _jax_update(jcfg):
    """The JAX package's state and metrics after the update of ``jcfg``."""
    return _jax_side()[3][jcfg]


def _tiny_fit(jcfg, backend="jnp"):
    """The port's update on the JAX fit's params, trajectory and streams;
    returns (port state after, port metrics)."""
    jts, traj, streams, _ = _jax_side()
    ts = conv.train_state_from_numpy(jts, "cpu")
    draws = ppo.FitDraws(None, *(
        torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
            n, jcfg.num_minibatches, -1)
        for flat, n in zip(streams, (jcfg.n_epochs_value,
                                     jcfg.n_epochs_policy))))
    return ppo.update_step(_port(jcfg, backend), envs.make(jcfg.env), ts,
                           traj, draws, None)


def _leaves(ts):
    return jax.tree.leaves(conv.train_state_to_numpy(ts))


def _assert_fit_matches(ts2, m, jcfg):
    """The port's fit against the JAX package's fit of ``jcfg``."""
    jts2, jm = _jax_update(jcfg)
    got = conv.train_state_to_numpy(ts2)
    for part, tol in (("policy_params", W_TOL), ("v_params", W_TOL)):
        for a, b in zip(jax.tree.leaves(getattr(got, part)),
                        jax.tree.leaves(getattr(jts2, part))):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=part, **tol)
    for opt in ("opt_policy", "opt_v", "opt_log_std"):
        g, w = getattr(got, opt), getattr(jts2, opt)
        assert g.t == int(w.t), opt
        for a, b in zip(jax.tree.leaves(g.m), jax.tree.leaves(w.m)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=opt, **W_TOL)
        for a, b in zip(jax.tree.leaves(g.v), jax.tree.leaves(w.v)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=opt, **V_TOL)
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), **M_TOL)


def _differs(a_ts, b_ts, part):
    return any(not np.allclose(a, b) for a, b in zip(
        jax.tree.leaves(getattr(conv.train_state_to_numpy(a_ts), part)),
        jax.tree.leaves(getattr(conv.train_state_to_numpy(b_ts), part))))


# --- the mirrored cases -------------------------------------------------------

def test_clip_by_global_norm_math():
    grads = [(torch.full((3,), 3.0), torch.full((4,), 4.0))]
    norm = float(np.sqrt(91.0))
    leaves = adam.tree_leaves(adam.clip_by_global_norm(grads, 1.0))
    got = float(np.sqrt(sum(float(torch.sum(g * g)) for g in leaves)))
    assert got == pytest.approx(1.0, rel=1e-5)
    np.testing.assert_allclose(leaves[0].numpy(), 3.0 / norm * np.ones(3),
                               rtol=1e-5)
    small = adam.clip_by_global_norm(grads, norm * 10)
    assert torch.equal(adam.tree_leaves(small)[0], grads[0][0])
    want = jax.tree.leaves(jadam.clip_by_global_norm(
        [(jnp.full((3,), 3.0), jnp.full((4,), 4.0))], 1.0))
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_huge_clip_threshold_is_identity():
    off, m_off = _tiny_fit(BASE)
    on, m_on = _tiny_fit(BASE.replace(max_grad_norm=1e9))
    for a, b in zip(_leaves(off), _leaves(on)):
        np.testing.assert_array_equal(a, b)
    _assert_fit_matches(on, m_on, BASE)


def test_tight_clip_changes_updates_and_stays_finite():
    off, _ = _tiny_fit(BASE)
    cfg = BASE.replace(max_grad_norm=1e-3)
    on, m = _tiny_fit(cfg)
    assert np.isfinite(float(m.value_loss))
    assert _differs(off, on, "v_params"), "a tight clip must change updates"
    _assert_fit_matches(on, m, cfg)


def test_target_kl_freezes_after_first_breach():
    """An unreachably small target freezes the policy within the first
    few minibatches; the value phase is not affected."""
    off, _ = _tiny_fit(BASE)
    n_updates = BASE.n_epochs_policy * BASE.num_minibatches
    assert off.opt_policy.t == n_updates
    on, m = _tiny_fit(BASE.replace(target_kl=1e-12))
    assert 1 <= on.opt_policy.t <= 3 < n_updates
    assert on.opt_log_std.t == on.opt_policy.t
    assert on.opt_v.t == BASE.n_epochs_value * BASE.num_minibatches
    assert np.isfinite(float(m.policy_loss))


def test_target_kl_generous_is_identity():
    off, _ = _tiny_fit(BASE)
    on, m = _tiny_fit(BASE.replace(target_kl=1e9))
    for a, b in zip(_leaves(off), _leaves(on)):
        np.testing.assert_array_equal(a, b)
    _assert_fit_matches(on, m, BASE)


def test_lr_anneal_endpoint_and_effect():
    cfg = BASE.replace(lr_anneal=True, n_epochs=1, fits_per_epoch=1)
    pcfg = _port(cfg)
    total = cfg.n_epochs * cfg.fits_per_epoch * cfg.n_epochs_value \
        * cfg.num_minibatches
    end = adam.AdamState(m=None, v=None, t=total)
    assert float(ppo._lr(3e-4, pcfg, end, cfg.num_minibatches,
                         cfg.n_epochs_value)) == 0.0
    for t in (0, 1, total // 2, total - 1):
        got = ppo._lr(3e-4, pcfg, adam.AdamState(None, None, t),
                      cfg.num_minibatches, cfg.n_epochs_value)
        want = jppo._lr(3e-4, cfg, jadam.AdamState(
            None, None, jnp.asarray(t, jnp.int32)), cfg.num_minibatches,
            cfg.n_epochs_value)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(want)
    mid = adam.AdamState(m=None, v=None, t=total // 2)
    assert 0.0 < float(ppo._lr(3e-4, pcfg, mid, cfg.num_minibatches,
                               cfg.n_epochs_value)) < 3e-4
    off, _ = _tiny_fit(BASE)
    on, m = _tiny_fit(cfg)
    assert _differs(off, on, "v_params")
    _assert_fit_matches(on, m, cfg)


def test_stabilizers_compose_and_learn():
    """The JAX test's run, from the JAX Trainer's seed-0 params (whether
    this 15-step toy is solved at all is set by the init's action slope,
    tests/test_ep.py:243-245; the port's own seed-0 draw is another
    init), trained on the port's own draws."""
    cfg = PPOConfig(env="simple", n_envs=32, rollout_len=15,
                    minibatch_size=64, fits_per_epoch=5, eval_envs=64,
                    eval_len=15, kernel_backend="jnp", hidden=(32, 32),
                    seed=0, max_grad_norm=0.5, target_kl=0.05,
                    lr_anneal=True, n_epochs=6)
    jcfg = JPPOConfig(**dataclasses.asdict(cfg))
    jts = jax.jit(lambda k: jppo.init_train_state(
        jcfg, jenvs.make("simple"), k))(jax.random.split(
            jax.random.PRNGKey(cfg.seed))[0])
    tr = Trainer(cfg, "cpu")
    tr.state = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    hist = tr.train(log=False)
    assert hist[-1]["R"] > 0.5


def test_clipped_value_loss_math():
    v = torch.tensor([1.0, 5.0, -2.0])
    vo = torch.zeros(3)
    t = torch.full((3,), 2.0)
    v_cl = np.clip(v.numpy(), -0.5, 0.5)
    expect = np.mean(np.maximum((v.numpy() - 2.0) ** 2, (v_cl - 2.0) ** 2))
    got = float(losses.clipped_value_loss(v, vo, t, 0.5))
    assert got == pytest.approx(expect, rel=1e-6)
    rng = np.random.default_rng(0)
    v, vo, t = rng.normal(size=(3, 64)).astype(np.float32)
    tv = torch.tensor(v, requires_grad=True)
    loss = losses.clipped_value_loss(tv, torch.tensor(vo), torch.tensor(t),
                                     0.2)
    loss.backward()
    jl, jg = jax.value_and_grad(lambda x: jlosses.clipped_value_loss(
        x, jnp.asarray(vo), jnp.asarray(t), 0.2))(jnp.asarray(v))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_huge_clip_value_is_identity_to_float_noise():
    off, _ = _tiny_fit(BASE)
    on, m = _tiny_fit(BASE.replace(clip_value=1e9))
    for a, b in zip(_leaves(off), _leaves(on)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=1e-5, atol=1e-6)
    _assert_fit_matches(on, m, BASE)


def test_tight_clip_value_changes_updates():
    off, _ = _tiny_fit(BASE)
    cfg = BASE.replace(clip_value=1e-3)
    on, m = _tiny_fit(cfg)
    assert np.isfinite(float(m.value_loss))
    assert _differs(off, on, "v_params")
    _assert_fit_matches(on, m, cfg)


def test_ent_anneal():
    cfg = BASE.replace(ent_coeff=0.01)
    off, _ = _tiny_fit(cfg)
    ann = cfg.replace(ent_anneal=True, n_epochs=1, fits_per_epoch=1)
    on, m = _tiny_fit(ann)
    assert _differs(off, on, "policy_params")
    _assert_fit_matches(on, m, ann)
    total = ann.n_epochs_policy * ann.num_minibatches
    assert float(ppo._ent_coeff(_port(ann), adam.AdamState(None, None, total),
                                ann.num_minibatches)) == 0.0


# --- the recurrent pair, on the attention trunk ----------------------------------

ABASE = JPPOConfig(env="recall", n_envs=16, rollout_len=6, minibatch_size=24,
                   hidden=(16,), attn_dim=8, attn_layers=1, attn_heads=2,
                   n_epochs_policy=2, n_epochs_value=2)


SEQ_HELD = ABASE.replace(max_grad_norm=0.5, lr_anneal=True, ent_anneal=True,
                         ent_coeff=0.01, clip_value=0.1, target_kl=1e9)


@functools.lru_cache(maxsize=None)
def _jax_seq_side():
    """The attention params (:func:`_shared_start`, seed 0, the
    stabilisers off), the port's rollout_rnn from them on its own draws
    (seed 1) as both packages' trajectory, and SEQ_HELD's JAX update of
    key 2, one jitted program."""
    env = jenvs.make(ABASE.env)
    off = ABASE.replace(**_STAB_OFF)
    ts, penv, jts = _shared_start(off, 0)
    traj, _ = precurrent.rollout_rnn(
        _port(off), penv, ts.policy_params,
        precurrent.draw_seq(penv, torch.Generator().manual_seed(1), 16, 6,
                            "cpu"))
    jtraj = jppo.Transition(*(x.numpy() for x in traj))
    fit = jax.jit(lambda ts, tr: jppo.update_step(
        SEQ_HELD, env, ts, tr, jax.random.PRNGKey(2), backend="jnp"))(
            jts, jtraj)
    return jts, traj, jax.device_get(fit)


def _seq_fit(jcfg, against_jax=True):
    """One sequence update_step of the port on the JAX rollout_rnn
    trajectory and its env-column streams (key 2); ``against_jax`` (for
    SEQ_HELD) also holds every leaf and Adam counter to the JAX package's
    update as tests/test_torch_recurrent.py does (``_fit_leaves_close``:
    the attention key bias, whose gradient is 0 in exact arithmetic,
    within its rounding-noise bounds).  Returns (port state after,
    metrics)."""
    from test_torch_recurrent import _fit_leaves_close, jax_columns

    jts, traj, (jts2, jm) = _jax_seq_side()
    k_val, k_pol = jax.random.split(jax.random.PRNGKey(2))
    draws = ppo.FitDraws(None, jax_columns(jcfg, k_val, jcfg.n_epochs_value),
                         jax_columns(jcfg, k_pol, jcfg.n_epochs_policy))
    ts = conv.train_state_from_numpy(jts, "cpu")
    ts2, m = ppo.update_step(_port(jcfg), envs.make(jcfg.env), ts, traj,
                             draws, None)
    if not against_jax:
        return ts2, m
    assert jcfg == SEQ_HELD
    got = conv.train_state_to_numpy(ts2)
    for part, tol in (("policy_params", W_TOL), ("v_params", W_TOL),
                      ("opt_policy.m", W_TOL), ("opt_v.m", W_TOL),
                      ("opt_log_std.m", W_TOL), ("opt_policy.v", V_TOL),
                      ("opt_v.v", V_TOL)):
        _fit_leaves_close(part, got, jts2, jts, tol)
    assert (got.opt_v.t, got.opt_policy.t, got.opt_log_std.t) == (
        int(jts2.opt_v.t), int(jts2.opt_policy.t), int(jts2.opt_log_std.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), **M_TOL)
    return ts2, m


def test_recurrent_phases_honor_stabilizers():
    """The JAX test's counts, on the port.  (A target of 1e-12 is below
    the first minibatch's KL rounding noise, whose sign differs between
    the packages, so the freeze point is each package's own; the sequence
    phases' parity is test_recurrent_stabilizers_match_jax.)"""
    ts2, _ = _seq_fit(ABASE.replace(target_kl=1e-12, max_grad_norm=0.5),
                      against_jax=False)
    n_updates = ABASE.n_epochs_policy * (16 // (24 // 6))
    assert 1 <= ts2.opt_policy.t < n_updates
    assert ts2.opt_log_std.t == ts2.opt_policy.t
    assert ts2.opt_v.t == ABASE.n_epochs_value * 4


def test_clip_value_recurrent():
    ts2, m = _seq_fit(ABASE.replace(n_epochs_policy=1, clip_value=0.1),
                      against_jax=False)
    assert np.isfinite(float(m.value_loss))
    assert ts2.opt_v.t == ABASE.n_epochs_value * 4


def test_recurrent_stabilizers_match_jax():
    """The clip, both annealings and value clipping together in the
    sequence phases: the whole fit held to the JAX package's."""
    _seq_fit(SEQ_HELD)


# --- beyond the JAX file ----------------------------------------------------------

def test_policy_clip_spans_mlp_and_log_std():
    """The policy step clips {"mlp", "log_std"} as one tree, as the JAX
    package's _prep_grads does: one scale from the joint norm, against
    the JAX clip on the same tree; clipping the two apart (the control)
    does not reproduce it."""
    rng = np.random.default_rng(3)
    mlp_g = [(rng.normal(size=(3, 4)).astype(np.float32) * 0.01,
              rng.normal(size=4).astype(np.float32) * 0.01)]
    ls_g = np.array([2.0, -1.5], np.float32)
    tree = {"mlp": [tuple(map(torch.tensor, l)) for l in mlp_g],
            "log_std": torch.tensor(ls_g)}
    cfg = _port(BASE.replace(max_grad_norm=0.5))
    got = ppo._prep_grads(cfg, tree)
    want = jadam.clip_by_global_norm(
        {"mlp": [tuple(map(jnp.asarray, l)) for l in mlp_g],
         "log_std": jnp.asarray(ls_g)}, 0.5)
    for a, b in zip(adam.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    joint = float(np.sqrt(sum(float(torch.sum(g * g))
                              for g in adam.tree_leaves(got))))
    assert joint == pytest.approx(0.5, rel=1e-5)
    apart = adam.clip_by_global_norm(tree["mlp"], 0.5)
    assert not np.allclose(adam.tree_leaves(apart)[0].numpy(),
                           adam.tree_leaves(got["mlp"])[0].numpy())


def test_target_kl_reports_the_frozen_minibatches():
    """With a target the policy crosses part-way, the freeze lands on the
    JAX package's minibatch (its Adam counters), and the reported loss and
    entropy are the means over every minibatch, the frozen ones included,
    as the JAX scan's are: a loop that stopped at the breach would report
    other means."""
    n_updates = BASE.n_epochs_policy * BASE.num_minibatches
    for target in (1e-4, 1e-3):
        cfg = BASE.replace(target_kl=target, ent_coeff=0.01)
        on, m = _tiny_fit(cfg)
        assert 1 < on.opt_policy.t < n_updates, target
        _assert_fit_matches(on, m, cfg)


@pytest.mark.parametrize("backend", ["pallas", "bf16"])
def test_stabilizers_on_the_kernel_backends(backend):
    """All five stabilisers on the "pallas" backend (K5's plain version
    here; the fused gate refuses them) and "bf16": the "pallas" fit holds
    to the JAX package's "jnp" one at the same tolerances, the "bf16" one
    stays finite with the same Adam counters."""
    cfg = BASE.replace(max_grad_norm=0.5, clip_value=0.2, target_kl=0.02,
                       lr_anneal=True, ent_anneal=True, ent_coeff=0.01)
    on, m = _tiny_fit(cfg, backend)
    if backend == "pallas":
        _assert_fit_matches(on, m, cfg)
    else:
        jon, _ = _jax_update(cfg)
        assert all(np.isfinite(float(x)) for x in m)
        assert (on.opt_policy.t, on.opt_v.t) == (int(jon.opt_policy.t),
                                                 int(jon.opt_v.t))

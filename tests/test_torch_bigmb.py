"""Port parity for K3 bf16 and K4 bf16, the bf16 big-tile phases: the plain
versions (``ops/cuda_update.py``) and ``ppo.value_phase_fused`` /
``policy_phase_fused(..., bf16=True)`` against the JAX package's
``pallas_update.value_phase_fused`` / ``policy_phase_fused(..., bf16=True)``
in interpret mode, at tests/test_bigmb.py's size (pendulum 32 x 128,
minibatch 4096, hidden (32, 32)), on the same rows: the ids come from the
JAX package's ``_stream_ids`` and the weights are carried across by
``utils/params.py``.

Tolerances.  Both sides round at the same points (each product's operands
to bf16, the hidden post-activations to bf16, the cotangents to bf16
before both backward products, the bias gradients from the float32
cotangent), so they part only where a float32 sum taken in another order
moves a value across a bf16 rounding boundary.  One step is held leaf by
leaf at bf16 scale with a bounded share of elements apart
(``_bf16_close``, as tests/test_torch_bf16.py holds its bf16 gradients),
and by each leaf's relative distance (STEP_REL), which the plain version
with the cotangent left float32 fails.
A whole phase is held at the float32 fused phases' tolerances
(tests/test_torch_update.py: weights rtol 1e-4, atol 1e-6; the value loss
rel 1e-5, the policy loss rel 1e-4 with abs 1e-6), 500 and 200 times
tighter than tests/test_bigmb.py holds the kernel against the scan, since
here the rounding points are the same and there they are not (measured:
the weights within 9e-7 relative, the losses equal).  The scan twin (the port's generic
bf16 phases, whose autodiff keeps the cotangents float32) is held at
test_bigmb's own tolerances (loss rel 2e-2; weights rtol 5e-2, atol 2e-4).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import cuda_update as cu
from ppoc_tpu_torch.ops.adam import AdamState
from ppoc_tpu_torch.utils import params as conv
from test_bigmb import _bigmb_cfg, _setup
from test_torch_bf16 import _bf16_close

torch.set_num_threads(2)

# same rounding points: the float32 fused phases' tolerances
PHASE_TOL = dict(rtol=1e-4, atol=1e-6)
PHASE_LOSS_REL = 1e-5
# test_bigmb's own, for the scan twin (the cotangents float32 there)
SCAN_TOL = dict(rtol=5e-2, atol=2e-4)
SCAN_LOSS_REL = 2e-2
# One step, leaf by leaf: the largest relative two-norm distance of a leaf
# (each W and b of the net, of m and of v; log_std and its moments) from
# the JAX kernel's.  After one step Adam moves every weight by about lr
# whatever the gradient, so m and v carry it.  Read: 8.1e-7 (value),
# 1.1e-6 (policy); the plain version with the cotangent left float32
# reads 3.0e-4 and 3.8e-3, and test_one_step_check_sees_the_cotangent_rounding
# holds it beyond this limit.
STEP_REL = 1e-5


def _port_setup(cfg, seed=0):
    """The JAX package's state and buffer (tests/test_bigmb.py's _setup) and
    the same in the port."""
    _, jts, jbuf = _setup(cfg, seed)
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    buf = buffer.RowBuffer(*(torch.tensor(np.asarray(x)) for x in jbuf[:5]))
    return jts, jbuf, ts, buf


def _stream(cfg, key, n_epochs):
    """The JAX package's id stream for ``key``, as [n_epochs, n_mb, ...]."""
    flat, _ = jpu._stream_ids(cfg, key, cfg.steps_per_fit,
                              cfg.num_minibatches, cfg.minibatch_size,
                              n_epochs)
    return torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
        n_epochs, cfg.num_minibatches, -1)


def _leaves(tree):
    return jax.tree.leaves(conv.tree_to_numpy(tree))


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(tree))]


def _leaf_dist(got, want):
    return max(float(np.linalg.norm(np.float64(a) - np.float64(b))
                     / np.linalg.norm(np.float64(b)))
               for a, b in zip(got, want))


def _allclose(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


# --- the gate and the tile rule ------------------------------------------------

@pytest.mark.parametrize("mb", [64, 2048, 3072, 4096, 5000, 8192, 16384])
def test_bigmb_ok_and_tile_match_jax(mb):
    assert cu.bigmb_ok(mb) == jpu.bigmb_ok(mb)
    _, n_sub, tile, *_ = jpu._phase_layout(1, mb, jpu._MAX_TILE_BF16,
                                           allow_unroll=False)
    assert cu.bf16_tile(mb) == tile and mb // tile == n_sub
    assert cu.MAX_TILE_BF16 == jpu._MAX_TILE_BF16


def test_plain_refuses_a_tile_that_does_not_divide_the_minibatch():
    cfg = _bigmb_cfg(n_epochs_value=1)
    _, _, ts, buf = _port_setup(cfg)
    with pytest.raises(ValueError, match="row tile"):
        cu.value_phase_bf16_plain(buf.obs[:4096], buf.target[:4096],
                                  ts.v_params, ts.opt_v, 1, 4096, "relu",
                                  ppo._hyper(cfg, cfg.lr_v), 1000)


@pytest.mark.parametrize("widths,what", [
    ((3, 600, 1), "512 wide"), ((3,) + (16,) * 8 + (1,), "1-8 layers")])
def test_kernel_refuses_nets_past_its_limits(widths, what):
    """K3 bf16 takes 1-8 layers, each at most 512 wide; its wrapper says so
    before it looks for the card."""
    params = [(torch.zeros(a, b), torch.zeros(b))
              for a, b in zip(widths[:-1], widths[1:])]
    opt = AdamState([(torch.zeros_like(w), torch.zeros_like(b))
                     for w, b in params],
                    [(torch.zeros_like(w), torch.zeros_like(b))
                     for w, b in params], 0)
    with pytest.raises(ValueError, match=what):
        cu.value_phase_bf16_kernel(torch.zeros(64, 3), torch.zeros(64),
                                   params, opt, 1, 64, "relu",
                                   cu.Hyper.of(1e-3, 0.9, 0.999, 1e-8))


# --- the plain versions against the JAX kernels in interpret mode ----------

@pytest.mark.parametrize("n_epochs", [1, 2])
def test_value_phase_bf16_matches_jax(n_epochs):
    """One step (one epoch of one minibatch) at bf16 leaf scale, then a
    whole two-step phase at PHASE_TOL, through ppo.value_phase_fused."""
    cfg = _bigmb_cfg(n_epochs_value=n_epochs)
    jts, jbuf, ts, buf = _port_setup(cfg)
    k = jax.random.PRNGKey(7)
    jp, jo, jloss = jax.jit(lambda vp, ov, key: jpu.value_phase_fused(
        cfg, vp, ov, jbuf, key, bf16=True))(jts.v_params, jts.opt_v, k)
    ts2, loss = ppo.value_phase_fused(cfg, ts, buf, _stream(cfg, k, n_epochs),
                                      bf16=True)
    assert ts2.opt_v.t == int(jo.t) == n_epochs
    got = _leaves((ts2.v_params, ts2.opt_v.m, ts2.opt_v.v))
    want = _jleaves((jp, jo.m, jo.v))
    if n_epochs == 1:
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        _bf16_close(zip(got, want), 0.01, "value phase, one step")
        assert _leaf_dist(got, want) <= STEP_REL
    else:
        assert float(loss) == pytest.approx(float(jloss), rel=PHASE_LOSS_REL)
        _allclose(got[:6], want[:6], PHASE_TOL)


@pytest.mark.parametrize("ent_coeff", [0.0, 0.01])
@pytest.mark.parametrize("n_epochs", [1, 2])
def test_policy_phase_bf16_matches_jax(ent_coeff, n_epochs):
    cfg = _bigmb_cfg(ent_coeff=ent_coeff, n_epochs_policy=n_epochs)
    jts, jbuf, ts, buf = _port_setup(cfg, seed=1)
    k = jax.random.PRNGKey(11)
    pol, op, ols, jloss, jent = jax.jit(
        lambda t, key: jpu.policy_phase_fused(
            cfg, t.policy_params, t.opt_policy, t.opt_log_std, jbuf, key,
            bf16=True))(jts, k)
    ts2, loss, ent = ppo.policy_phase_fused(
        cfg, ts, buf, _stream(cfg, k, n_epochs), bf16=True)
    assert ts2.opt_policy.t == int(op.t) == n_epochs
    assert ts2.opt_log_std.t == int(ols.t) == n_epochs
    assert float(ent) == pytest.approx(float(jent), rel=1e-6)
    got = _leaves((ts2.policy_params, ts2.opt_policy.m, ts2.opt_policy.v,
                   ts2.opt_log_std.m, ts2.opt_log_std.v))
    want = _jleaves((pol, op.m, op.v, ols.m, ols.v))
    if n_epochs == 1:
        # the surrogate is a mean of order-1 terms that cancel to ~1e-4
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4, abs=1e-6)
        _bf16_close(zip(got, want), 0.01, "policy phase, one step")
        assert _leaf_dist(got, want) <= STEP_REL
    else:
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4,
                                            abs=1e-6)
        _allclose(_leaves(ts2.policy_params), _jleaves(pol), PHASE_TOL)


@pytest.mark.parametrize("kind", ["value", "policy"])
def test_one_step_check_sees_the_cotangent_rounding(kind):
    """The plain version with the cotangent left float32 (a kernel that
    skipped that rounding) fails the one-step leaf check against the JAX
    kernel that the plain version passes."""
    cfg = _bigmb_cfg(n_epochs_value=1, n_epochs_policy=1)
    jts, jbuf, ts, buf = _port_setup(cfg, seed=1)
    k = jax.random.PRNGKey(13)
    idx = _stream(cfg, k, 1)
    if kind == "value":
        jp, jo, _ = jax.jit(lambda vp, ov, key: jpu.value_phase_fused(
            cfg, vp, ov, jbuf, key, bf16=True))(jts.v_params, jts.opt_v, k)
        want = _jleaves((jp, jo.m, jo.v))
        cols = buffer.gather_mb((buf.obs, buf.target), idx)
        args = (*cols, ts.v_params, ts.opt_v, 1, cfg.minibatch_size,
                cfg.activation, ppo._hyper(cfg, cfg.lr_v))
        plain = cu.value_phase_bf16_plain

        def leaves(out):
            return _leaves((out[0], out[1].m, out[1].v))
    else:
        pol, op, ols, _, _ = jax.jit(lambda t, key: jpu.policy_phase_fused(
            cfg, t.policy_params, t.opt_policy, t.opt_log_std, jbuf, key,
            bf16=True))(jts, k)
        want = _jleaves((pol, op.m, op.v, ols.m, ols.v))
        cols = buffer.gather_mb((buf.obs, buf.action, buf.log_prob,
                                 buf.advantage), idx)
        p = ts.policy_params
        args = (*cols, p["mlp"], p["log_std"], ts.opt_policy,
                ts.opt_log_std, 1, cfg.minibatch_size, cfg.activation,
                ppo._hyper(cfg, cfg.lr_policy), cfg.clip_eps, cfg.ent_coeff)
        plain = cu.policy_phase_bf16_plain

        def leaves(out):
            return _leaves(({"mlp": out[0], "log_std": out[1]}, out[2].m,
                            out[2].v, out[3].m, out[3].v))
    assert _leaf_dist(leaves(plain(*args)), want) <= STEP_REL
    control = plain(*args, round_cotangent=False)
    assert _leaf_dist(leaves(control), want) > 10 * STEP_REL


# --- the kernels' sum order: tiles in groups, then the groups ----------------

def _one_step(kind, cfg, ts, buf, idx):
    """(plain, args) of one step of ``kind`` on the stream ``idx``."""
    if kind == "value":
        cols = buffer.gather_mb((buf.obs, buf.target), idx)
        return cu.value_phase_bf16_plain, (
            *cols, ts.v_params, ts.opt_v, 1, cfg.minibatch_size,
            cfg.activation, ppo._hyper(cfg, cfg.lr_v))
    cols = buffer.gather_mb((buf.obs, buf.action, buf.log_prob,
                             buf.advantage), idx)
    p = ts.policy_params
    return cu.policy_phase_bf16_plain, (
        *cols, p["mlp"], p["log_std"], ts.opt_policy, ts.opt_log_std, 1,
        cfg.minibatch_size, cfg.activation, ppo._hyper(cfg, cfg.lr_policy),
        cfg.clip_eps, cfg.ent_coeff)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("kind", ["value", "policy"])
def test_plain_sums_tiles_in_groups(monkeypatch, kind, group):
    """At 8 row tiles of 512 each dW and db a plain version hands Adam is,
    bit for bit, the explicit float32 sum of its tiles' partials in groups
    of ``group`` (each from zero; the last group short at 3), then the
    groups in order; at group 1 every tile added in turn."""
    cfg = _bigmb_cfg(n_epochs_value=1, n_epochs_policy=1)
    _, _, ts, buf = _port_setup(cfg, seed=1)
    plain, args = _one_step(kind, cfg, ts, buf,
                            _stream(cfg, jax.random.PRNGKey(13), 1))
    calls = []
    tile_sum = cu._tile_sum

    def record(parts, g):
        out = tile_sum(parts, g)
        calls.append((parts.clone(), g, out.clone()))
        return out

    monkeypatch.setattr(cu, "_tile_sum", record)
    plain(*args, 512, group=group)
    assert len(calls) == 6   # dW and db of each of the 3 layers
    for parts, g, out in calls:
        assert g == group and parts.shape[0] == 8
        want = torch.zeros_like(parts[0])
        for g0 in range(0, 8, group):
            part = torch.zeros_like(parts[0])
            for tile in parts[g0:g0 + group]:
                part = part + tile
            want = want + part
        assert torch.equal(out, want)
        if group == 1:
            flat = torch.zeros_like(parts[0])
            for tile in parts:
                flat = flat + tile
            assert torch.equal(out, flat)


@pytest.mark.parametrize("group", [2, 8])
@pytest.mark.parametrize("kind", ["value", "policy"])
def test_plain_in_groups_holds_to_jax(kind, group):
    """The one-step leaf check against the JAX kernel holds in any sum
    order the kernel may take: row tiles of 128 summed in groups of
    ``group``."""
    cfg = _bigmb_cfg(n_epochs_value=1, n_epochs_policy=1)
    jts, jbuf, ts, buf = _port_setup(cfg, seed=1)
    k = jax.random.PRNGKey(13)
    plain, args = _one_step(kind, cfg, ts, buf, _stream(cfg, k, 1))
    out = plain(*args, 128, group=group)
    if kind == "value":
        jp, jo, _ = jax.jit(lambda vp, ov, key: jpu.value_phase_fused(
            cfg, vp, ov, jbuf, key, bf16=True))(jts.v_params, jts.opt_v, k)
        want = _jleaves((jp, jo.m, jo.v))
        got = _leaves((out[0], out[1].m, out[1].v))
    else:
        pol, op, ols, _, _ = jax.jit(lambda t, key: jpu.policy_phase_fused(
            cfg, t.policy_params, t.opt_policy, t.opt_log_std, jbuf, key,
            bf16=True))(jts, k)
        want = _jleaves((pol, op.m, op.v, ols.m, ols.v))
        got = _leaves(({"mlp": out[0], "log_std": out[1]}, out[2].m,
                       out[2].v, out[3].m, out[3].v))
    assert _leaf_dist(got, want) <= STEP_REL


def test_plain_refuses_a_group_below_one():
    cfg = _bigmb_cfg(n_epochs_value=1)
    _, _, ts, buf = _port_setup(cfg)
    with pytest.raises(ValueError, match="group"):
        cu.value_phase_bf16_plain(buf.obs[:4096], buf.target[:4096],
                                  ts.v_params, ts.opt_v, 1, 4096, "relu",
                                  ppo._hyper(cfg, cfg.lr_v), group=0)


def test_value_phase_bf16_two_minibatches_match_jax(monkeypatch):
    """Minibatch 3072 in row tiles of 1024 (three sub-tiles; the JAX
    package's tile cap lowered to 1024 as test_bigmb_value_subtiling_exact
    lowers it: its own rule takes one tile of 3072 here) and two
    minibatches an epoch: Adam's timestep advances by 4 over two epochs,
    and the phase holds to the JAX kernel's."""
    cfg = _bigmb_cfg(n_envs=48, minibatch_size=3072, n_epochs_value=2)
    assert cfg.num_minibatches == 2 and cu.bf16_tile(3072) == 3072
    jts, jbuf, ts, buf = _port_setup(cfg)
    k = jax.random.PRNGKey(5)
    monkeypatch.setattr(jpu, "_MAX_TILE_BF16", 1024)
    jp, jo, jloss = jax.jit(lambda vp, ov, key: jpu.value_phase_fused(
        cfg, vp, ov, jbuf, key, bf16=True))(jts.v_params, jts.opt_v, k)
    obs, tgt = buffer.gather_mb((buf.obs, buf.target), _stream(cfg, k, 2))
    p2, o2, loss = cu.value_phase_bf16_plain(
        obs, tgt, ts.v_params, ts.opt_v, 4, 3072, cfg.activation,
        ppo._hyper(cfg, cfg.lr_v), 1024)
    assert o2.t - ts.opt_v.t == int(jo.t) - int(jts.opt_v.t) == 4
    assert float(loss) == pytest.approx(float(jloss), rel=PHASE_LOSS_REL)
    _allclose(_leaves(p2), _jleaves(jp), PHASE_TOL)


def test_value_phase_bf16_subtiling_is_float32_noise():
    """The plain version's tile sums (float32 over bf16 partial products)
    at tile 1024 against one tile of 4096, to float32 reduction noise, as
    test_bigmb_value_subtiling_exact holds the JAX kernel."""
    cfg = _bigmb_cfg(n_epochs_value=2)
    _, _, ts, buf = _port_setup(cfg)
    idx = _stream(cfg, jax.random.PRNGKey(3), 2)
    obs, tgt = buffer.gather_mb((buf.obs, buf.target), idx)
    hyper = ppo._hyper(cfg, cfg.lr_v)
    runs = [cu.value_phase_bf16_plain(obs, tgt, ts.v_params, ts.opt_v, 2,
                                      4096, cfg.activation, hyper, tile)
            for tile in (4096, 1024)]
    assert float(runs[0][2]) == pytest.approx(float(runs[1][2]), rel=1e-5)
    _allclose(_leaves(runs[1][0]), _leaves(runs[0][0]),
              dict(rtol=1e-4, atol=1e-6))


# --- the scan twin: the port's own generic bf16 phases ------------------------

def test_bf16_tile_phases_match_the_generic_bf16_phases():
    """Both plain bf16-tile phases against the port's generic bf16 phases
    (``ppo.value_phase`` / ``policy_phase`` under kernel_backend "bf16")
    on the same block stream, at test_bigmb's tolerances."""
    cfg = PPOConfig(**dataclasses.asdict(_bigmb_cfg(
        ent_coeff=0.01, shuffle_block=1024)))
    _, _, ts, buf = _port_setup(cfg)
    assert not ppo._fused(cfg, True)
    idx = ppo.draw_fit(cfg, torch.Generator().manual_seed(4), "cpu")
    tk, lk = ppo.value_phase_fused(cfg, ts, buf, idx.value_idx, bf16=True)
    tr, lr = ppo.value_phase(cfg, ts, buf, idx.value_idx)
    assert float(lk) == pytest.approx(float(lr), rel=SCAN_LOSS_REL)
    _allclose(_leaves(tk.v_params), _leaves(tr.v_params), SCAN_TOL)
    tk, lk, ek = ppo.policy_phase_fused(cfg, ts, buf, idx.policy_idx,
                                        bf16=True)
    tr, lr, er = ppo.policy_phase(cfg, ts, buf, idx.policy_idx)
    assert float(ek) == pytest.approx(float(er), rel=1e-3)
    assert float(lk) == pytest.approx(float(lr), rel=SCAN_LOSS_REL, abs=1e-4)
    _allclose(_leaves(tk.policy_params), _leaves(tr.policy_params), SCAN_TOL)
    assert (tk.opt_policy.t, tk.opt_log_std.t) == (tr.opt_policy.t,
                                                    tr.opt_log_std.t)


def test_policy_phase_fused_refuses_a_categorical_policy():
    cfg = PPOConfig(env="cartpole", n_envs=8, rollout_len=16,
                    minibatch_size=32, hidden=(16, 16))
    tr = Trainer(cfg, "cpu")
    buf = buffer.RowBuffer(torch.zeros(128, 4),
                           torch.zeros(128, 1, dtype=torch.int32),
                           torch.zeros(128), torch.zeros(128),
                           torch.zeros(128))
    idx = torch.arange(128).reshape(1, 4, 32)
    with pytest.raises(ValueError, match="categorical"):
        ppo.policy_phase_fused(cfg, tr.state, buf, idx, bf16=True)


def test_value_phase_fused_without_bf16_is_k3():
    """bf16=False runs K3's plain version on the same gathered rows."""
    cfg = _bigmb_cfg(n_epochs_value=1, minibatch_size=1024)
    _, _, ts, buf = _port_setup(cfg)
    idx = _stream(cfg, jax.random.PRNGKey(2), 1)
    ts2, loss = ppo.value_phase_fused(cfg, ts, buf, idx)
    obs, tgt = buffer.gather_mb((buf.obs, buf.target), idx)
    want = cu.value_phase_plain(obs, tgt, ts.v_params, ts.opt_v, 4, 1024,
                                cfg.activation, ppo._hyper(cfg, cfg.lr_v))
    assert torch.equal(loss, want[2])
    for a, b in zip(mlp.flatten(ts2.v_params), mlp.flatten(want[0])):
        assert torch.equal(a, b)


# --- no trainer path routes here ------------------------------------------------

def test_no_trainer_path_selects_the_bf16_tile_phases(monkeypatch):
    """A bf16 Trainer at minibatch 4096 in blocks of 1024 (the throughput
    regime in small) fits and evaluates without calling either bf16-tile
    phase, as the JAX package's gate never routes there."""
    def refuse(*_, **__):
        raise AssertionError("a trainer path reached a bf16-tile phase")

    for name in ("value_phase_bf16", "policy_phase_bf16",
                 "value_phase_bf16_plain", "policy_phase_bf16_plain"):
        monkeypatch.setattr(cu, name, refuse)
    cfg = PPOConfig(env="pendulum", n_envs=32, rollout_len=128,
                    minibatch_size=4096, shuffle_block=1024,
                    n_epochs_value=2, n_epochs_policy=1, fits_per_epoch=1,
                    eval_envs=8, eval_len=200, hidden=(32, 32),
                    kernel_backend="bf16")
    tr = Trainer(cfg, "cpu")
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"])
    assert tr.state.opt_v.t == 2 and tr.state.opt_policy.t == 1

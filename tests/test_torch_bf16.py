"""Port parity for the "bf16" backend: each ported bf16 function against
the JAX package's ``kernel_backend="bf16"`` on the same inputs, drawn with
numpy from a seed, the weights carried across by ``utils/params.py``.

* ``mlp.apply(..., "bf16")``: bf16 operands, float32 products and output.
* One whole generic fit_step (K1 without the V planes, the bf16 value
  forwards, K2, both phases in bf16) against ``ppo.fit_step(backend=
  "bf16")``; the fused gate and ``kernel_fit`` under bf16.
* K7's bf16 plain versions (forward with the Pallas kernel's key tile as
  its chunk, the explicit backward) against ``pallas_attn.flash_mha(...,
  compute_dtype=bfloat16)`` in interpret mode.
* ``apply_seq`` on both cores, the ``BF16_SITES`` bisect, ``decode_next``
  and its repaired site gating, the sequence values and one sequence
  update_step.
* Small CPU Trainers under bf16 that must learn.

Tolerances.  A bf16 x bf16 product is exact in float32, so the two
packages' forwards part only by the order of float32 sums (rtol 1e-5 /
atol 1e-6 on values of order 1), except where such a difference moves a
value across a bf16 rounding boundary before the next product: one bf16
ulp (2^-8 of the value) there.  Gradients are rounded to bf16 where the
JAX VJP rounds them, so an element differs by at most one bf16 ulp of
itself (``_within_bf16_ulp``), and only a few elements do (the share is
bounded per test, from the measured share times about 10).  Whole fits
take a few Adam steps on such gradients: weights within rtol 1e-4 /
atol 1e-5 as tests/test_torch_throughput.py holds the f32 fit, the first
Adam moments within 2^-7 relative (two bf16 ulps of a gradient), the
second (squared gradients) within 2^-6, each plus 1e-3 of the leaf's
largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs
from ppoc_tpu.algo import ppo as jppo, recurrent as jrec
from ppoc_tpu.models import attn as jattn, mlp as jmlp
from ppoc_tpu.ops import pallas_attn
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo, recurrent
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.models import attn, mlp
from ppoc_tpu_torch.ops import (adam, cuda_attn, cuda_mlp, cuda_rollout,
                                cuda_update, resolve_backend)
from ppoc_tpu_torch.utils import params as conv
# the JAX package's draws, as the f32 parity tests take them
from test_torch_recurrent import jax_columns
from test_torch_throughput import jax_fit_draws

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
W_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16's unit roundoff: rounding to nearest moves a value by at most 2^-8
# of itself (half an ulp; an ulp is 2^-8 to 2^-7 of the value)
BF16_EPS = 2.0 ** -8


def _bf16_close(pairs, max_share: float, what: str = "", units: int = 2):
    """Each (got, want) leaf within ``units`` bf16 roundoffs (2^-8) of the
    leaf's largest magnitude, and at most ``max_share`` of all the elements
    apart by more than float32 rounding (1e-6 of the leaf's largest
    magnitude, at least 1e-6): the packages agree except where a float32
    sum order moved a value across a bf16 rounding boundary.  A float32
    computation held to a bf16 one fails the share."""
    n = apart = 0
    for i, (got, want) in enumerate(pairs):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        top = max(1.0, float(np.abs(want).max()))
        diff = np.abs(got - want)
        assert diff.max() <= units * BF16_EPS * top, (what, i, diff.max(),
                                                      top)
        n, apart = n + diff.size, apart + int((diff > 1e-6 * top).sum())
    assert apart <= max_share * n, (what, apart / n)


def _j(x):
    return jnp.asarray(x)


def _jcfg(**kw):
    base = dict(env="pendulum", n_envs=32, rollout_len=256,
                minibatch_size=4096, shuffle_block=1024, n_epochs_value=2,
                n_epochs_policy=1, fits_per_epoch=1, eval_envs=8,
                eval_len=200, hidden=(32, 32), kernel_backend="bf16")
    base.update(kw)
    return JPPOConfig(**base)


def _port(jcfg):
    return PPOConfig(**dataclasses.asdict(jcfg))


# --- the backend and the dense MLP ------------------------------------------

def test_bf16_backend_resolves():
    assert resolve_backend("bf16") == "bf16"
    assert ppo.backend_of(PPOConfig(kernel_backend="bf16")) == "bf16"


def test_mlp_apply_bf16_matches_jax():
    """Float32 out; outputs and every parameter gradient within one bf16
    ulp of the JAX package's, on at most 1% of elements beyond float32
    rounding (measured 0.2% of outputs, where a hidden value sits on a
    bf16 rounding boundary, and 0.1% of gradients: the two sum in another
    order before the gradient is rounded to bf16)."""
    rng = np.random.default_rng(0)
    widths = (10, 256, 256, 2)
    jp = jmlp.init(jax.random.PRNGKey(0), widths)
    x = rng.standard_normal((512, 10)).astype(np.float32)
    c = rng.standard_normal((512, 2)).astype(np.float32)
    want = jmlp.apply(jp, _j(x), "relu", "bf16")
    jg = jax.grad(lambda p: jnp.sum(jmlp.apply(p, _j(x), "relu", "bf16")
                                    * _j(c)))(jp)
    tp = conv.trunk_from_numpy(jax.device_get(jp), "cpu")
    leaves = adam.tree_map(lambda t: t.requires_grad_(), tp)
    got = mlp.apply(leaves, torch.tensor(x), "relu", "bf16")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _bf16_close([(got.detach().numpy(), want)], 0.01, "out")
    grads = torch.autograd.grad((got * torch.tensor(c)).sum(),
                                adam.tree_leaves(leaves))
    _bf16_close(zip(grads, jax.tree.leaves(jg)), 0.01, "gradients")


def test_mlp_apply_bf16_rounds_operands_not_the_output():
    """Inputs and weights that are bf16 values give the float32 product
    exactly (torch.matmul on two bf16 tensors would round the output);
    unknown backends are refused."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((64, 8)).astype(np.float32))
    p = [(torch.tensor(rng.standard_normal((8, 16)).astype(np.float32)),
          torch.zeros(16))]
    xb = x.to(torch.bfloat16).float()
    wb = p[0][0].to(torch.bfloat16).float()
    torch.testing.assert_close(mlp.apply(p, x, "relu", "bf16"), xb @ wb,
                               rtol=0, atol=0)
    assert not torch.equal(mlp.apply(p, x, "relu", "bf16"),
                           (xb.bfloat16() @ wb.bfloat16()).float())
    with pytest.raises(NotImplementedError, match="tp:x"):
        mlp.apply(p, x, "relu", "tp:x")


# --- the fit ------------------------------------------------------------------

def test_generic_fit_step_matches_jax_bf16_fit_step():
    """One fit at minibatch 4096 (2 x 4096 rows, blocks of 1024, [3,32,32,1]
    and [3,32,32,1]): K1 without the V planes, V(s) and V(s') as bf16
    forwards, K2, 2 value epochs and 1 policy epoch of generic bf16 steps,
    against the JAX package's fit_step(backend="bf16") with K1 and K2 in
    interpret mode."""
    jcfg = _jcfg()
    env, jenv = envs.make("pendulum"), jenvs.make("pendulum")
    jts = jppo.init_train_state(jcfg, jenv, jax.random.PRNGKey(0))
    ts = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    key = jax.random.PRNGKey(42)
    jts2, jm = jax.jit(lambda s, k: jppo.fit_step(
        jcfg, jenv, s, k, backend="bf16"))(jts, key)
    draws = jax_fit_draws(jcfg, key)
    assert draws.value_idx.shape == (2, 2, 4)
    counts = {k: c.n for k, c in cuda_rollout.lane_launches.items()}
    ts2, m = ppo.fit_step(_port(jcfg), env, ts, draws)
    assert counts == {k: c.n for k, c in cuda_rollout.lane_launches.items()}
    got = conv.train_state_to_numpy(ts2)
    want = jax.device_get(jts2)
    for a, b in zip(jax.tree.leaves((got.policy_params, got.v_params)),
                    jax.tree.leaves((want.policy_params, want.v_params))):
        np.testing.assert_allclose(a, np.asarray(b), **W_TOL)
    for moment, rtol in (("m", 2 * BF16_EPS), ("v", 4 * BF16_EPS)):
        for a, b in zip(
                jax.tree.leaves([getattr(o, moment) for o in (
                    got.opt_policy, got.opt_v, got.opt_log_std)]),
                jax.tree.leaves([getattr(o, moment) for o in (
                    want.opt_policy, want.opt_v, want.opt_log_std)])):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=1e-3 * np.abs(b).max())
    assert (got.opt_v.t, got.opt_policy.t) == (int(want.opt_v.t),
                                               int(want.opt_policy.t)) == (4, 2)
    # the policy loss is a mean of order-1 terms that cancel to ~1e-4
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mb", [64, 2048, 4096])
def test_fused_gate_is_pallas_only(monkeypatch, mb):
    """Under bf16 no whole-phase kernel runs at any minibatch size (the
    JAX package's gate is ``backend == "pallas"``), and the fit's K1
    launch takes no value net."""
    cfg = PPOConfig(env="pendulum", n_envs=32, rollout_len=128,
                    minibatch_size=mb, n_epochs_value=1, n_epochs_policy=1,
                    hidden=(8, 8), kernel_backend="bf16")
    assert not ppo._fused(cfg, True)
    assert ppo._fused(cfg.replace(kernel_backend="pallas"), True) == (
        mb <= ppo.MAX_FUSED_MB)
    calls = []
    for name in ("value_phase", "policy_phase", "policy_phase_categorical"):
        monkeypatch.setattr(cuda_update, name,
                            lambda *a, _n=name: calls.append(_n))
    for name in ("mlp_forward",):
        monkeypatch.setattr(cuda_mlp, name,
                            lambda *a, _n=name: calls.append(_n))
    seen = []
    real = cuda_rollout.rollout_fused
    monkeypatch.setattr(cuda_rollout, "rollout_fused", lambda *a, **kw: (
        seen.append(kw.get("v_params")) or real(*a, **kw)))
    env = envs.make("pendulum")
    ts = ppo.init_train_state(cfg, env, torch.Generator().manual_seed(0),
                              "cpu")
    ts2, _ = ppo.fit_step(cfg, env, ts, ppo.draw_fit(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    assert calls == [] and seen == [None]
    assert ts2.opt_v.t == cfg.num_minibatches


@pytest.mark.parametrize("env,hidden", [("pendulum", (64, 64)),
                                        ("reacher", (256, 256)),
                                        ("cartpole", (256, 256))])
def test_kernel_fit_under_bf16_lists_k1_only(env, hidden):
    """kernel_fit under bf16: K1 without the V planes, in the variant its
    bytes take; no K5, K3, K4 or K6."""
    cfg = PPOConfig(env=env, hidden=hidden, kernel_backend="bf16")
    fits = ppo.kernel_fit(cfg, 232448)
    spec = envs.make(env).spec
    pw = (spec.obs_dim, *hidden, spec.action_dim)
    assert [k.kernel for k in fits] == [f"K1 (rollout, {env} lane)"]
    assert fits[0].widths == (pw,)
    assert fits[0].nbytes == tuple(cuda_rollout.variant_bytes(pw))
    assert fits[0].variant == ("smem" if hidden == (64, 64) else "global")


# --- K7's bf16 variant, plain versions ----------------------------------------

def _case(T, B, H, hd, p_done, seed=0):
    rng = np.random.default_rng(seed + T)
    q, k, v = (rng.standard_normal((T, B, H, hd)).astype(np.float32)
               for _ in range(3))
    done = rng.random((T, B)) < p_done
    return q, k, v, np.asarray(jattn.episode_ids(_j(done))), done


FLASH_CASES = [(130, 2, 2, 8, 0.1), (1024, 1, 1, 8, 0.02)]


@pytest.mark.parametrize("T,B,H,hd,p_done", FLASH_CASES)
def test_bf16_flash_forward_matches_pallas(monkeypatch, T, B, H, hd, p_done):
    """out and lse of the plain bf16 forward, chunked by the Pallas
    kernel's key tile (128 at T 130, 256 at T 1024), against
    flash_mha_block(..., compute_dtype=bfloat16) in interpret mode: float32
    rounding (measured 2.4e-7); both float32."""
    monkeypatch.setattr(cuda_attn, "BF16_CHUNK", pallas_attn._tiles(T)[1])
    q, k, v, ep, _ = _case(T, B, H, hd, p_done)
    want = pallas_attn.flash_mha_block(*map(_j, (q, k, v, ep, ep)), 0,
                                       compute_dtype=jnp.bfloat16)
    got = cuda_attn.flash_mha_block(*map(torch.tensor, (q, k, v, ep, ep)), 0,
                                    compute_dtype=torch.bfloat16)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("T,B,H,hd,p_done", FLASH_CASES)
def test_bf16_flash_gradients_match_pallas(monkeypatch, T, B, H, hd, p_done):
    """dq, dk, dv through the explicit bf16 backward against the Pallas
    bf16 backward (dq and dk/dv kernels in interpret mode), for a loss
    with an out and an lse cotangent: each element within one bf16 ulp,
    at most 0.5% of them apart (measured 0.02%: the two sides' ds differ in
    the last float32 bit and round to neighbouring bf16 values); the
    folded gradients are bf16, the public ones float32."""
    monkeypatch.setattr(cuda_attn, "BF16_CHUNK", pallas_attn._tiles(T)[1])
    q, k, v, ep, _ = _case(T, B, H, hd, p_done, seed=5)
    rng = np.random.default_rng(9)
    c = rng.standard_normal(q.shape).astype(np.float32)
    c_lse = rng.standard_normal(q.shape[:-1]).astype(np.float32)

    def jloss(q, k, v):
        out, lse = pallas_attn.flash_mha_block(q, k, v, _j(ep), _j(ep), 0,
                                               compute_dtype=jnp.bfloat16)
        return jnp.sum(out * _j(c)) + jnp.sum(lse * _j(c_lse))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(_j, (q, k, v)))
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    out, lse = cuda_attn.flash_mha_block(*leaves, torch.tensor(ep),
                                         torch.tensor(ep), 0,
                                         compute_dtype=torch.bfloat16)
    tg = torch.autograd.grad((out * torch.tensor(c)).sum()
                             + (lse * torch.tensor(c_lse)).sum(), leaves)
    assert all(a.dtype == torch.float32 and b.dtype == jnp.float32
               for a, b in zip(tg, jg))
    _bf16_close(zip(tg, jg), 0.005, "dq, dk, dv")
    # the folded gradients the bf16 backward returns are bf16
    fq, fk, fv = (cuda_attn.fold(x).to(torch.bfloat16).requires_grad_()
                  for x in map(torch.tensor, (q, k, v)))
    epf = cuda_attn.fold_ep(torch.tensor(ep))
    o, _ = cuda_attn.attention_folded(fq, fk, fv, epf, epf, 0, H)
    assert all(g.dtype == torch.bfloat16
               for g in torch.autograd.grad(o.sum(), (fq, fk, fv)))


def test_bf16_plain_with_one_chunk_is_the_materialised_bf16_core():
    """chunk >= T is _mha's bf16 form up to where the weights are rounded:
    bf16(p) / l here, bf16(p / l) there.  Each rounding moves a weight by
    at most 2^-8 of it, so the outputs part by at most 2^-7 (w @ |v|)."""
    q, k, v, ep, done = _case(40, 3, 2, 8, 0.15)
    qt, kt, vt = (torch.tensor(x).to(torch.bfloat16).float()
                  for x in (q, k, v))
    mask = attn.causal_episode_mask(torch.tensor(done))
    want = attn._mha(qt, kt, vt, mask, bf16_av=True)
    H = q.shape[-2]
    epf = cuda_attn.fold_ep(torch.tensor(ep))
    out, _ = cuda_attn.attention_plain_bf16(
        *(cuda_attn.fold(x).to(torch.bfloat16) for x in (qt, kt, vt)), epf,
        epf, 0, H, chunk=40)
    w_abs_v = attn._mha(qt, kt, vt.abs(), mask)
    diff = (cuda_attn.unfold(out, qt.shape) - want).abs()
    assert (diff <= 2 * BF16_EPS * w_abs_v + 1e-6).all()
    assert diff.max() > 0     # the two do round different values


def test_bf16_flash_on_cpu_launches_nothing():
    counters = (cuda_attn.fwd_bf16_launches, cuda_attn.dq_bf16_launches,
                cuda_attn.dkv_bf16_launches, cuda_attn.fwd_launches)
    before = [c.n for c in counters]
    q, k, v, ep, _ = _case(20, 1, 2, 8, 0.1)
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    cuda_attn.flash_mha(*leaves, torch.tensor(ep),
                        compute_dtype=torch.bfloat16).sum().backward()
    assert [c.n for c in counters] == before


# --- the attention trunk ------------------------------------------------------

def _trunk(T, seed=0, d=16, layers=2, heads=2, head=(16, 8, 2), obs=3):
    jp = jattn.init(jax.random.PRNGKey(seed), obs, d, layers, heads, 2 * d,
                    T + 1, (d, *head[1:]))
    return jp, conv.trunk_from_numpy(jax.device_get(jp), "cpu")


def _seq_inputs(T, E, obs=3, out=2, p_done=0.15, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, E, obs)).astype(np.float32)
    done = rng.random((T, E)) < p_done
    c = rng.standard_normal((T, E, out)).astype(np.float32)
    return xs, done, c


def _apply_seq_pair(jp, tp, xs, done, c):
    """(out, param grads of sum(out * c)) on each side, backend bf16."""
    want = jattn.apply_seq(jp, _j(xs), _j(done), "relu", backend="bf16")
    jg = jax.grad(lambda p: jnp.sum(jattn.apply_seq(
        p, _j(xs), _j(done), "relu", backend="bf16") * _j(c)))(jp)
    leaves = adam.tree_map(lambda t: t.detach().requires_grad_(), tp)
    got = attn.apply_seq(leaves, torch.tensor(xs), torch.tensor(done),
                         "relu", backend="bf16")
    tg = torch.autograd.grad((got * torch.tensor(c)).sum(),
                             adam.tree_leaves(leaves))
    return (got.detach().numpy(), np.asarray(want), tg,
            jax.tree.leaves(jg))


SITE_SETS = {
    "default": None,
    "no scores": frozenset({"embed", "qkv", "av", "out", "ff", "head"}),
    "no av": frozenset({"embed", "qkv", "scores", "out", "ff", "head"}),
    "head only": frozenset({"head"}),
}


@pytest.mark.parametrize("core", ["materialised", "flash"])
@pytest.mark.parametrize("sites", list(SITE_SETS))
def test_apply_seq_bf16_matches_jax(monkeypatch, core, sites):
    """apply_seq(backend="bf16") on each core (the flash core with
    FLASH_MIN_T lowered in both packages; a bisected set of sites keeps
    the materialised core there too, as the JAX package does) and under
    the BF16_SITES cases of tests/test_pallas_attn.py: outputs and every
    parameter gradient within two bf16 ulps of the leaf's largest
    magnitude.  Most elements agree to float32 rounding; the rest are
    where a float32 sum order moved an operand across a bf16 rounding
    boundary and the trunk carried it on: measured 0.6% of the outputs
    and 9.8% of the gradient elements on the materialised core with every
    site (q and k rounded ahead of the scores), up to 1.3% elsewhere; held
    to 5% and 25%, where a float32 computation parts on nearly all.
    BF16_CHUNK is set to the Pallas key tile, so the two chunk alike
    whatever their defaults."""
    T, E = 40, 4
    if sites != "default":
        monkeypatch.setattr(jattn, "BF16_SITES", SITE_SETS[sites])
        monkeypatch.setattr(attn, "BF16_SITES", SITE_SETS[sites])
    if core == "flash":
        monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
        monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
        monkeypatch.setattr(cuda_attn, "BF16_CHUNK", pallas_attn._tiles(T)[1])
    jp, tp = _trunk(T)
    got, want, tg, jg = _apply_seq_pair(jp, tp, *_seq_inputs(T, E))
    assert got.dtype == np.float32
    _bf16_close([(got, want)], 0.05, "out")
    assert len(tg) == len(jg)
    _bf16_close(zip(tg, jg), 0.25, "gradients")


def test_apply_seq_bf16_cores_and_sites(monkeypatch):
    """The port's own choices: no site gives the f32 forward exactly; the
    flash core runs K7's bf16 plain version (its launches none on the CPU)
    only with both "scores" and "av"; without "scores" the flash regime
    takes the materialised core."""
    T, E = 40, 4
    _, tp = _trunk(T)
    xs, done, _ = map(torch.tensor, _seq_inputs(T, E))
    f32 = attn.apply_seq(tp, xs, done, "relu")
    monkeypatch.setattr(attn, "BF16_SITES", frozenset())
    assert torch.equal(attn.apply_seq(tp, xs, done, "relu", backend="bf16"),
                       f32)
    calls = []
    real = cuda_attn.flash_mha
    monkeypatch.setattr(cuda_attn, "flash_mha", lambda *a, **kw: (
        calls.append(a[4]) or real(*a, **kw)))
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "BF16_SITES", SITE_SETS["no scores"])
    attn.apply_seq(tp, xs, done, "relu", backend="bf16")
    assert calls == []
    monkeypatch.setattr(attn, "BF16_SITES", jattn.BF16_SITES)
    out = attn.apply_seq(tp, xs, done, "relu", backend="bf16")
    assert calls == [torch.bfloat16] * 2
    torch.testing.assert_close(out, f32, rtol=0, atol=0.05)


def _decode_inputs(T, E, obs=3, seed=3):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, E, obs)).astype(np.float32)
    nxt = rng.standard_normal((T, E, obs)).astype(np.float32)
    done = rng.random((T, E)) < 0.15
    return xs, nxt, done


def _decode(mod, p, xs, nxt, done, backend, tensor):
    """mod.decode_next over the context of apply_seq(with_cache) on the
    float32 pass (the cache is the same whatever the decode's backend)."""
    T = xs.shape[0]
    _, ks, vs = mod.apply_seq(p, tensor(xs), tensor(done), "relu",
                              with_cache=True, backend=backend)
    pos = np.minimum(np.arange(T) + 1, T)
    mask = mod.causal_episode_mask(tensor(done))
    return mod.decode_next(p, tensor(nxt), tensor(pos), ks, vs, mask, "relu",
                           backend=backend)


def test_decode_next_bf16_matches_jax():
    """Under the default set both packages round embed, qkv, out, ff and
    head, and keep the scores and P.V in float32: V(s') within one bf16
    ulp (measured 0 beyond float32 rounding: at most 5%)."""
    T, E = 12, 4
    jp, tp = _trunk(T, head=(16, 8, 1))
    xs, nxt, done = _decode_inputs(T, E)
    want = _decode(jattn, jp, xs, nxt, done, "bf16", _j)
    got = _decode(attn, tp, xs, nxt, done, "bf16", torch.tensor)
    _bf16_close([(got, want)], 0.05, "V(s')")


def test_decode_next_gates_sites_where_the_jax_package_does_not(
        monkeypatch):
    """The repaired fault (ROADMAP.md §3): with BF16_SITES empty on both
    sides, the port's bf16 decode_next equals its float32 one exactly,
    while the JAX package's bf16 decode_next still rounds its five sites
    and parts from its own "jnp" one."""
    T, E = 12, 4
    jp, tp = _trunk(T, head=(16, 8, 1))
    xs, nxt, done = _decode_inputs(T, E)
    monkeypatch.setattr(jattn, "BF16_SITES", frozenset())
    monkeypatch.setattr(attn, "BF16_SITES", frozenset())
    assert torch.equal(_decode(attn, tp, xs, nxt, done, "bf16", torch.tensor),
                       _decode(attn, tp, xs, nxt, done, "jnp", torch.tensor))
    j16 = np.asarray(_decode(jattn, jp, xs, nxt, done, "bf16", _j))
    j32 = np.asarray(_decode(jattn, jp, xs, nxt, done, "jnp", _j))
    assert not np.array_equal(j16, j32)
    assert np.abs(j16 - j32).max() > 1e-4


# --- the sequence path --------------------------------------------------------

def _seq_jcfg(**kw):
    base = dict(env="recall", n_envs=8, rollout_len=12, minibatch_size=24,
                n_epochs_value=2, n_epochs_policy=1, fits_per_epoch=1,
                eval_envs=8, eval_len=12, hidden=(16,), attn_dim=16,
                attn_layers=1, attn_heads=2, lr_policy=1e-3, lr_v=1e-3,
                kernel_backend="bf16")
    base.update(kw)
    return JPPOConfig(**base)


def _seq_ts(seed, **kw):
    jcfg = _seq_jcfg(**kw)
    jts = jppo.init_train_state(jcfg, jenvs.make("recall"),
                                jax.random.PRNGKey(seed))
    return jcfg, jts, conv.train_state_from_numpy(jax.device_get(jts), "cpu")


def _flash_everywhere(monkeypatch):
    monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)


def test_compute_values_rnn_bf16_matches_jax(monkeypatch):
    """V(s) through the bf16 flash core and V(s') through the bf16 decode
    on a JAX trajectory with episode ends inside the window (T 12: one key
    chunk on both sides): within one bf16 ulp, at most 5% beyond float32
    rounding."""
    _flash_everywhere(monkeypatch)
    jcfg, jts, ts = _seq_ts(2)
    jtraj, _ = jrec.rollout_rnn(jcfg, jenvs.make("recall"),
                                jts.policy_params, jax.random.PRNGKey(3), 8,
                                12)
    want = jrec.compute_values_rnn(jcfg, jts.v_params, jtraj, "bf16")
    traj = ppo.Transition(*(torch.tensor(np.asarray(x)) for x in jtraj))
    assert traj.terminated[:-1].any()
    got = recurrent.compute_values_rnn(_port(jcfg), ts.v_params, traj,
                                       "bf16")
    _bf16_close(zip(got, want), 0.05, "V(s), V(s')")


def _leaves(part, got, want, before):
    """(path, port leaf, JAX leaf, leaf before the fit) of ``part``
    ("policy_params", "opt_v.m", ...) of the three train states."""
    def get(tree):
        for name in part.split("."):
            tree = getattr(tree, name)
        return tree

    paths = jax.tree_util.tree_flatten_with_path(get(want))[0]
    mine, old = jax.tree.leaves(get(got)), jax.tree.leaves(get(before))
    assert len(paths) == len(mine) == len(old)
    for (path, b), a, a0 in zip(paths, mine, old):
        yield (part + jax.tree_util.keystr(path), np.asarray(a),
               np.asarray(b), np.asarray(a0))


def _key_bias_apart(where, a, b, a0, max_move):
    """The key slot of a bqkv leaf: first moments below 1% of the query
    and value slots', parameters moved within ``max_move``."""
    if where.endswith(".m"):
        for x in (a, b):
            assert np.abs(x[1]).max() < 0.01 * np.abs(x[[0, 2]]).max(), where
    elif "params" in where:
        assert np.abs(a[1] - a0[1]).max() <= max_move, where


def test_sequence_update_step_bf16_matches_jax(monkeypatch):
    """One whole sequence update_step under bf16 (values, GAE + Welford,
    2 value and 1 policy epoch through K7's bf16 plain version) against
    the JAX package's on the same trajectory and env-column streams.  The
    attention key bias has no gradient in exact arithmetic (it shifts all
    of a row's scores alike); in bf16 only the rounding of k gives it one,
    so each package's Adam steps it by its own rounding noise: its first
    moments are held below 1% of the query and value biases', its moves
    within lr a step (``_key_bias_apart``).  Weights within rtol 1e-4 /
    atol 1e-5; the Adam moments as apply_seq's gradients (two roundoffs
    of the leaf's largest magnitude, four for the squared ones)."""
    _flash_everywhere(monkeypatch)
    jcfg, jts, ts = _seq_ts(4, ent_coeff=0.01)
    jenv = jenvs.make("recall")
    jtraj, _ = jrec.rollout_rnn(jcfg, jenv, jts.policy_params,
                                jax.random.PRNGKey(5), 8, 12)
    key = jax.random.PRNGKey(6)
    jts2, jm = jax.jit(lambda s, tr, k: jppo.update_step(
        jcfg, jenv, s, tr, k, backend="bf16"))(jts, jtraj, key)
    k_val, k_pol = jax.random.split(key)
    draws = ppo.FitDraws(None, jax_columns(jcfg, k_val, jcfg.n_epochs_value),
                         jax_columns(jcfg, k_pol, jcfg.n_epochs_policy))
    traj = ppo.Transition(*(torch.tensor(np.asarray(x)) for x in jtraj))
    ts2, m = ppo.update_step(_port(jcfg), envs.make("recall"), ts, traj,
                             draws, None)
    got = conv.train_state_to_numpy(ts2)
    want = jax.device_get(jts2)
    before = jax.device_get(jts)
    steps = {"v": int(want.opt_v.t), "policy": int(want.opt_policy.t)}
    moments = {"m": [], "v": []}
    for part in ("policy_params", "v_params", "opt_policy.m", "opt_v.m",
                 "opt_log_std.m", "opt_policy.v", "opt_v.v"):
        trunk = "v" if "v_params" in part or "opt_v" in part else "policy"
        for where, a, b, a0 in _leaves(part, got, want, before):
            if "bqkv" in where:
                _key_bias_apart(where, a, b, a0, steps[trunk] * jcfg.lr_v)
                a, b = a[[0, 2]], b[[0, 2]]
            if "params" in part:
                np.testing.assert_allclose(a, b, err_msg=where, **W_TOL)
            else:
                moments[part[-1]].append((a, b))
    # as apply_seq's gradients, which they average (squared for v)
    _bf16_close(moments["m"], 0.25, "first moments")
    _bf16_close(moments["v"], 0.25, "second moments", units=4)
    assert (got.opt_v.t, got.opt_policy.t) == (int(want.opt_v.t),
                                               int(want.opt_policy.t))
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-6)


# --- trainers -------------------------------------------------------------------

LEARN_SEEDS = range(16)
LEARN_WINS = 4


def test_bf16_trainer_learns_on_cpu():
    """tests/test_ops.py's bf16 learning check on the port: simple, hidden
    (32, 32), 4 epochs, R > 0.5 a run; the fit's rollout is K1 without
    the V planes.

    At this config a `simple` run ends at R 0 or R 1, and which one a seed
    gives turns on the host's float rounding, so one seed is a coin flip.
    Over seeds 0-23 on the CPU (torch 2.13, jax 0.9) both packages reach
    R > 0.5 in 15 of 24 runs: the JAX package on "jnp" and the port on
    "bf16" alike.  So at least LEARN_WINS of the seeds LEARN_SEEDS must
    learn (the loop stops at the last one needed); at the 15-of-24 rate a
    false failure has probability 4.5e-4, and a port that does not learn
    gives none."""
    wins, finals = 0, []
    for seed in LEARN_SEEDS:
        cfg = PPOConfig(env="simple", n_envs=32, rollout_len=15,
                        minibatch_size=64, fits_per_epoch=5, n_epochs=4,
                        eval_envs=64, eval_len=15, kernel_backend="bf16",
                        hidden=(32, 32), seed=seed)
        tr = Trainer(cfg, "cpu")
        finals.append(tr.train(log=False)[-1]["R"])
        wins += finals[-1] > 0.5
        if wins == LEARN_WINS:
            break
    assert wins >= LEARN_WINS, finals
    assert np.isfinite(tr.evaluate(deterministic=True).R)


def test_bf16_attention_trainer_on_cpu(monkeypatch):
    """One attention epoch under bf16 with the flash core engaged
    (FLASH_MIN_T lowered): finite losses, the Adam counts of the column
    plan, and both evaluations."""
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    cfg = _port(_seq_jcfg(fits_per_epoch=2, n_epochs_value=1))
    tr = Trainer(cfg, "cpu")
    hist = tr.train(n_epochs=1, log=False)
    assert np.isfinite(hist[0]["value_loss"]) and hist[0]["episodes"] == 16
    _, n_mb = recurrent.seq_minibatch_plan(8, 12, 24)
    assert tr.state.opt_v.t == 2 * n_mb and tr.state.opt_policy.t == 2 * n_mb
    assert 0.0 <= tr.evaluate(deterministic=True).R <= 1.0

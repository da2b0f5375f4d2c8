"""Port parity: Adam, GAE, Welford and the PPO losses against the JAX
package on the same inputs.

Tolerances: Adam and the losses are the same float32 formulas, rtol 1e-5 /
atol 1e-7 (the bias corrections are formed in float64 on one side and
float32 on the other); the doubling-scan GAE and the pairwise Welford tree
sum in another order than XLA, rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.ops import adam as jadam, gae as jgae, losses as jlosses
from ppoc_tpu.ops import welford as jwelford
from ppoc_tpu_torch.ops import adam, gae, losses, resolve_backend, welford
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.default_rng(0)


def test_adam_matches_jax_over_steps():
    p = [(RNG.normal(size=(4, 3)).astype(np.float32),
          RNG.normal(size=3).astype(np.float32))]
    grads = [[(RNG.normal(size=(4, 3)).astype(np.float32),
               RNG.normal(size=3).astype(np.float32))] for _ in range(5)]
    jp, jst = p, jadam.init(p)
    tp = [tuple(t) for t in conv.tree_from_numpy(p, "cpu")]
    st = adam.init(tp)
    for g in grads:
        jp, jst = jadam.update(jp, g, jst, 3e-4, 0.9, 0.999, 1e-8)
        tg = [tuple(t) for t in conv.tree_from_numpy(g, "cpu")]
        tp, st = adam.update(tp, tg, st, 3e-4, 0.9, 0.999, 1e-8)
    assert st.t == int(jst.t) == 5
    for got, want in zip(adam.tree_leaves((tp, st.m, st.v)),
                         jax.tree.leaves((jp, jst.m, jst.v))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


def test_adam_eps_outside_sqrt_and_bias_in_step():
    """First step from zero moments: p - lr * g / (|g| + eps/sqrt(1))."""
    p = torch.tensor([1.0, 1.0])
    g = torch.tensor([1e-8, 2.0])
    p2, _ = adam.update(p, g, adam.init(p), 0.1, 0.9, 0.999, 1e-8)
    torch.testing.assert_close(p2, torch.tensor([1.0 - 0.05, 0.9]))


def _gae_inputs(T=33, E=5, seed=1):
    rng = np.random.default_rng(seed)
    r, v, nv = (rng.normal(size=(T, E)).astype(np.float32) for _ in range(3))
    term = rng.random((T, E)) < 0.1
    trunc = (rng.random((T, E)) < 0.1) & ~term
    return r, v, nv, term, trunc


@pytest.mark.parametrize("fn", ["gae", "gae_reference"])
def test_gae_matches_jax(fn):
    args = _gae_inputs()
    want_a, want_t = jgae.gae(*(jnp.asarray(x) for x in args), 0.99, 0.95)
    got_a, got_t = getattr(gae, fn)(*(torch.as_tensor(x) for x in args),
                                    0.99, 0.95)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)


def test_discounted_episode_returns_match_jax():
    r, _, _, term, trunc = _gae_inputs(seed=2)
    done = term | trunc
    want = jgae.discounted_episode_returns(jnp.asarray(r), jnp.asarray(done),
                                           0.9)
    got = gae.discounted_episode_returns(torch.as_tensor(r),
                                         torch.as_tensor(done), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_welford_mean_var_matches_jax(n):
    x = (np.random.default_rng(n).normal(size=n) * 3 + 5).astype(np.float32)
    jm, jv = jwelford.mean_var(jnp.asarray(x))
    m, v = welford.mean_var(torch.tensor(x))
    np.testing.assert_allclose(float(m), float(jm), **TOL)
    np.testing.assert_allclose(float(v), float(jv), **TOL)
    np.testing.assert_allclose(float(v), float(np.var(x.astype(np.float64))),
                               rtol=1e-5, atol=1e-6)


def test_clipped_surrogate_value_and_grad_match_jax():
    rng = np.random.default_rng(4)
    lp = rng.normal(size=64).astype(np.float32) * 0.3
    lp_old = rng.normal(size=64).astype(np.float32) * 0.3
    adv = rng.normal(size=64).astype(np.float32)
    jl, jg = jax.value_and_grad(jlosses.clipped_surrogate_loss)(
        jnp.asarray(lp), jnp.asarray(lp_old), jnp.asarray(adv), 0.2)
    t = torch.tensor(lp, requires_grad=True)
    loss = losses.clipped_surrogate_loss(t, torch.tensor(lp_old),
                                         torch.tensor(adv), 0.2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    v, tgt = rng.normal(size=(2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.value_loss(torch.tensor(v), torch.tensor(tgt))),
        float(jlosses.value_loss(jnp.asarray(v), jnp.asarray(tgt))),
        rtol=1e-6)


def test_resolve_backend():
    assert resolve_backend("pallas") == "pallas"
    assert resolve_backend("auto") == "pallas"
    for name in ("jnp", "bf16"):
        with pytest.raises(NotImplementedError, match=name):
            resolve_backend(name)

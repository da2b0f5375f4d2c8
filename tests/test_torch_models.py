"""Port parity: the MLP and the Gaussian policy against the JAX package on
the same weights (converted with utils/params.py).

Tolerance rtol 1e-5 / atol 1e-6: float32 products summed in another order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.models import mlp as jmlp, policy as jpolicy
from ppoc_tpu.ops import pallas_mlp as jpm
from ppoc_tpu_torch.models import mlp, policy
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = (3, 16, 16, 2)


def _params(seed=0):
    jp = jax.device_get(jmlp.init(jax.random.PRNGKey(seed), SIZES))
    return jp, [tuple(t) for t in conv.tree_from_numpy(jp, "cpu")]


def _x(n=32, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("activation", ["relu", "tanh", "none"])
def test_mlp_apply_matches_jax(activation):
    jp, p = _params()
    x = _x()
    want = jmlp.apply(jp, jnp.asarray(x), activation, "jnp")
    got = mlp.apply(p, torch.tensor(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_pallas_backend_on_cpu_is_the_plain_forward():
    """On a CPU tensor backend="pallas" runs K5's plain version, which
    matches the JAX Pallas MLP kernel (interpret mode)."""
    jp, p = _params(1)
    x = _x(40, seed=1)
    want = jpm.mlp_forward(jp, jnp.asarray(x), "relu")
    got = mlp.apply(p, torch.tensor(x), "relu", backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_init_reference_scheme():
    """Same shapes and uniform bounds as the JAX init: W within
    sqrt(3)*gain*sqrt(2/(fan_in+fan_out)), b within 1/sqrt(fan_in)."""
    sizes = (3, 128, 128, 1)
    g = torch.Generator().manual_seed(0)
    p = mlp.init(sizes, g, "cpu")
    jp = jmlp.init(jax.random.PRNGKey(0), sizes)
    for i, ((w, b), (jw, jb)) in enumerate(zip(p, jp)):
        assert w.shape == jw.shape and b.shape == jb.shape
        gain = 1.0 if i == len(p) - 1 else math.sqrt(2.0)
        bw = math.sqrt(3.0) * gain * math.sqrt(2.0 / (sizes[i] + sizes[i + 1]))
        assert float(w.abs().max()) <= bw
        assert float(w.abs().max()) > 0.9 * bw
        assert float(b.abs().max()) <= 1.0 / math.sqrt(sizes[i])


def test_flatten_roundtrip():
    _, p = _params()
    flat = mlp.flatten(p)
    assert flat.numel() == sum(w.numel() + b.numel() for w, b in p)
    for (w, b), (w2, b2) in zip(p, mlp.unflatten(flat, mlp.dims(p))):
        torch.testing.assert_close(w, w2, rtol=0, atol=0)
        torch.testing.assert_close(b, b2, rtol=0, atol=0)


def _policy(seed=0):
    jpp = jax.device_get(jpolicy.init_gaussian(
        jax.random.PRNGKey(seed), 3, 2, (16, 16), init_std=0.7))
    pp = conv.tree_from_numpy(jpp, "cpu")
    pp["mlp"] = [tuple(t) for t in pp["mlp"]]
    return jpp, pp


def test_gaussian_log_prob_entropy_mode_match_jax():
    jpp, pp = _policy()
    x = _x()
    a = np.random.default_rng(5).normal(size=(32, 2)).astype(np.float32)
    want = jpolicy.log_prob(jpp, jnp.asarray(x), jnp.asarray(a), "relu",
                            "jnp", False)
    got = policy.log_prob(pp, torch.tensor(x), torch.tensor(a), "relu", "jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        float(policy.entropy(pp)), float(jpolicy.gaussian_entropy(jpp)),
        rtol=1e-6)
    ja, jlp = jpolicy.mode(jpp, jnp.asarray(x), "relu", "jnp", False)
    ma, mlp_ = policy.mode(pp, torch.tensor(x), "relu", "jnp")
    np.testing.assert_allclose(ma.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(mlp_.numpy(), np.asarray(jlp), **TOL)


def test_sample_with_given_noise_is_mu_plus_eps_sigma():
    """sample() takes its noise explicitly; action and log-prob follow the
    JAX formulas for that noise."""
    jpp, pp = _policy(1)
    x = _x(seed=2)
    eps = np.random.default_rng(9).normal(size=(32, 2)).astype(np.float32)
    mu = jmlp.apply(jpp["mlp"], jnp.asarray(x), "relu", "jnp")
    want_a = mu + jnp.asarray(eps) * jnp.exp(jpp["log_std"])
    want_lp = jpolicy.gaussian_log_prob_from_mean(mu, jpp["log_std"], want_a)
    a, lp = policy.sample(pp, torch.tensor(x), "relu", "jnp",
                          eps=torch.tensor(eps))
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), **TOL)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    torch.testing.assert_close(
        policy.sample(pp, torch.tensor(x), "relu", "jnp", generator=g1)[0],
        policy.sample(pp, torch.tensor(x), "relu", "jnp", generator=g2)[0])


def test_entropy_is_closed_form():
    _, pp = _policy()
    want = 0.5 * 2 * (1.0 + math.log(2 * math.pi)) + 2 * math.log(0.7)
    assert float(policy.entropy(pp)) == pytest.approx(want, rel=1e-6)

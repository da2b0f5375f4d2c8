"""Port parity: the fused GAE kernel's plain version (ops/cuda_gae.py) and
ppo.compute_advantages against the JAX Pallas GAE kernel in interpret mode.

Tolerance rtol 1e-5 / atol 1e-6: the recurrence is the same float32
operations in the same order; the whole-buffer mean and variance are sums
of 128 terms taken in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.ops import pallas_gae as jpg
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.ops import cuda_gae, gae, welford

torch.set_num_threads(1)

T, E = 16, 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(T, E)).astype(np.float32)
    v = rng.normal(size=(T, E)).astype(np.float32)
    nv = rng.normal(size=(T, E)).astype(np.float32)
    term = rng.random((T, E)) < 0.1
    trunc = (rng.random((T, E)) < 0.1) & ~term
    trunc[-1] |= ~term[-1]
    return r, v, nv, term, trunc


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_gae_norm_matches_pallas_kernel(normalize, seed):
    r, v, nv, term, trunc = _inputs(seed)
    j_adv, j_tgt = jpg.gae_norm_fused(
        jnp.asarray(r), jnp.asarray(v), jnp.asarray(nv), jnp.asarray(term),
        jnp.asarray(trunc), 0.99, 0.95, normalize=normalize)
    adv, tgt = cuda_gae.gae_norm_fused(
        *(torch.as_tensor(x) for x in (r, v, nv, term, trunc)), 0.99, 0.95,
        normalize=normalize)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), **TOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(j_tgt), **TOL)


def test_term_gates_bootstrap_and_done_gates_recurrence():
    """A terminated step drops V(s'); a truncated one keeps V(s') but still
    cuts the recurrence."""
    z = torch.zeros(3, 1)
    r, v = torch.ones(3, 1), z
    nv = torch.full((3, 1), 10.0)
    term = torch.tensor([[False], [True], [False]])
    trunc = torch.tensor([[False], [False], [True]])
    adv, _ = cuda_gae.gae_norm_fused(r, v, nv, term, trunc, 0.5, 1.0,
                                     normalize=False)
    # t=2 (truncated): 1 + 0.5*10 = 6; t=1 (terminated): 1, no bootstrap;
    # t=0: 1 + 0.5*10 + 0.5*A_1 = 6.5
    torch.testing.assert_close(adv[:, 0], torch.tensor([6.5, 1.0, 6.0]))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_compute_advantages_backends_agree(backend):
    """ppo.compute_advantages (K2's path) equals K2's plain version
    ("pallas") and the JAX package's generic composition, doubling-scan
    GAE + Welford mean/var + normalize, built from the ported ops
    ("jnp")."""
    r, v, nv, term, trunc = (torch.as_tensor(x) for x in _inputs(2))
    traj = ppo.Transition(obs=None, action=None, log_prob=None, next_obs=None,
                          reward=r, terminated=term, truncated=trunc)
    cfg = PPOConfig(env="pendulum")
    adv, tgt = ppo.compute_advantages(cfg, envs.make("pendulum"), traj,
                                      (v, nv))
    if backend == "pallas":
        want_adv, want_tgt = cuda_gae.gae_norm_plain(r, v, nv, term, trunc,
                                                     0.99, cfg.lam)
    else:
        raw_adv, want_tgt = gae.gae(r, v, nv, term, trunc, 0.99, cfg.lam)
        mean, var = welford.mean_var(raw_adv)
        want_adv = gae.normalize(raw_adv, mean, torch.sqrt(var))
    torch.testing.assert_close(adv, want_adv, **TOL)
    torch.testing.assert_close(tgt, want_tgt, **TOL)

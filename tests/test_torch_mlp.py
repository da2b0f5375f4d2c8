"""Port parity for K5 (ppoc_tpu_torch/ops/cuda_mlp.py): its plain forward and
its autograd backward (MLPForward, the plain backward on the CPU) against
the JAX package's pallas_mlp.mlp_forward custom VJP, run in interpret mode
as tests/test_pallas_mlp.py runs it.  The same weights (JAX init, converted),
inputs and cotangents, drawn with numpy from a seed.

Tolerance rtol 1e-5 / atol 1e-5: float32 products and batch sums taken in
another order than XLA's, at widths up to 128 and batches up to 100 rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.models import mlp as jmlp
from ppoc_tpu.ops import pallas_mlp as jpm
from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import cuda_mlp
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [((3, 128, 128, 1), (100,)), ((5, 32, 32, 2), (64,)),
         ((17, 32, 5), (7, 13)), ((3, 16, 16, 16, 1), (1,))]


def _setup(sizes, lead, seed):
    jp = jax.device_get(jmlp.init(jax.random.PRNGKey(seed), sizes))
    params = [tuple(t) for t in conv.tree_from_numpy(jp, "cpu")]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (sizes[0],)).astype(np.float32)
    g = rng.normal(size=lead + (sizes[-1],)).astype(np.float32)
    return jp, params, x, g


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("sizes,lead", CASES)
def test_forward_matches_jax_pallas(sizes, lead, activation):
    jp, params, x, _ = _setup(sizes, lead, 0)
    want = np.asarray(jpm.mlp_forward(jp, jnp.asarray(x), activation))
    got = cuda_mlp.mlp_forward(params, torch.tensor(x), activation)
    assert got.shape == want.shape == lead + (sizes[-1],)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    via_apply = mlp.apply(params, torch.tensor(x), activation,
                          backend="pallas")
    torch.testing.assert_close(via_apply, got, rtol=0, atol=0)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("sizes,lead", CASES)
def test_vjp_matches_jax_pallas(sizes, lead, activation):
    """dW, db and dX of MLPForward's backward against jax.vjp of the Pallas
    custom VJP, for one cotangent."""
    jp, params, x, g = _setup(sizes, lead, 1)
    _, vjp = jax.vjp(lambda p, xx: jpm.mlp_forward(p, xx, activation),
                     jp, jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_() for pair in params for t in pair]
    xt = torch.tensor(x, requires_grad=True)
    out = cuda_mlp.mlp_forward(cuda_mlp._pairs(leaves), xt, activation)
    grads = torch.autograd.grad(out, leaves + [xt], torch.tensor(g))
    want = [np.asarray(t) for pair in jdp for t in pair] + [np.asarray(jdx)]
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, **TOL)


def test_backward_skips_dx_that_nobody_wants():
    """With x not requiring grad the backward computes no dX, and the
    weight gradients are unchanged."""
    _, params, x, g = _setup((3, 32, 32, 1), (40,), 2)
    xt = torch.tensor(x)
    leaves = [t.clone().requires_grad_() for pair in params for t in pair]
    out = cuda_mlp.MLPForward.apply("relu", xt, *leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    ref, dx = cuda_mlp.mlp_backward_plain(
        params, xt, cuda_mlp.mlp_forward_plain(params, xt, "relu")[1],
        torch.tensor(g), "relu", need_dx=False)
    assert dx is None
    for a, b in zip(grads, [t for pair in ref for t in pair]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_forward_saves_the_hidden_post_activations():
    _, params, x, _ = _setup((3, 16, 8, 2), (10,), 3)
    out, hiddens = cuda_mlp.mlp_forward_plain(params, torch.tensor(x),
                                              "tanh")
    assert [h.shape for h in hiddens] == [(10, 16), (10, 8)]
    h1 = torch.tanh(torch.tensor(x) @ params[0][0] + params[0][1])
    torch.testing.assert_close(hiddens[0], h1)
    torch.testing.assert_close(out, hiddens[1] @ params[2][0] + params[2][1])


def test_launch_counts_stay_zero_on_the_cpu():
    before = (cuda_mlp.fwd_launches.n, cuda_mlp.bwd_launches.n)
    _, params, x, g = _setup((3, 16, 1), (8,), 4)
    leaves = [t.clone().requires_grad_() for pair in params for t in pair]
    out = cuda_mlp.mlp_forward(cuda_mlp._pairs(leaves), torch.tensor(x))
    out.backward(torch.tensor(g))
    assert (cuda_mlp.fwd_launches.n, cuda_mlp.bwd_launches.n) == before

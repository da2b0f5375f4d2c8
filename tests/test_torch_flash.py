"""Port parity for K7, the flash attention: the plain version of
``ppoc_tpu_torch/ops/cuda_attn.py`` against ``ppoc_tpu.ops.pallas_attn``
(its Pallas kernels in interpret mode) on the same inputs, drawn with
numpy from a seed.

Tolerances, as the JAX suite holds its kernel against its jnp twin
(tests/test_pallas_attn.py): out and lse atol 1e-5, the gradients of
sum(sin(out)) atol 2e-4 (the two sum in another order).  Measured here:
out and lse differ by at most 5e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.models import attn as jattn
from ppoc_tpu.ops import pallas_attn
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.ops import cuda_attn

torch.set_num_threads(1)

OUT_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=0, atol=2e-4)


def _case(T, B, H, hd, p_done, seed=0):
    rng = np.random.default_rng(seed + T)
    q, k, v = (rng.standard_normal((T, B, H, hd)).astype(np.float32)
               for _ in range(3))
    done = rng.random((T, B)) < p_done
    return q, k, v, done


def _ep(done):
    return np.asarray(jattn.episode_ids(jnp.asarray(done)))


def _t(*xs):
    return [torch.tensor(x) for x in xs]


CASES = [(12, 3, 2, 8, 0.25), (50, 2, 1, 16, 0.1), (130, 2, 2, 8, 0.05),
         (256, 2, 2, 16, 0.3)]


@pytest.mark.parametrize("T,B,H,hd,p_done", CASES)
def test_forward_matches_pallas_flash(T, B, H, hd, p_done):
    q, k, v, done = _case(T, B, H, hd, p_done)
    ep = _ep(done)
    want = pallas_attn.flash_mha(*(jnp.asarray(x) for x in (q, k, v, ep)))
    got = cuda_attn.flash_mha(*_t(q, k, v, ep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def _grads_jax(q, k, v, ep):
    def loss(q, k, v):
        return jnp.sum(jnp.sin(pallas_attn.flash_mha(q, k, v, ep)))

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))


def _grads_port(q, k, v, ep):
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    loss = torch.sin(cuda_attn.flash_mha(*leaves, torch.tensor(ep))).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("T,B,H,hd,p_done", CASES + [(1030, 1, 1, 8, 0.02)])
def test_gradients_match_pallas_flash(T, B, H, hd, p_done):
    """dq, dk, dv of the plain version (autograd through it) against the
    Pallas backward (dq and dk/dv kernels in interpret mode), including
    the ragged T = 1030 window on the (256, 256) tiles."""
    q, k, v, done = _case(T, B, H, hd, p_done, seed=5)
    ep = _ep(done)
    for a, b in zip(_grads_port(q, k, v, ep), _grads_jax(q, k, v, ep)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_ragged_forward_matches_pallas_flash():
    q, k, v, done = _case(1030, 1, 1, 8, 0.02)
    ep = _ep(done)
    want = pallas_attn.flash_mha(*(jnp.asarray(x) for x in (q, k, v, ep)))
    got = cuda_attn.flash_mha(*_t(q, k, v, ep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("rel", [-1, 0, 1])
def test_block_matches_pallas_flash_block(rel):
    """(out, lse) of one ring block at each relation, with query and key
    episode ids that differ (a block of an earlier time shard); rel +1 is
    all-invalid: out 0 and lse NEG."""
    T, B, H, hd = 130, 2, 2, 8
    q, k, v, done = _case(T, B, H, hd, 0.05, seed=2)
    q_ep = _ep(done)
    k_ep = np.maximum(q_ep - (np.arange(T)[:, None] % 3 == 0), 0)
    want = pallas_attn.flash_mha_block(
        *(jnp.asarray(x) for x in (q, k, v, q_ep, k_ep)), rel)
    got = cuda_attn.flash_mha_block(*_t(q, k, v, q_ep, k_ep), rel)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OUT_TOL)
    if rel > 0:
        assert (got[0] == 0).all() and (got[1] == cuda_attn.NEG).all()


def test_all_invalid_rows_give_zero_and_neg():
    """The exp(NEG - NEG) = 1 trap: a query with no valid key gets out 0
    and lse NEG, never a uniform average."""
    q, k, v, _ = _case(6, 1, 1, 8, 0.0)
    ep = np.zeros((6, 1), np.int32)
    k_ep = ep + 1                       # no key shares a query's episode
    out, lse = cuda_attn.flash_mha_block(*_t(q, k, v, ep, k_ep), 0)
    assert (out == 0).all() and (lse == cuda_attn.NEG).all()


def test_plain_core_matches_materialised_mha():
    """The port's flash_mha equals its own materialised core _mha with
    causal_episode_mask (the two paths apply_seq chooses between)."""
    q, k, v, done = _case(40, 3, 2, 8, 0.15)
    qt, kt, vt, dt = _t(q, k, v, done)
    want = attn._mha(qt, kt, vt, attn.causal_episode_mask(dt))
    got = cuda_attn.flash_mha(qt, kt, vt, attn.episode_ids(dt))
    torch.testing.assert_close(got, want, **OUT_TOL)


def test_fold_and_unfold_are_inverse():
    x = torch.arange(5 * 2 * 3 * 4 * 8, dtype=torch.float32).reshape(
        5, 2, 3, 4, 8)
    f = cuda_attn.fold(x)
    assert f.shape == (2 * 3 * 4, 5, 8)
    assert torch.equal(cuda_attn.unfold(f, x.shape), x)
    ep = torch.arange(5 * 6, dtype=torch.int32).reshape(5, 2, 3)
    assert torch.equal(cuda_attn.fold_ep(ep)[4], ep[:, 1, 1])


def test_cpu_tensors_launch_nothing():
    counters = (cuda_attn.fwd_launches, cuda_attn.dq_launches,
                cuda_attn.dkv_launches)
    before = [c.n for c in counters]
    q, k, v, done = _case(20, 1, 2, 8, 0.1)
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    cuda_attn.flash_mha(*leaves, torch.tensor(_ep(done))).sum().backward()
    assert [c.n for c in counters] == before

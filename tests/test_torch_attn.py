"""Port parity for ``ppoc_tpu_torch/models/attn.py``: the attention trunk
against ``ppoc_tpu.models.attn`` on the same parameters (the JAX package's
init, carried across leaf by leaf) and the same inputs, drawn with numpy
from a seed; then the model's own invariants, as tests/test_attn.py holds
the JAX package's.

Tolerances: outputs atol 1e-5 (float32 sums in another order; measured
here at most 1.2e-6), parameter gradients rtol 1e-4 / atol 1e-5, as
tests/test_pallas_attn.py holds the JAX package's two backends.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu.models import attn as jattn
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.ops import adam, cuda_attn
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

OUT_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(key=0, T=12, obs_dim=4, d=16, layers=2, heads=2, out=2):
    """(JAX params, the port's copy of them)."""
    jp = jattn.init(jax.random.PRNGKey(key), obs_dim, d, layers, heads,
                    2 * d, T, (d, 8, out))
    return jp, conv.trunk_from_numpy(jax.device_get(jp), "cpu")


def _inputs(T, E, obs_dim=4, p_done=0.2, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, E, obs_dim)).astype(np.float32)
    return xs, rng.random((T, E)) < p_done


def _leaves_close(got, want, tol):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_init_has_the_jax_tree_and_bounds():
    """The port's init gives the JAX package's tree, shapes and bounds
    (its own draws: a generator is not a JAX key)."""
    jp, _ = _params(T=9, layers=2)
    p = attn.init(4, 16, 2, 2, 32, 9, (16, 8, 2),
                  torch.Generator().manual_seed(0), "cpu")
    want = jax.device_get(jp)
    got = conv.tree_to_numpy(p)
    assert (jax.tree.structure(jax.tree.map(np.shape, got))
            == jax.tree.structure(jax.tree.map(np.shape, want)))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
    blk = p["attn"]["blocks"][0]
    bound = np.sqrt(3.0) * np.sqrt(2.0 / 32)
    assert 0.9 * bound < float(blk["wqkv"].abs().max()) <= bound
    assert float(p["attn"]["pos"].abs().max()) <= 0.02
    assert torch.equal(blk["ln1"][0], torch.ones(16))
    assert attn.width(p) == 16 and attn.window(p) == 9
    assert attn.is_attn(p) and not attn.is_attn([(None, None)])


def test_episode_ids_and_mask_match_jax():
    _, done = _inputs(15, 3, p_done=0.3)
    np.testing.assert_array_equal(
        attn.episode_ids(torch.tensor(done)).numpy(),
        np.asarray(jattn.episode_ids(jnp.asarray(done))))
    np.testing.assert_array_equal(
        attn.causal_episode_mask(torch.tensor(done)).numpy(),
        np.asarray(jattn.causal_episode_mask(jnp.asarray(done))))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_apply_seq_matches_jax(backend, monkeypatch):
    """Outputs, the cached keys and values, and every parameter gradient of
    sum(out^2), on each backend; FLASH_MIN_T is lowered in both packages
    so "pallas" takes the flash path at T = 40 (the JAX kernel in
    interpret mode, K7's plain version here)."""
    monkeypatch.setattr(jattn, "FLASH_MIN_T", 8)
    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    flash_calls = []
    real = cuda_attn.flash_mha
    monkeypatch.setattr(cuda_attn, "flash_mha",
                        lambda *a: flash_calls.append(1) or real(*a))
    T, E = 40, 4
    jp, p = _params(T=T)
    xs, done = _inputs(T, E, p_done=0.15, seed=1)
    jx, jd = jnp.asarray(xs), jnp.asarray(done)
    tx, td = torch.tensor(xs), torch.tensor(done)
    want, jks, jvs = jattn.apply_seq(jp, jx, jd, "relu", with_cache=True,
                                     backend=backend)
    got, ks, vs = attn.apply_seq(p, tx, td, "relu", with_cache=True,
                                 backend=backend)
    assert len(flash_calls) == (2 if backend == "pallas" else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    _leaves_close([k.numpy() for k in ks + vs], jks + jvs, OUT_TOL)

    jg = jax.grad(lambda q: jnp.sum(jnp.square(
        jattn.apply_seq(q, jx, jd, "relu", backend=backend))))(jp)
    leaves = adam.tree_map(lambda t: t.detach().requires_grad_(), p)
    loss = (attn.apply_seq(leaves, tx, td, "relu", backend=backend) ** 2).sum()
    g = torch.autograd.grad(loss, adam.tree_leaves(leaves))
    _leaves_close([x.numpy() for x in g], jg, GRAD_TOL)


def test_step_matches_jax_step():
    """The KV-cache decode, step by step with episode resets, against the
    JAX package's step and reset_lanes."""
    T, E = 12, 3
    jp, p = _params(T=T)
    xs, done = _inputs(T, E, p_done=0.25, seed=2)
    jc, c = jattn.initial_cache(jp, (E,)), attn.initial_cache(p, (E,))
    for t in range(T):
        jc, jo = jattn.step(jp, jc, jnp.asarray(xs[t]), "relu")
        c, o = attn.step(p, c, torch.tensor(xs[t]), "relu")
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **OUT_TOL)
        jc = jattn.reset_lanes(jc, jnp.asarray(done[t]))
        c = attn.reset_lanes(c, torch.tensor(done[t]))
        np.testing.assert_array_equal(c["start"].numpy(),
                                      np.asarray(jc["start"]))
    assert c["t"] == int(jc["t"]) == T
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]),
                               **OUT_TOL)


def test_decode_matches_parallel():
    """The rollout's decode reproduces the update's parallel pass step for
    step."""
    T, E = 12, 3
    _, p = _params(T=T)
    xs, done = (torch.tensor(x) for x in _inputs(T, E, p_done=0.25, seed=3))
    out_par = attn.apply_seq(p, xs, done, "relu")
    cache = attn.initial_cache(p, (E,))
    outs = []
    for t in range(T):
        cache, o = attn.step(p, cache, xs[t], "relu")
        outs.append(o)
        cache = attn.reset_lanes(cache, done[t])
    torch.testing.assert_close(torch.stack(outs), out_par, **OUT_TOL)


def test_decode_next_matches_jax_and_the_shifted_parallel_pass():
    """decode_next against the JAX package's on the same context, and
    against the parallel pass's row t + 1 wherever the episode
    continues."""
    T, E = 10, 4
    jp, p = _params(T=T, out=1)
    xs, done = _inputs(T, E, p_done=0.2, seed=4)
    tx, td = torch.tensor(xs), torch.tensor(done)
    out_par, ks, vs = attn.apply_seq(p, tx, td, "relu", with_cache=True)
    mask = attn.causal_episode_mask(td)
    pos_idx = torch.clamp(torch.arange(T) + 1, max=T - 1)
    nxt = attn.decode_next(p, torch.roll(tx, -1, 0), pos_idx, ks, vs, mask,
                           "relu")
    _, jks, jvs = jattn.apply_seq(jp, jnp.asarray(xs), jnp.asarray(done),
                                  "relu", with_cache=True)
    want = jattn.decode_next(jp, jnp.roll(jnp.asarray(xs), -1, 0),
                             jnp.asarray(pos_idx.numpy()), jks, jvs,
                             jnp.asarray(mask.numpy()), "relu")
    np.testing.assert_allclose(nxt.numpy(), np.asarray(want), **OUT_TOL)
    cont = ~done & (np.arange(T)[:, None] < T - 1)
    np.testing.assert_allclose(nxt.numpy()[cont],
                               torch.roll(out_par, -1, 0).numpy()[cont],
                               **OUT_TOL)


def test_decode_next_chunked_matches_direct_and_jax():
    """T > 256 runs 128 queries at a time: equal to the direct computation
    and to the JAX package's chunked decode."""
    T, E = 300, 2
    jp, p = _params(T=T + 1, out=1)
    xs, done = _inputs(T, E, p_done=0.1, seed=5)
    tx, td = torch.tensor(xs), torch.tensor(done)
    _, ks, vs = attn.apply_seq(p, tx, td, "relu", with_cache=True)
    mask = attn.causal_episode_mask(td)
    pos_idx = torch.arange(T) + 1
    nxt = torch.roll(tx, -1, 0)
    chunked = attn.decode_next(p, nxt, pos_idx, ks, vs, mask, "relu")
    direct = attn._decode_next(p, nxt, pos_idx, ks, vs, mask, "relu")
    torch.testing.assert_close(chunked, direct, rtol=0, atol=1e-6)
    _, jks, jvs = jattn.apply_seq(jp, jnp.asarray(xs), jnp.asarray(done),
                                  "relu", with_cache=True)
    want = jattn.decode_next(jp, jnp.asarray(nxt.numpy()),
                             jnp.asarray(pos_idx.numpy()), jks, jvs,
                             jnp.asarray(mask.numpy()), "relu")
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **OUT_TOL)


def test_mask_blocks_cross_episode_attention():
    """Outputs after a done do not move when the earlier episode's
    observations change; without the done they do."""
    T, E = 8, 3
    _, p = _params(T=T)
    rng = np.random.default_rng(6)
    xs = torch.tensor(rng.standard_normal((T, E, 4)).astype(np.float32))
    done = torch.zeros(T, E, dtype=torch.bool)
    done[2] = True
    ys = attn.apply_seq(p, xs, done, "relu")
    xs2 = xs.clone()
    xs2[:3] = torch.tensor(rng.standard_normal((3, E, 4)).astype(np.float32))
    torch.testing.assert_close(attn.apply_seq(p, xs2, done, "relu")[3:],
                               ys[3:], rtol=0, atol=1e-6)
    ys3 = attn.apply_seq(p, xs2, torch.zeros_like(done), "relu")
    assert not torch.allclose(ys3[3:], ys[3:], atol=1e-4)


def test_window_overflow_and_unported_backend_raise():
    """A window past the positional table and an unported backend raise;
    "bf16" is ported: float32 out at bf16 rounding scale of the float32
    forward (tests/test_pallas_attn.py's atol 0.05)."""
    _, p = _params(T=6)
    with pytest.raises(ValueError, match="positional table"):
        attn.apply_seq(p, torch.zeros(8, 2, 4), torch.zeros(8, 2, dtype=bool),
                       "relu")
    with pytest.raises(NotImplementedError, match="tp:x"):
        attn.apply_seq(p, torch.zeros(4, 2, 4), torch.zeros(4, 2, dtype=bool),
                       "relu", backend="tp:x")
    xs = torch.tensor(np.random.default_rng(7).standard_normal(
        (4, 2, 4)).astype(np.float32))
    done = torch.zeros(4, 2, dtype=bool)
    out = attn.apply_seq(p, xs, done, "relu", backend="bf16")
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, attn.apply_seq(p, xs, done, "relu"),
                               rtol=0, atol=0.05)


def test_reset_lanes_clamps_past_the_window():
    _, p = _params(T=4)
    cache = attn.initial_cache(p, (2,))
    x = torch.zeros(2, 4)
    for _ in range(6):
        cache, _ = attn.step(p, cache, x, "relu")
    cache = attn.reset_lanes(cache, torch.tensor([True, False]))
    assert cache["start"].tolist() == [3, 0]

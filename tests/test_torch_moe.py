"""Port parity for the mixture-of-experts trunk on one device:
ppoc_tpu_torch/models/moe.py, its structural dispatch in ``mlp.apply``,
the MoE branch of ``init_train_state``, the load-balance term of the
generic phases, kind-1 checkpoints and serving, against the JAX package.

Mirrors the single-device cases of tests/test_ep.py
(``test_moe_apply_matches_manual``, the structural dispatch, the top-k
gate, the load-balance loss, learning the toy integrator, the checkpoint
round trip and interchange), and adds whole-fit parity under "moe:2" and
"moe:2:bf16".  Parameters are numpy draws at the JAX package's init
bounds, or the port's own init (``shared_start``), carried across by
``utils/params.py``.

Tolerances.  Forwards rtol 1e-5 / atol 1e-5 (test_ep.py's); gradients
rtol 1e-4 / atol 1e-6; the f32 fit as tests/test_torch_jnp_backend.py
(weights rtol 1e-4 / atol 1e-5); the bf16 expert products and fit by
distance, as tests/test_torch_bf16.py holds bf16 (two bf16 roundoffs of
a leaf's largest magnitude, a bounded share of elements apart).

XLA's CPU backend has no batched bf16 x bf16 -> float32 dot, so the JAX
package's bf16 mixture does not run here; its bf16 reference
(:func:`jax_bf16`) takes the expert contractions on operands rounded to
bf16 and cast back to float32: the same values (a bf16 x bf16 product is
exact in float32, the sums float32), and the casts' VJP rounds each
cotangent to bf16 as the bf16 operand's own would.
"""
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs, serve as jserve
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.models import mlp as jmlp, moe as jmoe
from ppoc_tpu.utils import checkpoint as jck
from ppoc_tpu_torch import PPOConfig, envs, serve
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.models import mlp, moe
from ppoc_tpu_torch.ops import adam
from ppoc_tpu_torch.utils import checkpoint, params as conv
from test_torch_bf16 import _bf16_close
from test_torch_checkpoint import (assert_leaves_equal, jax_config,
                                   jax_state, random_state)
from test_torch_jnp_backend import (_as_fit_draws, _fit_draws, fit_close,
                                    shared_start)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
G_TOL = dict(rtol=1e-4, atol=1e-6)


def _emulated_expert_forward(experts, x, activation, bf16):
    """``ppoc_tpu/models/moe.py`` ``_expert_forward`` with each bf16
    contraction on bf16-rounded float32 operands (see the module doc)."""
    act = jmlp._ACTIVATIONS[activation]

    def dot(a, b, spec):
        if bf16:
            def r(t):
                return t.astype(jnp.bfloat16).astype(jnp.float32)

            return jnp.einsum(spec, r(a), r(b))
        return jnp.einsum(spec, a, b)

    w0, b0 = experts[0]
    h = dot(x, w0, "...i,eio->...eo") + b0
    for layer in range(1, len(experts)):
        h = act(h)
        w, b = experts[layer]
        h = dot(h, w, "...eo,eoh->...eh") + b
    return h


@pytest.fixture
def jax_bf16(monkeypatch):
    """The JAX package's mixture with :func:`_emulated_expert_forward`."""
    monkeypatch.setattr(jmoe, "_expert_forward", _emulated_expert_forward)


def _params(seed, sizes, n_experts):
    """Mixture params drawn with numpy at the JAX package's init bounds
    (``ppoc_tpu/models/moe.py`` ``init``: uniform, sqrt(3) x the Glorot
    std for the weights, 1/sqrt(fan_in) for the biases), as the JAX
    tree and the port's."""
    rng = np.random.default_rng(seed)

    def layer(fan_in, fan_out, lead=()):
        bw = np.sqrt(3.0) * np.sqrt(2.0 / (fan_in + fan_out))
        bb = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-bw, bw, lead + (fan_in, fan_out)).astype(
                    np.float32),
                rng.uniform(-bb, bb, lead + (fan_out,)).astype(np.float32))

    jp = {"router": layer(sizes[0], n_experts),
          "experts": [layer(i, o, (n_experts,))
                      for i, o in zip(sizes[:-1], sizes[1:])]}
    return jp, conv.trunk_from_numpy(jp, "cpu")


def _x(seed, shape):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, torch.tensor(x)


def _manual_moe(params, x, activation, topk=0):
    """Independent numpy evaluation: loop experts, softmax gate (as
    tests/test_ep.py)."""
    wr, br = (np.asarray(a) for a in params["router"])
    logits = np.asarray(x) @ wr + br
    z = logits - logits.max(-1, keepdims=True)
    g = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    e = g.shape[-1]
    if 0 < topk < e:
        idx = np.argsort(-g, axis=-1)[..., :topk]
        mask = np.zeros_like(g)
        np.put_along_axis(mask, idx, 1.0, axis=-1)
        g = g * mask
        g = g / g.sum(-1, keepdims=True)
    act = {"relu": lambda v: np.maximum(v, 0.0), "tanh": np.tanh}[activation]
    outs = []
    for i in range(e):
        h = np.asarray(x)
        layers = [(np.asarray(w)[i], np.asarray(b)[i])
                  for w, b in params["experts"]]
        for l, (w, b) in enumerate(layers):
            h = h @ w + b
            if l < len(layers) - 1:
                h = act(h)
        outs.append(h)
    return np.einsum("be,beo->bo", g, np.stack(outs, axis=-2))


@pytest.mark.parametrize("topk", [0, 1, 2])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_moe_apply_matches_manual(activation, topk):
    jp, p = _params(0, (5, 16, 16, 3), 4)
    x, tx = _x(1, (32, 5))
    out = moe.apply(p, tx, activation, topk=topk).numpy()
    np.testing.assert_allclose(out, _manual_moe(jp, x, activation, topk),
                               **FWD_TOL)
    np.testing.assert_allclose(
        out, np.asarray(jmoe.apply(jp, jnp.asarray(x), activation,
                                   topk=topk)), **FWD_TOL)


def test_moe_structural_dispatch_via_mlp_apply():
    """mlp.apply routes a mixture to moe.apply for any backend string,
    "pallas" included (no K5 for a mixture); the encoded backend carries
    the top-k and bf16."""
    _, p = _params(2, (4, 8, 2), 2)
    _, x = _x(3, (8, 4))
    for backend in ("jnp", "pallas"):
        assert torch.equal(mlp.apply(p, x, "relu", backend),
                           moe.apply(p, x, "relu"))
    assert mlp.moe_backend("jnp", 1) == jmlp.moe_backend("jnp", 1) == "moe:1"
    assert mlp.moe_backend("bf16", 2) == "moe:2:bf16"
    assert torch.equal(mlp.apply(p, x, "relu", mlp.moe_backend("jnp", 1)),
                       moe.apply(p, x, "relu", topk=1))
    assert torch.equal(mlp.apply(p, x, "relu", "moe:1:bf16"),
                       moe.apply(p, x, "relu", topk=1, bf16=True))
    for s in ("jnp", "bf16", "moe:0", "moe:2:bf16"):
        assert mlp._parse_moe_backend(s) == jmlp._parse_moe_backend(s)[1:]


def test_topk_gate_zeros_and_renormalizes():
    jp, p = _params(4, (3, 8, 1), 4)
    x, tx = _x(5, (16, 3))
    g = moe.gate_weights(p, tx, topk=2).numpy()
    np.testing.assert_array_equal((g > 0).sum(axis=-1), np.full(16, 2))
    np.testing.assert_allclose(g.sum(axis=-1), np.ones(16), rtol=1e-6)
    np.testing.assert_allclose(
        g, np.asarray(jmoe.gate_weights(jp, jnp.asarray(x), topk=2)),
        rtol=1e-6, atol=1e-7)


def test_load_balance_loss_values():
    """~1.0 at a uniform router, ~2 when it collapses onto one expert;
    the gradient un-collapses it; values and router gradients equal the
    JAX package's."""
    jp, p = _params(12, (4, 8, 1), 4)
    x, tx = _x(13, (256, 4))
    wr, br = p["router"]
    uniform = dict(p, router=(torch.zeros_like(wr), torch.zeros_like(br)))
    assert float(moe.load_balance_loss(uniform, tx, topk=2)) == \
        pytest.approx(1.0, rel=1e-5)
    collapsed = dict(p, router=(wr, br + torch.tensor([10.0, 0, 0, 0])))
    worse = float(moe.load_balance_loss(collapsed, tx, topk=2))
    assert worse > 1.9, worse
    router = tuple(t.clone().requires_grad_() for t in collapsed["router"])
    moe.load_balance_loss(dict(collapsed, router=router), tx, 2).backward()
    gb = router[1].grad.numpy()
    assert gb[0] == gb.max() and gb[0] > 0, gb
    jcol = dict(jp, router=(jp["router"][0],
                            jp["router"][1] + jnp.array([10.0, 0, 0, 0])))
    for topk in (0, 2):
        jl, jg = jax.jit(jax.value_and_grad(lambda q: jmoe.load_balance_loss(
            q, jnp.asarray(x), topk)))(jcol)
        r = tuple(t.clone().requires_grad_() for t in collapsed["router"])
        loss = moe.load_balance_loss(dict(collapsed, router=r), tx, topk)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-6)
        for a, b in zip(r, jg["router"]):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       **G_TOL)


@pytest.mark.parametrize("topk", [0, 2])
def test_moe_gradients_match_jax(topk):
    """Router and expert gradients of an MSE through the mixture."""
    jp, p = _params(8, (5, 16, 16, 2), 4)
    x, tx = _x(9, (32, 5))
    y, ty = _x(10, (32, 2))
    jg = jax.jit(jax.grad(lambda q: jnp.mean(jnp.square(
        jmoe.apply(q, jnp.asarray(x), "relu", topk=topk)
        - jnp.asarray(y)))))(jp)
    q = adam.tree_map(lambda t: t.clone().requires_grad_(), p)
    loss = torch.mean((moe.apply(q, tx, "relu", topk=topk) - ty) ** 2)
    grads = torch.autograd.grad(loss, adam.tree_leaves(q))
    for a, b in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **G_TOL)


def test_moe_bf16_products_match_jax(jax_bf16):
    """bf16 expert contractions with a float32 output (the JAX package's
    preferred_element_type=float32), forward and gradients, by distance;
    the float32 mixture, held to the bf16 one the same way, is a control
    that must fail the share."""
    jp, p = _params(6, (5, 32, 32, 3), 4)
    x, tx = _x(7, (256, 5))
    def jax_apply(q):
        return jmoe.apply(q, jnp.asarray(x), "relu", topk=2, bf16=True)

    want, jg = jax.device_get(jax.jit(lambda q: (jax_apply(q), jax.grad(
        lambda r: jnp.sum(jax_apply(r) ** 2))(q)))(jp))
    got = moe.apply(p, tx, "relu", topk=2, bf16=True)
    assert got.dtype == torch.float32
    _bf16_close([(got.detach().numpy(), want)], 0.2, "forward")
    f32 = moe.apply(p, tx, "relu", topk=2).numpy()
    with pytest.raises(AssertionError):
        _bf16_close([(f32, want)], 0.2, "control")
    q = adam.tree_map(lambda t: t.clone().requires_grad_(), p)
    grads = torch.autograd.grad(
        torch.sum(moe.apply(q, tx, "relu", topk=2, bf16=True) ** 2),
        adam.tree_leaves(q))
    _bf16_close([(a.numpy(), np.asarray(b))
                 for a, b in zip(grads, jax.tree.leaves(jg))], 0.3, "grads")


def test_expert_parallelism_is_refused_by_item():
    _, p = _params(0, (3, 8, 1), 2)
    with pytest.raises(NotImplementedError, match="§1 item 16"):
        moe.apply(p, torch.zeros(2, 3), ep_axis="ep")


def test_init_layout_and_aux_setup():
    """The port's own init has the JAX package's tree, shapes and
    init bounds; aux_setup reads the gating from the backend string."""
    cfg = PPOConfig(env="pendulum", hidden=(8, 8), n_experts=3,
                    moe_topk=2, moe_aux_coeff=0.01)
    ts = ppo.init_train_state(cfg, envs.make("pendulum"),
                              torch.Generator().manual_seed(0), "cpu")
    jts = jax.eval_shape(lambda k: jppo.init_train_state(
        JPPOConfig(**dataclasses.asdict(cfg)), jenvs.make("pendulum"), k),
        jax.random.PRNGKey(0))

    def shapes(state):
        return [(jax.tree_util.keystr(k), np.shape(x)) for k, x in
                jax.tree_util.tree_flatten_with_path(tuple(state))[0]]

    assert shapes(conv.train_state_to_numpy(ts)) == shapes(jts)
    wr = ts.policy_params["mlp"]["router"][0]
    assert float(wr.abs().max()) <= np.sqrt(3.0) * np.sqrt(2.0 / (3 + 3))
    assert moe.n_experts(ts.v_params) == 3
    backend = ppo.backend_of(cfg)
    assert backend == "moe:2"
    assert moe.aux_setup(cfg, ts.v_params, backend) == (0.01, 2)
    assert moe.aux_setup(cfg, [(wr, wr[0])], backend) == (0.0, 0)
    assert ppo.backend_of(cfg.replace(kernel_backend="bf16")) == "moe:2:bf16"


def test_moe_learns_simple_env():
    """The JAX test's run (top-2, seed 1), from the JAX Trainer's seed-1
    params (whether this toy is solved is set by the init,
    tests/test_ep.py:243-245), on the port's own draws."""
    cfg = PPOConfig(env="simple", n_envs=16, rollout_len=15,
                    minibatch_size=32, fits_per_epoch=3, n_epochs=2,
                    eval_envs=32, eval_len=15, kernel_backend="jnp",
                    hidden=(16, 16), seed=1, n_experts=4, moe_topk=2)
    jts = jax.jit(lambda k: jppo.init_train_state(
        JPPOConfig(**dataclasses.asdict(cfg)), jenvs.make("simple"), k))(
            jax.random.split(jax.random.PRNGKey(cfg.seed))[0])
    tr = Trainer(cfg, "cpu")
    assert tr.backend == "moe:2"
    tr.state = conv.train_state_from_numpy(jax.device_get(jts), "cpu")
    r = tr.solve(target_R=0.4, max_epochs=8)
    assert r["R"] >= 0.4, r


MOE_CFG = PPOConfig(env="simple", n_envs=16, rollout_len=15, minibatch_size=32,
                    fits_per_epoch=2, n_epochs=2, eval_envs=32, eval_len=15,
                    kernel_backend="jnp", hidden=(16, 16), seed=3,
                    n_experts=4, moe_topk=2)


def test_moe_checkpoint_roundtrip_and_interchange(tmp_path):
    """Kind-1 files round-trip bit for bit through the port; the port's
    stream is the JAX writer's, byte for byte, on the same numbers; each
    package loads the other's file leaf for leaf (Adam's leaves in sorted
    key order: the experts before the router)."""
    path = str(tmp_path / "moe.bin")
    tr = Trainer(MOE_CFG, "cpu")
    tr.train(n_epochs=1, log=False)
    tr.save(path)
    tr2 = Trainer.from_checkpoint(path, device="cpu")
    assert tr2.cfg.n_experts == 4 and tr2.cfg.moe_topk == 2
    assert_leaves_equal(tr.state, tr2.state)
    assert torch.equal(tr.generator.get_state(), tr2.generator.get_state())
    tr2.train(n_epochs=1, log=False)
    # port -> JAX
    jk = jck.load(path)
    assert_leaves_equal(conv.train_state_to_numpy(tr.state),
                        jax.device_get(jk.state))
    # the same numbers through both writers: the same bytes
    ns = random_state(MOE_CFG, 5)
    spec = jenvs.make("simple").spec
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jck._save_stream(jbuf, jax_config(MOE_CFG), spec, jax_state(ns))
    checkpoint._save_stream(pbuf, MOE_CFG, envs.make("simple").spec, ns)
    assert pbuf.getvalue() == jbuf.getvalue()
    # JAX -> port
    jpath = tmp_path / "jax.bin"
    jpath.write_bytes(jbuf.getvalue())
    ck = checkpoint.load(str(jpath))
    assert_leaves_equal(ck.state, ns)
    flat_m = checkpoint._flat_adam(ck.state.opt_v, ck.state.v_params)[0]
    first = np.asarray(ns.opt_v.m["experts"][0][0]).ravel()
    np.testing.assert_array_equal(flat_m[: first.size], first)
    with pytest.warns(checkpoint.DrawStreamWarning):
        tr3 = Trainer.from_checkpoint(str(jpath), device="cpu")
    assert_leaves_equal(tr3.state, ns)
    assert np.isfinite(tr3.evaluate().R)


def test_moe_serving_matches_jax(tmp_path):
    """A mixture's checkpoint serves through the plain mixture with the
    file's top-k, as the JAX package's load_policy does."""
    ns = random_state(MOE_CFG.replace(env="pendulum"), 6)
    cfg = MOE_CFG.replace(env="pendulum")
    p = tmp_path / "m.bin"
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make("pendulum").spec,
                     jax_state(ns))
    p.write_bytes(buf.getvalue())
    obs = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    got = serve.load_policy(str(p), device="cpu")(obs).numpy()
    want = np.asarray(jserve.load_policy(str(p))(obs))
    np.testing.assert_allclose(got, want, **FWD_TOL)


FIT_CFG = JPPOConfig(env="pendulum", n_envs=8, rollout_len=16,
                     minibatch_size=32, n_epochs_value=2, n_epochs_policy=1,
                     fits_per_epoch=1, hidden=(16, 16), n_experts=4,
                     moe_topk=2, moe_aux_coeff=0.01, ent_coeff=0.01)


@functools.lru_cache(maxsize=None)
def _jax_fits():
    """The JAX package's fit_step of key 4 under "moe:2" and
    "moe:2:bf16" (its bf16 mixture emulated, :func:`jax_bf16`) from the
    same params (``shared_start`` seed 0), and the draws, as one jitted
    program.  Returns (port state, {backend: (state, metrics)}, draws)."""
    ts, jts = shared_start(FIT_CFG, 0)
    env = jenvs.make("pendulum")
    real = jmoe._expert_forward
    jmoe._expert_forward = _emulated_expert_forward
    try:
        def program(state):
            key = jax.random.PRNGKey(4)
            return ({b: jppo.fit_step(FIT_CFG.replace(kernel_backend=b), env,
                                      state, key,
                                      backend=jmlp.moe_backend(b, 2))
                     for b in ("jnp", "bf16")},
                    _fit_draws(FIT_CFG, env, key))

        fits, raw = jax.device_get(jax.jit(program)(jts))
    finally:
        jmoe._expert_forward = real
    return ts, fits, _as_fit_draws(FIT_CFG, raw)


@pytest.mark.parametrize("kernel_backend", ["jnp", "bf16"])
def test_moe_fit_step_matches_jax(kernel_backend):
    """One whole fit under "moe:2" (the env loop through the mixture, the
    doubling-scan GAE, the generic phases with the load-balance term) and
    under "moe:2:bf16" (bf16 expert products, K2's plain version), against
    the JAX package's fit_step with the same backend string, on its own
    draws.  bf16 is held by distance (Adam moments within two bf16
    roundoffs of the leaf's scale)."""
    jcfg = FIT_CFG.replace(kernel_backend=kernel_backend)
    cfg = PPOConfig(**dataclasses.asdict(jcfg))
    assert ppo.backend_of(cfg) == jmlp.moe_backend(kernel_backend, 2)
    ts, fits, draws = _jax_fits()
    jts2, jm = fits[kernel_backend]
    ts2, m = ppo.fit_step(cfg, envs.make("pendulum"), ts, draws)
    if kernel_backend == "jnp":
        fit_close(ts2, m, jts2, jm)
        return
    got, want = conv.train_state_to_numpy(ts2), jts2
    assert (got.opt_v.t, got.opt_policy.t) == (int(want.opt_v.t),
                                               int(want.opt_policy.t))
    _bf16_close(zip(jax.tree.leaves((got.policy_params, got.v_params)),
                    jax.tree.leaves((want.policy_params, want.v_params))),
                0.5, "weights")
    _bf16_close(zip(jax.tree.leaves((got.opt_policy.m, got.opt_v.m)),
                    jax.tree.leaves((want.opt_policy.m, want.opt_v.m))),
                0.5, "moments")
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-2, atol=1e-3)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch.cuda.is_available()
is false.  This file imports neither jax nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the RNG bits must match exactly; one kernel step rtol/atol
1e-5 / 1e-6 (float32 sums in another order than cuBLAS); trajectories are
held to the plain physics by re-stepping the recorded obs, which is robust
to ulp drift in sin/cos/exp/log.  The discrete lanes' sampler must pick the
plain sampler's classes exactly on shared logits; their trajectories are
held per env to the plain rollout up to the first step the two pick apart,
which must be a near-tie of the perturbed logits (gap under 1e-4).  K5's backward sums up to 8192 rows per
weight, so its gradients are held at rtol 1e-4 with atol 1e-5 of the
leaf's largest magnitude.
"""
import pytest
import torch

from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.envs.pendulum import PendulumState
from ppoc_tpu_torch.models import mlp, policy
from ppoc_tpu_torch.ops import (adam, cuda_gae, cuda_mlp,
                                cuda_rollout as cr, cuda_update as cu)
from ppoc_tpu_torch.ops.adam import AdamState

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-6)
ENV = envs.make("pendulum")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _state(dev, hidden=(16, 16), seed=0, env="pendulum"):
    cfg = PPOConfig(env=env, hidden=hidden)
    return ppo.init_train_state(cfg, envs.make(env),
                                torch.Generator().manual_seed(seed), dev)


@pytest.mark.parametrize("t,draw", [(0, 0), (cr.T_INIT, 50), (199, 51)])
def test_rng_bits_are_exact(dev, t, draw):
    lanes = torch.arange(1000, dtype=torch.int64, device=dev)
    got = cr.rng_bits_cuda(0xDEADBEEF, 0x01234567, t, draw, 1000, dev)
    assert torch.equal(got, cr.rng_bits(0xDEADBEEF, 0x01234567, t, draw,
                                         lanes))


@pytest.mark.parametrize("hidden,E,T,carry_t", [
    ((16, 16), 15, 32, None), ((128, 128), 64, 40, 180), ((32,), 9, 8, 0)])
def test_rollout_kernel_matches_plain(dev, hidden, E, T, carry_t):
    ts = _state(dev, hidden)
    pp, vp = ts.policy_params, ts.v_params
    st0 = steps0 = None
    if carry_t is not None:
        g = torch.Generator().manual_seed(1)
        st0 = (torch.rand(E, 2, generator=g) * 4 - 2).to(dev)
        steps0 = torch.full((E,), float(carry_t), device=dev)
    args = (pp["mlp"], pp["log_std"], vp, (7, 9), E, T, "relu", st0, steps0)
    raw, ref = cr.rollout_kernel(*args), cr.rollout_plain(*args)
    torch.testing.assert_close(raw.obs[0], ref.obs[0], **TOL)
    torch.testing.assert_close(raw.action[:4], ref.action[:4], rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(raw.truncated, ref.truncated)
    assert torch.equal(raw.steps_final, ref.steps_final)
    th = torch.atan2(raw.obs[..., 1], raw.obs[..., 0]).reshape(-1)
    st = PendulumState(th, raw.obs[..., 2].reshape(-1),
                       torch.zeros_like(th, dtype=torch.int32))
    _, nobs, rew, _, _ = ENV.step(st, raw.action.reshape(-1, 1))
    torch.testing.assert_close(nobs.reshape(T, E, 3), raw.next_obs,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rew.reshape(T, E), raw.reward, rtol=1e-4,
                               atol=1e-4)
    mu = mlp.apply(pp["mlp"], raw.obs, "relu")
    torch.testing.assert_close(
        policy.gaussian_log_prob_from_mean(mu, pp["log_std"], raw.action),
        raw.log_prob, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mlp.apply(vp, raw.obs, "relu")[..., 0],
                               raw.value, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mlp.apply(vp, raw.next_obs, "relu")[..., 0],
                               raw.next_value, rtol=1e-4, atol=1e-5)


def test_rollout_kernel_metrics_match_its_trajectory(dev):
    ts = _state(dev)
    traj, _, (sum_r, sum_j, n) = cr.rollout_fused(
        "pendulum", ts.policy_params, (1, 2), 16, 230, return_metrics=True)
    want = ppo.eval_metrics_from_traj(traj, 0.99)
    assert float(n) == float(want.episodes) == 16
    torch.testing.assert_close(sum_r / n, want.R, rtol=1e-5, atol=0)
    torch.testing.assert_close(sum_j / n, want.J, rtol=1e-5, atol=0)


def _gae_args(dev, T, E, normalize):
    g = torch.Generator().manual_seed(T * E)
    r, v, nv = (torch.randn(T, E, generator=g).to(dev) for _ in range(3))
    term = (torch.rand(T, E, generator=g) < 0.05).to(dev)
    trunc = (torch.rand(T, E, generator=g) < 0.05).to(dev) & ~term
    return (r, v, nv, term, trunc, 0.99, 0.95, normalize)


@pytest.mark.parametrize("T,E", [(200, 64), (200, 512), (7, 3)])
@pytest.mark.parametrize("normalize", [True, False])
def test_gae_kernel_matches_plain(dev, T, E, normalize):
    """(200, 512) takes a cluster of 16 blocks of 32 env columns (past one
    block's shared memory), the others one block."""
    args = _gae_args(dev, T, E, normalize)
    adv, tgt = cuda_gae.gae_norm_kernel(*args)
    adv_p, tgt_p = cuda_gae.gae_norm_plain(*args)
    torch.testing.assert_close(adv, adv_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tgt, tgt_p, rtol=1e-5, atol=1e-5)


# K2 on both sides of the one-block / cluster edge (200 x 229 elements fit
# one block's shared memory, 200 x 230 do not), at E no multiple of a
# block's columns (1000: 16 blocks of 64, the last 40; 100: 4 of 32), at
# T = 1, at 999 x 512 and 150 x 4096 (the MountainCar and reacher paths),
# and past a cluster's shared memory (5000 x 64: two blocks of 32 columns,
# 1432 steps a chunk)
GAE_EDGES = [(200, 229), (200, 230), (200, 1000), (37, 100), (1, 64),
             (1, 4096), (999, 512), (150, 4096), (5000, 64)]


@pytest.mark.parametrize("T,E", GAE_EDGES)
@pytest.mark.parametrize("normalize", [True, False])
def test_gae_kernel_at_the_grid_edges_matches_plain(dev, T, E, normalize):
    args = _gae_args(dev, T, E, normalize)
    adv, tgt = cuda_gae.gae_norm_kernel(*args)
    adv_p, tgt_p = cuda_gae.gae_norm_plain(*args)
    torch.testing.assert_close(adv, adv_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tgt, tgt_p, rtol=1e-5, atol=1e-5)
    adv2, tgt2 = cuda_gae.gae_norm_kernel(*args)
    assert torch.equal(adv, adv2) and torch.equal(tgt, tgt2)


@pytest.mark.parametrize("T,E", GAE_EDGES + [(7, 3)])
def test_gae_plan_is_the_kernels(dev, T, E):
    want = cuda_gae.plan(T, E)
    assert cuda_gae.kernel_plan(T, E) == want
    assert (want.blocks == 1) == (5 * T * E <= cuda_gae.SMEM)


@pytest.mark.parametrize("E", [230, 1024])
def test_gae_bits_do_not_depend_on_the_plan(dev, E):
    """The same 64 seeded env columns, alone (one block) and first in a
    [200, E] buffer (8 blocks of 32 columns, or 16 of 64): their
    unnormalised advantages and their targets are the same bits in both
    plans."""
    T = 200
    assert cuda_gae.plan(T, 64).blocks == 1
    assert cuda_gae.plan(T, E).blocks > 1
    small = _gae_args(dev, T, 64, False)
    wide = _gae_args(dev, T, E, False)
    wide = tuple(torch.cat([a, w[:, 64:]], dim=1) for a, w
                 in zip(small[:5], wide[:5])) + small[5:]
    for normalize in (False, True):
        adv, tgt = cuda_gae.gae_norm_kernel(*small[:7], normalize)
        adv_w, tgt_w = cuda_gae.gae_norm_kernel(*wide[:7], normalize)
        assert torch.equal(tgt, tgt_w[:, :64])
        if not normalize:
            assert torch.equal(adv, adv_w[:, :64])


def _rows(dev, n_rows, d0, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(n_rows, d, generator=g) * s).to(dev)
            for d, s in ((d0, 1.0), (k, 1.0), (1, 0.3), (1, 1.0))]


@pytest.mark.parametrize("hidden,activation,mb,n", [
    ((16, 16), "relu", 32, 1), ((128, 128), "relu", 256, 1),
    ((24, 40), "tanh", 48, 3), ((128, 128), "relu", 256, 8)])
def test_value_phase_kernel_matches_plain(dev, hidden, activation, mb, n):
    ts = _state(dev, hidden)
    x, _, _, tgt = _rows(dev, n * mb, 3, 1)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    opt = ts.opt_v._replace(t=5)
    k = cu.value_phase_kernel(x, tgt * 50, ts.v_params, opt, n, mb,
                              activation, h)
    p = cu.value_phase_plain(x, tgt * 50, ts.v_params, opt, n, mb,
                             activation, h)
    torch.testing.assert_close(mlp.flatten(k[0]), mlp.flatten(p[0]),
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(mlp.flatten(k[1].m), mlp.flatten(p[1].m),
                               rtol=1e-3, atol=1e-7)
    assert k[1].t == p[1].t == 5 + n
    torch.testing.assert_close(k[2], p[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("hidden,activation,mb,n,ent", [
    ((16, 16), "relu", 32, 1, 0.0), ((128, 128), "relu", 256, 1, 0.01),
    ((24, 40), "tanh", 48, 3, 0.01), ((128, 128), "relu", 256, 8, 0.0)])
def test_policy_phase_kernel_matches_plain(dev, hidden, activation, mb, n,
                                           ent):
    ts = _state(dev, hidden)
    x, a, lp, adv = _rows(dev, n * mb, 3, 1, seed=1)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    pol = ts.policy_params
    args = (x, a, lp[:, 0], adv[:, 0], pol["mlp"], pol["log_std"],
            ts.opt_policy._replace(t=3), ts.opt_log_std._replace(t=7), n, mb,
            activation, h, 0.2, ent)
    k, p = cu.policy_phase_kernel(*args), cu.policy_phase_plain(*args)
    torch.testing.assert_close(mlp.flatten(k[0]), mlp.flatten(p[0]),
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
    assert (k[2].t, k[3].t) == (p[2].t, p[3].t) == (3 + n, 7 + n)
    torch.testing.assert_close(k[4], p[4], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(k[5], p[5], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", [2, 3, 8])
def test_gumbel_sampler_kernel_matches_plain(dev, K):
    g = torch.Generator().manual_seed(K)
    h = torch.randn(4096, K, generator=g).to(dev)
    h[:100, 1] = h[:100, 0]                    # exact logit ties
    for t in (0, 7, 499):
        idx, lp = cr.gumbel_max_cuda(h, 0xDEADBEEF, 0x01234567, t)
        idx_p, lp_p = cr.gumbel_max_plain(h, 0xDEADBEEF, 0x01234567, t,
                                          torch.arange(4096, device=dev))
        assert torch.equal(idx, idx_p)
        torch.testing.assert_close(lp, lp_p, rtol=0, atol=1e-6)


@pytest.mark.parametrize("lane,hidden,E,T,with_v", [
    ("cartpole", (16, 16), 15, 64, True), ("cartpole", (128, 128), 64, 200,
                                           True),
    ("acrobot", (16, 16), 9, 32, True), ("acrobot", (128, 128), 64, 32,
                                         False)])
def test_rollout_discrete_lane_matches_plain(dev, lane, hidden, E, T, with_v):
    ts = _state(dev, hidden, env=lane)
    pp = ts.policy_params["mlp"]
    vp = ts.v_params if with_v else None
    seed = (11, 0x9E3779B9)
    args = (pp, None, vp, seed, E, T, "relu", None, None, 0.99, lane)
    raw, ref = cr.rollout_kernel(*args), cr.rollout_plain(*args)
    assert raw.action.dtype == torch.int32 and raw.action.shape == (T, E, 1)
    lanes = torch.arange(E, device=dev)
    h = mlp.apply(pp, raw.obs, "relu")
    near = torch.zeros(T, E, dtype=torch.bool, device=dev)
    for t in range(T):
        idx, _ = cr.gumbel_max_cuda(h[t].contiguous(), *seed, t)
        near[t] = cr.gumbel_gap(h[t], *seed, t, lanes) < 1e-4
        assert torch.equal((idx != raw.action[t, :, 0]) & ~near[t],
                           torch.zeros_like(near[t]))
    apart = raw.action[..., 0] != ref.action[..., 0]
    first = torch.where(apart.any(0), apart.to(torch.int64).argmax(0),
                        torch.full((E,), T, device=dev))
    for e in range(E):
        n = int(first[e])
        assert n == T or near[n, e]
        torch.testing.assert_close(raw.obs[:n, e], ref.obs[:n, e],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(raw.reward[:n, e], ref.reward[:n, e])
        torch.testing.assert_close(raw.log_prob[:n, e], ref.log_prob[:n, e],
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(raw.terminated[:n, e], ref.terminated[:n, e])
        assert torch.equal(raw.truncated[:n, e], ref.truncated[:n, e])
        if with_v:
            torch.testing.assert_close(raw.value[:n, e], ref.value[:n, e],
                                       rtol=1e-4, atol=1e-5)
    if lane == "cartpole" and T >= 64:
        assert raw.terminated.any()


def _categorical_case(dev, hidden, K, n_rows, seed=1):
    """A train state with a K-class policy (cartpole's at K 2, acrobot's
    at 3, else acrobot's inputs and a K-class head from seed 0) and
    ``n_rows`` seeded rows."""
    env = "cartpole" if K == 2 else "acrobot"
    ts = _state(dev, hidden, env=env)
    d0 = envs.make(env).spec.obs_dim
    if K > 3:
        net = mlp.init((d0, *hidden, K), torch.Generator().manual_seed(0),
                       dev)
        ts = ts._replace(policy_params={"mlp": net},
                         opt_policy=adam.init(net))
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n_rows, d0, generator=g).to(dev)
    a = torch.randint(0, K, (n_rows, 1), generator=g,
                      dtype=torch.int32).to(dev)
    lp = (torch.log(torch.full((n_rows,), 1.0 / K))
          + 0.3 * torch.randn(n_rows, generator=g)).to(dev)
    adv = torch.randn(n_rows, generator=g).to(dev)
    return ts, (x, a, lp, adv)


@pytest.mark.parametrize("hidden,activation,mb,n,ent,K", [
    ((16, 16), "relu", 32, 1, 0.0, 2), ((128, 128), "relu", 256, 1, 0.01, 3),
    ((24, 40), "tanh", 48, 3, 0.01, 3), ((128, 128), "relu", 256, 8, 0.0, 2)])
def test_categorical_phase_kernel_matches_plain(dev, hidden, activation, mb,
                                                n, ent, K):
    ts, rows = _categorical_case(dev, hidden, K, n * mb)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    args = (*rows, ts.policy_params["mlp"], ts.opt_policy._replace(t=3), n,
            mb, activation, h, 0.2, ent)
    k = cu.policy_phase_categorical_kernel(*args)
    p = cu.policy_phase_categorical_plain(*args)
    torch.testing.assert_close(mlp.flatten(k[0]), mlp.flatten(p[0]),
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(mlp.flatten(k[1].m), mlp.flatten(p[1].m),
                               rtol=1e-3, atol=1e-7)
    assert k[1].t == p[1].t == 3 + n
    torch.testing.assert_close(k[2], p[2], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(k[3], p[3], rtol=1e-6, atol=1e-6)


def test_categorical_phase_chained_launches_equal_one_launch(dev):
    ts, rows = _categorical_case(dev, (128, 128), 3, 6 * 256, seed=2)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    whole = cu.policy_phase_categorical_kernel(
        *rows, ts.policy_params["mlp"], ts.opt_policy, 6, 256, "relu", h,
        0.2, 0.01)
    params, opt = ts.policy_params["mlp"], ts.opt_policy
    for s in range(6):
        params, opt, _, _ = cu.policy_phase_categorical_kernel(
            *(r[s * 256:(s + 1) * 256] for r in rows), params, opt, 1, 256,
            "relu", h, 0.2, 0.01)
    assert torch.equal(mlp.flatten(params), mlp.flatten(whole[0]))
    assert torch.equal(mlp.flatten(opt.v), mlp.flatten(whole[1].v))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ts = _state(dev)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    x = torch.zeros(64, 3, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        cu.value_phase_kernel(x, torch.zeros(64, device=dev), ts.v_params,
                              ts.opt_v, 2, 32, "relu", h)
    r = torch.zeros(8, 4, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gae.gae_norm_kernel(r, r, r, r.bool(), r.bool(), 0.99, 0.95)
    # past both variants: the activation tiles alone exceed shared memory
    big = PPOConfig(env="pendulum", hidden=(512, 512))
    tsb = ppo.init_train_state(big, ENV, torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="shared memory"):
        cr.rollout_kernel(tsb.policy_params["mlp"],
                          tsb.policy_params["log_std"], tsb.v_params, (0, 0),
                          8, 4)
    wide = mlp.init((4, 16, 9), torch.Generator().manual_seed(0), dev)
    ts_c, (x, a, lp, adv) = _categorical_case(dev, (16, 16), 2, 64)
    with pytest.raises(ValueError, match="1-8 classes"):
        cu.policy_phase_categorical_kernel(
            x, a, lp, adv, wide, ppo.adam.init(wide), 2, 32, "relu", h, 0.2,
            0.0)
    with pytest.raises(ValueError, match="int32"):
        cu.policy_phase_categorical_kernel(
            x, a.float(), lp, adv, ts_c.policy_params["mlp"],
            ts_c.opt_policy, 2, 32, "relu", h, 0.2, 0.0)
    with pytest.raises(ValueError, match="cartpole policy net"):
        cr.rollout_kernel(ts.policy_params["mlp"], None, None, (0, 0), 8, 4,
                          lane="cartpole")


def _mlp_case(dev, sizes, batch, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = mlp.init(sizes, g, dev)
    x = torch.randn(batch, sizes[0], generator=g).to(dev)
    ct = torch.randn(batch, sizes[-1], generator=g).to(dev)
    return params, x, ct


def _close_grads(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("sizes,batch,activation", [
    ((3, 128, 128, 1), 8192, "relu"), ((3, 128, 128, 1), 256, "relu"),
    ((3, 128, 128, 1), 100, "tanh"), ((17, 32, 5), 1, "relu"),
    ((3, 16, 16, 16, 1), 257, "tanh"), ((5, 64, 3), 65, "none"),
    ((3, 32, 1), 204800, "relu")])
def test_mlp_kernel_matches_plain(dev, sizes, batch, activation):
    """K5 forward (output and saved hiddens) and backward (dW, db, dX),
    ragged last tiles and the grid-stride loop over more tiles than
    blocks included."""
    params, x, ct = _mlp_case(dev, sizes, batch)
    out, hid = cuda_mlp.mlp_forward_kernel(params, x, activation)
    out_p, hid_p = cuda_mlp.mlp_forward_plain(params, x, activation)
    torch.testing.assert_close(out, out_p, **TOL)
    for a, b in zip(hid, hid_p):
        torch.testing.assert_close(a, b, **TOL)
    grads, dx = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct,
                                             activation)
    grads_p, dx_p = cuda_mlp.mlp_backward_plain(params, x, hid_p, ct,
                                                activation)
    _close_grads([t for pr in grads for t in pr] + [dx],
                 [t for pr in grads_p for t in pr] + [dx_p])


def test_mlp_backward_is_deterministic_and_skips_dx(dev):
    params, x, ct = _mlp_case(dev, (3, 128, 128, 1), 8192, seed=1)
    _, hid = cuda_mlp.mlp_forward_kernel(params, x, "relu")
    a, dx = cuda_mlp.mlp_backward_kernel(params, x, hid, ct, "relu")
    b, none = cuda_mlp.mlp_backward_kernel(params, x, hid, ct, "relu",
                                           need_dx=False)
    assert none is None and dx is not None
    assert torch.equal(mlp.flatten(a), mlp.flatten(b))


def test_mlp_pallas_backend_on_cuda_launches_k5(dev):
    """mlp.apply(backend="pallas") with leading dims and autograd goes
    through both K5 kernels, once each."""
    params, _, _ = _mlp_case(dev, (3, 32, 32, 2), 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(7, 13, 3, generator=g).to(dev).requires_grad_()
    leaves = [t.clone().requires_grad_() for pr in params for t in pr]
    pairs = cuda_mlp._pairs(leaves)
    f0, b0 = cuda_mlp.fwd_launches.n, cuda_mlp.bwd_launches.n
    out = mlp.apply(pairs, x, "relu", backend="pallas")
    got = torch.autograd.grad(out.square().sum(), leaves + [x])
    assert cuda_mlp.fwd_launches.n - f0 == 1
    assert cuda_mlp.bwd_launches.n - b0 == 1
    ref = mlp.apply(pairs, x, "relu", backend="jnp")
    torch.testing.assert_close(out, ref, **TOL)
    _close_grads(got, torch.autograd.grad(ref.square().sum(), leaves + [x]))


def test_mlp_kernel_refuses_a_net_over_shared_memory(dev):
    """Past both variants: at width 640 even the global-memory variant's
    two 16-row activation tiles and its dX slices exceed one block's
    shared memory (width 512 takes 230,400 B of the H100's 232,448)."""
    params, x, _ = _mlp_case(dev, (3, 640, 640, 1), 4)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_mlp.mlp_forward_kernel(params, x, "relu")


# --- K1's last four lanes, and K1 and K5 for nets past shared memory ---------
# The new lanes' physics rounds as PyTorch's ops do (__fmul_rn), so
# replay_plain on the kernel's own actions reproduces its trajectory bit
# for bit; the draws are held to the plain rollout where the two policies'
# forwards (kernel loop against cuBLAS) still agree to ~1e-6.

NEW_LANES = ("simple", "mountain_car", "mountain_car_norm", "reacher")
H100_OPTIN = 232448   # the H100's opt-in shared memory per block


def _check_lane(raw, ref, lane, pp, vp, seed, steps):
    assert torch.equal(raw.obs[0], ref.obs[0])        # the entry reset
    torch.testing.assert_close(raw.action[:steps], ref.action[:steps],
                               rtol=1e-4, atol=1e-5)
    rep = cr.replay_plain(lane, raw.action, seed)
    for key in ("obs", "next_obs", "reward", "terminated", "truncated",
                "st_final", "steps_final"):
        assert torch.equal(rep[key], getattr(raw, key)), key
    mu = mlp.apply(pp["mlp"], raw.obs, "relu")
    torch.testing.assert_close(
        policy.gaussian_log_prob_from_mean(mu, pp["log_std"], raw.action),
        raw.log_prob, rtol=1e-4, atol=1e-4)
    if vp is not None:
        torch.testing.assert_close(mlp.apply(vp, raw.obs, "relu")[..., 0],
                                   raw.value, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(
            mlp.apply(vp, raw.next_obs, "relu")[..., 0], raw.next_value,
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lane", NEW_LANES)
@pytest.mark.parametrize("variant", ["smem", "global"])
def test_rollout_new_lane_matches_plain(dev, lane, variant):
    ts = _state(dev, (16, 16), env=lane)
    pp, vp = ts.policy_params, ts.v_params
    seed, E, T = (7, 0x2545F491), 40, 60
    args = (pp["mlp"], pp["log_std"], vp, seed, E, T, "relu", None, None,
            0.99, lane)
    raw = cr.rollout_kernel(*args, variant=variant)
    _check_lane(raw, cr.rollout_plain(*args), lane, pp, vp, seed, 4)
    if lane == "simple":
        assert raw.truncated.any()
    m = cr.rollout_kernel(*args[:2], None, *args[3:], variant=variant)
    traj = ppo.Transition(m.obs, m.action, m.log_prob, m.next_obs, m.reward,
                          m.terminated, m.truncated)
    want = ppo.eval_metrics_from_traj(traj, 0.99)
    n = m.metrics[2].sum()
    assert float(n) == float(want.episodes)
    if float(n):
        torch.testing.assert_close(m.metrics[0].sum() / n, want.R,
                                   rtol=1e-5, atol=1e-6)


def test_mountain_car_kernel_terminates_on_the_last_step(dev):
    """Cars carried to the goal's doorstep reach it on their 999th step,
    the window's last: terminated, not truncated, and reset."""
    ts = _state(dev, (16, 16), env="mountain_car")
    pp = ts.policy_params
    E = 16
    st0 = torch.tensor([[0.3, 0.07], [-0.9, 0.0]] * (E // 2), device=dev)
    steps0 = torch.full((E,), 996.0, device=dev)
    args = (pp["mlp"], pp["log_std"], None, (1, 2), E, 3, "relu", st0,
            steps0, 0.99, "mountain_car")
    raw = cr.rollout_kernel(*args)
    assert raw.terminated[2, 0::2].all() and not raw.terminated[:2].any()
    assert raw.truncated[2, 1::2].all() and not raw.truncated[2, 0::2].any()
    assert (raw.steps_final == 0).all()
    rep = cr.replay_plain("mountain_car", raw.action, (1, 2), st0, steps0)
    for key in ("obs", "next_obs", "reward", "terminated", "truncated",
                "st_final"):
        assert torch.equal(rep[key], getattr(raw, key)), key


def test_rollout_global_variant_at_2x256(dev):
    """Reacher with its regime's 2x256 nets: past one block's shared
    memory, so the launch takes the global-memory variant by size."""
    ts = _state(dev, (256, 256), env="reacher")
    pp, vp = ts.policy_params, ts.v_params
    seed = (3, 0x632BE59B)
    args = (pp["mlp"], pp["log_std"], vp, seed, 70, 24, "relu", None, None,
            0.99, "reacher")
    n_s = cr.lane_launches["reacher", "values"].n
    n_g = cr.global_launches["reacher", "values"].n
    raw = cr.rollout_kernel(*args)
    assert cr.global_launches["reacher", "values"].n == n_g + 1
    assert cr.lane_launches["reacher", "values"].n == n_s
    _check_lane(raw, cr.rollout_plain(*args), "reacher", pp, vp, seed, 4)
    with pytest.raises(ValueError, match="shared memory"):
        cr.rollout_kernel(*args, variant="smem")


@pytest.mark.parametrize("lane", ["pendulum", "reacher", "cartpole"])
def test_rollout_variants_give_the_same_bits(dev, lane):
    """On nets both variants take, the global-memory variant sums each unit
    in the same order as the shared-memory one: equal outputs."""
    ts = _state(dev, (64, 64), env=lane)
    pp = ts.policy_params
    for vp in (ts.v_params, None):
        args = (pp["mlp"], pp.get("log_std"), vp, (5, 6), 45, 30, "relu",
                None, None, 0.99, lane)
        a = cr.rollout_kernel(*args, variant="smem")
        b = cr.rollout_kernel(*args, variant="global")
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


def test_variant_is_chosen_by_size(dev):
    """K1 (pendulum, policy and value [3,h,h,1]) and K5 ([3,h,h,1]): the
    largest nets that fit one block's shared memory take it, one unit
    wider take the global-memory variant.  At the H100's 232,448 B: K1's
    shared-memory variant needs 4 (2h^2 + 44h + 42) + 1024 B (h 159 fits,
    160 does not), K5's backward at its 16-row tile
    (cuda_mlp.smem_bytes) 225,280 B at h 192 and 234,016 B at 193."""
    from ppoc_tpu_torch.ops import _build

    if _build.smem_optin(dev) != H100_OPTIN:
        pytest.skip("the boundary widths are the H100's")
    for h, counts in ((159, cr.lane_launches), (160, cr.global_launches)):
        ts = _state(dev, (h, h))
        before = counts["pendulum", "values"].n
        cr.rollout_kernel(ts.policy_params["mlp"],
                          ts.policy_params["log_std"], ts.v_params, (1, 1),
                          8, 2)
        assert counts["pendulum", "values"].n == before + 1, h
    for h, fwd, bwd in ((192, cuda_mlp.fwd_launches, cuda_mlp.bwd_launches),
                        (193, cuda_mlp.fwd_global_launches,
                         cuda_mlp.bwd_global_launches)):
        params, x, ct = _mlp_case(dev, (3, h, h, 1), 100)
        f0, b0 = fwd.n, bwd.n
        _, hid = cuda_mlp.mlp_forward_kernel(params, x, "relu")
        cuda_mlp.mlp_backward_kernel(params, x, hid, ct, "relu")
        assert (fwd.n, bwd.n) == (f0 + 1, b0 + 1), h


@pytest.mark.parametrize("sizes,batch,activation", [
    ((10, 256, 256, 1), 512, "relu"), ((10, 256, 256, 2), 512, "relu"),
    ((10, 256, 256, 2), 37, "tanh"), ((3, 200, 300, 70, 1), 129, "relu")])
def test_mlp_global_variant_matches_plain(dev, sizes, batch, activation):
    """K5 for nets past shared memory: forward (output and hiddens) and
    backward (dW, db, dX), ragged tiles and slices included; the backward
    twice, bit for bit."""
    params, x, ct = _mlp_case(dev, sizes, batch)
    f0 = cuda_mlp.fwd_global_launches.n
    out, hid = cuda_mlp.mlp_forward_kernel(params, x, activation)
    assert cuda_mlp.fwd_global_launches.n == f0 + 1
    out_p, hid_p = cuda_mlp.mlp_forward_plain(params, x, activation)
    torch.testing.assert_close(out, out_p, **TOL)
    for a, b in zip(hid, hid_p):
        torch.testing.assert_close(a, b, **TOL)
    grads, dx = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct,
                                             activation)
    again, dx2 = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct,
                                              activation)
    grads_p, dx_p = cuda_mlp.mlp_backward_plain(params, x, hid_p, ct,
                                                activation)
    _close_grads([t for pr in grads for t in pr] + [dx],
                 [t for pr in grads_p for t in pr] + [dx_p])
    assert torch.equal(mlp.flatten(grads), mlp.flatten(again))
    assert torch.equal(dx, dx2)


def test_mlp_variants_agree(dev):
    """On a net both variants take: the forward and dX are the same bits
    (each output summed over the same k-steps in the same order); dW/db
    agree to rounding (the variants' tiles may differ)."""
    params, x, ct = _mlp_case(dev, (10, 64, 64, 2), 300, seed=3)
    out_s, hid_s = cuda_mlp.mlp_forward_kernel(params, x, "relu", "smem")
    out_g, hid_g = cuda_mlp.mlp_forward_kernel(params, x, "relu", "global")
    assert torch.equal(out_s, out_g)
    assert all(torch.equal(a, b) for a, b in zip(hid_s, hid_g))
    gs, dxs = cuda_mlp.mlp_backward_kernel(params, x, hid_s, ct, "relu",
                                           variant="smem")
    gg, dxg = cuda_mlp.mlp_backward_kernel(params, x, hid_s, ct, "relu",
                                           variant="global")
    assert torch.equal(dxs, dxg)
    _close_grads([t for pr in gg for t in pr], [t for pr in gs for t in pr])


# K5's row tiles: every tile the picker can choose, in both variants, the
# rows at each tile's edges (a ragged last tile, one row, a full grid)
K5_TILE_NETS = {"smem": (3, 128, 128, 1), "global": (10, 256, 256, 2)}


def _k5_tiles(dev, variant):
    """The tiles K5 takes on ``variant``'s net (both directions fit)."""
    w = K5_TILE_NETS[variant]
    fwd = cuda_mlp.launch_plan(w, 1, False, variant, device=dev)["variant"]
    assert cuda_mlp._build.VARIANTS[fwd] == variant
    return [t for t in cuda_mlp.TILES
            if max(cuda_mlp.smem_bytes(w, fwd, b, t) for b in (False, True))
            <= cuda_mlp._build.smem_optin(dev)]


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("tile", cuda_mlp.TILES)
def test_mlp_every_tile_matches_plain(dev, variant, tile):
    """K5 at each forced row tile, at rows 1, tile - 1, tile, tile + 1 and
    a grid past one wave of resident blocks: forward and backward against
    the plain versions; the backward again bit for bit, without dX the same
    dW/db bits; the two variants' forward and dX the same bits at this
    tile where both take it."""
    if tile not in _k5_tiles(dev, variant):
        pytest.skip(f"{variant} takes no {tile}-row tile on this card")
    w = K5_TILE_NETS[variant]
    plan = cuda_mlp.launch_plan(w, tile, True, variant, tile, device=dev)
    for rows, act in ((1, "relu"), (tile - 1, "tanh"), (tile, "none"),
                      (tile + 1, "relu"),
                      (tile * (plan["resident"] + 3) + 5, "tanh")):
        if rows < 1:
            continue
        params, x, ct = _mlp_case(dev, w, rows, seed=rows)
        out, hid = cuda_mlp.mlp_forward_kernel(params, x, act, variant, tile)
        out_p, hid_p = cuda_mlp.mlp_forward_plain(params, x, act)
        torch.testing.assert_close(out, out_p, **TOL)
        for a, b in zip(hid, hid_p):
            torch.testing.assert_close(a, b, **TOL)
        grads, dx = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct, act,
                                                 True, variant, tile)
        again, dx2 = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct, act,
                                                  True, variant, tile)
        no_dx, none = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct, act,
                                                   False, variant, tile)
        grads_p, dx_p = cuda_mlp.mlp_backward_plain(params, x, hid_p, ct,
                                                    act)
        _close_grads([t for pr in grads for t in pr] + [dx],
                     [t for pr in grads_p for t in pr] + [dx_p])
        assert torch.equal(mlp.flatten(grads), mlp.flatten(again)), rows
        assert torch.equal(dx, dx2) and none is None, rows
        assert torch.equal(mlp.flatten(grads), mlp.flatten(no_dx)), rows
        if variant == "smem":
            out_g, hid_g = cuda_mlp.mlp_forward_kernel(params, x, act,
                                                       "global", tile)
            _, dx_g = cuda_mlp.mlp_backward_kernel(params, x, hid_p, ct, act,
                                                   True, "global", tile)
            assert torch.equal(out, out_g), rows
            assert all(torch.equal(a, b) for a, b in zip(hid, hid_g)), rows
            assert torch.equal(dx, dx_g), rows


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("backward", [False, True])
def test_mlp_tile_picker_edges_match_plain(dev, variant, backward):
    """Where the picker moves from one tile to the next (the last row count
    a tile's grid holds in one wave of resident blocks, and one more), and
    at rows 15, 16, 17, 255, 256, 257: the launch takes tile_for's tile
    and matches the plain version."""
    w = K5_TILE_NETS[variant]
    rows_list = [15, 16, 17, 255, 256, 257]
    for t in _k5_tiles(dev, variant)[:-1]:
        # resident blocks at tile t (the backward's in clusters of 16, as
        # a grid of 16 tiles or more takes them)
        edge = t * cuda_mlp.launch_plan(w, 16 * t, backward, variant, t,
                                        device=dev)["resident"]
        rows_list += [edge, edge + 1]
    for rows in rows_list:
        params, x, ct = _mlp_case(dev, w, rows, seed=7)
        plan = cuda_mlp.launch_plan(w, rows, backward, variant, device=dev)
        out, hid = cuda_mlp.mlp_forward_kernel(params, x, "relu", variant)
        if not backward:
            assert cuda_mlp.last_launch["forward"] == plan
            torch.testing.assert_close(
                out, cuda_mlp.mlp_forward_plain(params, x, "relu")[0], **TOL)
            continue
        grads, dx = cuda_mlp.mlp_backward_kernel(params, x, hid, ct, "relu",
                                                 True, variant)
        assert cuda_mlp.last_launch["backward"] == plan
        assert plan["blocks"] % plan["cluster"] == 0
        grads_p, dx_p = cuda_mlp.mlp_backward_plain(params, x, hid, ct,
                                                    "relu")
        _close_grads([t for pr in grads for t in pr] + [dx],
                     [t for pr in grads_p for t in pr] + [dx_p])


@pytest.mark.parametrize("widths", [(3, 128, 128, 1), (10, 256, 256, 2),
                                    (17, 32, 5), (3, 192, 192, 1),
                                    (3, 200, 300, 70, 1)])
def test_mlp_smem_bytes_equal_the_kernels(dev, widths):
    """cuda_mlp.smem_bytes, from the widths alone, is csrc/mlp.cu's
    smem_bytes at every tile, in both variants and directions."""
    import ctypes

    lib = cuda_mlp._declare()
    dims = (ctypes.c_int * len(widths))(*widths)
    ma = cuda_mlp._MlpArgs(dims=dims, n_layers=len(widths) - 1, B=300)
    out = (ctypes.c_long * 4)()
    for tile in cuda_mlp.TILES:
        ma.tile = tile
        for v in range(2):
            assert lib.ppoc_mlp_sizes(ctypes.byref(ma), v, out)
            assert out[2] == tile
            assert [out[0], out[1]] == [cuda_mlp.smem_bytes(widths, v, b,
                                                            tile)
                                        for b in (False, True)], (tile, v)


def test_mlp_backward_partials_take_one_row_a_cluster(dev):
    """The throughput and reacher backwards: blocks in clusters of 16 (one
    row of the partial scratch each), at most 8 rows where the first
    design had 128 (a row a block)."""
    for w, rows in (((3, 128, 128, 1), 8192), ((10, 256, 256, 1), 16384)):
        plan = cuda_mlp.launch_plan(w, rows, True, device=dev)
        assert plan["cluster"] == cuda_mlp.CLUSTER
        assert plan["blocks"] // plan["cluster"] <= 8, plan


def test_trainer_on_cuda_reacher_regime_in_small(dev):
    """The reacher regime's path at 2x256 nets and a small batch: K1's
    reacher lane in global memory (V planes, then metrics), K2, and K5's
    global-memory variant per generic minibatch step; no K3/K4."""
    counters = [cr.global_launches["reacher", "values"],
                cr.global_launches["reacher", "metrics"], cuda_gae.launches,
                cuda_mlp.fwd_global_launches, cuda_mlp.bwd_global_launches,
                cuda_mlp.fwd_launches, cu.value_launches, cu.policy_launches]
    cfg = PPOConfig(env="reacher", n_envs=128, rollout_len=64,
                    minibatch_size=4096, shuffle_block=1024,
                    fits_per_epoch=1, n_epochs_value=2, n_epochs_policy=1,
                    eval_envs=16, eval_len=150, hidden=(256, 256),
                    kernel_backend="pallas")
    tr = Trainer(cfg)
    before = [c.n for c in counters]
    fit = tr.train_epoch()
    ev = tr.evaluate()
    # 2 x 2 value + 1 x 2 policy minibatch steps
    assert [c.n - b for c, b in zip(counters, before)] == [1, 1, 1, 6, 6, 0,
                                                           0, 0]
    assert torch.isfinite(fit.entropy) and ev.episodes == 16


def test_trainer_on_cuda_throughput_path(dev):
    """Minibatches over 2048 rows take the generic phases (K5 forward and
    backward, no K3/K4); the mean-policy evaluation is K5 forwards."""
    counters = [cr.lane_launches["pendulum", "values"],
                cr.lane_launches["pendulum", "metrics"], cuda_gae.launches,
                cu.value_launches, cu.policy_launches, cuda_mlp.fwd_launches,
                cuda_mlp.bwd_launches, cu.categorical_launches]
    cfg = PPOConfig(env="pendulum", n_envs=64, rollout_len=128,
                    minibatch_size=4096, shuffle_block=1024,
                    fits_per_epoch=1, n_epochs_value=2, n_epochs_policy=1,
                    eval_envs=16, eval_len=200, hidden=(32, 32))
    tr = Trainer(cfg)
    before = [c.n for c in counters]
    tr.train_epoch()
    ev = tr.evaluate(deterministic=True)
    n = [c.n - b for c, b in zip(counters, before)]
    # 2 x 2 value + 2 x 1 policy minibatch steps, then 200 eval steps
    assert n == [1, 0, 1, 0, 0, 4 + 2 + 200, 4 + 2, 0]
    assert ev.episodes == 16 and torch.isfinite(torch.tensor(ev.R))


def test_trainer_on_cuda_launches_every_kernel(dev):
    counters = [cr.lane_launches["pendulum", "values"],
                cr.lane_launches["pendulum", "metrics"], cuda_gae.launches,
                cu.value_launches, cu.policy_launches]
    before = [c.n for c in counters]
    cfg = PPOConfig(env="pendulum", n_envs=16, rollout_len=50,
                    minibatch_size=64, fits_per_epoch=2, n_epochs_value=2,
                    n_epochs_policy=2, eval_envs=16, eval_len=200,
                    kernel_backend="pallas")
    tr = Trainer(cfg, dev)
    hist = tr.train(n_epochs=2, log=False)
    assert all(torch.isfinite(torch.tensor(r["R"])) for r in hist)
    # per epoch: 2 training rollouts (V planes), 1 evaluation rollout
    # (metrics) after each epoch and one before the first, 2 GAEs, 2 value
    # and 2 policy phases
    assert [c.n - b for c, b in zip(counters, before)] == [4, 3, 4, 4, 4]
    assert tr.state.opt_v.t == 2 * 2 * 2 * (16 * 50 // 64)
    assert isinstance(tr.state.opt_log_std, AdamState)


@pytest.mark.parametrize("lane", ["cartpole", "acrobot"])
def test_trainer_on_cuda_discrete_path(dev, lane):
    """One discrete epoch under the fused gate runs K1's lane, K2, K3 and
    K6, and no K4; the mean-policy evaluation is K5 forwards only."""
    counters = [cr.lane_launches[lane, "values"],
                cr.lane_launches[lane, "metrics"], cuda_gae.launches,
                cu.value_launches, cu.categorical_launches,
                cu.policy_launches, cuda_mlp.fwd_launches]
    cfg = PPOConfig(env=lane, n_envs=16, rollout_len=64, minibatch_size=64,
                    fits_per_epoch=2, n_epochs_value=2, n_epochs_policy=2,
                    eval_envs=8, eval_len=500)
    tr = Trainer(cfg, dev)
    before = [c.n for c in counters]
    fit = tr.train_epoch()
    assert [c.n - b for c, b in zip(counters, before)] == [2, 0, 2, 2, 2, 0,
                                                           0]
    assert torch.isfinite(fit.entropy) and tr.state.opt_log_std.t == 0
    before = [c.n for c in counters]
    ev = tr.evaluate(deterministic=True)
    assert [c.n - b for c, b in zip(counters, before)] == [0, 0, 0, 0, 0, 0,
                                                           500]
    assert ev.episodes >= 1


# --- K7: flash attention ------------------------------------------------------
# Out and lse at atol 1e-5 and the gradients at 1e-4 of the leaf's largest
# magnitude: the kernel's online softmax and its dot products sum in another
# order than the plain version's matmuls (the JAX suite holds its kernel at
# 1e-5 and 2e-4).

def _flash_case(dev, T, B, H, hd, p_done, seed=0):
    g = torch.Generator().manual_seed(seed + T)
    q, k, v = (torch.randn(T, B, H, hd, generator=g).to(dev)
               for _ in range(3))
    done = (torch.rand(T, B, generator=g) < p_done).to(dev)
    d = done.to(torch.int32)
    return q, k, v, torch.cumsum(d, 0) - d


def _flash_grads(fn, q, k, v, ep, rel):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out, lse = fn(*leaves, ep, ep, rel)
    g = torch.Generator().manual_seed(5)
    c = torch.randn(lse.shape, generator=g).to(lse.device)
    # the lse cotangent only where a key is valid (NEG rows carry none)
    loss = torch.sin(out).sum() + (torch.where(lse > -1e8, lse, 0.0) * c).sum()
    return (out, lse), torch.autograd.grad(loss, leaves, allow_unused=True)


def _plain_block(q, k, v, qe, ke, rel):
    from ppoc_tpu_torch.ops import cuda_attn as ca

    o, l = ca.attention_plain(ca.fold(q), ca.fold(k), ca.fold(v),
                              ca.fold_ep(qe), ca.fold_ep(ke), rel,
                              q.shape[-2])
    return ca.unfold(o, q.shape), ca.unfold(l, q.shape)


# The tile edges of both variants (a warp's 16 rows, a 64-row tile), every
# head dim under each rel, layouts where the tile skip skips most tiles
# (p_done 0.25) and none (one episode over the window), B*H 128 and the
# X-ray shape.
FLASH_EDGES = [
    (1, 2, 2, 8, 0.1, 0), (15, 2, 2, 8, 0.1, 0), (17, 2, 2, 8, 0.1, 0),
    (1030, 2, 2, 8, 0.02, -1),
    *[(200, 2, 2, hd, 0.1, rel) for hd in (16, 32, 64) for rel in (-1, 0, 1)],
    (1024, 2, 2, 8, 0.25, 0), (1024, 2, 2, 8, 0.0, 0),
    (1024, 32, 4, 8, 0.02, 0), (2048, 16, 8, 64, 0.02, 0)]


@pytest.mark.parametrize("T,B,H,hd,p_done,rel", [
    (12, 3, 2, 8, 0.25, 0), (130, 2, 2, 16, 0.05, 0),
    (200, 2, 2, 32, 0.1, -1), (100, 1, 2, 64, 0.1, 0),
    (1030, 1, 1, 8, 0.02, 0), (70, 2, 2, 8, 0.1, 1), *FLASH_EDGES])
def test_flash_kernel_matches_plain(dev, T, B, H, hd, p_done, rel):
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, T, B, H, hd, p_done)
    (out, lse), grads = _flash_grads(ca.flash_mha_block, q, k, v, ep, rel)
    (out_p, lse_p), grads_p = _flash_grads(_plain_block, q, k, v, ep, rel)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-5)
    if rel > 0:
        assert (out == 0).all() and (lse == ca.NEG).all()
    for a, b in zip(grads, grads_p):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("rel", [-1, 0, 1])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("T", [1, 15, 17, 1030])
def test_flash_f32_edges_match_plain(dev, T, hd, rel):
    """The f32 kernels at the tile edges (a warp's 16 rows, a block's 32,
    a 64-row tile; T 1030 ragged), every head dim and ring relation: at T
    1, 15 and 17 a block visits one key tile, so every warp group but the
    first walks nothing."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, T, 1, 2, hd, 0.05)
    (out, lse), grads = _flash_grads(ca.flash_mha_block, q, k, v, ep, rel)
    (out_p, lse_p), grads_p = _flash_grads(_plain_block, q, k, v, ep, rel)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-5)
    if rel > 0:
        assert (out == 0).all() and (lse == ca.NEG).all()
    for a, b in zip(grads, grads_p):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("hd", [8, 64])
def test_flash_f32_rows_without_a_valid_key(dev, hd):
    """rel -1 against a key window whose episode ids start 3 later: the
    query rows of the first three episodes have no valid key and come back
    out 0 and lse NEG exactly, with zero gradients; the others match the
    plain version."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, 300, 2, 2, hd, 0.05)
    ke = ep + 3
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out, lse = ca.flash_mha_block(*leaves, ep, ke, -1)
    out_p, lse_p = _plain_block(q, k, v, ep, ke, -1)
    empty = lse_p <= ca.NEG / 2
    assert empty.any() and (~empty).any()
    assert (out[empty] == 0).all() and (lse[empty] == ca.NEG).all()
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse[~empty], lse_p[~empty], rtol=0, atol=1e-5)
    gq, = torch.autograd.grad(torch.sin(out).sum(), leaves[:1])
    assert (gq[empty] == 0).all()


@pytest.mark.parametrize("hd,T", [(8, 100), (8, 300), (16, 300), (32, 130),
                                  (64, 60), (64, 150)])
def test_flash_f32_key_split_with_an_empty_group(dev, hd, T):
    """One episode over the window: the last query block visits ceil(T /
    64) key tiles, fewer than its warp groups (hd 8 at T 100, hd 64 at T
    60), or a count they do not divide (5 tiles to 4 groups at T 300), so a
    group's share is empty or short; the results match the plain version
    and repeat bit for bit."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    splits = ca.f32_plan(hd).splits
    n = -(-T // ca.TILE)
    shares = [len(x) for x in ca.deal(list(range(n)), splits)]
    assert min(shares) == 0 or max(shares) > min(shares)
    q, k, v, ep = _flash_case(dev, T, 2, 2, hd, 0.0)
    (out, lse), grads = _flash_grads(ca.flash_mha_block, q, k, v, ep, 0)
    (out_p, lse_p), grads_p = _flash_grads(_plain_block, q, k, v, ep, 0)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-5)
    for a, b in zip(grads, grads_p):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, float(b.abs().max())))
    _, again = _flash_grads(ca.flash_mha_block, q, k, v, ep, 0)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("hd,T,rel", [(8, 1030, 0), (8, 1030, -1),
                                      (64, 1030, 0), (32, 500, -1)])
def test_flash_f32_backward_repeats_bit_for_bit(dev, hd, T, rel):
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, T, 2, 2, hd, 0.02, seed=7)
    _, g1 = _flash_grads(ca.flash_mha_block, q, k, v, ep, rel)
    _, g2 = _flash_grads(ca.flash_mha_block, q, k, v, ep, rel)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_flash_backward_is_deterministic_and_counted(dev):
    """One forward and one backward launch each of K7's three kernels;
    two backward passes agree bit for bit."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, 300, 2, 2, 8, 0.02, seed=3)
    counters = (ca.fwd_launches, ca.dq_launches, ca.dkv_launches)
    before = [c.n for c in counters]
    _, g1 = _flash_grads(ca.flash_mha_block, q, k, v, ep, 0)
    assert [c.n - b for c, b in zip(counters, before)] == [1, 1, 1]
    _, g2 = _flash_grads(ca.flash_mha_block, q, k, v, ep, 0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    out = ca.flash_mha(q, k, v, ep)
    assert [c.n - b for c, b in zip(counters, before)] == [3, 2, 2]
    assert out.shape == q.shape


def test_flash_refuses_what_the_kernel_does_not_take(dev):
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, 16, 1, 2, 8, 0.1)
    fq, fk, fv, fe = ca.fold(q), ca.fold(k), ca.fold(v), ca.fold_ep(ep)
    with pytest.raises(ValueError, match="head dims"):
        ca.flash_fwd_kernel(fq[..., :6].contiguous(), fk[..., :6].contiguous(),
                            fv[..., :6].contiguous(), fe, fe, 0, 2)
    with pytest.raises(ValueError, match="float32"):
        ca.flash_fwd_kernel(fq.double(), fk, fv, fe, fe, 0, 2)
    with pytest.raises(ValueError, match="int32"):
        ca.flash_fwd_kernel(fq, fk, fv, fe.long(), fe, 0, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ca.flash_fwd_kernel(fq.cpu(), fk, fv, fe, fe, 0, 2)
    # a launch the library itself refuses (a head dim it has no template
    # for) returns a CUDA error, which the wrapper's check raises
    from ppoc_tpu_torch.ops import _build

    lib = ca._declare()
    out, lse = torch.empty_like(fq), torch.empty(4, 16, device=dev)
    code = lib.ppoc_flash_fwd(fq.data_ptr(), fk.data_ptr(), fv.data_ptr(),
                              fe.data_ptr(), fe.data_ptr(), out.data_ptr(),
                              lse.data_ptr(), 4, 2, 16, 12, 0, 0.3,
                              _build.stream_of(dev))
    assert code != 0
    with pytest.raises(RuntimeError, match="K7 forward failed"):
        _build.check(lib, code, "K7 forward")


# --- K7's bf16 variant --------------------------------------------------------
# Held to its plain versions run on the card (the forward with the kernel's
# BF16_CHUNK): every output within two bf16 roundoffs (2^-7) of the leaf's
# largest magnitude, and at most 1% of the elements apart by more than
# 1e-5 of it.  The two sum in another order, so a p, ds or w near a bf16
# rounding boundary, or a bf16 output, now and then rounds to the
# neighbouring value; a kernel that skipped a rounding would part on
# nearly every element.

def _bf16_agree(got, want, max_share=0.01):
    top = max(1.0, float(want.abs().max()))
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= 2.0 ** -7 * top, (float(diff.max()), top)
    assert float((diff > 1e-5 * top).float().mean()) <= max_share


def _bf16_case(dev, T, B, H, hd, p_done, seed=0):
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, T, B, H, hd, p_done, seed)
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g).to(dev)
    g_lse = torch.randn(q.shape[:-1], generator=g).to(dev)
    fold = [ca.fold(x).to(torch.bfloat16) for x in (q, k, v)]
    return fold, ca.fold(dout), ca.fold(g_lse[..., None])[..., 0], \
        ca.fold_ep(ep)


@pytest.mark.parametrize("T,B,H,hd,p_done,rel", [
    (12, 3, 2, 8, 0.25, 0), (130, 2, 2, 16, 0.05, 0),
    (200, 2, 2, 32, 0.1, -1), (100, 1, 2, 64, 0.1, 0),
    (1030, 1, 1, 8, 0.02, 0), (70, 2, 2, 8, 0.1, 1),
    (1024, 4, 4, 8, 0.02, 0), *FLASH_EDGES])
def test_flash_bf16_kernel_matches_plain(dev, T, B, H, hd, p_done, rel):
    """The bf16 forward (out, lse float32) and backward (dq, dk, dv bf16)
    against attention_plain_bf16(chunk=BF16_CHUNK) and the explicit plain
    backward on the same bf16 inputs."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    (q, k, v), dout, g_lse, ep = _bf16_case(dev, T, B, H, hd, p_done)
    args = (q, k, v, ep, ep, rel, H)
    out, lse = ca.flash_fwd_kernel(*args)
    out_p, lse_p = ca.attention_plain_bf16(*args, chunk=ca.BF16_CHUNK)
    assert out.dtype == lse.dtype == torch.float32
    _bf16_agree(out, out_p)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-5)
    if rel > 0:
        assert (out == 0).all() and (lse == ca.NEG).all()
    dsum = ca.dsum_of(dout, out, g_lse).contiguous()
    bargs = args + (dout.to(torch.bfloat16), dsum, lse)
    got = (ca.flash_dq_kernel(*bargs),) + ca.flash_dkv_kernel(*bargs)
    want = ((ca.flash_dq_plain_bf16(*bargs),)
            + ca.flash_dkv_plain_bf16(*bargs))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _bf16_agree(a, b)


@pytest.mark.parametrize("T,B,H,hd", [(1024, 4, 4, 8), (2048, 16, 8, 64)])
def test_flash_bf16_check_sees_where_l_is_summed(dev, T, B, H, hd):
    """The rounding control: a forward that summed l from bf16(p)
    (attention_plain_bf16(round_l=True)) fails the check that the kernel
    passes against its plain version, so the check sees that rounding
    point."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    (q, k, v), _, _, ep = _bf16_case(dev, T, B, H, hd, 0.02)
    args = (q, k, v, ep, ep, 0, H)
    out, _ = ca.flash_fwd_kernel(*args)
    want, _ = ca.attention_plain_bf16(*args)
    control, _ = ca.attention_plain_bf16(*args, round_l=True)
    _bf16_agree(out, want)
    with pytest.raises(AssertionError):
        _bf16_agree(control, want)


def test_flash_bf16_is_deterministic_and_counted_apart(dev):
    """flash_mha(compute_dtype=bf16) with autograd launches each bf16
    kernel once and no float32 one; two backward passes agree bit for
    bit; the public gradients are float32."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    q, k, v, ep = _flash_case(dev, 300, 2, 2, 8, 0.02, seed=3)
    counters = (ca.fwd_bf16_launches, ca.dq_bf16_launches,
                ca.dkv_bf16_launches, ca.fwd_launches, ca.dq_launches,
                ca.dkv_launches)

    def grads():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = ca.flash_mha(*leaves, ep, torch.bfloat16)
        return torch.autograd.grad(torch.sin(out).sum(), leaves)

    before = [c.n for c in counters]
    g1 = grads()
    assert [c.n - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0, 0]
    g2 = grads()
    assert all(a.dtype == torch.float32 and torch.equal(a, b)
               for a, b in zip(g1, g2))


def test_flash_bf16_refuses_mixed_types(dev):
    from ppoc_tpu_torch.ops import cuda_attn as ca

    (q, k, v), dout, g_lse, ep = _bf16_case(dev, 16, 1, 2, 8, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        ca.flash_fwd_kernel(q, k.float(), v, ep, ep, 0, 2)
    out, lse = ca.flash_fwd_kernel(q, k, v, ep, ep, 0, 2)
    dsum = ca.dsum_of(dout, out, None).contiguous()
    with pytest.raises(ValueError, match="dout"):
        ca.flash_dq_kernel(q, k, v, ep, ep, 0, 2, dout, dsum, lse)
    # the bf16 kernels copy rows 16 bytes at a time: a view that starts
    # off that alignment is refused by the library, not read
    off = torch.empty(q.numel() + 8, dtype=q.dtype, device=dev)
    q_off = off[1:q.numel() + 1].view(q.shape).copy_(q)
    with pytest.raises(RuntimeError, match="K7 forward_bf16 failed"):
        ca.flash_fwd_kernel(q_off, k, v, ep, ep, 0, 2)


# --- the bf16 MLP products -----------------------------------------------------

def test_bf16_dot_on_card_matches_the_cpu_form(dev):
    """mlp.bf16_dot on the card (a bf16 tensor-core product with float32
    output) against the CPU form run on the card with TF32 off (float32
    products of the bf16 values): the forward within 1e-5 of the sum of
    |products| (both exact products, summed in another order); the
    gradients are the same float32 products rounded to bf16, so equal up
    to a rounding flip (one bf16 ulp, 2^-7) on at most 1% of elements."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(16384, 256, generator=g).to(dev).requires_grad_()
    w = (0.06 * torch.randn(256, 256, generator=g)).to(dev).requires_grad_()
    c = torch.randn(16384, 256, generator=g).to(dev)
    out = mlp.bf16_dot(a, w)
    ga, gw = torch.autograd.grad((out * c).sum(), (a, w))
    ab, wb = (t.detach().to(torch.bfloat16).float().requires_grad_()
              for t in (a, w))
    ref = ab @ wb
    ra, rw = torch.autograd.grad((ref * c).sum(), (ab, wb))
    ra, rw = ra.to(torch.bfloat16).float(), rw.to(torch.bfloat16).float()
    bound = 1e-5 * (ab.detach().abs() @ wb.detach().abs())
    assert out.dtype == torch.float32
    assert ((out - ref).abs() <= bound + 1e-6).all()
    for x, y in ((ga, ra), (gw, rw)):
        diff = (x - y).abs()
        assert (diff <= 2.0 ** -7 * y.abs() + 1e-30).all()
        assert float((diff > 0).float().mean()) <= 0.01


def test_mlp_bf16_on_card_matches_the_cpu_form(dev):
    """mlp.apply(..., "bf16") on the card, a [10,256,256,1] net on 16384
    rows, against the same on the CPU: outputs and parameter gradients
    within two bf16 roundoffs of the leaf's largest magnitude, at most 1%
    of elements apart by more than 1e-5 of it."""
    params = mlp.init((10, 256, 256, 1), torch.Generator().manual_seed(1),
                      "cpu")
    x = torch.randn(16384, 10, generator=torch.Generator().manual_seed(2))
    res = {}
    for d in ("cpu", dev):
        leaves = [tuple(t.detach().to(d).requires_grad_() for t in layer)
                  for layer in params]
        out = mlp.apply(leaves, x.to(d), "relu", "bf16")
        res[str(d)] = [out] + list(torch.autograd.grad(
            out.square().mean(), [t for layer in leaves for t in layer]))
    for a, b in zip(res[str(dev)], res["cpu"]):
        _bf16_agree(a.detach().cpu(), b.detach())


# --- the bf16 backend through Trainer ------------------------------------------

def test_trainer_on_cuda_bf16_dense_path(dev):
    """Trainer(kernel_backend="bf16") on the card by default, the reacher
    regime in small: a fit is one K1 launch without the V planes (counted
    under "metrics") in the global variant and one K2; no K3, K4, K5 or
    K6; the mean-policy evaluation launches no kernel."""
    counters = {"k1": cr.global_launches["reacher", "metrics"],
                "k1_values": cr.global_launches["reacher", "values"],
                "k2": cuda_gae.launches}
    others = [cu.value_launches, cu.policy_launches, cu.categorical_launches,
              cu.value_global_launches, cu.policy_global_launches,
              cu.categorical_global_launches, cuda_mlp.fwd_launches,
              cuda_mlp.bwd_launches, cuda_mlp.fwd_global_launches,
              cuda_mlp.bwd_global_launches]
    cfg = PPOConfig(env="reacher", n_envs=64, rollout_len=64,
                    minibatch_size=4096, shuffle_block=1024,
                    fits_per_epoch=2, n_epochs_value=2, n_epochs_policy=1,
                    eval_envs=8, eval_len=150, hidden=(256, 256),
                    kernel_backend="bf16")
    tr = Trainer(cfg)
    assert tr.device == torch.device("cuda", 0)
    before = {k: c.n for k, c in counters.items()}
    o0 = [c.n for c in others]
    fit = tr.train_epoch()
    assert {k: c.n - before[k] for k, c in counters.items()} == {
        "k1": 2, "k1_values": 0, "k2": 2}
    ev = tr.evaluate(deterministic=True)
    assert [c.n for c in others] == o0
    assert torch.isfinite(fit.value_loss) and ev.episodes == 8
    assert tr.state.opt_v.t == 2 * 2 * 1     # fits x epochs x minibatches


def test_trainer_on_cuda_bf16_attention_path(dev, monkeypatch):
    """An attention trunk under bf16 on the card with the flash core
    engaged (FLASH_MIN_T lowered): every K7 launch is the bf16 variant."""
    from ppoc_tpu_torch.models import attn
    from ppoc_tpu_torch.ops import cuda_attn as ca

    monkeypatch.setattr(attn, "FLASH_MIN_T", 8)
    cfg = PPOConfig(env="recall", n_envs=16, rollout_len=12,
                    minibatch_size=48, fits_per_epoch=1, n_epochs_value=1,
                    n_epochs_policy=1, eval_envs=16, eval_len=12,
                    hidden=(16,), attn_dim=16, attn_layers=1, attn_heads=2,
                    kernel_backend="bf16")
    tr = Trainer(cfg)
    bf = (ca.fwd_bf16_launches, ca.dq_bf16_launches, ca.dkv_bf16_launches)
    f32 = (ca.fwd_launches, ca.dq_launches, ca.dkv_launches)
    b0, f0 = [c.n for c in bf], [c.n for c in f32]
    fit = tr.train_epoch()
    n_mb = 16 // 4
    assert [c.n - b for c, b in zip(bf, b0)] == [1 + 2 * n_mb, 2 * n_mb,
                                                 2 * n_mb]
    assert [c.n for c in f32] == f0
    assert torch.isfinite(fit.value_loss) and torch.isfinite(fit.entropy)


# --- K3, K4 and K6 for nets past shared memory --------------------------------
# K3, K4 and K6 are three kinds of the same two cluster kernels: the
# replicated cluster (the nets in shared memory) and the sharded one (the
# "global" slot).  Against the plain version each is held as
# chip_smoke.check_phase holds a phase: one step within 1e-6, 20 steps
# within 1e-4 (weights and the loss and entropy, relative where above 1).
# "K6" is cartpole's 2-class policy; "K6/3" (acrobot's), "K6/5" and "K6/8"
# run the head at 3, 5 and 8 classes (the kernels pad it to 4 or 8
# columns).

def _phase_case(dev, kind, hidden, n, mb, seed=0):
    """(kernel, plain, args, global counter, smem counter) of one whole
    phase on seeded rows: K3 on the value net and K4 on the Gaussian
    policy, reacher's at 2x256 (two action dims), else pendulum's; K6 on
    a categorical policy of 2 classes, or of the count after the slash
    (_categorical_case)."""
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    if kind.startswith("K6"):
        ts, rows = _categorical_case(dev, hidden, int(kind[3:] or 2), n * mb,
                                     seed=seed)
        return (cu.policy_phase_categorical_kernel,
                cu.policy_phase_categorical_plain,
                (*rows, ts.policy_params["mlp"], ts.opt_policy._replace(t=4),
                 n, mb, "relu", h, 0.2, 0.01),
                cu.categorical_global_launches, cu.categorical_launches)
    env = "reacher" if hidden == (256, 256) else "pendulum"
    ts = _state(dev, hidden, seed=seed, env=env)
    spec = envs.make(env).spec
    x, a, lp, adv = _rows(dev, n * mb, spec.obs_dim, spec.action_dim,
                          seed=seed)
    if kind == "K3":
        return (cu.value_phase_kernel, cu.value_phase_plain,
                (x, adv * 50, ts.v_params, ts.opt_v._replace(t=5), n, mb,
                 "relu", h), cu.value_global_launches, cu.value_launches)
    pol = ts.policy_params
    return (cu.policy_phase_kernel, cu.policy_phase_plain,
            (x, a, lp[:, 0], adv[:, 0], pol["mlp"], pol["log_std"],
             ts.opt_policy._replace(t=3), ts.opt_log_std._replace(t=7), n,
             mb, "relu", h, 0.2, 0.01),
            cu.policy_global_launches, cu.policy_launches)


def _phase_weights(out):
    """The trained tensors of a phase's results: the net, and log_std."""
    extra = [out[1]] if isinstance(out[1], torch.Tensor) else []
    return torch.cat([mlp.flatten(out[0])] + extra)


def _phase_stats(out):
    return out[-2:] if isinstance(out[1], torch.Tensor) else out[2:]


def _phase_outputs(out):
    """Every output of a phase as flat tensors (Adam steps as tensors)."""
    def flat(t):
        return t.reshape(-1) if isinstance(t, torch.Tensor) else mlp.flatten(t)

    got = []
    for x in out:
        if isinstance(x, AdamState):
            got += [flat(x.m), flat(x.v), torch.tensor(x.t)]
        else:
            got.append(flat(x))
    return got


def _chip_smoke():
    """chip_smoke.py as a module (its step walk's yardsticks)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_step_close(kind, plain, args, k, p, tol, near_eps=False):
    """One step ``k`` of the kernel within ``tol`` of the plain step ``p``
    (weights, and the loss and entropy relative where above 1).  With
    ``near_eps`` (the sharded K6) a step past ``tol`` is held as
    chip_smoke.check_phase holds the sharded cluster's: its sums run in
    another order than cuBLAS, and on a weight whose gradient cancels near
    Adam's eps that order's rounding turns into a visible step; so the
    kernel step must lie within STEP_TOL, beyond twice the plain step's
    distance, of the float64 steps with every ReLU gate and clip branch
    within rounding and every gradient element near eps over its float32
    rounding taken either way (gate_band with near_eps), and the float64
    step with the learning rate 1% high must lie more than STEP_TOL
    outside them.  A step that fails names the weight farthest outside
    the band (chip_smoke.band_reading)."""
    for a, b in zip(_phase_stats(k), _phase_stats(p)):
        assert abs(float(a - b)) <= tol * max(1.0, abs(float(b)))
    err = float((_phase_weights(k) - _phase_weights(p)).abs().max())
    if err <= tol:
        return
    cs = _chip_smoke()
    rows, state, tail = _split_case(kind, args)
    mb, hyper = tail[0], tail[2]
    first = _band_rows(kind, rows, 0, mb)
    x1 = plain(*(_double(a) for a in args))
    reading = cs.band_reading(state, first, hyper, tail[3:], k, p, x1)
    assert near_eps and kind.startswith("K6"), (err, reading)
    band, _ = cs.gate_band(state, first, hyper, tail[3:], near_eps=True)
    lr_fault = cu.Hyper.of(1.01 * hyper.lr, hyper.b1, hyper.b2, hyper.eps)
    fault = plain(*(_double(a) for a in args[:len(rows) + len(state) + 3]),
                  lr_fault, *tail[3:])
    assert cs.outside(_phase_weights(fault), band) > STEP_TOL
    excess = (cs.outside(_phase_weights(k), band)
              - 2 * cs.outside(_phase_weights(p), band))
    assert excess <= STEP_TOL, (err, excess, reading)


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("n,tol", [(1, 1e-6), (20, 1e-4)])
def test_phase_global_variant_matches_plain_at_2x256(dev, kind, n, tol):
    """K3 on [10,256,256,1] and K4 on [10,256,256,2] (the reference
    schedule at reacher's width, minibatch 64), K6 on [4,256,256,2]: past
    one block's shared memory, so the launch takes the second variant by
    size (the sharded cluster) and counts it there.  (One K6 step on seed
    0's rows parts from the plain step by 1.69e-6 at one weight:
    _one_step_close.)"""
    kernel, plain, args, count_g, count_s = _phase_case(dev, kind,
                                                        (256, 256), n, 64)
    g0, s0 = count_g.n, count_s.n
    k = kernel(*args)
    assert (count_g.n, count_s.n) == (g0 + 1, s0)
    p = plain(*args)
    if n == 1:
        _one_step_close(kind, plain, args, k, p, tol, near_eps=True)
        return
    torch.testing.assert_close(_phase_weights(k), _phase_weights(p),
                               rtol=0, atol=tol)
    for a, b in zip(_phase_stats(k), _phase_stats(p)):
        assert abs(float(a - b)) <= tol * max(1.0, abs(float(b)))


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("n,tol", [(1, 1e-6), (20, 1e-4)])
def test_phase_variants_agree(dev, kind, n, tol):
    """K3, K4 and K6 on the bench nets (K6: [4,128,128,2]), minibatch 256:
    the replicated cluster (the shared-memory variant) and the sharded one
    sum in different orders, so they agree at the plain version's
    tolerances (weights, and the loss and entropy relative where above
    1)."""
    kernel, _, args, count_g, count_s = _phase_case(dev, kind, (128, 128),
                                                    n, 256, seed=3)
    g0, s0 = count_g.n, count_s.n
    a = kernel(*args, variant="smem")
    b = kernel(*args, variant="global")
    assert (count_g.n - g0, count_s.n - s0) == (1, 1)
    torch.testing.assert_close(_phase_weights(a), _phase_weights(b),
                               rtol=0, atol=tol)
    for x, y in zip(_phase_stats(a), _phase_stats(b)):
        assert abs(float(x - y)) <= tol * max(1.0, abs(float(y)))


@pytest.mark.parametrize("kind,h", [("K3", 140), ("K6", 140)])
def test_phase_variant_is_chosen_by_size(dev, kind, h):
    """At the H100's 232,448 B: the cluster block keeps K3's [3,h,h,1] and
    K6's [4,h,h,2] in shared memory to h 140 (its weights and gradient
    partial, each row padded to 4 * odd floats, a 32-row tile of
    activations and its Adam slice: cu.cluster_bytes + 1024 B; both heads
    pad to 4 columns); one unit wider takes the sharded cluster."""
    from ppoc_tpu_torch.ops import _build

    if _build.smem_optin(dev) != H100_OPTIN:
        pytest.skip("the boundary widths are the H100's")
    for width, wide in ((h, False), (h + 1, True)):
        kernel, _, args, count_g, count_s = _phase_case(
            dev, kind, (width, width), 2, 32)
        g0, s0 = count_g.n, count_s.n
        kernel(*args)
        assert (count_g.n - g0, count_s.n - s0) == (
            (1, 0) if wide else (0, 1)), width


@pytest.mark.parametrize("kind,nbytes", [("K3", 680336), ("K4", 680336),
                                         ("K6", 660624)])
def test_phase_smem_variant_refused_at_2x256(dev, kind, nbytes):
    """Forcing the shared-memory variant on a 2x256 net raises, naming the
    bytes it needs (the cluster block, cu.cluster_bytes, with the static
    1 KB; K6's [4,256,256,2] has fewer inputs than reacher's)."""
    from ppoc_tpu_torch.ops import _build

    if _build.smem_optin(dev) != H100_OPTIN:
        pytest.skip("the byte counts are checked against the H100's")
    kernel, _, args, count_g, count_s = _phase_case(dev, kind, (256, 256),
                                                    1, 64)
    n0 = (count_g.n, count_s.n)
    with pytest.raises(ValueError, match=f"{nbytes} B of shared memory"):
        kernel(*args, variant="smem")
    assert (count_g.n, count_s.n) == n0


@pytest.mark.parametrize("widths", [(10, 256, 256, 1), (4, 256, 256, 2),
                                    (3, 237, 237, 1), (3, 64, 64, 1),
                                    (6, 100, 300, 70, 3), (10, 448, 448, 2),
                                    (3, 448, 448, 448, 1)])
def test_kernel_fit_bytes_equal_the_kernels(dev, widths):
    """ppo.kernel_fit sizes each kernel from the widths alone (the ops
    modules' variant_bytes): the same bytes as the kernels' own size
    functions, in each variant (K1 with and without the value net)."""
    import ctypes

    from ppoc_tpu_torch.ops import _build

    lib = _build.load()
    dims = (ctypes.c_int * len(widths))(*widths)
    pa = cu._PhaseArgs(dims=dims, n_layers=len(widths) - 1, mb=64)
    cu._declare()
    cluster = lib.ppoc_phase_cluster_smem(ctypes.byref(pa))
    assert cluster == cu.cluster_bytes(widths)
    shard = lib.ppoc_phase_shard_smem(ctypes.byref(pa))
    assert shard == cu.shard_bytes(widths)
    assert cu.variant_bytes(widths) == [cluster + 1024, shard + 1024]
    for kind in ("value", "policy", "categorical policy"):
        # the plans' shared memory, where the card holds the cluster
        for variant, plan in enumerate((cu.phase_cluster_plan,
                                        cu.phase_shard_plan)):
            if cu.variant_bytes(widths)[variant] <= H100_OPTIN:
                assert plan(kind, widths, 64, device=dev)["smem"] == (
                    (cluster, shard)[variant])
    cuda_mlp._declare()
    ma = cuda_mlp._MlpArgs(dims=dims, n_layers=len(widths) - 1, B=300)
    want = []
    for v in range(2):
        out = (ctypes.c_long * 4)()
        assert lib.ppoc_mlp_sizes(ctypes.byref(ma), v, out)
        want.append(max(out[0], out[1]))
    assert cuda_mlp.variant_bytes(widths) == want
    cr._declare()
    vw = (widths[0], *widths[1:-1], 1)
    vdims = (ctypes.c_int * len(vw))(*vw)
    for with_v in (True, False):
        ra = cr._RolloutArgs(policy_dims=dims, value_dims=vdims,
                             value_params=1 if with_v else None,
                             n_layers=len(widths) - 1)
        got = cr.variant_bytes(widths, vw if with_v else None)
        assert got == [lib.ppoc_rollout_smem_bytes(ctypes.byref(ra), v) + 1024
                       for v in range(2)]


# --- K3 and K4 as a thread-block cluster (the weights in shared memory) -------

def _double(x):
    """A copy of a phase argument with its float tensors in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, AdamState):
        return AdamState(_double(x.m), _double(x.v), x.t)
    if isinstance(x, (list, tuple)):
        return type(x)(_double(y) for y in x)
    return x


STEP_TOL = 2e-7   # chip_smoke.STEP_TOL


def _split_case(kind, args):
    """(row columns, state, the arguments after n_steps) of a K3, K4 or
    K6 case's arguments."""
    cols, state = {"K3": (2, 2), "K4": (4, 4), "K6": (4, 2)}[kind[:2]]
    return (args[:cols], args[cols:cols + state],
            args[cols + state + 1:])


@pytest.mark.parametrize("kind", ["K3", "K4", "K6", "K6/3", "K6/5",
                                  "K6/8"])
@pytest.mark.parametrize("mb", [64, 100, 256, 2048])
@pytest.mark.parametrize("n,tol", [(1, 1e-6), (20, 1e-4)])
def test_cluster_phase_matches_plain(dev, kind, mb, n, tol):
    """The bench nets (K6: cartpole's [4,128,128,2], acrobot's
    [6,128,128,3], and 5- and 8-class heads) at the reference
    schedule's minibatch (64: 16 blocks
    of 4 rows), a ragged one (100: 14 blocks of 7, one of 2, one empty),
    the bench's (256: 16 of 16) and the fused gate's edge (2048: 16 blocks
    of 4 sub-tiles).  One step is held to the plain version at 1e-6.
    Twenty steps are held as chip_smoke.check_phase holds a phase: walked
    one launch a step from the kernel's own state, each step within
    STEP_TOL of one float64 step from that state beyond twice the plain
    float32 step's distance, the chained launches equal to the 20-step
    launch bit for bit, and its loss (and entropy) within 1e-4 of the plain
    version's, relative where above 1; K6's flagged steps, as chip_smoke
    holds them, against the float64 steps with the ReLU gates and clip
    branches within rounding taken either way (no rounding near eps).
    (The whole phase is not held
    elementwise: on a weight whose gradient is near zero, Adam's
    normalised step turns rounding into steps of lr size, so a float32
    run can part from float64 by ~1e-4 in 20 steps while every step
    agrees.)"""
    kernel, plain, args, count_g, count_s = _phase_case(dev, kind,
                                                        (128, 128), n, mb)
    g0, s0 = count_g.n, count_s.n
    k = kernel(*args)
    assert (count_g.n - g0, count_s.n - s0) == (0, 1)
    p = plain(*args)
    if n == 1:
        _one_step_close(kind, plain, args, k, p, tol)
        return
    for a, b in zip(_phase_stats(k), _phase_stats(p)):
        assert abs(float(a - b)) <= tol * max(1.0, abs(float(b)))
    _walk(kind, kernel, plain, args, mb, n, k,
          band="gates" if kind.startswith("K6") else None)


def _band_rows(kind, rows, s, mb):
    """The columns of minibatch ``s`` as chip_smoke.gate_band takes them
    (K3's targets as a vector)."""
    cols = [c[s * mb:(s + 1) * mb] for c in rows]
    if kind == "K3":
        cols[1] = cols[1].reshape(-1)
    return cols


def _walk(kind, kernel, plain, args, mb, n, whole, band=None):
    """chip_smoke.check_phase's step walk of the ``n``-step case ``args``:
    one launch a step from the kernel's own state, each step within
    STEP_TOL of one float64 step from that state beyond twice the plain
    float32 step's distance; the chained launches equal ``whole``, the
    ``n``-step launch, bit for bit.  ``band`` (as chip_smoke holds K6 and
    the sharded cluster): a step past that is held again, within STEP_TOL
    of the float64 steps with the ReLU gates and clip branches within
    rounding taken either way ("gates"), and also each gradient element
    near Adam's eps over its float32 rounding ("near eps": the sharded
    cluster), beyond twice the plain step's distance (chip_smoke.gate_band).
    A step that fails names the weight farthest outside the band
    (chip_smoke.band_reading)."""
    chip_smoke = _chip_smoke()
    rows, state, tail = _split_case(kind, args)
    ns = len(state)

    def step(fn, st, s, cast=lambda x: x):
        return fn(*(cast(c[s * mb:(s + 1) * mb]) for c in rows),
                  *cast(st), 1, *cast(tail))

    def apart(a, b):
        return float((_phase_weights(a).double()
                      - _phase_weights(b).double()).abs().max())

    for s in range(n):
        k1 = step(kernel, state, s)[:ns]
        x1 = step(plain, state, s, _double)
        p1 = step(plain, state, s)
        excess = apart(k1, x1) - 2 * apart(p1, x1)
        reading = None
        if band and excess > STEP_TOL:
            cols = _band_rows(kind, rows, s, mb)
            held, _ = chip_smoke.gate_band(state, cols, tail[2], tail[3:],
                                           near_eps=band == "near eps")
            excess = (chip_smoke.outside(_phase_weights(k1), held)
                      - 2 * chip_smoke.outside(_phase_weights(p1), held))
            if excess > STEP_TOL:
                reading = chip_smoke.band_reading(state, cols, tail[2],
                                                  tail[3:], k1, p1, x1)
        assert excess <= STEP_TOL, (s, excess, reading)
        state = k1
    assert torch.equal(_phase_weights(state), _phase_weights(whole))


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("mb", [100, 256])
def test_cluster_phase_repeats_and_chains_bit_for_bit(dev, kind, mb):
    """Two identical launches give the same bits in every output, and 6
    chained one-step launches the bits of one 6-step launch."""
    n = 6
    kernel, _, args, _, _ = _phase_case(dev, kind, (128, 128), n, mb,
                                        seed=5)
    a, b = _phase_outputs(kernel(*args)), _phase_outputs(kernel(*args))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rows, state, tail = _split_case(kind, args)
    for s in range(n):
        step = kernel(*(c[s * mb:(s + 1) * mb] for c in rows), *state, 1,
                      *tail)
        state = step[:len(state)]
    assert torch.equal(_phase_weights(step), _phase_weights(
        kernel(*args)))


@pytest.mark.parametrize("mb", [1, 32, 64, 100, 256, 512, 2048])
def test_cluster_size_follows_the_minibatch(dev, mb):
    """The launch plan: cu.CLUSTER blocks at every minibatch size, each
    taking ceil(mb / CLUSTER) rows in 32-row sub-tiles, 256 threads,
    cu.cluster_bytes of shared memory, and the card holds such a
    cluster."""
    import math

    for kind, widths in (("value", (3, 128, 128, 1)),
                         ("policy", (3, 128, 128, 1)),
                         ("categorical policy", (6, 128, 128, 3))):
        plan = cu.phase_cluster_plan(kind, widths, mb, device=dev)
        assert plan["cluster"] == cu.CLUSTER
        assert plan["rows"] == math.ceil(mb / cu.CLUSTER)
        assert plan["sub_tiles"] == math.ceil(plan["rows"] / 32)
        assert plan["threads"] == 256
        assert plan["smem"] == cu.cluster_bytes(widths)
        assert plan["max_active_clusters"] >= 1


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("cluster", [4, 8, 16])
def test_cluster_sizes_agree_with_plain(dev, kind, cluster):
    """A forced cluster size (the measurement's knob) gives a phase within
    the plain version's 20-step tolerance at the bench shape."""
    kernel, plain, args, _, count_s = _phase_case(dev, kind, (128, 128), 20,
                                                  256, seed=7)
    s0 = count_s.n
    k = kernel(*args, cluster=cluster)
    assert count_s.n == s0 + 1
    torch.testing.assert_close(_phase_weights(k), _phase_weights(plain(*args)),
                               rtol=0, atol=1e-4)


def test_cluster_refuses_what_it_cannot_launch(dev):
    """A cluster past 16 blocks (either variant) and one whose Adam slices
    pass shared memory (2 blocks of the bench net) raise before a launch,
    and none counts one."""
    kernel, _, args, count_g, count_s = _phase_case(dev, "K3", (128, 128),
                                                    1, 256)
    n0 = (count_g.n, count_s.n)
    with pytest.raises(ValueError, match="1-16 blocks"):
        kernel(*args, cluster=32)
    with pytest.raises(ValueError, match="B of shared memory"):
        kernel(*args, cluster=2)
    with pytest.raises(ValueError, match="1-16 blocks"):
        kernel(*args, variant="global", cluster=17)
    assert (count_g.n, count_s.n) == n0


# --- K3 and K4 sharded over a cluster (nets past one block) -------------------
# The "global" slot: the weights sharded by column over cu.SHARDS blocks
# (csrc/update_shard.cuh).  Held to the plain version as the replicated
# cluster is: one step within 1e-6, twenty walked step by step.

@pytest.mark.parametrize("kind", ["K3", "K4", "K6", "K6/3", "K6/5",
                                  "K6/8"])
@pytest.mark.parametrize("hidden", [(141, 141), (192, 192), (448, 448),
                                    (160, 160, 160), (448, 448, 448)])
@pytest.mark.parametrize("n,tol", [(1, 1e-6), (20, 1e-4)])
def test_shard_phase_matches_plain(dev, kind, hidden, n, tol):
    """[3,141,141,1] (one unit past the replicated cluster's boundary),
    [3,192,192,1], [3,448,448,1] (the widest K1 takes, a 32-row sub-tile),
    [3,160,160,160,1] (three hidden layers: COL, ROW, COL, ROW, two
    exchanges a sub-tile each way) and [3,448,448,448,1] (its weights
    spilled to global memory), minibatch 64, with K6 at 2, 3, 5 and 8
    classes: the launch takes the sharded variant by size.  (On seed 0's
    rows the 3-hidden-layer K3 walk's step
    0 needs gate_band's rounding: one weight's gradient, 6.6e-7, is a
    64-row sum that cancels, which Adam's eps turns into 0.4% of its
    step; K6's single steps at [3,160,160,160,2] and [3,448,448,448,2]
    part from the plain step by 1.18e-6 and 1.15e-6 at one weight each:
    _one_step_close.)"""
    kernel, plain, args, count_g, count_s = _phase_case(dev, kind, hidden,
                                                        n, 64)
    g0, s0 = count_g.n, count_s.n
    k = kernel(*args)
    assert (count_g.n - g0, count_s.n - s0) == (1, 0)
    p = plain(*args)
    if n == 1:
        _one_step_close(kind, plain, args, k, p, tol, near_eps=True)
        return
    for a, b in zip(_phase_stats(k), _phase_stats(p)):
        assert abs(float(a - b)) <= tol * max(1.0, abs(float(b)))
    _walk(kind, kernel, plain, args, 64, n, k, band="near eps")


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("hidden,mb", [((256, 256), 64), ((256, 256), 100),
                                       ((448, 448, 448), 64)])
def test_shard_phase_repeats_and_chains_bit_for_bit(dev, kind, hidden, mb):
    """Two identical launches give the same bits in every output, and 6
    chained one-step launches the bits of one 6-step launch (at mb 100 a
    sub-tile of 64 rows and one of 36)."""
    n = 6
    kernel, _, args, _, _ = _phase_case(dev, kind, hidden, n, mb, seed=5)
    a, b = _phase_outputs(kernel(*args)), _phase_outputs(kernel(*args))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rows, state, tail = _split_case(kind, args)
    for s in range(n):
        step = kernel(*(c[s * mb:(s + 1) * mb] for c in rows), *state, 1,
                      *tail)
        state = step[:len(state)]
    assert torch.equal(_phase_weights(step), _phase_weights(
        kernel(*args)))


@pytest.mark.parametrize("widths", [(10, 256, 256, 1), (3, 448, 448, 1),
                                    (3, 448, 448, 448, 1)])
@pytest.mark.parametrize("mb", [1, 64, 100, 2048])
def test_shard_plan_follows_the_layout(dev, widths, mb):
    """The launch plan: cu.SHARDS blocks, the layout's sub-tile rows
    (cu.shard_layout), ceil(mb / rows) sub-tiles, cu.SHARD_THREADS
    threads, the layout's shared memory, a card that holds such a cluster,
    and global scratch only where the weights spill."""
    import math

    lay = cu.shard_layout(widths)
    for kind in ("value", "policy", "categorical policy"):
        plan = cu.phase_shard_plan(kind, widths, mb, device=dev)
        assert plan["cluster"] == cu.SHARDS
        assert plan["sub_rows"] == lay.sub
        assert plan["sub_tiles"] == math.ceil(mb / lay.sub)
        assert plan["threads"] == cu.SHARD_THREADS
        assert plan["smem"] == lay.nbytes == cu.shard_bytes(widths)
        assert plan["max_active_clusters"] >= 1
        assert (plan["scratch"] > 0) == lay.spill


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("mb", [64, 2048])
def test_shard_cluster_sizes_agree_with_plain(dev, kind, cluster, mb):
    """A forced cluster size (the measurement's knob) gives 2x256 steps
    held as the step walk holds them: within STEP_TOL of float64 beyond
    twice the plain float32 step's distance (on seed 7's rows one weight's
    gradient is near zero, where Adam turns any rounding into a step of
    ~lr, so elementwise against the plain step it parts by 4e-5)."""
    import functools

    kernel, plain, args, count_g, _ = _phase_case(dev, kind, (256, 256), 2,
                                                  mb, seed=7)
    g0 = count_g.n
    sized = functools.partial(kernel, variant="global", cluster=cluster)
    _walk(kind, sized, plain, args, mb, 2, sized(*args), band="near eps")
    assert count_g.n == g0 + 3


def test_shard_refuses_what_it_cannot_launch(dev):
    """A net whose replicated layer 0 alone passes shared memory
    ([600,600,600,1]: W0 and its partial are 2 x 600 x 604 floats) raises
    before a launch, naming the bytes it needs, and counts none."""
    g = torch.Generator().manual_seed(0)
    params = mlp.init((600, 600, 600, 1), g, dev)
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    x = torch.randn(64, 600, generator=g).to(dev)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    n0 = (cu.value_global_launches.n, cu.value_launches.n)
    with pytest.raises(ValueError, match="B of shared memory"):
        cu.value_phase_kernel(x, x[:, 0].contiguous(), params,
                              AdamState(zeros, zeros, 0), 1, 64, "relu", h)
    assert (cu.value_global_launches.n, cu.value_launches.n) == n0


def test_trainer_refuses_512_at_construction(dev):
    """hidden (512, 512) fits K1 in no variant: Trainer raises before it
    builds any state, naming K1 and the widths."""
    with pytest.raises(NotImplementedError, match=r"K1 .*512, 512"):
        Trainer(PPOConfig(env="pendulum", hidden=(512, 512)))


def test_trainer_on_cuda_wide_fused_path(dev):
    """The reference schedule's path at 2x256 in small (reacher, minibatch
    64): K1's reacher lane and K3/K4 all in their global-memory variants,
    no shared-memory phase and no K5."""
    counters = [cr.global_launches["reacher", "values"], cuda_gae.launches,
                cu.value_global_launches, cu.policy_global_launches,
                cu.value_launches, cu.policy_launches,
                cuda_mlp.fwd_global_launches, cuda_mlp.bwd_global_launches]
    cfg = PPOConfig(env="reacher", n_envs=8, rollout_len=64,
                    minibatch_size=64, fits_per_epoch=2, n_epochs_value=2,
                    n_epochs_policy=1, eval_envs=8, eval_len=150,
                    hidden=(256, 256), kernel_backend="pallas")
    tr = Trainer(cfg)
    before = [c.n for c in counters]
    fit = tr.train_epoch()
    assert [c.n - b for c, b in zip(counters, before)] == [2, 2, 2, 2, 0, 0,
                                                           0, 0]
    assert tr.state.opt_v.t == 2 * 2 * 8 and tr.state.opt_log_std.t == 2 * 8
    assert torch.isfinite(fit.entropy) and torch.isfinite(fit.value_loss)


# --- K3 bf16 and K4 bf16: the bf16 big-tile phases --------------------------
# The kernel and its plain version round at the same points; they sum in
# other orders (mma fragments and the blocks' partials against cuBLAS), so
# one step is held at bf16 leaf scale (two bf16 roundoffs of each leaf's
# largest magnitude, at least 1) with at most 1% of the elements apart by
# more than 1e-6 of it, and a whole phase at tests/test_bigmb.py's
# kernel-against-scan tolerances (weights rtol 5e-2, atol 2e-4; the losses
# rel 2e-2, atol 1e-4).  The kernel's own sums are in a fixed order: two
# launches, and a phase split over two launches, give the same bits.

def _bf16_phase_case(dev, kind, hidden, n, mb, seed=0):
    """(kernel, plain, args) of one whole bf16 phase on seeded rows: K3 bf16
    on the value net, K4 bf16 on the Gaussian policy (reacher's, two action
    dims, at 2x256, else pendulum's); the plain version takes the JAX
    rule's row tile."""
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    env = "reacher" if hidden == (256, 256) else "pendulum"
    ts = _state(dev, hidden, seed=seed, env=env)
    spec = envs.make(env).spec
    x, a, lp, adv = _rows(dev, n * mb, spec.obs_dim, spec.action_dim,
                          seed=seed)
    if kind == "K3":
        return (cu.value_phase_bf16_kernel, cu.value_phase_bf16_plain,
                (x, adv * 5, ts.v_params, ts.opt_v._replace(t=5), n, mb,
                 "relu", h))
    pol = ts.policy_params
    return (cu.policy_phase_bf16_kernel, cu.policy_phase_bf16_plain,
            (x, a, lp[:, 0], adv[:, 0], pol["mlp"], pol["log_std"],
             ts.opt_policy._replace(t=3), ts.opt_log_std._replace(t=7), n,
             mb, "relu", h, 0.2, 0.01))


def _bf16_state_count(kind):
    """How many of _phase_outputs' leading entries are the trained state:
    all but the loss (K3) or the loss and the entropy (K4)."""
    return 4 if kind == "K3" else 8


def _bf16_leaf_close(got, want, share=0.01):
    for x, y in zip(got, want):
        top = max(1.0, float(y.abs().max()))
        diff = (x.double() - y.double()).abs()
        assert float(diff.max()) <= 2 * 2.0 ** -8 * top
        assert float((diff > 1e-6 * top).double().mean()) <= share


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("hidden,mb,n", [
    ((32, 32), 4096, 1), ((32, 32), 4096, 8), ((32, 32), 3072, 4),
    ((32, 32), 1000, 4), ((256, 256), 2048, 3)])
def test_bf16_phase_kernel_matches_plain(dev, kind, hidden, mb, n):
    """At test_bigmb's widths at minibatch 4096 (one step, then 8), 3072,
    1000 (not a multiple of 16: the last row tile masked), and the
    reacher regime's 2x256 (W staged in four slices); one launch each,
    counted once."""
    kernel, plain, args = _bf16_phase_case(dev, kind, hidden, n, mb)
    counter = cu.value_bf16_launches if kind == "K3" else \
        cu.policy_bf16_launches
    before = counter.n
    k = kernel(*args)
    assert counter.n == before + 1
    p = plain(*args)
    n_state = _bf16_state_count(kind)
    got, want = _phase_outputs(k)[:n_state], _phase_outputs(p)[:n_state]
    if n == 1:
        _bf16_leaf_close(got, want)
    torch.testing.assert_close(_phase_weights(k), _phase_weights(p),
                               rtol=5e-2, atol=2e-4)
    for a, b in zip(_phase_stats(k), _phase_stats(p)):
        assert abs(float(a - b)) <= 2e-2 * abs(float(b)) + 1e-4
    # Adam's timesteps
    assert [int(x) for x in got if x.numel() == 1 and x.dtype == torch.int64] \
        == [int(x) for x in want if x.numel() == 1 and x.dtype == torch.int64]


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("widths,activation,mb,n", [
    ((17, 40, 512, 24), "tanh", 700, 3), ((5, 512, 512, 512), "relu", 96, 2),
    ((3,), "relu", 300, 2)])
def test_bf16_phase_takes_any_widths(dev, kind, widths, activation, mb, n):
    """Widths that are not multiples of 16 (the padding), three 512-wide
    layers (fewer rows a block: shared memory), no hidden layer at all,
    tanh; one step and a few, against the plain version."""
    g = torch.Generator().manual_seed(5)
    k = 1 if kind == "K3" else 3
    sizes = list(widths) + [k]
    params = mlp.init(sizes, g, dev)
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    opt = AdamState(zeros, zeros, 0)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    x, a, lp, adv = _rows(dev, n * mb, sizes[0], k, seed=6)
    plan = cu.phase_bf16_plan("value" if kind == "K3" else "policy", sizes,
                              mb, dev)
    tiles = -(-mb // plan["rows"])
    assert plan["rounds"] == 1 and plan["grid"] % plan["cluster"] == 0
    assert tiles <= plan["grid"] < tiles + plan["cluster"]
    for steps in (1, n):
        rows = steps * mb
        if kind == "K3":
            args = (x[:rows], adv[:rows] * 5, params, opt, steps, mb,
                    activation, h)
            kernel, plain = cu.value_phase_bf16_kernel, \
                cu.value_phase_bf16_plain
        else:
            ls = torch.zeros(k, device=dev)
            ols = AdamState(torch.zeros(k, device=dev),
                            torch.zeros(k, device=dev), 0)
            args = (x[:rows], a[:rows], lp[:rows, 0], adv[:rows, 0], params,
                    ls, opt, ols, steps, mb, activation, h, 0.2, 0.01)
            kernel, plain = cu.policy_phase_bf16_kernel, \
                cu.policy_phase_bf16_plain
        got, want = kernel(*args), plain(*args)
        n_state = _bf16_state_count(kind)
        if steps == 1:
            _bf16_leaf_close(_phase_outputs(got)[:n_state],
                             _phase_outputs(want)[:n_state])
        torch.testing.assert_close(_phase_weights(got), _phase_weights(want),
                                   rtol=5e-2, atol=2e-4)


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("mb", [20000, 1])
def test_bf16_phase_blocks_take_several_tiles(dev, kind, mb):
    """More row tiles than the card holds blocks at once (20000 rows: 157
    tiles of 128), so a block sums its partials over two tiles (the grid
    whole clusters, the fewest for two rounds); and a minibatch of one
    row."""
    kernel, plain, args = _bf16_phase_case(dev, kind, (32, 32), 2, mb,
                                           seed=7)
    plan = cu.phase_bf16_plan("value" if kind == "K3" else "policy",
                              mlp.dims(args[2] if kind == "K3" else args[4]),
                              mb, dev)
    tiles = -(-mb // plan["rows"])
    assert plan["grid"] % plan["cluster"] == 0
    assert plan["rounds"] == -(-tiles // plan["grid"])
    assert plan["grid"] <= plan["blocks_per_sm"] * plan["sms"]
    if mb == 20000:
        assert plan["rounds"] == 2 and plan["grid"] == 79
    k, p = kernel(*args), plain(*args)
    torch.testing.assert_close(_phase_weights(k), _phase_weights(p),
                               rtol=5e-2, atol=2e-4)
    for a, b in zip(_phase_stats(k), _phase_stats(p)):
        assert abs(float(a - b)) <= 2e-2 * abs(float(b)) + 1e-4


def _bf16_net_leaves(kind, out):
    """Each W and b of a bf16 phase's trained net, of its m and of its v."""
    params, opt = out[0], out[1] if kind == "K3" else out[2]
    return [t for tree in (params, opt.m, opt.v) for wb in tree for t in wb]


def _bf16_leaf_dist(kind, got, want):
    """The largest relative two-norm distance of a net leaf from want's."""
    return max(float((x.double() - y.double()).norm() / y.double().norm())
               for x, y in zip(_bf16_net_leaves(kind, got),
                               _bf16_net_leaves(kind, want)))


@pytest.mark.parametrize("kind", ["K3", "K4"])
def test_bf16_phase_rounds_the_cotangent(dev, kind):
    """One step at 2x256 against the plain version summing in the kernel's
    own order (row tiles of its rows a block): every leaf of the net and
    of its moments at least 10 times nearer than the plain version with
    the cotangent left float32 is to it, so a kernel that skipped that
    rounding fails (on REACHER_BF16's rows chip_smoke.py read 700-900x for
    K3 and, with log_std's leaf, 66-121x for K4)."""
    kernel, plain, args = _bf16_phase_case(dev, kind, (256, 256), 1, 2048)
    widths = mlp.dims(args[2] if kind == "K3" else args[4])
    plan = cu.phase_bf16_plan("value" if kind == "K3" else "policy", widths,
                              2048, dev)
    want = plain(*args, plan["rows"], group=plan["group"])
    got = _bf16_leaf_dist(kind, kernel(*args), want)
    control = _bf16_leaf_dist(kind, plain(*args, plan["rows"],
                                          group=plan["group"],
                                          round_cotangent=False), want)
    assert 10 * got <= control, (got, control)


@pytest.mark.parametrize("kind", ["K3", "K4"])
def test_bf16_phase_is_deterministic_and_splits(dev, kind):
    """Two launches on the same inputs give the same bits, and so do two
    launches of half the steps each (Adam's t carried) against one."""
    n, mb = 8, 1000
    kernel, _, args = _bf16_phase_case(dev, kind, (32, 32), n, mb, seed=4)
    one = _phase_outputs(kernel(*args))
    assert all(torch.equal(x, y) for x, y in zip(
        one, _phase_outputs(kernel(*args))))
    half = n // 2 * mb
    if kind == "K3":
        x, tgt, params, opt, _, _, act, h = args
        p1, o1, _ = kernel(x[:half], tgt[:half], params, opt, n // 2, mb,
                           act, h)
        split = kernel(x[half:], tgt[half:], p1, o1, n // 2, mb, act, h)
    else:
        x, a, lp, adv, params, ls, op, ols, _, _, act, h, ce, ent = args
        p1, ls1, op1, ols1, _, _ = kernel(
            x[:half], a[:half], lp[:half], adv[:half], params, ls, op, ols,
            n // 2, mb, act, h, ce, ent)
        split = kernel(x[half:], a[half:], lp[half:], adv[half:], p1, ls1,
                       op1, ols1, n // 2, mb, act, h, ce, ent)
    n_state = _bf16_state_count(kind)
    assert all(torch.equal(x, y) for x, y in zip(
        _phase_outputs(split)[:n_state], one[:n_state]))


@pytest.mark.parametrize("kind", ["value", "policy"])
def test_bf16_phase_grid_spans_the_card(dev, kind):
    """128 rows a block: minibatch 16384 of the reacher nets launches 128
    cooperative blocks, one per row tile, all resident at once (two
    consumer warpgroups and the producer warp a block, W's ring two stages
    of 64 x 256), in clusters of 2 (of 4 or more the card holds 120 or
    fewer blocks at this shared memory), and sums the partials in 16 groups
    of 8; 1000 rows take one round too."""
    widths = [10, 256, 256, 1 if kind == "value" else 2]
    plan = cu.phase_bf16_plan(kind, widths, 16384, dev)
    props = torch.cuda.get_device_properties(dev)
    assert plan["rows"] == 128 and plan["threads"] == 288
    assert plan["stages"] == 2 and plan["stage_bytes"] == 64 * 256 * 2
    assert plan["rounds"] == 1 and plan["group"] == 8
    assert plan["grid"] == 128 and plan["cluster"] == 2
    assert plan["sms"] == props.multi_processor_count
    small = cu.phase_bf16_plan(kind, widths, 1000, dev)
    assert small["rounds"] == 1 and small["grid"] == 8
    assert small["cluster"] == 8


# one step against the plain version in the kernel's order: chip_smoke.py's
# BIGMB_STEP_REL
_BF16_STEP_REL = {"K3": 1e-5, "K4": 2.5e-4}


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("mb,rows", [(2048, 128), (64, 64)])
def test_bf16_phase_matches_plain_in_its_order(dev, kind, mb, rows):
    """One step at 2x256 against the plain version summing in the kernel's
    order (its rows a tile, its plan's group), each leaf of the net and its
    moments within _BF16_STEP_REL of its two-norm: 128 rows a block on two
    warpgroups, and 64 rows (a minibatch of 64) on one."""
    kernel, plain, args = _bf16_phase_case(dev, kind, (256, 256), 1, mb)
    widths = mlp.dims(args[2] if kind == "K3" else args[4])
    plan = cu.phase_bf16_plan("value" if kind == "K3" else "policy", widths,
                              mb, dev)
    assert plan["rows"] == rows
    got = kernel(*args)
    want = plain(*args, plan["rows"], group=plan["group"])
    assert _bf16_leaf_dist(kind, got, want) <= _BF16_STEP_REL[kind]


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_bf16_phase_every_cluster_size(dev, kind, cluster):
    """Each cluster size the plan can pick (forced), W multicast to the
    cluster's blocks: one step at 2x256, minibatch 2048 (16 tiles), against
    the plain version at the plan's rows and group, then two launches of
    two steps, the same bits."""
    kernel, plain, args = _bf16_phase_case(dev, kind, (256, 256), 1, 2048)
    widths = mlp.dims(args[2] if kind == "K3" else args[4])
    plan = cu.phase_bf16_plan("value" if kind == "K3" else "policy", widths,
                              2048, dev, cluster=cluster)
    assert plan["cluster"] == cluster and plan["grid"] % cluster == 0
    got = kernel(*args, cluster=cluster)
    want = plain(*args, plan["rows"], group=plan["group"])
    assert _bf16_leaf_dist(kind, got, want) <= _BF16_STEP_REL[kind]
    kernel, _, args = _bf16_phase_case(dev, kind, (256, 256), 2, 2048)
    one = _phase_outputs(kernel(*args, cluster=cluster))
    assert all(torch.equal(x, y) for x, y in zip(
        one, _phase_outputs(kernel(*args, cluster=cluster))))


# wgmma.cuh's products as the kernel runs them: K, N
_WGMMA_CASES = {"forward": [(16, 256), (64, 64), (48, 192), (10, 128)],
                "dx": [(256, 64), (64, 64), (192, 64), (40, 64)],
                "dw": [(128, 256), (16, 64), (64, 192), (112, 128)],
                "head_forward": [(64, 16), (10, 16)],
                "head_dx": [(16, 256), (16, 192), (16, 64)],
                "head_dw": [(128, 16), (16, 16)]}


@pytest.mark.parametrize("mode,k,n", [(m, k, n) for m, cases in
                                      _WGMMA_CASES.items()
                                      for k, n in cases])
def test_wgmma_product_matches_float64(dev, mode, k, n):
    """One wgmma.cuh product (64 output rows) against float64 products of
    the same bf16 operands: within float32 summation (each output's error
    at most K x 2^-23 of the sum of |terms|), on the forward's, dX's and
    dW's operand layouts, and the head's (16 columns, the 32-byte
    swizzle)."""
    g = torch.Generator().manual_seed(k * 1000 + n)
    shapes = {"forward": ((64, k), (k, n)), "dx": ((64, k), (64, k)),
              "dw": ((k, 64), (k, n)), "head_forward": ((64, k), (k, 16)),
              "head_dx": ((64, 16), (n, 16)),
              "head_dw": ((k, 64), (k, 16))}[mode]
    a, b = (torch.randn(*s, generator=g) for s in shapes)
    got = cu.wgmma_product(mode, a.to(dev), b.to(dev)).cpu().double()
    at = a.T if mode in ("dw", "head_dw") else a
    bt = b.T if mode in ("dx", "head_dx") else b
    ab, bb = cu._bf(at).double(), cu._bf(bt).double()
    want, scale = ab @ bb, ab.abs() @ bb.abs()
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= k * 2.0 ** -23 * scale + 1e-30).all())


@pytest.mark.parametrize("widths,what", [
    ((3, 600, 1), "512 wide"), ((3,) + (16,) * 8 + (1,), "1-8 layers")])
def test_bf16_phase_refuses_nets_past_its_limits(dev, widths, what):
    params = [(torch.zeros(a, b, device=dev), torch.zeros(b, device=dev))
              for a, b in zip(widths[:-1], widths[1:])]
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    opt = AdamState(zeros, zeros, 0)
    before = cu.value_bf16_launches.n
    with pytest.raises(ValueError, match=what):
        cu.value_phase_bf16_kernel(
            torch.zeros(64, 3, device=dev), torch.zeros(64, device=dev),
            params, opt, 1, 64, "relu", cu.Hyper.of(1e-3, 0.9, 0.999, 1e-8))
    with pytest.raises(ValueError, match=what):
        cu.phase_bf16_plan("value", widths, 64, dev)
    assert cu.value_bf16_launches.n == before


# --- K1's tiles, split-K layer passes and V(s') from the next V(s) ----------
# An env's sums are split by the layer widths alone and its draws keyed by
# its index, so its outputs are the same bits at any env count and tile, and
# the V(s') taken from the next step's V(s) is the bits the value net's own
# pass gives on the same obs.

def _env_rows(raw, n):
    """The outputs of envs 0..n-1 of a launch, by field."""
    per_env = ("st_final", "steps_final")   # [E, ...]; the rest [T|3, E]
    return {key: x[:n] if key in per_env else x[:, :n]
            for key, x in raw._asdict().items() if x is not None}


def _carried(lane, E, dev, seed=1):
    """A carried state of E envs whose step counters run close to the
    horizon, so a 60-step window truncates (pendulum) or whose episodes end
    (cartpole); reacher truncates at 150."""
    g = torch.Generator().manual_seed(seed)
    ln = cr.LANES[lane]
    if lane == "pendulum":
        st = torch.rand(E, 2, generator=g) * 4 - 2
    elif lane == "cartpole":
        st = (torch.rand(E, 4, generator=g) - 0.5) * 0.1
    else:
        st = (torch.rand(E, ln.state_dim, generator=g) - 0.5) * 1.6
    steps = torch.randint(ln.horizon - 50, ln.horizon, (E,), generator=g)
    return st.to(dev), steps.to(torch.float32).to(dev)


@pytest.mark.parametrize("lane,hidden", [
    ("pendulum", (128, 128)), ("cartpole", (64, 64)), ("reacher", (256, 256))])
def test_rollout_env_bits_do_not_depend_on_env_count_or_tile(dev, lane,
                                                             hidden):
    """Envs 0..63 of a 64-env and a 1024-env launch, and of the 64-env
    launch at every tile the variant takes, equal bit for bit, with the V
    planes and with the metrics; each equal to the launch that runs the
    value net's V(s') pass at every step.  Reacher's 2x256 nets take the
    global-memory variant."""
    ts = _state(dev, hidden, env=lane)
    pp = ts.policy_params
    st0, steps0 = _carried(lane, 1024, dev)
    tiles = cr.TILES if lane != "reacher" else (32,)
    for vp in (ts.v_params, None):
        def run(E, fn=cr.rollout_kernel, **kw):
            return fn(pp["mlp"], pp.get("log_std"), vp, (5, 0x9E3779B9), E,
                      60, "relu", st0[:E].contiguous(), steps0[:E].clone(),
                      0.99, lane, **kw)
        want = _env_rows(run(64), 64)
        assert bool(want["truncated"].any() or want["terminated"].any())
        if lane == "reacher":
            assert cr.last_launch["variant"] == 1
        runs = {"1024 envs": run(1024)}
        for tile in tiles:
            runs[f"tile {tile}"] = run(64, tile=tile)
            if vp is not None:
                runs[f"tile {tile}, V(s') every step"] = run(
                    64, cr.rollout_kernel_vnext_every_step, tile=tile)
        for name, raw in runs.items():
            got = _env_rows(raw, 64)
            for key, x in want.items():
                assert torch.equal(got[key], x), (name, key)


@pytest.mark.parametrize("E", [1, 3, 64, 129, 1024])
def test_rollout_kernel_matches_plain_at_any_env_count(dev, E):
    """The bench nets from a carried state that crosses the horizon: the
    first steps against the plain version, the trajectory against the plain
    physics, and the V planes (V(s') from the next step's V(s) where a step
    did not end) against the plain forward on the recorded obs."""
    ts = _state(dev, (128, 128))
    pp, vp = ts.policy_params, ts.v_params
    st0, steps0 = _carried("pendulum", E, dev, seed=E)
    T = 60
    args = (pp["mlp"], pp["log_std"], vp, (7, 9), E, T, "relu", st0, steps0)
    raw, ref = cr.rollout_kernel(*args), cr.rollout_plain(*args)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = cr.last_launch["resident"]
    assert resident >= sms and resident % sms == 0
    assert cr.last_launch["tile"] == cr.tile_for(E, resident)
    torch.testing.assert_close(raw.obs[0], ref.obs[0], **TOL)
    torch.testing.assert_close(raw.action[:4], ref.action[:4], rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(raw.truncated, ref.truncated)
    assert raw.truncated.any()
    assert torch.equal(raw.steps_final, ref.steps_final)
    th = torch.atan2(raw.obs[..., 1], raw.obs[..., 0]).reshape(-1)
    st = PendulumState(th, raw.obs[..., 2].reshape(-1),
                       torch.zeros_like(th, dtype=torch.int32))
    _, nobs, _, _, _ = ENV.step(st, raw.action.reshape(-1, 1))
    torch.testing.assert_close(nobs.reshape(T, E, 3), raw.next_obs,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mlp.apply(vp, raw.obs, "relu")[..., 0],
                               raw.value, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mlp.apply(vp, raw.next_obs, "relu")[..., 0],
                               raw.next_value, rtol=1e-4, atol=1e-5)


def test_rollout_tile_refuses_what_the_variant_does_not_run(dev):
    ts = _state(dev, (16, 16))
    args = (ts.policy_params["mlp"], ts.policy_params["log_std"],
            ts.v_params, (1, 2), 8, 4)
    before = cr.lane_launches["pendulum", "values"].n
    for tile in (3, 16, 32):
        with pytest.raises(ValueError, match="envs a block"):
            cr.rollout_kernel(*args, tile=tile)
    with pytest.raises(ValueError, match="envs a block"):
        cr.rollout_kernel(*args, variant="global", tile=8)
    assert cr.lane_launches["pendulum", "values"].n == before


def test_rollout_split_is_a_function_of_the_widths_alone(dev):
    """The built kernel's S parts per unit (csrc/rollout.cu layer_split,
    queried through ppoc_rollout_layer_split, whose arguments are the
    widths alone): a power of two; the output layers of 1-2 units at 128
    and 256 inputs spread over a whole warp, the hidden layers over at most
    4 lanes, the input layers not at all, and every part sums at least 4
    (narrow) or 32 (wide) inputs."""
    for din in (128, 256):
        for dout in (1, 2):
            assert cr.layer_split(din, dout) == 32
        assert cr.layer_split(din, din) == 4
    for din, dout in [(3, 128), (10, 256), (4, 64), (31, 64)]:
        assert cr.layer_split(din, dout) == 1
    for din in range(1, 600):
        for dout in (1, 2, 3, 16, 31, 32, 64, 128, 256, 300):
            s = cr.layer_split(din, dout)
            assert s & (s - 1) == 0 and 1 <= s <= (32 if dout < 32 else 4)
            assert s == 1 or s * (4 if dout < 32 else 32) <= din

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch.cuda.is_available()
is false.  This file imports neither jax nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the RNG bits must match exactly; one kernel step rtol/atol
1e-5 / 1e-6 (float32 sums in another order than cuBLAS); trajectories are
held to the plain physics by re-stepping the recorded obs, which is robust
to ulp drift in sin/cos/exp/log.  K5's backward sums up to 8192 rows per
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
from ppoc_tpu_torch.ops import (cuda_gae, cuda_mlp, cuda_rollout as cr,
                                cuda_update as cu)
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


def _state(dev, hidden=(16, 16), seed=0):
    cfg = PPOConfig(env="pendulum", hidden=hidden)
    return ppo.init_train_state(cfg, ENV, torch.Generator().manual_seed(seed),
                                dev)


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


@pytest.mark.parametrize("T,E", [(200, 64), (200, 512), (7, 3)])
@pytest.mark.parametrize("normalize", [True, False])
def test_gae_kernel_matches_plain(dev, T, E, normalize):
    """(200, 512) keeps the advantages in global memory (past the
    shared-memory size), the others in shared memory."""
    g = torch.Generator().manual_seed(T * E)
    r, v, nv = (torch.randn(T, E, generator=g).to(dev) for _ in range(3))
    term = (torch.rand(T, E, generator=g) < 0.05).to(dev)
    trunc = (torch.rand(T, E, generator=g) < 0.05).to(dev) & ~term
    args = (r, v, nv, term, trunc, 0.99, 0.95, normalize)
    adv, tgt = cuda_gae.gae_norm_kernel(*args)
    adv_p, tgt_p = cuda_gae.gae_norm_plain(*args)
    torch.testing.assert_close(adv, adv_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tgt, tgt_p, rtol=1e-5, atol=1e-5)


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
    big = PPOConfig(env="pendulum", hidden=(256, 256))
    tsb = ppo.init_train_state(big, ENV, torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="shared memory"):
        cr.rollout_kernel(tsb.policy_params["mlp"],
                          tsb.policy_params["log_std"], tsb.v_params, (0, 0),
                          8, 4)


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
    params, x, _ = _mlp_case(dev, (3, 512, 512, 1), 4)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_mlp.mlp_forward_kernel(params, x, "relu")


def test_trainer_on_cuda_throughput_path(dev):
    """Minibatches over 2048 rows take the generic phases (K5 forward and
    backward, no K3/K4); the mean-policy evaluation is K5 forwards."""
    counters = [cr.launches, cuda_gae.launches, cu.value_launches,
                cu.policy_launches, cuda_mlp.fwd_launches,
                cuda_mlp.bwd_launches]
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
    assert n == [1, 1, 0, 0, 4 + 2 + 200, 4 + 2]
    assert ev.episodes == 16 and torch.isfinite(torch.tensor(ev.R))


def test_trainer_on_cuda_launches_every_kernel(dev):
    counters = [cr.launches, cuda_gae.launches, cu.value_launches,
                cu.policy_launches]
    before = [c.n for c in counters]
    cfg = PPOConfig(env="pendulum", n_envs=16, rollout_len=50,
                    minibatch_size=64, fits_per_epoch=2, n_epochs_value=2,
                    n_epochs_policy=2, eval_envs=16, eval_len=200,
                    kernel_backend="pallas")
    tr = Trainer(cfg, dev)
    hist = tr.train(n_epochs=2, log=False)
    assert all(torch.isfinite(torch.tensor(r["R"])) for r in hist)
    # per epoch: 2 fits + 1 eval rollouts, 2 GAEs, 2 value, 2 policy phases
    assert [c.n - b for c, b in zip(counters, before)] == [7, 4, 4, 4]
    assert tr.state.opt_v.t == 2 * 2 * 2 * (16 * 50 // 64)
    assert isinstance(tr.state.opt_log_std, AdamState)

"""Port parity for the host actor (``ppoc_tpu_torch/envs/host.py``,
``native/`` and the running normalisers of ``envs/wrappers.py``), held to
the JAX package's ``envs/host.py`` and ``native``; mirrors
tests/test_host_trainer.py.

Bit for bit: the port's engine against ``ppoc_tpu.native`` (resets, steps,
the autoreset); ``HostPolicy`` and ``collect_host_np`` on carried-over
params and the same numpy seed (Gaussian, categorical, a top-k mixture);
the three normalisers on the same streams; the sidecars and checkpoints
both ways.  Within tolerances: the device actor's log-probs against the
JAX ``policy.log_prob`` of its actions (1e-6 absolute and relative), and
one host fit's update
against the JAX ``update_step`` on the same trajectory with the JAX
update's row-id streams carried across: weights rtol 1e-4 / atol 1e-5,
Adam's second moments rtol 1e-3 / atol 1e-7, metrics rtol 1e-4 / atol
1e-6 (as tests/test_torch_trainer.py).  The JAX side of that fit is one
jitted program.
"""
import dataclasses
import functools
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, envs as jenvs, native as jnative
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.envs import host as jhost, wrappers as jwrappers
from ppoc_tpu.models import policy as jpolicy
from ppoc_tpu.ops import pallas_update as jpu
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import score
from ppoc_tpu_torch.envs import host, wrappers
from ppoc_tpu_torch.models import moe, policy
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not jnative.available(), reason="native library unavailable (no g++)")

W_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-7)
M_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfg(**kw):
    base = dict(env="simple", n_envs=16, rollout_len=15, minibatch_size=32,
                fits_per_epoch=2, n_epochs=3, eval_envs=32, eval_len=15,
                hidden=(32, 32), kernel_backend="jnp", seed=0)
    base.update(kw)
    return PPOConfig(**base)


def _jcfg(cfg):
    return JPPOConfig(**dataclasses.asdict(cfg))


def _trainer(cfg, **kw):
    return host.HostTrainer(
        cfg, host.NativeHostVecEnv(cfg.env, cfg.n_envs, seed=0),
        host.NativeHostVecEnv(cfg.env, cfg.eval_envs, seed=99),
        device="cpu", **kw)


def _policy_np(kind, seed=0):
    """(numpy policy params, obs_dim, discrete, moe_topk) drawn by the
    port: a Gaussian [3,16,16,1], a categorical [4,16,16,2], a 4-expert
    top-2 mixture [3,16,16,1]."""
    g = torch.Generator().manual_seed(seed)
    if kind == "gaussian":
        p = policy.init(3, 1, (16, 16), 1.0, False, g, "cpu")
        return conv.tree_to_numpy(p), 3, False, 0
    if kind == "categorical":
        p = policy.init(4, 2, (16, 16), 1.0, True, g, "cpu")
        return conv.tree_to_numpy(p), 4, True, 0
    p = {"mlp": moe.init((3, 16, 16, 1), 4, g, "cpu"),
         "log_std": torch.zeros(1)}
    return conv.tree_to_numpy(p), 3, False, 2


ENGINES = ("pendulum", "cartpole", "simple", "acrobot", "reacher", "recall")


@pytest.mark.parametrize("name", ENGINES)
def test_engine_and_host_env_match_the_jax_native_bits(name):
    """The port's engine (its own copy, built under build/) against
    ppoc_tpu.native: NativeHostVecEnv's reset and 510 autoreset steps on the
    same seeds and actions, every array bit for bit."""
    a, b = (host.NativeHostVecEnv(name, 16, seed=3),
            jhost.NativeHostVecEnv(name, 16, seed=3))
    assert a.spec == envs.make(name).spec
    np.testing.assert_array_equal(a.reset(), b.reset())
    rng = np.random.default_rng(4)
    dones = 0
    for _ in range(510):      # past the longest horizon here (500)
        if a.spec.discrete:
            act = rng.integers(0, a.spec.action_dim, (16, 1)).astype(np.int32)
        else:
            act = rng.uniform(-2, 2, (16, a.spec.action_dim)).astype(
                np.float32)
        got, want = a.step(act), b.step(act)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        dones += int((got[3] | got[4]).sum())
    np.testing.assert_array_equal(a._nat.states, b._nat.states)
    assert dones > 0     # the autoreset ran


def test_native_host_autoreset_semantics():
    venv = host.NativeHostVecEnv("simple", 4, seed=0)
    assert venv.reset().shape == (4, 1)
    for _ in range(5):
        a = np.array([[1.0], [1.0], [0.0], [0.0]], np.float32)
        obs_after, next_obs, rew, term, trunc = venv.step(a)
    assert term[0] and term[1] and not term[2]
    assert next_obs[0, 0] == 5.0          # the true successor, for GAE
    assert obs_after[0, 0] == 0.0         # the autoreset obs, for the policy
    assert venv._nat.steps[0] == 0 and venv._nat.steps[2] == 5


def test_failed_engine_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails raises with its output."""
    from ppoc_tpu_torch import native

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.mark.parametrize("kind", ["gaussian", "categorical", "moe_top2"])
def test_host_policy_and_collect_match_the_jax_bits(kind):
    """HostPolicy's forward and samples (stochastic and deterministic) on
    carried-over params and one numpy seed, then a whole collect_host_np
    window through the native engine with force-truncation, bit for
    bit."""
    params, obs_dim, discrete, topk = _policy_np(kind)
    mine = host.HostPolicy(params, "relu", discrete, moe_topk=topk)
    ref = jhost.HostPolicy(params, "relu", discrete, moe_topk=topk)
    obs = np.random.default_rng(5).standard_normal((32, obs_dim)).astype(
        np.float32)
    np.testing.assert_array_equal(mine.forward(obs), ref.forward(obs))
    for det in (False, True):
        got = mine.sample(obs, np.random.default_rng(6), det)
        want = ref.sample(obs, np.random.default_rng(6), det)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    a, lp = mine.sample(obs, np.random.default_rng(7))
    np.testing.assert_array_equal(mine.log_prob(obs, a), lp)
    name = "cartpole" if discrete else "pendulum"
    cfg = _cfg(env=name)
    got, last = host.collect_host_np(
        cfg, host.NativeHostVecEnv(name, 8, seed=1), mine,
        np.random.default_rng(8), 60)
    want, jlast = jhost.collect_host_np(
        _jcfg(cfg), jhost.NativeHostVecEnv(name, 8, seed=1), ref,
        np.random.default_rng(8), 60)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(last, jlast)
    assert bool((got.terminated[-1] | got.truncated[-1]).all())


@functools.lru_cache(maxsize=None)
def _jax_log_prob(discrete):
    return jax.jit(functools.partial(jpolicy.log_prob, activation="relu",
                                     backend="jnp", discrete=discrete))


@pytest.mark.parametrize("kind", ["gaussian", "categorical"])
def test_device_actor_log_probs_match_jax(kind):
    """The device actor's stored log-probs against the JAX package's
    policy.log_prob of its actions on the same params: within 1e-6 and
    1e-6 of their magnitude (each package sums the trunk in its own
    order); the window force-truncated."""
    params, _, discrete, _ = _policy_np(kind)
    name = "cartpole" if discrete else "pendulum"
    cfg = _cfg(env=name, kernel_backend="pallas")
    traj, _ = host.collect_host(cfg, host.NativeHostVecEnv(name, 8, seed=2),
                                conv.tree_from_numpy(params, "cpu"),
                                torch.Generator().manual_seed(3), 40)
    want = _jax_log_prob(discrete)(params, traj.obs.numpy(),
                                   traj.action.numpy())
    np.testing.assert_allclose(traj.log_prob.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert bool((traj.terminated[-1] | traj.truncated[-1]).all())
    assert traj.action.dtype == (torch.int32 if discrete else torch.float32)


def _streams(rng, n):
    """A stream of observation batches, scales far apart."""
    return [(rng.standard_normal((k, 3)) * [1, 10, 0.01] + [0, -5, 2])
            .astype(np.float32) for k in (1, 7, 13, 100, 879)[:n]]


def test_running_stats_match_jax_bits():
    mine, ref = wrappers.RunningStats(3), jwrappers.RunningStats(3)
    batches = _streams(np.random.default_rng(0), 5)
    x = np.random.default_rng(1).standard_normal((9, 3)).astype(np.float32)
    np.testing.assert_array_equal(mine.normalize(x, 10.0),
                                  ref.normalize(x, 10.0))   # identity, count 0
    for b in batches:
        mine.update(b)
        ref.update(b)
        assert mine.count == ref.count
        np.testing.assert_array_equal(mine.mean, ref.mean)
        np.testing.assert_array_equal(mine.m2, ref.m2)
        np.testing.assert_array_equal(mine.normalize(x, 2.0),
                                      ref.normalize(x, 2.0))
    mine.update(np.zeros((0, 3)))
    assert mine.count == ref.count
    flat = np.concatenate(batches).astype(np.float64)
    np.testing.assert_allclose(mine.variance(), flat.var(axis=0), rtol=1e-9)


def test_obs_and_reward_norm_wrappers_match_jax_bits():
    """RunningRewardNorm around RunningObsNorm around the native engine, in
    both packages, on the same actions: every step's five outputs, the
    statistics and the return accumulator bit for bit; the eval wrapper
    reads the shared statistics without writing."""
    def stack(pkg_host, pkg_wrap):
        inner = pkg_wrap.RunningObsNorm(
            pkg_host.NativeHostVecEnv("pendulum", 6, seed=2), clip=3.0)
        return pkg_wrap.RunningRewardNorm(inner, gamma=0.99), inner

    (mine, m_in), (ref, r_in) = stack(host, wrappers), stack(jhost, jwrappers)
    assert mine.stats is m_in.stats
    np.testing.assert_array_equal(mine.reset(), ref.reset())
    rng = np.random.default_rng(3)
    for _ in range(230):
        a = rng.uniform(-2, 2, (6, 1)).astype(np.float32)
        for x, y in zip(mine.step(a), ref.step(a)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(mine._ret, ref._ret)
    for s, t in ((m_in.stats, r_in.stats), (mine.ret_stats, ref.ret_stats)):
        assert s.count == t.count
        np.testing.assert_array_equal(s.mean, t.mean)
        np.testing.assert_array_equal(s.m2, t.m2)
    ev = wrappers.RunningObsNorm(host.NativeHostVecEnv("pendulum", 3),
                                 stats=m_in.stats, update=False)
    c0 = m_in.stats.count
    ev.reset()
    ev.step(np.zeros((3, 1), np.float32))
    assert m_in.stats.count == c0


class _FakeVenv:
    def __init__(self, n, env="simple"):
        self.n_envs = n
        self.spec = envs.make(env).spec


class _JFakeVenv:
    def __init__(self, n, env="simple"):
        self.n_envs = n
        self.spec = jenvs.make(env).spec


REFUSALS = {
    "n_envs": (dict(), dict(n=8), {}),
    "eval_envs": (dict(), dict(n_eval=8), {}),
    "minibatch": (dict(minibatch_size=1024), dict(), {}),
    "actor": (dict(), dict(), dict(actor="gpu")),
    "overlap": (dict(), dict(), dict(actor="device", overlap=True)),
    "zero1": (dict(zero1=True), dict(), {}),
    "obs_loc": (dict(obs_loc=(0.0,), obs_scale=(1.0,)), dict(), {}),
    "sequence": (dict(rnn_hidden=8), dict(), {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_host_trainer_refusals_carry_the_jax_messages(case):
    kw, sizes, extra = REFUSALS[case]
    cfg = _cfg(**kw)
    n, n_eval = sizes.get("n", cfg.n_envs), sizes.get("n_eval", cfg.eval_envs)
    with pytest.raises(ValueError) as want:
        jhost.HostTrainer(_jcfg(cfg), _JFakeVenv(n), _JFakeVenv(n_eval),
                          **extra)
    with pytest.raises(ValueError) as got:
        host.HostTrainer(cfg, _FakeVenv(n), _FakeVenv(n_eval), device="cpu",
                         **extra)
    assert str(got.value) == str(want.value)


def test_host_trainer_runs_on_the_card_by_default():
    """device=None means CUDA device 0: without CUDA it raises, naming
    device="cpu", before anything is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: device=None takes it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        host.HostTrainer(_cfg(), _FakeVenv(16), _FakeVenv(32))


def test_backend_is_the_configs_and_the_jax_default_is_jnp():
    """F5 (ROADMAP.md §3): the JAX HostTrainer takes backend "jnp" unless
    told, so a "pallas" config runs its learner without the fused phases;
    the port resolves cfg.kernel_backend: under "pallas" the learner takes
    the fused route (K3, K4), an explicit backend wins, a mixture keeps
    its top-k, and save embeds the config as given."""
    cfg = _cfg(env="pendulum", kernel_backend="pallas", n_envs=8,
               rollout_len=32, minibatch_size=64, eval_envs=4, eval_len=200)
    jtr = jhost.HostTrainer(_jcfg(cfg), _JFakeVenv(8, "pendulum"),
                            _JFakeVenv(4, "pendulum"))
    assert jtr.backend == "jnp"
    tr = host.HostTrainer(cfg, _FakeVenv(8, "pendulum"),
                          _FakeVenv(4, "pendulum"), device="cpu")
    assert tr.backend == "pallas"
    assert ppo._fused(tr._learn_cfg, ppo._stab_value_ok(tr._learn_cfg))
    names = [k.kernel.split()[0] for k in
             ppo.kernel_fit(tr._learn_cfg, 232448, tr.env, rollout=False)]
    assert names == ["K5", "K5", "K3", "K4"]
    assert ppo.kernel_fit(tr._learn_cfg, 232448, tr.env)[0].kernel.startswith(
        "K1")
    tr2 = host.HostTrainer(cfg, _FakeVenv(8, "pendulum"),
                           _FakeVenv(4, "pendulum"), backend="jnp",
                           device="cpu")
    assert tr2.backend == "jnp" and tr2.cfg.kernel_backend == "pallas"
    assert not ppo._fused(tr2._learn_cfg, True)
    tr3 = host.HostTrainer(cfg.replace(n_experts=4, moe_topk=2),
                           _FakeVenv(8, "pendulum"), _FakeVenv(4, "pendulum"),
                           device="cpu")
    assert tr3.backend == "moe:2"


@functools.lru_cache(maxsize=None)
def _jax_host_fits():
    """One jitted JAX program for the file: update_step (key 2, "jnp") on
    two host trajectories the port collected (Gaussian pendulum,
    categorical cartpole) from params the port drew, with its row-id
    streams.  Returns {env: (params, traj, streams, (state, metrics))}."""
    out, progs = {}, []
    for name in ("pendulum", "cartpole"):
        cfg = _cfg(env=name, n_envs=8, rollout_len=32, minibatch_size=64,
                   n_epochs_value=2, n_epochs_policy=2, hidden=(16, 16),
                   kernel_backend="pallas", eval_envs=4, eval_len=500)
        tr = _trainer(cfg, actor="host")
        traj = tr._collect()
        jts = conv.train_state_to_numpy(tr.state)
        shape = jax.eval_shape(lambda k: jppo.init_train_state(
            _jcfg(cfg), jenvs.make(name), k), jax.random.PRNGKey(0))
        jts = jax.tree.unflatten(jax.tree.structure(shape), [
            np.asarray(x, w.dtype) for x, w in
            zip(jax.tree.leaves(jts), jax.tree.leaves(shape))])
        out[name] = (cfg, tr, traj, jts)
        progs.append((_jcfg(cfg).replace(kernel_backend="jnp"),
                      jenvs.make(name)))

    def program(states, trajs):
        key = jax.random.PRNGKey(2)
        res = []
        for (jcfg, env), ts, traj in zip(progs, states, trajs):
            streams = tuple(
                jpu._stream_ids(jcfg, k, jcfg.steps_per_fit,
                                jcfg.num_minibatches, jcfg.minibatch_size,
                                n)[0]
                for k, n in zip(jax.random.split(key),
                                (jcfg.n_epochs_value, jcfg.n_epochs_policy)))
            res.append((streams, jppo.update_step(jcfg, env, ts, traj, key,
                                                  backend="jnp")))
        return res

    res = jax.device_get(jax.jit(program)(
        [out[n][3] for n in out],
        [jppo.Transition(*(x.numpy() for x in out[n][2])) for n in out]))
    return {n: out[n] + (r,) for n, r in zip(out, res)}


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_host_fit_update_matches_jax_update_step(name, backend):
    """One host fit's learner (HostTrainer._update's ppo.update_step, K5,
    K2, K3 and K4 or K6 as their plain versions under "pallas") on the
    host actor's window, against the JAX update_step on the same window
    and params with its streams carried across."""
    cfg, tr, traj, _, (streams, (jstate, jm)) = _jax_host_fits()[name]
    draws = ppo.FitDraws(None, *(
        torch.tensor(np.asarray(flat), dtype=torch.int64).reshape(
            n, cfg.num_minibatches, -1)
        for flat, n in zip(streams, (cfg.n_epochs_value,
                                     cfg.n_epochs_policy))))
    lcfg = cfg.replace(kernel_backend=backend)
    assert ppo._fused(lcfg, True) == (backend == "pallas")
    ts, m = ppo.update_step(lcfg, tr.env, tr.state, traj, draws, None)
    got = conv.train_state_to_numpy(ts)
    for part in ("policy_params", "v_params"):
        for a, b in zip(jax.tree.leaves(getattr(got, part)),
                        jax.tree.leaves(getattr(jstate, part))):
            np.testing.assert_allclose(a, b, **W_TOL)
    for part in ("opt_policy", "opt_v", "opt_log_std"):
        g, w = getattr(got, part), getattr(jstate, part)
        assert int(g.t) == int(w.t)
        for a, b in zip(jax.tree.leaves(g.m), jax.tree.leaves(w.m)):
            np.testing.assert_allclose(a, b, **W_TOL)
        for a, b in zip(jax.tree.leaves(g.v), jax.tree.leaves(w.v)):
            np.testing.assert_allclose(a, b, **V_TOL)
    for a, b in zip(m, jm):
        np.testing.assert_allclose(float(a), float(b), **M_TOL)


LEARN_SEEDS = range(8)
LEARN_WINS = 2


@pytest.mark.parametrize("actor,overlap", [("device", False),
                                           ("host", False), ("host", True)])
def test_host_trainer_learns_serial_and_overlapped(actor, overlap):
    """tests/test_host_trainer.py's learning checks (simple, 3 epochs, R >
    0.4) on the port, serial and overlapped.  Which way a `simple` run
    ends turns on its init draw (the port's draws are not the JAX
    package's): over seeds 0-11 on the CPU 7 of 12 learn with either
    actor, 6 of 12 overlapped, so LEARN_WINS of LEARN_SEEDS must (the
    loop stops once they have)."""
    wins, finals = 0, []
    for seed in LEARN_SEEDS:
        tr = _trainer(_cfg(seed=seed), actor=actor, overlap=overlap)
        finals.append(tr.train(log=False)[-1]["R"])
        if overlap:
            assert tr._pending is not None   # a window is always in flight
        wins += finals[-1] > 0.4
        if wins == LEARN_WINS:
            break
    assert wins >= LEARN_WINS, finals


def test_overlap_keeps_the_one_fit_stale_contract(tmp_path):
    """Each window the overlapped loop collects, while the update it
    follows runs, comes from the weights before that update (and is
    consumed by the next one): its stored log-probs are HostPolicy(those
    weights)'s, bit for bit.  The window waits on the host; a load drops
    it."""
    tr = _trainer(_cfg(env="pendulum", n_envs=8, rollout_len=32,
                       minibatch_size=64, eval_envs=4, eval_len=200,
                       kernel_backend="pallas"), actor="host", overlap=True)
    for _ in range(3):
        pre = conv.tree_to_numpy(tr.state.policy_params)
        tr._train_fit_overlapped()
        pend = tr._pending
        assert pend.obs.device.type == "cpu"
        np.testing.assert_array_equal(
            host.HostPolicy(pre, "relu", False).log_prob(
                pend.obs.numpy().reshape(-1, 3),
                pend.action.numpy().reshape(-1, 1)),
            pend.log_prob.numpy().reshape(-1))
    assert not np.array_equal(pre["mlp"][0][0], conv.tree_to_numpy(
        tr.state.policy_params)["mlp"][0][0])
    p = str(tmp_path / "o.bin")
    tr.save(p)
    tr.load(p)
    assert tr._pending is None


def test_deterministic_eval_and_score():
    """evaluate(deterministic=True) serves the mean through HostPolicy
    (its action is the forward, exactly); trainer.score takes a host
    trainer."""
    tr = _trainer(_cfg(n_epochs=1))
    tr.train(log=False)
    pol = tr.host_policy()
    obs = np.array([[0.5], [2.0]], np.float32)
    a, lp = pol.sample(obs, np.random.default_rng(0), deterministic=True)
    np.testing.assert_array_equal(a, pol.forward(obs).astype(np.float32))
    assert np.isfinite(lp).all()
    m = tr.evaluate(deterministic=True)
    assert np.isfinite(m.R) and m.episodes > 0
    s = score(tr, episodes=40)
    assert s["episodes"] >= 40 and np.isfinite(s["R"])


def _jtrainer(cfg, obs_norm=False, reward_norm=False):
    venv = jhost.NativeHostVecEnv(cfg.env, cfg.n_envs, seed=0)
    eval_venv = jhost.NativeHostVecEnv(cfg.env, cfg.eval_envs, seed=99)
    if obs_norm:
        venv = jwrappers.RunningObsNorm(venv, clip=5.0, eps=1e-6)
        eval_venv = jwrappers.RunningObsNorm(eval_venv, stats=venv.stats,
                                             clip=5.0, update=False)
    if reward_norm:
        venv = jwrappers.RunningRewardNorm(venv, gamma=0.99)
    return jhost.HostTrainer(_jcfg(cfg), venv, eval_venv)


def _ptrainer(cfg, obs_norm=False, reward_norm=False, **kw):
    venv = host.NativeHostVecEnv(cfg.env, cfg.n_envs, seed=0)
    eval_venv = host.NativeHostVecEnv(cfg.env, cfg.eval_envs, seed=99)
    if obs_norm:
        venv = wrappers.RunningObsNorm(venv, clip=5.0, eps=1e-6)
        eval_venv = wrappers.RunningObsNorm(eval_venv, stats=venv.stats,
                                            clip=5.0, update=False)
    if reward_norm:
        venv = wrappers.RunningRewardNorm(venv, gamma=0.99)
    return host.HostTrainer(cfg, venv, eval_venv, device="cpu", **kw)


def _same_state(a, b):
    for x, y in zip(jax.tree.leaves(conv.train_state_to_numpy(a)),
                    jax.tree.leaves(jax.device_get(b))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _same_stats(a, b):
    assert a.count == b.count
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.m2, b.m2)


def test_checkpoints_and_sidecars_move_both_ways(tmp_path):
    """A JAX host trainer's file and both sidecars load into the port's
    (params, Adam states, statistics in the train and eval wrappers), and
    the port's into the JAX package's; the port's file resumes its own
    generator; a re-save without normalisation clears the sidecars."""
    cfg = _cfg(n_epochs=1, fits_per_epoch=1)
    jtr = _jtrainer(cfg, obs_norm=True, reward_norm=True)
    jtr.train(log=False)
    p = str(tmp_path / "j.bin")
    jtr.save(p)
    tr = _ptrainer(cfg, obs_norm=True, reward_norm=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the JAX file's draw stream
        tr.load(p)
    _same_state(tr.state, jtr.state)
    _same_stats(tr.venv.stats, jtr.venv.stats)
    _same_stats(tr.venv.ret_stats, jtr.venv.ret_stats)
    assert tr.eval_venv.stats is tr.venv.stats

    tr.train(log=False)
    q = str(tmp_path / "p.bin")
    tr.save(q)
    side = np.load(q + ".obsnorm.npz")
    assert float(side["clip"]) == 5.0 and float(side["eps"]) == 1e-6
    jtr2 = _jtrainer(cfg, obs_norm=True, reward_norm=True)
    jtr2.load(q)
    _same_state(tr.state, jtr2.state)
    _same_stats(jtr2.venv.stats, tr.venv.stats)
    _same_stats(jtr2.venv.ret_stats, tr.venv.ret_stats)

    tr3 = _ptrainer(cfg, obs_norm=True, reward_norm=True)
    tr3.load(q)
    assert torch.equal(tr3.generator.get_state(), tr.generator.get_state())
    _ptrainer(cfg).save(q)
    assert not (tmp_path / "p.bin.obsnorm.npz").exists()
    assert not (tmp_path / "p.bin.retnorm.npz").exists()


def test_load_warns_on_a_missing_or_unused_sidecar(tmp_path):
    cfg = _cfg(n_epochs=1, fits_per_epoch=1)
    p = str(tmp_path / "m.bin")
    _ptrainer(cfg, obs_norm=True).save(p)
    with pytest.warns(UserWarning, match="not norm-wrapped"):
        _ptrainer(cfg).load(p)
    shutil.copy(p, tmp_path / "bare.bin")
    with pytest.warns(UserWarning, match="no obs-norm sidecar"):
        _ptrainer(cfg, obs_norm=True).load(str(tmp_path / "bare.bin"))


def test_periodic_checkpoint_keeps_state_and_generator(tmp_path):
    from ppoc_tpu_torch.utils import checkpoint

    cfg = _cfg(n_envs=8, minibatch_size=16, fits_per_epoch=1, eval_envs=8,
               hidden=(16, 16))
    tr = host.HostTrainer(cfg, host.NativeHostVecEnv("simple", 8, seed=0),
                          host.NativeHostVecEnv("simple", 8, seed=7),
                          device="cpu")
    p = str(tmp_path / "host_ck.bin")
    tr.train(n_epochs=2, log=False, checkpoint_path=p, checkpoint_every=1)
    ck = checkpoint.load(p)
    assert ck.cfg == cfg and ck.meta["epochs_done"] == 2
    assert torch.equal(ck.generator, tr.generator.get_state())
    for a, b in zip(jax.tree.leaves(conv.train_state_to_numpy(tr.state)),
                    jax.tree.leaves(ck.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_new_modules_import_no_jax():
    """Neither jax nor any module of the JAX package is loaded by importing
    this slice's modules and running them: a host fit on the port's engine
    with each actor, a Gymnasium window, a one-lane sweep, the NaN guard
    and a profiler trace."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, tempfile; import ppoc_tpu_torch.envs.host as h, "
        "ppoc_tpu_torch.envs.gym_bridge as g, ppoc_tpu_torch.sweep as s, "
        "ppoc_tpu_torch.native, ppoc_tpu_torch.utils.debug as d, "
        "ppoc_tpu_torch.utils.profiling as p, ppoc_tpu_torch.envs.wrappers "
        "as w; from ppoc_tpu_torch import PPOConfig as C; "
        "c = C(env='pendulum', n_envs=4, rollout_len=16, minibatch_size=32, "
        "eval_envs=2, hidden=(4,), fits_per_epoch=1); "
        "[h.HostTrainer(c, w.RunningObsNorm(h.NativeHostVecEnv('pendulum', "
        "4)), h.NativeHostVecEnv('pendulum', 2), actor=a, overlap=o, "
        "device='cpu').train_fit() for a, o in (('device', 0), "
        "('host', 1))]; "
        "t = g.GymTrainer(c, 'Pendulum-v1', actor='host', device='cpu'); "
        "t._collect(); s.solve_many(c, [0], 1e9, 1, device='cpu'); "
        "ctx = d.nan_guard(); ctx.__enter__(); ctx.__exit__(None, None, "
        "None); "
        "tr = p.trace(tempfile.mkdtemp()); tr.__enter__(); "
        "tr.__exit__(None, None, None); "
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ppoc_tpu' "
        "or m.startswith('ppoc_tpu.')); "
        "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=env, timeout=120)

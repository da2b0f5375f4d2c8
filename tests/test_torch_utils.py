"""The port's profiling and debug utilities (``ppoc_tpu_torch/utils/
profiling.py``, ``utils/debug.py``); mirrors tests/test_utils.py.

``checked`` and ``nan_guard`` on a clean function, on a NaN, and on a
whole ``fit_step`` (clean, then with one NaN injected into a trajectory's
observations, which must raise at the op that first carries it);
``trace`` writes a Chrome trace naming the ops it saw; ``sync`` and the
throughput meter.  The fit runs the "pallas" backend, whose kernels run
their plain versions here.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.utils import debug, profiling

torch.set_num_threads(1)

CFG = PPOConfig(env="pendulum", n_envs=8, rollout_len=16, minibatch_size=32,
                n_epochs_value=2, n_epochs_policy=1, hidden=(16, 16),
                kernel_backend="pallas")


def _fit():
    env = envs.make(CFG.env)
    g = torch.Generator().manual_seed(0)
    ts = ppo.init_train_state(CFG, env, g, "cpu")
    return env, ts, ppo.draw_fit(CFG, g, "cpu", env)


def test_throughput_meter():
    m = profiling.ThroughputMeter()
    x = torch.arange(1000.0)
    with m.section(500, sync_on={"x": [x]}):
        torch.sum(x * 2)
    assert m.total_steps == 500 and m.total_seconds > 0
    assert m.steps_per_second > 0
    rep = m.report()
    assert rep["env_steps"] == 500.0
    assert rep["env_steps_per_s"] == m.steps_per_second


def test_sync_takes_any_tree():
    x = torch.ones(8, 8)
    profiling.sync({"a": x, "b": [x * 2, (x, 3)], "c": None})


def test_checked_clean_function():
    err, out = debug.checked(lambda x: torch.sqrt(x) + 1.0)(
        torch.tensor([4.0, 9.0]))
    err.throw()
    assert err.get() is None
    np.testing.assert_allclose(out.numpy(), [3.0, 4.0])


def test_checked_catches_nan_and_names_the_op():
    err, _ = debug.checked(lambda x: torch.log(x))(torch.tensor([-1.0]))
    assert "log" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()
    # an output leaf that holds one, no op under the check having made it
    err, _ = debug.checked(lambda x: (x, 1))(torch.tensor([float("nan")]))
    assert "output leaf 0" in err.get()


def test_checked_on_fit_step():
    """A whole fit runs clean under the checks."""
    env, ts, draws = _fit()
    err, (ts2, metrics) = debug.checked(
        functools.partial(ppo.fit_step, CFG, env))(ts, draws)
    err.throw()
    assert np.isfinite(float(metrics.value_loss))


def test_nan_guard_on_a_fit_and_an_injected_nan():
    """A fit passes the guard; the same learner on a trajectory with one
    NaN observation raises FloatingPointError, and the guard is off again
    after it."""
    env, ts, draws = _fit()
    with debug.nan_guard():
        ts2, m = ppo.fit_step(CFG, env, ts, draws)
    assert np.isfinite(float(m.value_loss))
    traj, _, vpair = ppo.rollout(CFG, env, ts.policy_params, draws.seed,
                                 CFG.n_envs, CFG.rollout_len,
                                 v_params=ts.v_params)
    obs = traj.obs.clone()
    obs[3, 2, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN or Inf"):
        with debug.nan_guard():
            ppo.update_step(CFG, env, ts, traj._replace(obs=obs), draws, None)
    assert not debug._checking()
    torch.tensor([0.0]) / 0     # no guard: no raise


def test_nan_guard_nests_and_restores():
    with debug.nan_guard():
        assert debug._checking()
        with debug.nan_guard(False):
            assert not debug._checking()
            torch.tensor([0.0]) / 0
        assert debug._checking()
        with pytest.raises(FloatingPointError):
            torch.tensor([1.0]) / 0
    assert not debug._checking()


def test_nan_guard_skips_uninitialised_memory():
    """Allocations a kernel (or a later op) fills, and views of them, are
    not checked: their values are, where written."""
    with debug.nan_guard():
        buf = torch.empty(64, 64)
        buf[3] = torch.ones(64)
        buf.fill_(1.0)
        assert float(buf.sum()) == 64 * 64


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    env, ts, draws = _fit()
    with profiling.trace(d):
        ts2, _ = ppo.fit_step(CFG, env, ts, draws)
        profiling.sync(ts2)
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert len(files) == 1 and files[0].endswith(".json")
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names

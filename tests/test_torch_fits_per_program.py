"""The relief valve ``fits_per_program`` in the port, mirroring
tests/test_fits_per_program.py.

In the JAX package the valve compiles the epoch as chunks of N fits over
the fused epoch's exact key stream: bit-identical training.  The port
runs every fit eagerly, so the valve is a validated no-op: a valved
config trains bit for bit as the unvalved one (every param and all three
Adam states, the epoch metrics exactly), ``validate`` keeps the JAX
package's checks, and ``Trainer.solve`` refuses it as the JAX ``solve``
does.  The committed curriculum checkpoints that set the valves (written
by the JAX package) load.
"""
import functools
import math
import os

import numpy as np
import pytest
import torch

from ppoc_tpu_torch import PPOConfig, serve
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.config import validate
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.utils import params as conv

from test_torch_checkpoint import assert_leaves_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNGS = (512, 1024, 2048, 4096, 8192, 16384)


def _pendulum(**kw):
    return PPOConfig(env="pendulum", n_envs=8, rollout_len=50,
                     minibatch_size=100, fits_per_epoch=4, eval_envs=8,
                     eval_len=200, hidden=(16, 16), seed=3, **kw)


def _epochs(cfg, n=2):
    tr = Trainer(cfg, "cpu")
    metrics = [tuple(float(x) for x in tr.train_epoch()) for _ in range(n)]
    return tr, metrics


@functools.lru_cache(maxsize=None)
def _trained(cfg):
    """Two epochs of ``cfg``, then an evaluation: (the numpy TrainState,
    the epoch metrics, the evaluation), computed once a config."""
    tr, metrics = _epochs(cfg)
    return conv.train_state_to_numpy(tr.state), metrics, tr.evaluate()


@pytest.mark.parametrize("per_program", [2, 4])
@pytest.mark.parametrize("reset_per_fit", [True, False])
def test_chunked_bit_equals_fused(reset_per_fit, per_program):
    """fits_per_program = 2 (two chunks) and 4 (the whole epoch) train two
    epochs bit for bit as the fused epoch: params, the three Adam states,
    the metrics, and the evaluation's draws after them."""
    fused = _trained(_pendulum(reset_per_fit=reset_per_fit))
    chunk = _trained(_pendulum(reset_per_fit=reset_per_fit,
                               fits_per_program=per_program))
    assert_leaves_equal(fused[0], chunk[0])
    assert chunk[1:] == fused[1:]


def test_chunked_attention_trunk():
    """The motivating regime: an attention-trunk epoch at
    fits_per_program=1, bit for bit as the fused one, then evaluated."""
    kw = dict(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
              fits_per_epoch=2, eval_envs=16, eval_len=6, hidden=(16,),
              seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    fused, m_f = _epochs(PPOConfig(**kw), 1)
    chunk, m_c = _epochs(PPOConfig(**kw, fits_per_program=1), 1)
    assert_leaves_equal(fused.state, chunk.state)
    assert m_c == m_f
    assert math.isfinite(chunk.evaluate().R)


def test_validation():
    with pytest.raises(ValueError, match="must divide"):
        Trainer(PPOConfig(env="pendulum", fits_per_epoch=10,
                          fits_per_program=3), "cpu")
    with pytest.raises(ValueError, match="single-device"):
        validate(PPOConfig(env="pendulum", tp_size=2, fits_per_program=1))
    with pytest.raises(ValueError, match="single-device"):
        validate(PPOConfig(env="recall", attn_dim=8, sp_size=2,
                           rollout_len=8, fits_per_program=1))


def test_solve_refuses_the_valve():
    """As ppoc_tpu/algo/trainer.py:970-978: solve() takes no valve and
    names train(stop_at_R=...)."""
    tr = Trainer(_pendulum(fits_per_program=2), "cpu")
    with pytest.raises(ValueError, match=r"train\(stop_at_R=\.\.\.\)"):
        tr.solve(-200.0, 1)


@pytest.mark.parametrize("T", RUNGS)
def test_committed_curriculum_rungs_load(T):
    """Each committed rung of examples/recall_xl_curriculum.py (written by
    the JAX package, the top two with their valves) builds a Trainer and
    an attention policy on the CPU; no fit is run.  The positional table
    is the file's own, T + 1 slots."""
    path = os.path.join(REPO, f"recall_curriculum_{T}_s0.bin")
    tr = Trainer.from_checkpoint(path, "cpu")
    valves = (tr.cfg.fit_dispatch, tr.cfg.rollout_chunk,
              tr.cfg.fits_per_program)
    assert valves == {8192: ("fused", 0, 1),
                      16384: ("phased", 4096, 0)}.get(T, ("fused", 0, 0))
    assert tr.cfg.rollout_len == tr.cfg.eval_len == T
    assert attn.window(tr.state.policy_params["mlp"]) == T + 1
    assert attn.window(tr.state.v_params) == T + 1
    act = serve.load_attention_policy(path, device="cpu")
    cache = act.initial_state(2)
    a, cache = act(np.array([[1.0, 1.0], [-1.0, 1.0]], np.float32), cache)
    assert a.shape == (2, 1) and np.isfinite(np.asarray(a)).all()


def test_cli_resumes_a_valved_file(tmp_path, monkeypatch):
    """The CLI takes a valved config from a file as the JAX CLI does:
    --resume trains on, and --solve-R reaches Trainer.solve's refusal."""
    from ppoc_tpu_torch import cli

    monkeypatch.setenv("PPOC_PLATFORM", "cpu")
    p = str(tmp_path / "v.bin")
    cfg = _pendulum(fits_per_program=2).replace(n_envs=4, rollout_len=16,
                                                minibatch_size=32,
                                                eval_envs=4)
    Trainer(cfg, "cpu").save(p)
    assert cli.main(["--resume", p, "--n-epochs", "1", "--save", p]) == 0
    assert Trainer.from_checkpoint(p, "cpu").cfg.fits_per_program == 2
    with pytest.raises(ValueError, match="relief valves"):
        cli.main(["--resume", p, "--solve-R", "-200"])


def test_host_trainer_takes_the_valve():
    """As the JAX host trainer, HostTrainer takes fits_per_program (its
    epoch is fits_per_epoch host fits either way)."""
    from ppoc_tpu_torch.envs.host import HostTrainer, NativeHostVecEnv

    cfg = _pendulum(fits_per_program=2).replace(n_envs=4, rollout_len=16,
                                                minibatch_size=32,
                                                eval_envs=4)
    tr = HostTrainer(cfg, NativeHostVecEnv("pendulum", 4),
                     NativeHostVecEnv("pendulum", 4, seed=1), device="cpu")
    m = tr.train_epoch()
    assert math.isfinite(float(m.value_loss))
    assert tr.state.opt_v.t == 4 * cfg.n_epochs_value * cfg.num_minibatches

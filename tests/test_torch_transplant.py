"""Port parity for the critic->policy encoder transplant
(``Trainer.transplant_value_trunk``, cfg.transplant_patience): mirrors
tests/test_transplant.py.  The transplant is held to the JAX package's
method applied to the same state (leaf for leaf, exactly: it copies
leaves and zeroes moments); the plateau trigger to the JAX package's rule
on a flat eval stream; the CLI's --jsonl rows carry the mark.
"""
import json

import jax
import numpy as np
import pytest
import torch

from ppoc_tpu.algo.trainer import Trainer as JTrainer
from ppoc_tpu_torch import PPOConfig, cli, config as config_mod
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

TRUNKS = {"attn": dict(attn_dim=8, attn_layers=1, attn_heads=2),
          "gru": dict(rnn_hidden=8),
          "lstm": dict(rnn_hidden=8, rnn_cell="lstm"),
          "attn_aux": dict(attn_dim=8, attn_layers=1, attn_heads=2,
                           aux_value_coeff=0.5)}


def _cfg(trunk="attn", **kw):
    base = dict(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
                fits_per_epoch=1, eval_envs=16, eval_len=6, hidden=(16,),
                seed=0, **TRUNKS[trunk])
    base.update(kw)
    return PPOConfig(**base)


def _eq(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


class _JaxHolder:
    """What the JAX package's transplant_value_trunk reads and writes: the
    trainer's state."""

    def __init__(self, state):
        self.state = state


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_method_matches_jax(trunk):
    """After an epoch, the transplant copies the critic's encoder (attn or
    cell) into the policy bit for bit, keeps the action head, the aux head
    and log_std, and restarts the policy Adam (t 0, zero moments): the JAX
    package's transplant on the same state, leaf for leaf.  Training goes
    on afterwards."""
    tr = Trainer(_cfg(trunk), "cpu")
    tr.train_epoch()
    before = conv.train_state_to_numpy(tr.state)
    part = "cell" if "rnn_hidden" in TRUNKS[trunk] else "attn"
    assert not _eq(before.policy_params["mlp"][part], before.v_params[part])
    tr.transplant_value_trunk()
    got = conv.train_state_to_numpy(tr.state)
    jh = _JaxHolder(jax.tree.map(np.asarray, before))
    JTrainer.transplant_value_trunk(jh)
    assert _eq(got, jh.state)
    pol = got.policy_params
    assert _eq(pol["mlp"][part], got.v_params[part])
    assert _eq(pol["mlp"]["head"], before.policy_params["mlp"]["head"])
    assert _eq(pol["log_std"], before.policy_params["log_std"])
    assert ("aux_head" in pol["mlp"]) == (trunk == "attn_aux")
    if trunk == "attn_aux":
        assert _eq(pol["mlp"]["aux_head"],
                   before.policy_params["mlp"]["aux_head"])
    assert tr.state.opt_policy.t == 0
    assert not any(np.any(x) for x in jax.tree.leaves(got.opt_policy.m))
    assert _eq(got.opt_log_std, before.opt_log_std)
    # a copy, not an alias: training the policy leaves the critic's alone
    assert tr.state.policy_params["mlp"][part] is not tr.state.v_params[part]
    tr.train_epoch()
    assert np.isfinite(tr.evaluate().R)


def test_method_dense_raises():
    tr = Trainer(PPOConfig(env="pendulum", n_envs=8, rollout_len=50,
                           minibatch_size=100, eval_envs=8, eval_len=200,
                           hidden=(16, 16)), "cpu")
    with pytest.raises(ValueError, match="sequence trunk"):
        tr.transplant_value_trunk()


def _flat_eval(monkeypatch):
    monkeypatch.setattr(
        Trainer, "evaluate",
        lambda self, deterministic=False: ppo.EvalMetrics(
            J=0.1, R=0.5, episodes=16))


@pytest.mark.parametrize("trunk", ["attn", "gru"])
def test_auto_trigger_on_plateau(trunk, monkeypatch):
    """A flat eval-R stream fires the one-time transplant after exactly
    ``patience`` epochs without a +0.05 gain (the first epoch sets the
    best), and marks that epoch's row, as the JAX package's train does."""
    tr = Trainer(_cfg(trunk, transplant_patience=3), "cpu")
    fired = []
    orig = Trainer.transplant_value_trunk
    monkeypatch.setattr(Trainer, "transplant_value_trunk",
                        lambda self: (fired.append(True), orig(self))[1])
    _flat_eval(monkeypatch)
    hist = tr.train(n_epochs=6, log=False)
    assert len(fired) == 1
    assert [i for i, r in enumerate(hist) if r.get("transplanted")] == [3]


def test_rising_return_never_fires(monkeypatch):
    """An eval R that gains at least 0.05 every epoch keeps resetting the
    count."""
    tr = Trainer(_cfg("gru", transplant_patience=1), "cpu")
    rs = iter(np.arange(0.0, 1.0, 0.1))
    monkeypatch.setattr(
        Trainer, "evaluate",
        lambda self, deterministic=False: ppo.EvalMetrics(
            J=0.0, R=float(next(rs)), episodes=16))
    hist = tr.train(n_epochs=4, log=False)
    assert not any(r.get("transplanted") for r in hist)


def test_cli_jsonl_rows_carry_the_mark(monkeypatch, capsys):
    """``python -m ppoc_tpu_torch --transplant-patience 1 --jsonl``: the
    epoch whose plateau fired the transplant says so in its JSON row."""
    monkeypatch.setenv("PPOC_PLATFORM", "cpu")
    _flat_eval(monkeypatch)
    argv = ["--env", "recall", "--n-envs", "8", "--rollout-len", "6",
            "--minibatch-size", "48", "--fits-per-epoch", "1", "--hidden",
            "8", "--rnn-hidden", "4", "--eval-len", "6", "--n-epochs", "3",
            "--transplant-patience", "1", "--jsonl"]
    assert cli.main(argv) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r.get("transplanted", False) for r in rows] == [False, True,
                                                            False]


def test_validation():
    with pytest.raises(ValueError, match="sequence trunk"):
        config_mod.validate(PPOConfig(env="pendulum", transplant_patience=5))
    with pytest.raises(ValueError, match="zero1"):
        config_mod.validate(_cfg(transplant_patience=5, zero1=True))

"""The relief valves ``fit_dispatch="phased"`` and ``rollout_chunk`` in the
port, mirroring tests/test_fit_dispatch.py.

In the JAX package "phased" compiles a sequence-trunk fit's four stages as
separate programs over the fused fit's key stream, and ``rollout_chunk``
runs the decode rollout as segments of one compiled program with the same
per-step keys as the monolithic scan.  The port runs every fit eagerly,
stage by stage and decode step by decode step, so both are validated
no-ops: a valved config trains and evaluates bit for bit as the unvalved
one (every param and all three Adam states), on an attention trunk and on
a GRU.  The valved attention rollout is held to the JAX package's
segmented decode on the same params and draws, as
``test_torch_recurrent.py::test_rollout_rnn_matches_jax`` holds the
monolithic one (class ids and done flags exactly, float planes rtol 1e-4
/ atol 1e-5).
"""
import dataclasses

import jax
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, Trainer as JTrainer
from ppoc_tpu import config as jconfig
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import recurrent
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.config import validate

from test_torch_checkpoint import assert_leaves_equal
from test_torch_recurrent import _jts, _port, _traj_close, jax_seq_draws

torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
                fits_per_epoch=3, eval_envs=16, eval_len=6, hidden=(16,),
                seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    base.update(kw)
    return PPOConfig(**base)


def _run(cfg):
    """An epoch, then a stochastic and a mean-policy evaluation."""
    tr = Trainer(cfg, "cpu")
    m = tuple(float(x) for x in tr.train_epoch())
    return tr, m, tr.evaluate(), tr.evaluate(deterministic=True)


GRU = dict(attn_dim=0, rnn_hidden=8)


@pytest.mark.parametrize("valves", [
    pytest.param(dict(fit_dispatch="phased"), id="phased"),
    pytest.param(dict(fit_dispatch="phased", rollout_chunk=2),
                 id="phased-chunk2"),
    pytest.param(dict(fit_dispatch="phased", aux_value_coeff=1.0),
                 id="phased-aux"),
    pytest.param(dict(GRU, fit_dispatch="phased"), id="gru-phased"),
    pytest.param(dict(GRU, fit_dispatch="phased", rollout_chunk=3),
                 id="gru-phased-chunk3")])
def test_valved_fit_bit_equals_fused(valves):
    """The valved trainer's epoch, its metrics and both evaluations equal
    the fused trainer's bit for bit."""
    plain = {k: v for k, v in valves.items()
             if k not in ("fit_dispatch", "rollout_chunk")}
    fused = _run(_cfg(**plain))
    valved = _run(_cfg(**valves))
    assert valved[0].cfg.fit_dispatch == "phased"
    assert_leaves_equal(fused[0].state, valved[0].state)
    assert valved[1:] == fused[1:]


def test_rollout_chunk_matches_jax_segmented_decode():
    """The port's rollout under a valved config (phased, rollout_chunk 4)
    against the JAX Trainer's segmented decode (``_chunked_rollout``: 3
    dispatches of the compiled 4-step segment) on the same params and the
    draws of its per-step keys."""
    jcfg, jts, ts = _jts("recall", seed=1)
    jcfg = dataclasses.replace(jcfg, fit_dispatch="phased", rollout_chunk=4)
    jtr = JTrainer(jcfg)
    key = jax.random.PRNGKey(7)
    want = jtr._chunked_rollout(jts.policy_params, key, 8, 12,
                                deterministic=False, force_truncate=True)
    got, (_, _, cache) = recurrent.rollout_rnn(
        _port(jcfg), envs.make("recall"), ts.policy_params,
        jax_seq_draws("recall", 8, 12, key))
    _traj_close(got, want)
    assert cache["t"] == 12


def test_solve_refuses_the_valves():
    """As ppoc_tpu/algo/trainer.py:970-978."""
    for valves in (dict(fit_dispatch="phased"),
                   dict(fit_dispatch="phased", rollout_chunk=2)):
        with pytest.raises(ValueError, match="relief valves"):
            Trainer(_cfg(**valves), "cpu").solve(0.9, 1)


def test_rollout_chunk_validation():
    with pytest.raises(ValueError, match="phased"):
        validate(_cfg(rollout_chunk=2))
    with pytest.raises(ValueError, match="divide"):
        validate(_cfg(fit_dispatch="phased", rollout_chunk=4))
    # rollout_chunk must divide eval_len as well as rollout_len
    with pytest.raises(ValueError, match="divide"):
        validate(_cfg(fit_dispatch="phased", rollout_chunk=3,
                      eval_len=8))


def test_validation():
    with pytest.raises(ValueError, match="SEQUENCE-trunk"):
        validate(PPOConfig(env="pendulum", fit_dispatch="phased"))
    with pytest.raises(ValueError, match="fused.*phased|phased.*fused"):
        validate(PPOConfig(env="pendulum", fit_dispatch="bogus"))
    with pytest.raises(ValueError, match="fits_per_program"):
        validate(_cfg(fit_dispatch="phased", fits_per_program=1))
    with pytest.raises(ValueError, match="single-device"):
        validate(_cfg(fit_dispatch="phased", sp_size=2, rollout_len=8))
    # accepted, as the JAX package's validate accepts them
    for kw in (dict(fit_dispatch="phased", rollout_chunk=2),
               dict(GRU, fit_dispatch="phased")):
        validate(_cfg(**kw))
        jconfig.validate(JPPOConfig(**dataclasses.asdict(_cfg(**kw))))

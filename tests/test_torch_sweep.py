"""Port parity for the sweeps (``ppoc_tpu_torch/sweep.py``); mirrors
tests/test_sweep.py.

The port runs a sweep's lanes one after another, each as the Trainer of
its config, so a one-lane ``solve_many`` is ``Trainer.solve`` exactly
(epochs, R, every leaf), and ``train_many`` each lane's epochs and
evaluations.  The grid's lanes are the JAX package's ``_expand_grid``
(names, values, seeds, combos) exactly, and every ``_validate`` refusal
carries the JAX message.  Nothing here compiles a JAX program.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JPPOConfig, sweep as jsweep
from ppoc_tpu_torch import PPOConfig, sweep
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.ops import adam

torch.set_num_threads(1)

CFG = PPOConfig(env="pendulum", n_envs=8, rollout_len=32, minibatch_size=64,
                fits_per_epoch=2, n_epochs_value=2, n_epochs_policy=2,
                eval_envs=4, eval_len=200, hidden=(16, 16),
                kernel_backend="pallas")


def _leaves(ts):
    return adam.tree_leaves(tuple(ts))


def test_single_seed_sweep_is_trainer_solve():
    """Lane 0 of solve_many and Trainer(cfg).solve: the same epochs, the
    same R and the same state, bit for bit (R -1e9 never reached: the
    whole max_epochs run)."""
    cfg = CFG.replace(seed=3)
    out = sweep.solve_many(cfg, [3], target_R=1e9, max_epochs=2,
                           device="cpu")
    tr = Trainer(cfg, "cpu")
    res = tr.solve(1e9, max_epochs=2)
    assert out["epochs"] == [res["epochs"]] == [2]
    assert out["R"] == [res["R"]]
    for a, b in zip(_leaves(out["states"]), _leaves(tr.state)):
        assert torch.equal(torch.as_tensor(a)[0], torch.as_tensor(b))


def test_train_many_is_each_lanes_trainer():
    out = sweep.train_many(CFG, seeds=[0, 1], n_epochs=2, device="cpu")
    assert out["R"].shape == out["J"].shape == out["entropy"].shape == (2, 2)
    assert out["R"].dtype == np.float32
    for lane, seed in enumerate((0, 1)):
        tr = Trainer(CFG.replace(seed=seed), "cpu")
        for epoch in range(2):
            ent = float(tr.train_epoch().entropy)
            ev = tr.evaluate()
            assert out["R"][lane, epoch] == np.float32(ev.R)
            assert out["J"][lane, epoch] == np.float32(ev.J)
            assert out["entropy"][lane, epoch] == np.float32(ent)
    ls = out["states"].policy_params["log_std"]
    steps = 2 * CFG.fits_per_epoch * CFG.n_epochs_value * CFG.num_minibatches
    assert ls.shape == (2, 1)
    assert out["states"].opt_v.t.tolist() == [steps, steps]
    assert not torch.equal(out["states"].v_params[0][0][0],
                           out["states"].v_params[0][0][1])


@pytest.mark.parametrize("axes,seeds", [
    ({"lr_policy": [1e-3, 3e-4]}, [0]),
    ({"lr_policy": [1e-3, 3e-4], "clip_eps": [0.1, 0.2, 0.3]}, [0, 5]),
    ({"init_std": [0.5, 1.0], "adam_eps": [1e-8], "lam": [0.9, 0.95]},
     [2, 1, 0]),
])
def test_expand_grid_matches_jax(axes, seeds):
    got = sweep._expand_grid(axes, seeds)
    want = jsweep._expand_grid(axes, seeds)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    for n in want[0]:
        np.testing.assert_array_equal(got[1][n], np.asarray(want[1][n]))
        assert got[1][n].dtype == np.float32


GRID_BAD = [({"minibatch_size": [32, 64]}, [0]), ({}, [0]),
            ({"lr_policy": []}, [0])]


@pytest.mark.parametrize("axes,seeds", GRID_BAD)
def test_expand_grid_refusals_match_jax(axes, seeds):
    with pytest.raises(ValueError) as want:
        jsweep._expand_grid(axes, seeds)
    with pytest.raises(ValueError) as got:
        sweep._expand_grid(axes, seeds)
    assert str(got.value) == str(want.value)


VALIDATE_BAD = {
    "no seed": (dict(), []),
    "zero minibatches": (dict(minibatch_size=10_000), [0]),
    "tp_size": (dict(tp_size=2), [0]),
    "sp_size": (dict(sp_size=2), [0]),
    "zero1": (dict(zero1=True), [0]),
    "transplant": (dict(transplant_patience=3, rnn_hidden=4), [0]),
    "phased": (dict(fit_dispatch="phased"), [0]),
    "fits_per_program": (dict(fits_per_program=1), [0]),
    "reset_per_fit": (dict(rnn_hidden=4, reset_per_fit=False), [0]),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_BAD))
def test_validate_messages_match_jax(case):
    kw, seeds = VALIDATE_BAD[case]
    cfg = CFG.replace(**kw)
    with pytest.raises(ValueError) as want:
        jsweep._validate(JPPOConfig(**dataclasses.asdict(cfg)), seeds)
    with pytest.raises(ValueError) as got:
        sweep._validate(cfg, seeds)
    assert str(got.value) == str(want.value)


def test_grid_entries_validate_before_running():
    with pytest.raises(ValueError, match="not grid-sweepable"):
        sweep.train_grid(CFG, {"minibatch_size": [32, 64]}, seeds=[0],
                         n_epochs=1, device="cpu")
    with pytest.raises(ValueError, match="at least one seed"):
        sweep.solve_grid(CFG, {"lr_policy": [1e-4]}, target_R=0.8, seeds=[],
                         device="cpu")


def test_solve_grid_lanes_and_best():
    """Each lane is the Trainer of cfg with the lane's seed and values
    (init_std reaches the init); 'best' is the fewest epochs, then the
    highest R; the states stack the lanes."""
    out = sweep.solve_grid(CFG, {"init_std": [0.5, 1.0]}, target_R=-1e9,
                           seeds=[0, 1], max_epochs=1, device="cpu")
    assert [c["seed"] for c in out["combos"]] == [0, 1, 0, 1]
    assert out["epochs"] == [1, 1, 1, 1]
    rs = out["R"]
    assert out["best"] == max(range(4), key=lambda i: (rs[i], -i))
    ls = out["states"].policy_params["log_std"]
    assert ls.shape == (4, 1)
    tr = Trainer(CFG.replace(seed=1, init_std=0.5), "cpu")
    tr.solve(-1e9, 1)
    for a, b in zip(_leaves(out["states"]), _leaves(tr.state)):
        assert torch.equal(torch.as_tensor(a)[1], torch.as_tensor(b))
    curves = sweep.train_grid(CFG, {"lr_policy": [1e-3]}, seeds=[0],
                              n_epochs=1, device="cpu")
    assert curves["R"].shape == (1, 1) and curves["combos"] == [
        {"lr_policy": 1e-3, "seed": 0}]


def test_sweep_respects_affine():
    """tests/test_obsnorm.py's sweep case: a lane builds its env through
    envs.make_for, so a one-seed train_many of an affine config is the
    Trainer's first epoch and evaluation exactly."""
    cfg = PPOConfig(env="simple", n_envs=8, rollout_len=15,
                    minibatch_size=32, fits_per_epoch=1, eval_envs=8,
                    eval_len=15, hidden=(16,), kernel_backend="jnp",
                    obs_loc=(2.0,), obs_scale=(3.0,))
    out = sweep.train_many(cfg, seeds=[0], n_epochs=1, device="cpu")
    tr = Trainer(cfg, "cpu")
    assert tr.env.spec.name == "simple#affine"
    tr.train_epoch()
    assert np.isfinite(out["R"]).all()
    assert out["R"][0, 0] == np.float32(tr.evaluate().R)

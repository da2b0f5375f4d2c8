"""Seed and hyperparameter sweeps (counterpart of ``ppoc_tpu/sweep.py``).

The API of the JAX module: :func:`solve_many` / :func:`train_many` over
seeds, :func:`solve_grid` / :func:`train_grid` over the cartesian product
of :data:`SWEEPABLE_HPARAMS` axes and seeds, with its validation and
messages and its return keys; ``states`` is every lane's TrainState
stacked leaf by leaf on a leading lane dimension.

The lanes run one after another, each on the Trainer's own path and
backend: lane (seed s, hyperparameters h) is ``Trainer(cfg.replace(seed=s,
**h))``, its generator threading and all, so a one-lane ``solve_many`` is
``Trainer.solve`` epochs and R bit for bit, and on the card every lane
launches the path's kernels (K1-K4 for ``bench_config``).  The JAX module
runs its lanes as one vmapped program on "jnp", since its Pallas kernels
do not batch under vmap; a lane loop has no such limit, but it also does
not give the JAX module's point: S lanes in one program, costing less
than S runs (a lane dimension through the kernels, or
``torch.func.vmap`` over the plain path, is ROADMAP.md's open item).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ppoc_tpu_torch import config
from ppoc_tpu_torch.config import PPOConfig

#: Hyperparameters that may vary across the lanes of one grid sweep: the
#: JAX module's set, those that enter its program only through arithmetic
SWEEPABLE_HPARAMS = (
    "lr_policy", "lr_v", "clip_eps", "ent_coeff", "lam",
    "adam_beta1", "adam_beta2", "adam_eps", "init_std",
)


def _validate(cfg: PPOConfig, seeds: Sequence[int]) -> None:
    """The Trainer's config checks (``config.validate``) plus the JAX
    module's own constraints on a sweep, with its messages."""
    if not len(seeds):
        raise ValueError("sweep needs at least one seed")
    config.validate(cfg)
    if cfg.tp_size > 1 or cfg.pp_size > 1 or cfg.ep_size > 1 \
            or cfg.sp_size > 1:
        raise ValueError(
            "sweeps are single-device vmapped programs; tp_size/pp_size/"
            "ep_size/sp_size must be 1")
    if cfg.zero1:
        raise ValueError(
            "zero1 shards optimizer state over a mesh; sweeps are "
            "single-device vmapped programs")
    if cfg.transplant_patience:
        raise ValueError(
            "transplant_patience is a Trainer.train host-loop intervention "
            "(critic->policy encoder transplant on plateau); the sweep's "
            "whole-run vmapped programs cannot perform it — it would be "
            "silently inert here, misreporting trap rates")
    if cfg.fit_dispatch != "fused" or cfg.fits_per_program \
            or cfg.rollout_chunk:
        raise ValueError(
            "sweeps compile whole training runs as single fused programs; "
            "the fit_dispatch/fits_per_program/rollout_chunk chunked "
            "dispatch modes do not apply (and their extreme-window target "
            "regime is beyond a vmapped multi-seed program anyway)")


def _expand_grid(axes: Dict[str, Sequence[float]], seeds: Sequence[int]
                 ) -> Tuple[Tuple[str, ...], Dict[str, np.ndarray],
                            List[int], List[Dict[str, Any]]]:
    """The cartesian product of the hyperparameter axes and the seeds as
    flat lanes: (names, {name: [G] float32 array}, [G] seeds, [G] combo
    dicts), in the JAX module's order."""
    if not axes:
        raise ValueError("grid sweep needs at least one hyperparameter axis")
    names = tuple(sorted(axes))
    for n in names:
        if n not in SWEEPABLE_HPARAMS:
            raise ValueError(
                f"{n!r} is not grid-sweepable; lanes of one compiled program "
                f"can only vary {SWEEPABLE_HPARAMS} (schedule/gating/mesh "
                f"fields shape the program itself — run those as separate "
                f"configs)")
        if not len(axes[n]):
            raise ValueError(f"grid axis {n!r} is empty")
    combos: List[Dict[str, Any]] = []
    for values in itertools.product(*(axes[n] for n in names)):
        for s in seeds:
            combos.append(dict(zip(names, map(float, values)), seed=int(s)))
    hp = {n: np.asarray([c[n] for c in combos], np.float32) for n in names}
    return names, hp, [c["seed"] for c in combos], combos


def _stack(trees):
    """Lane trees stacked leaf by leaf on a new leading dimension
    (NamedTuples, dicts, lists and tuples kept; an Adam timestep becomes an
    int64 tensor)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stack([t[k] for t in trees]) for k in head}
    if isinstance(head, tuple) and hasattr(head, "_fields"):
        return type(head)(*(_stack(list(x)) for x in zip(*trees)))
    if isinstance(head, (list, tuple)):
        out = [_stack(list(x)) for x in zip(*trees)]
        return out if isinstance(head, list) else tuple(out)
    return torch.stack([torch.as_tensor(t) for t in trees])


def _lanes(cfg: PPOConfig, combos: List[Dict[str, Any]], device):
    """One Trainer a lane, built as its turn comes: cfg with the lane's
    seed and hyperparameters."""
    from ppoc_tpu_torch.algo.trainer import Trainer

    return (Trainer(cfg.replace(**c), device) for c in combos)


def _solve(cfg, combos, target_R, max_epochs, device):
    epochs, rs, states = [], [], []
    for tr in _lanes(cfg, combos, device):
        res = tr.solve(target_R, max_epochs)
        epochs.append(int(res["epochs"]))
        rs.append(float(res["R"]))
        states.append(tr.state)
    return epochs, rs, _stack(states)


def _train(cfg, combos, n_epochs, device):
    R, J, ent, states = [], [], [], []
    for tr in _lanes(cfg, combos, device):
        curve = []
        for _ in range(n_epochs):
            m = tr.train_epoch()
            ev = tr.evaluate()
            curve.append((ev.R, ev.J, float(m.entropy)))
        R.append([c[0] for c in curve])
        J.append([c[1] for c in curve])
        ent.append([c[2] for c in curve])
        states.append(tr.state)

    def arr(x):
        return np.asarray(x, np.float32).reshape(len(combos), n_epochs)

    return arr(R), arr(J), arr(ent), _stack(states)


def solve_many(cfg: PPOConfig, seeds: Sequence[int], target_R: float,
               max_epochs: int = 100, device=None) -> Dict[str, Any]:
    """Train every seed until its stochastic eval R >= ``target_R`` (at
    most ``max_epochs``), each as ``Trainer.solve``.  Returns {"epochs":
    [S], "R": [S], "states": stacked TrainState}."""
    _validate(cfg, seeds)
    epochs, rs, states = _solve(cfg, [{"seed": int(s)} for s in seeds],
                                target_R, max_epochs, device)
    return {"epochs": epochs, "R": rs, "states": states}


def train_many(cfg: PPOConfig, seeds: Sequence[int],
               n_epochs: Optional[int] = None, device=None
               ) -> Dict[str, Any]:
    """A fixed schedule for every seed: per epoch a training epoch, then a
    stochastic evaluation.  Returns {"R", "J", "entropy": [S, n_epochs]
    float32 arrays, "states": stacked TrainState}."""
    n_epochs = cfg.n_epochs if n_epochs is None else n_epochs
    _validate(cfg, seeds)
    R, J, ent, states = _train(cfg, [{"seed": int(s)} for s in seeds],
                               n_epochs, device)
    return {"R": R, "J": J, "entropy": ent, "states": states}


def solve_grid(cfg: PPOConfig, axes: Dict[str, Sequence[float]],
               target_R: float, seeds: Sequence[int] = (0,),
               max_epochs: int = 100, device=None) -> Dict[str, Any]:
    """A hyperparameter grid: every combination of the ``axes`` values
    (SWEEPABLE_HPARAMS names) crossed with ``seeds``, each lane solved as
    ``Trainer(cfg.replace(seed=s, **h)).solve``.  Returns {"combos": [G]
    {name: value, "seed": s}, "epochs": [G], "R": [G], "states": stacked
    TrainState, "best": the lane with the fewest epochs (ties: highest
    R)}."""
    _validate(cfg, seeds)
    _, _, _, combos = _expand_grid(axes, seeds)
    epochs, rs, states = _solve(cfg, combos, target_R, max_epochs, device)
    best = min(range(len(combos)), key=lambda i: (epochs[i], -rs[i]))
    return {"combos": combos, "epochs": epochs, "R": rs, "states": states,
            "best": best}


def train_grid(cfg: PPOConfig, axes: Dict[str, Sequence[float]],
               seeds: Sequence[int] = (0,), n_epochs: Optional[int] = None,
               device=None) -> Dict[str, Any]:
    """The fixed-schedule grid (:func:`train_many` over the lanes of
    :func:`solve_grid`).  Returns {"combos": [G], "R", "J", "entropy": [G,
    n_epochs], "states": stacked TrainState}."""
    n_epochs = cfg.n_epochs if n_epochs is None else n_epochs
    _validate(cfg, seeds)
    _, _, _, combos = _expand_grid(axes, seeds)
    R, J, ent, states = _train(cfg, combos, n_epochs, device)
    return {"combos": combos, "R": R, "J": J, "entropy": ent,
            "states": states}

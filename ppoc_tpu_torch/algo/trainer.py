"""Training driver: epoch loop, evaluation, the per-epoch metrics line.

Counterpart of ``ppoc_tpu/algo/trainer.py`` for one device.  The trainer
owns one ``torch.Generator`` (seeded from cfg.seed) in place of the JAX
package's key; every fit and evaluation draws its seed words and row-id
streams from it.  ``solve`` is a host loop over epochs plus evaluation
(``ppo.train_until``), where the JAX package compiles that loop into one
``while_loop``.  The trainer runs on CUDA device 0 unless it is given
another device (the CPU tests pass ``device="cpu"``).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from ppoc_tpu_torch import envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.config import PPOConfig, validate
from ppoc_tpu_torch.ops import resolve_backend


class EvalWindowWarning(UserWarning):
    """cfg.eval_len < env horizon: evaluation counts only episodes that
    COMPLETE inside the window, so long episodes are censored."""


# PPOConfig fields whose non-default settings select parts of the JAX
# package that are not ported yet, with the value that is supported.
_NOT_PORTED = {
    "n_experts": 1, "moe_topk": 0, "moe_aux_coeff": 0.0, "rnn_hidden": 0,
    "attn_dim": 0, "tp_size": 1, "pp_size": 1, "ep_size": 1, "sp_size": 1,
    "zero1": False, "max_grad_norm": 0.0, "target_kl": 0.0,
    "lr_anneal": False, "clip_value": 0.0, "ent_anneal": False,
    "transplant_patience": 0, "aux_value_coeff": 0.0,
    "fit_dispatch": "fused", "rollout_chunk": 0, "fits_per_program": 0,
}


def check_ported(cfg: PPOConfig) -> None:
    """Raise NotImplementedError for a config that needs an unported part."""
    bad = {k: getattr(cfg, k) for k, ok in _NOT_PORTED.items()
           if getattr(cfg, k) != ok}
    if bad:
        raise NotImplementedError(
            f"not ported to ppoc_tpu_torch yet: {bad} (see ROADMAP.md)")


def resolve_device(device=None) -> torch.device:
    """``device=None`` means CUDA device 0; without CUDA that raises rather
    than run on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA device 0 by default, and CUDA is not "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def score(trainer, episodes: int = 100, deterministic: bool = True,
          max_rounds: int = 1000) -> Dict[str, float]:
    """Evaluation over at least ``episodes`` COMPLETED episodes: repeat
    ``trainer.evaluate`` rounds, weighting each round's mean J/R by its
    episode count (``ppoc_tpu/algo/trainer.py`` ``score``).  Returns {"J",
    "R", "episodes", "rounds"}."""
    tot_j = tot_r = tot_n = 0.0
    rounds = zero_rounds = 0
    while tot_n < episodes and rounds < max_rounds:
        m = trainer.evaluate(deterministic=deterministic)
        rounds += 1
        if m.episodes > 0:
            tot_j += m.J * m.episodes
            tot_r += m.R * m.episodes
            tot_n += m.episodes
        else:
            zero_rounds += 1
            # eval_len < horizon completes no episode, every round alike
            if zero_rounds >= 3 and tot_n == 0:
                break
    if tot_n == 0:
        raise RuntimeError(
            f"no episode completed in {rounds} evaluation rounds; is "
            f"eval_len >= the env horizon?")
    return {"J": tot_j / tot_n, "R": tot_r / tot_n,
            "episodes": int(tot_n), "rounds": rounds}


class Trainer:
    def __init__(self, cfg: PPOConfig, device=None):
        validate(cfg)
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.env = envs.make_for(cfg)
        resolve_backend(cfg.kernel_backend)   # refuses "jnp": not ported
        self.generator = torch.Generator().manual_seed(cfg.seed)
        if cfg.eval_len < self.env.spec.horizon:
            warnings.warn(
                f"eval_len ({cfg.eval_len}) < env horizon "
                f"({self.env.spec.horizon}): evaluation counts only episodes "
                f"that COMPLETE within the window, so long episodes are "
                f"censored; set eval_len >= the horizon for unbiased R/J",
                EvalWindowWarning, stacklevel=2)
        self.state = ppo.init_train_state(cfg, self.env, self.generator,
                                          self.device)

    def evaluate(self, deterministic: bool = False) -> ppo.EvalMetrics:
        """Stochastic eval by default (one K1 launch);
        ``deterministic=True`` rolls out the policy mean, the mean-policy
        protocol, through the env loop.  Returns Python floats."""
        draws = ppo.draw_eval(self.cfg, self.env, self.generator,
                              self.device, deterministic)
        m = ppo.evaluate(self.cfg, self.env, self.state.policy_params, draws,
                         deterministic=deterministic)
        return ppo.EvalMetrics(*(float(x) for x in m))

    def train_epoch(self) -> ppo.FitMetrics:
        self.state, metrics = ppo.train_epoch(self.cfg, self.env, self.state,
                                              self.generator)
        return metrics

    def train(self, n_epochs: Optional[int] = None, log: bool = True,
              stop_at_R: Optional[float] = None,
              initial_eval: bool = True,
              eval_deterministic: bool = False) -> List[Dict[str, Any]]:
        """Full training run; returns per-epoch metric dicts.  ``stop_at_R``
        stops once the eval mean undiscounted return reaches it.
        ``eval_deterministic`` scores each epoch with the mean policy, and
        stop_at_R then gates on that R."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        history: List[Dict[str, Any]] = []
        if initial_eval:
            m0 = self.evaluate(deterministic=eval_deterministic)
            if log:
                print(f"J: {m0.J:f} R: {m0.R:f} Episodes: {int(m0.episodes)}",
                      flush=True)
        for i in range(n_epochs):
            tic = time.perf_counter()
            fit = ppo.FitMetrics(*(float(x) for x in self.train_epoch()))
            toc = time.perf_counter()
            ev = self.evaluate(deterministic=eval_deterministic)
            row = {
                "epoch": i,
                "entropy": fit.entropy,
                "time_s": toc - tic,
                "J": ev.J,
                "R": ev.R,
                "episodes": int(ev.episodes),
                "value_loss": fit.value_loss,
                "policy_loss": fit.policy_loss,
                "mean_reward": fit.mean_reward,
            }
            history.append(row)
            if log:
                print(f"Epoch: {i} Entropy: {row['entropy']:f} "
                      f"Time {row['time_s']:f}s J: {row['J']:f} "
                      f"R: {row['R']:f} Episodes: {row['episodes']}",
                      flush=True)
            if stop_at_R is not None and ev.R >= stop_at_R:
                break
        return history

    def solve(self, target_R: float, max_epochs: int = 100) -> Dict[str, Any]:
        """Train until eval R >= target_R (or max_epochs); returns
        {"epochs": n, "R": R}."""
        self.state, n, R = ppo.train_until(
            self.cfg, self.env, self.state, self.generator, target_R,
            max_epochs)
        return {"epochs": n, "R": R}

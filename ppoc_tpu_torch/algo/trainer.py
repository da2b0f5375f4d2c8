"""Training driver: epoch loop, evaluation, the per-epoch metrics line.

Counterpart of ``ppoc_tpu/algo/trainer.py`` for one device.  The trainer
owns one ``torch.Generator`` (seeded from cfg.seed) in place of the JAX
package's key; every fit and evaluation draws its seed words and row-id
streams from it.  ``solve`` is a host loop over epochs plus evaluation
(``ppo.train_until``), where the JAX package compiles that loop into one
``while_loop``.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from ppoc_tpu_torch import envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.config import PPOConfig, validate
from ppoc_tpu_torch.ops import cuda_rollout, resolve_backend


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
    "shuffle_block": 0, "transplant_patience": 0, "aux_value_coeff": 0.0,
    "fit_dispatch": "fused", "rollout_chunk": 0, "fits_per_program": 0,
    "eval_estimator": "completed",
}


def check_ported(cfg: PPOConfig) -> None:
    """Raise NotImplementedError for a config that needs an unported part."""
    bad = {k: getattr(cfg, k) for k, ok in _NOT_PORTED.items()
           if getattr(cfg, k) != ok}
    if bad:
        raise NotImplementedError(
            f"not ported to ppoc_tpu_torch yet: {bad} (see ROADMAP.md)")


class Trainer:
    def __init__(self, cfg: PPOConfig, device):
        validate(cfg)
        check_ported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
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

    def evaluate(self) -> ppo.EvalMetrics:
        """Stochastic-policy eval (mean-policy eval needs kernel K5, not
        ported yet).  Returns Python floats."""
        m = ppo.evaluate(self.cfg, self.env, self.state.policy_params,
                         cuda_rollout.seed_words(self.generator))
        return ppo.EvalMetrics(*(float(x) for x in m))

    def train_epoch(self) -> ppo.FitMetrics:
        self.state, metrics = ppo.train_epoch(self.cfg, self.env, self.state,
                                              self.generator)
        return metrics

    def train(self, n_epochs: Optional[int] = None, log: bool = True,
              stop_at_R: Optional[float] = None,
              initial_eval: bool = True) -> List[Dict[str, Any]]:
        """Full training run; returns per-epoch metric dicts.  ``stop_at_R``
        stops once the eval mean undiscounted return reaches it."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        history: List[Dict[str, Any]] = []
        if initial_eval:
            m0 = self.evaluate()
            if log:
                print(f"J: {m0.J:f} R: {m0.R:f} Episodes: {int(m0.episodes)}",
                      flush=True)
        for i in range(n_epochs):
            tic = time.perf_counter()
            fit = ppo.FitMetrics(*(float(x) for x in self.train_epoch()))
            toc = time.perf_counter()
            ev = self.evaluate()
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

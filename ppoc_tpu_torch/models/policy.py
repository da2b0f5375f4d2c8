"""Diagonal Gaussian policy (counterpart of ``ppoc_tpu/models/policy.py``).

An MLP mean ``mu`` plus a state-independent learnable ``log_std`` vector
initialised to log(init_std), with

  * sampling  a = mu + eps * exp(log_std)
  * log-prob  -k/2 log(2 pi) - sum_j [log_std_j + ((a_j - mu_j) / exp(log_std_j))^2 / 2]
  * entropy   k/2 (1 + log(2 pi)) + sum_j log_std_j

Categorical policies (and kernel K6) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import mlp

LOG_2PI = math.log(2.0 * math.pi)


def init_gaussian(obs_dim: int, action_dim: int, hidden: Sequence[int],
                  init_std: float, generator: torch.Generator,
                  device: torch.device) -> Dict:
    return {
        "mlp": mlp.init((obs_dim, *hidden, action_dim), generator, device),
        "log_std": torch.full((action_dim,), math.log(init_std),
                              dtype=torch.float32, device=device),
    }


def gaussian_log_prob_from_mean(mu: torch.Tensor, log_std: torch.Tensor,
                                action: torch.Tensor) -> torch.Tensor:
    k = action.shape[-1]
    z = (action - mu) * torch.exp(-log_std)
    return -0.5 * k * LOG_2PI - torch.sum(log_std + 0.5 * z * z, dim=-1)


def sample(params: Dict, obs: torch.Tensor, activation: str, backend: str,
           eps: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample actions and their log-probs.  The standard-normal noise is
    ``eps`` when given, else drawn from ``generator``."""
    mu = mlp.apply(params["mlp"], obs, activation, backend)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator,
                          dtype=mu.dtype).to(mu.device)
    action = mu + eps * torch.exp(params["log_std"])
    return action, gaussian_log_prob_from_mean(mu, params["log_std"], action)


def mode(params: Dict, obs: torch.Tensor, activation: str,
         backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(action, log_prob) of the distribution mode (the Gaussian mean); the
    log_prob is that of the mean under the stochastic policy."""
    out = mlp.apply(params["mlp"], obs, activation, backend)
    return out, gaussian_log_prob_from_mean(out, params["log_std"], out)


def log_prob(params: Dict, obs: torch.Tensor, action: torch.Tensor,
             activation: str, backend: str) -> torch.Tensor:
    mu = mlp.apply(params["mlp"], obs, activation, backend)
    return gaussian_log_prob_from_mean(mu, params["log_std"], action)


def entropy(params: Dict) -> torch.Tensor:
    k = params["log_std"].shape[0]
    return 0.5 * k * (1.0 + LOG_2PI) + torch.sum(params["log_std"])

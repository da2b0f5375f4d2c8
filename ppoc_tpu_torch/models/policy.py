"""Stochastic policies (counterpart of ``ppoc_tpu/models/policy.py``).

Diagonal Gaussian: an MLP mean ``mu`` plus a state-independent learnable
``log_std`` vector initialised to log(init_std), with

  * sampling  a = mu + eps * exp(log_std)
  * log-prob  -k/2 log(2 pi) - sum_j [log_std_j + ((a_j - mu_j) / exp(log_std_j))^2 / 2]
  * entropy   k/2 (1 + log(2 pi)) + sum_j log_std_j

Categorical (the discrete envs): an MLP over the K class logits and no
``log_std``; the log-prob is the log-softmax at the action's class, the
entropy the mean over rows of -sum_k p_k log p_k.  Its whole fused policy
phase is kernel K6 (``ops/cuda_update.py``); sampling is K1's Gumbel-max
(``ops/cuda_rollout.py``).

``init``, ``mode``, ``log_prob`` and ``entropy`` dispatch on ``discrete``
as the JAX package's do; every MLP call goes through ``mlp.apply`` with the
caller's backend, so through K5 on the card.  :func:`act_from_out` is the
distribution math for callers that run the trunk themselves (the sequence
rollout, ``algo/recurrent.py``), on noise drawn beforehand.
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


def init_categorical(obs_dim: int, n_actions: int, hidden: Sequence[int],
                     generator: torch.Generator,
                     device: torch.device) -> Dict:
    return {"mlp": mlp.init((obs_dim, *hidden, n_actions), generator,
                            device)}


# --- Gaussian ---------------------------------------------------------------

def gaussian_log_prob_from_mean(mu: torch.Tensor, log_std: torch.Tensor,
                                action: torch.Tensor) -> torch.Tensor:
    k = action.shape[-1]
    z = (action - mu) * torch.exp(-log_std)
    return -0.5 * k * LOG_2PI - torch.sum(log_std + 0.5 * z * z, dim=-1)


def sample(params: Dict, obs: torch.Tensor, activation: str, backend: str,
           eps: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample Gaussian actions and their log-probs.  The standard-normal
    noise is ``eps`` when given, else drawn from ``generator``."""
    mu = mlp.apply(params["mlp"], obs, activation, backend)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator,
                          dtype=mu.dtype).to(mu.device)
    action = mu + eps * torch.exp(params["log_std"])
    return action, gaussian_log_prob_from_mean(mu, params["log_std"], action)


def gaussian_entropy(params: Dict) -> torch.Tensor:
    k = params["log_std"].shape[0]
    return 0.5 * k * (1.0 + LOG_2PI) + torch.sum(params["log_std"])


# --- Categorical -------------------------------------------------------------

def categorical_log_prob(params: Dict, obs: torch.Tensor,
                         action: torch.Tensor, activation: str,
                         backend: str) -> torch.Tensor:
    """log softmax(logits)[action]; ``action`` holds class ids [..., 1]."""
    logits = mlp.apply(params["mlp"], obs, activation, backend)
    logp_all = torch.log_softmax(logits, dim=-1)
    return torch.take_along_dim(logp_all, action.long(), dim=-1)[..., 0]


def categorical_entropy(params: Dict, obs: torch.Tensor, activation: str,
                        backend: str) -> torch.Tensor:
    """Mean over rows of -sum_k p_k log p_k."""
    logits = mlp.apply(params["mlp"], obs, activation, backend)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.sum(torch.exp(logp) * logp, dim=-1))


# --- unified dispatch ---------------------------------------------------------

def init(obs_dim: int, action_dim: int, hidden: Sequence[int],
         init_std: float, discrete: bool, generator: torch.Generator,
         device: torch.device) -> Dict:
    if discrete:
        return init_categorical(obs_dim, action_dim, hidden, generator,
                                device)
    return init_gaussian(obs_dim, action_dim, hidden, init_std, generator,
                         device)


def mode(params: Dict, obs: torch.Tensor, activation: str, backend: str,
         discrete: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(action, log_prob) of the distribution mode: the Gaussian mean, or
    the categorical argmax as int32 [..., 1] (the first of tied maxima).
    The log_prob is that of the returned action under the stochastic
    policy."""
    out = mlp.apply(params["mlp"], obs, activation, backend)
    if discrete:
        action = torch.argmax(out, dim=-1, keepdim=True)
        logp = torch.take_along_dim(torch.log_softmax(out, dim=-1), action,
                                    dim=-1)[..., 0]
        return action.to(torch.int32), logp
    return out, gaussian_log_prob_from_mean(out, params["log_std"], out)


def log_prob(params: Dict, obs: torch.Tensor, action: torch.Tensor,
             activation: str, backend: str,
             discrete: bool = False) -> torch.Tensor:
    if discrete:
        return categorical_log_prob(params, obs, action, activation, backend)
    mu = mlp.apply(params["mlp"], obs, activation, backend)
    return gaussian_log_prob_from_mean(mu, params["log_std"], action)


def entropy(params: Dict, obs: Optional[torch.Tensor] = None,
            activation: str = "relu", backend: str = "jnp",
            discrete: bool = False) -> torch.Tensor:
    """The policy's entropy: closed form for the Gaussian (no obs needed),
    the mean over the rows of ``obs`` for the categorical."""
    if discrete:
        return categorical_entropy(params, obs, activation, backend)
    return gaussian_entropy(params)


def draw_noise(shape, discrete: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The noise :func:`act_from_out` reads, float32 on the CPU, from
    ``generator``: standard normals for the Gaussian, Gumbel(0, 1) draws
    -log(-log u) for the categorical."""
    if discrete:
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def act_from_out(out: torch.Tensor, discrete: bool,
                 log_std: Optional[torch.Tensor] = None,
                 deterministic: bool = False,
                 noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(action, log_prob) from a precomputed head output ``out`` (logits or
    the Gaussian mean), as ``ppoc_tpu/models/policy.py`` ``act_from_out``.
    ``noise`` is shaped like ``out``: standard normals for the Gaussian
    (a = mu + noise * exp(log_std)), Gumbel(0, 1) draws for the categorical
    (the class is argmax(noise + logits), ``jax.random.categorical``'s
    sampler).  ``deterministic`` takes the mode and reads no noise.  The
    log_prob is that of the returned action under the stochastic policy;
    a class comes back as int32 [..., 1]."""
    if discrete:
        a_idx = torch.argmax(out if deterministic else noise + out, dim=-1,
                             keepdim=True)
        logp = torch.take_along_dim(torch.log_softmax(out, dim=-1), a_idx,
                                    dim=-1)[..., 0]
        return a_idx.to(torch.int32), logp
    action = out if deterministic else out + noise * torch.exp(log_std)
    return action, gaussian_log_prob_from_mean(out, log_std, action)

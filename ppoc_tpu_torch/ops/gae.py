"""GAE(lambda) over the time axis (counterpart of ``ppoc_tpu/ops/gae.py``).

The masked first-order recurrence

    A_t = delta_t + gamma*lam * not(terminated_t | truncated_t) * A_{t+1}
    delta_t = r_t + gamma * V(s_{t+1}) * not(terminated_t) - V(s_t)

is linear, so :func:`gae` solves it with a log-depth doubling scan over
``[T, E]`` tensors (ceil(log2 T) passes, the JAX package's associative
scan); :func:`gae_reference` is the sequential O(T) loop kept as its oracle.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _deltas(rewards, values, next_values, terminated, truncated, gamma, lam):
    term = terminated.to(rewards.dtype)
    done = (terminated | truncated).to(rewards.dtype)
    delta = rewards + gamma * next_values * (1.0 - term) - values
    coeff = gamma * lam * (1.0 - done)
    return delta, coeff


def gae(rewards: torch.Tensor, values: torch.Tensor,
        next_values: torch.Tensor, terminated: torch.Tensor,
        truncated: torch.Tensor, gamma: float,
        lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (advantages, value_targets), both shaped like ``rewards``;
    ``value_targets = V(s) + A`` (before any advantage normalisation)."""
    delta, coeff = _deltas(rewards, values, next_values, terminated,
                           truncated, gamma, lam)
    # element t holds the affine map A -> d + c*A over steps [t, t+span);
    # doubling the span composes it with the map that starts at t+span
    c, d = coeff.clone(), delta.clone()
    T = rewards.shape[0]
    span = 1
    while span < T:
        d[:T - span] = d[:T - span] + c[:T - span] * d[span:]
        c[:T - span] = c[:T - span] * c[span:]
        span *= 2
    return d, values + d


def gae_reference(rewards, values, next_values, terminated, truncated,
                  gamma: float, lam: float):
    """Sequential O(T) twin of :func:`gae`."""
    delta, coeff = _deltas(rewards, values, next_values, terminated,
                           truncated, gamma, lam)
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = delta[t] + coeff[t] * carry
        adv[t] = carry
    return adv, values + adv


def discounted_episode_returns(rewards: torch.Tensor, done: torch.Tensor,
                               gamma: float) -> torch.Tensor:
    """Per-step suffix returns that restart at episode boundaries:
    J_t = r_t + gamma * not(done_t) * J_{t+1}; ``done_t`` marks the last
    step of an episode."""
    coeff = gamma * (1.0 - done.to(rewards.dtype))
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + coeff[t] * carry
        out[t] = carry
    return out


def normalize(x: torch.Tensor, mean, std, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps)."""
    return (x - mean) / (std + eps)

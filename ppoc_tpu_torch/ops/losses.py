"""PPO losses (counterpart of ``ppoc_tpu/ops/losses.py``).

Autograd of the clipped surrogate gives the reference's hand-written
gradient: it flows only through the unclipped branch, because the clipped
branch is constant in the ratio.  ``clipped_value_loss`` is the PPO2
value clipping of the ``clip_value`` stabiliser.
"""
from __future__ import annotations

import torch


def clipped_surrogate_loss(log_probs: torch.Tensor,
                           old_log_probs: torch.Tensor,
                           advantages: torch.Tensor,
                           clip_eps: float) -> torch.Tensor:
    """-E[min(r*A, clip(r, 1-eps, 1+eps)*A)], r = exp(logp - old_logp)."""
    ratio = torch.exp(log_probs - old_log_probs)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    return -torch.mean(torch.minimum(ratio * advantages, clipped * advantages))


def value_loss(v_pred: torch.Tensor, v_target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    return torch.mean((v_pred - v_target) ** 2)


def clipped_value_loss(v_pred: torch.Tensor, v_old: torch.Tensor,
                       v_target: torch.Tensor, clip: float) -> torch.Tensor:
    """PPO2 value clipping: the mean of the elementwise max of the
    unclipped squared error and that of V_old + clip(V - V_old, +/-clip)."""
    v_clipped = v_old + torch.clamp(v_pred - v_old, -clip, clip)
    return torch.mean(torch.maximum((v_pred - v_target) ** 2,
                                    (v_clipped - v_target) ** 2))

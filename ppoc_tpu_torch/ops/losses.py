"""PPO losses (counterpart of ``ppoc_tpu/ops/losses.py``).

Autograd of the clipped surrogate gives the reference's hand-written
gradient: it flows only through the unclipped branch, because the clipped
branch is constant in the ratio.  Value clipping (``clipped_value_loss``)
arrives with the stabilisers in a later slice.
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

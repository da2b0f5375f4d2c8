"""Trajectory rows, shuffle and minibatch gather (counterpart of
``ppoc_tpu/data/buffer.py``).

Each epoch draws a fresh permutation of the row ids, slices it into
``n_mb`` minibatches and drops the tail (< minibatch_size rows), as the
reference does.  Block-granular shuffling (``shuffle_block``) arrives in a
later slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch


class RowBuffer(NamedTuple):
    """Flattened per-transition training rows (the post-GAE buffer)."""
    obs: torch.Tensor        # [N, obs_dim]
    action: torch.Tensor     # [N, act_dim]
    log_prob: torch.Tensor   # [N]
    advantage: torch.Tensor  # [N]
    target: torch.Tensor     # [N]  value targets V(s) + A


def from_rollout(traj, advantage: torch.Tensor,
                 target: torch.Tensor) -> RowBuffer:
    """Flatten a [T, E, ...] rollout and its GAE outputs into [T*E, ...] rows
    (row t*E + e is step t of env e)."""
    n = traj.obs.shape[0] * traj.obs.shape[1]
    return RowBuffer(
        obs=traj.obs.reshape(n, -1),
        action=traj.action.reshape(n, traj.action.shape[-1]),
        log_prob=traj.log_prob.reshape(n),
        advantage=advantage.reshape(n),
        target=target.reshape(n),
    )


def permutation_minibatches(generator: torch.Generator, n_rows: int,
                            n_mb: int, mb_size: int) -> torch.Tensor:
    """A fresh shuffle sliced into [n_mb, mb_size] row ids (on the
    generator's device), tail dropped."""
    perm = torch.randperm(n_rows, generator=generator)[: n_mb * mb_size]
    return perm.reshape(n_mb, mb_size)


def gather(cols: Sequence[torch.Tensor], idx: torch.Tensor) -> Any:
    """Gather rows by id from each column tensor."""
    flat = idx.reshape(-1)
    return tuple(c.index_select(0, flat) for c in cols)


def gather_mb(cols: Sequence[torch.Tensor], idx: torch.Tensor) -> Any:
    """Gather one minibatch (or a whole pre-gathered phase stream)."""
    return gather(cols, idx)

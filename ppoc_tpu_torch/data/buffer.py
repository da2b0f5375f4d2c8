"""Trajectory rows, shuffle and minibatch gather (counterpart of
``ppoc_tpu/data/buffer.py``).

Each epoch draws a fresh permutation of the row ids, slices it into
``n_mb`` minibatches and drops the tail (< minibatch_size rows), as the
reference does.  With ``cfg.shuffle_block`` the permutation is of aligned
blocks of that many rows, and a minibatch gathers whole blocks
(``block_permutation_minibatches``, ``gather_blocks``).
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


def block_permutation_minibatches(generator: torch.Generator, n_rows: int,
                                  n_mb: int, mb_size: int,
                                  block: int) -> torch.Tensor:
    """Minibatches at block granularity: a shuffle of the n_rows/block
    aligned row blocks, dealt into [n_mb, mb_size/block] block ids (tail
    blocks dropped).  Every row still appears once per epoch."""
    check_blocks(n_rows, mb_size, block)
    n_blocks, mb_blocks = n_rows // block, mb_size // block
    perm = torch.randperm(n_blocks, generator=generator)[: n_mb * mb_blocks]
    return perm.reshape(n_mb, mb_blocks)


def check_blocks(n_rows: int, mb_size: int, block: int) -> None:
    """``epoch_scan``'s divisibility check of the JAX package."""
    if n_rows % block or mb_size % block:
        raise ValueError(
            f"shuffle_block ({block}) must divide both the per-shard "
            f"row count ({n_rows}) and minibatch size ({mb_size})")


def gather(cols: Sequence[torch.Tensor], idx: torch.Tensor) -> Any:
    """Gather rows by id from each column tensor."""
    flat = idx.reshape(-1)
    return tuple(c.index_select(0, flat) for c in cols)


def gather_blocks(cols: Sequence[torch.Tensor], block_ids: torch.Tensor,
                  block: int) -> Any:
    """Gather aligned blocks of ``block`` rows by block id from each column
    tensor, through a [N/block, block, ...] view: each gathered unit is
    ``block`` contiguous rows."""
    flat = block_ids.reshape(-1)

    def one(c):
        blocked = c.reshape((c.shape[0] // block, block) + c.shape[1:])
        return blocked.index_select(0, flat).reshape(
            (flat.shape[0] * block,) + c.shape[1:])

    return tuple(one(c) for c in cols)


def gather_mb(cols: Sequence[torch.Tensor], idx: torch.Tensor,
              block: int = 0) -> Any:
    """Gather one minibatch (or a whole pre-gathered phase stream) by row
    ids (``block=0``) or by block ids (``block>0``), in stream order."""
    return gather_blocks(cols, idx, block) if block else gather(cols, idx)

"""Adam over parameter trees (counterpart of ``ppoc_tpu/ops/adam.py``).

    t      += 1
    m       = b1*m + (1-b1)*g
    v       = b2*v + (1-b2)*g^2
    denom   = sqrt(v / (1 - b2^t)) + eps          # eps OUTSIDE the sqrt
    p      -= lr / (1 - b1^t) * m / denom         # bias correction in the step

A parameter tree is a tensor, or a list/tuple of trees (an MLP is a list of
``(W, b)`` pairs).  The timestep ``t`` is a Python int: it only ever counts
minibatch steps, and keeping it on the host spares a device sync.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch


class AdamState(NamedTuple):
    m: Any   # tree like params
    v: Any   # tree like params
    t: int   # timestep


def tree_map(fn: Callable, *trees):
    """Map ``fn`` over the tensor leaves of same-shaped trees."""
    head = trees[0]
    if isinstance(head, torch.Tensor):
        return fn(*trees)
    if isinstance(head, (list, tuple)):
        out = [tree_map(fn, *sub) for sub in zip(*trees)]
        return out if isinstance(head, list) else tuple(out)
    raise TypeError(f"unsupported parameter tree node {type(head).__name__}")


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


def init(params) -> AdamState:
    return AdamState(m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params), t=0)


def update(params, grads, state: AdamState, lr: float, beta1: float = 0.9,
           beta2: float = 0.999, eps: float = 1e-8) -> Tuple[Any, AdamState]:
    t = state.t + 1
    step_size = lr / (1.0 - beta1 ** t)
    bc2 = 1.0 - beta2 ** t

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        m2 = beta1 * m + (1.0 - beta1) * g
        v2 = beta2 * v + (1.0 - beta2) * g * g
        new_p.append(p - step_size * m2 / (torch.sqrt(v2 / bc2) + eps))
        new_m.append(m2)
        new_v.append(v2)
    return (tree_unflatten(params, new_p),
            AdamState(m=tree_unflatten(params, new_m),
                      v=tree_unflatten(params, new_v), t=t))


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """The tree shaped like ``like`` whose leaves, in order, are ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

"""Adam over parameter trees (counterpart of ``ppoc_tpu/ops/adam.py``).

    t      += 1
    m       = b1*m + (1-b1)*g
    v       = b2*v + (1-b2)*g*g
    denom   = sqrt(v / (1 - b2^t)) + eps          # eps OUTSIDE the sqrt
    p      -= lr / (1 - b1^t) * m / denom         # bias correction in the step

A parameter tree is a leaf (a tensor; where ``utils/checkpoint.py`` reads
or checks a file, also a numpy array or an Adam timestep's int), or a
list/tuple of trees (an MLP is a list of ``(W, b)`` pairs), or a dict of
trees (an attention trunk, whose leaves go in sorted key order, as
``jax.tree.leaves`` takes them); any other node is refused.  The timestep
``t`` is a Python int: it only ever counts minibatch steps, and keeping it
on the host spares a device sync.

``lr`` is a Python float, or a 0-dim float32 tensor (an annealed rate,
``algo/ppo._lr``): then the step size is that tensor over the float32 bias
correction, a tensor division as the JAX package's ``lr / bc1``, whose
float32 value the step then takes as its scalar.
:func:`clip_by_global_norm` is the stabiliser that scales a gradient tree
to a global L2 norm.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch

LEAF_TYPES = (torch.Tensor, np.ndarray, int)


class AdamState(NamedTuple):
    m: Any   # tree like params
    v: Any   # tree like params
    t: int   # timestep


def tree_map(fn: Callable, *trees):
    """Map ``fn`` over the leaves of same-shaped trees."""
    head = trees[0]
    if isinstance(head, (list, tuple)):
        out = [tree_map(fn, *sub) for sub in zip(*trees)]
        return out if isinstance(head, list) else tuple(out)
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(head)}
    if isinstance(head, LEAF_TYPES):
        return fn(*trees)
    raise TypeError(f"unsupported parameter tree node {type(head).__name__}")


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order (NamedTuples as tuples)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if isinstance(tree, LEAF_TYPES):
        return [tree]
    raise TypeError(f"unsupported parameter tree node {type(tree).__name__}")


def init(params) -> AdamState:
    return AdamState(m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params), t=0)


def update(params, grads, state: AdamState, lr, beta1: float = 0.9,
           beta2: float = 0.999, eps: float = 1e-8) -> Tuple[Any, AdamState]:
    t = state.t + 1
    if isinstance(lr, torch.Tensor):
        step_size = float(lr / torch.tensor(1.0 - beta1 ** t, dtype=lr.dtype,
                                            device=lr.device))
    else:
        step_size = lr / (1.0 - beta1 ** t)
    bc2 = 1.0 - beta2 ** t
    # the formulas above, term by term, one multi-tensor op a term over
    # every leaf: the generic phases' host cost is their launches
    p, g, m, v = (tree_leaves(x) for x in (params, grads, state.m, state.v))
    new_m = torch._foreach_add(torch._foreach_mul(m, beta1),
                               torch._foreach_mul(g, 1.0 - beta1))
    new_v = torch._foreach_add(
        torch._foreach_mul(v, beta2),
        torch._foreach_mul(torch._foreach_mul(g, 1.0 - beta2), g))
    denom = torch._foreach_add(
        torch._foreach_sqrt(torch._foreach_div(new_v, bc2)), eps)
    new_p = torch._foreach_sub(
        p, torch._foreach_div(torch._foreach_mul(new_m, step_size), denom))
    return (tree_unflatten(params, new_p),
            AdamState(m=tree_unflatten(params, new_m),
                      v=tree_unflatten(params, new_v), t=t))


def clip_by_global_norm(grads, max_norm: float):
    """Scale the whole gradient tree so its global L2 norm is at most
    ``max_norm``: the norm over the leaves in :func:`tree_leaves` order
    (dict keys sorted, as ``jax.tree.leaves``), in float32, and the scale
    ``min(1, max_norm / max(norm, 1e-12))`` by tensor division, as
    ``ppoc_tpu/ops/adam.py`` ``clip_by_global_norm``."""
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """The tree shaped like ``like`` whose leaves, in order, are ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

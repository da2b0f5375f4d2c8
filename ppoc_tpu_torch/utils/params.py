"""Parameter and optimizer-state exchange with the JAX package.

The port keeps the JAX package's layouts (an MLP is a list of
``(W [in, out], b [out])`` pairs, a Gaussian policy ``{"mlp", "log_std"}``,
a categorical policy ``{"mlp"}`` whose log_std optimizer holds empty
``(0,)`` moments, an attention trunk a dict of lists of dicts of tuples
with an MLP ``"head"`` (``models/attn.py``), a mixture of experts
``{"router": (W, b), "experts": [(W, b), ...]}`` (``models/moe.py``), an
Adam state ``(m, v, t)``),
so conversion is leaf by leaf: numpy arrays in
(for instance ``jax.device_get`` of a ``ppoc_tpu`` TrainState), tensors out,
and back.  Nothing here imports jax: any object with the right attribute
names converts.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ppoc_tpu_torch.ops.adam import AdamState


def tree_from_numpy(tree, device) -> Any:
    """numpy arrays (nested in lists/tuples/dicts) -> float32 tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_from_numpy(v, device) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return torch.tensor(np.array(tree, dtype=np.float32), device=device)


def tree_to_numpy(tree) -> Any:
    """Tensors (nested in lists/tuples/dicts) -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_to_numpy(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree.detach().cpu().numpy()


def _mlp_list(tree) -> list:
    """An MLP tree as the port's list of (W, b) tuples."""
    return [tuple(layer) for layer in tree]


def _trunk(tree):
    """A trunk tree in the port's layout: an MLP as a list of (W, b)
    tuples; an attention trunk with its head so, the rest as it came; a
    mixture's experts so and its router a tuple."""
    if isinstance(tree, dict) and "experts" in tree:
        return dict(tree, router=tuple(tree["router"]),
                    experts=_mlp_list(tree["experts"]))
    if isinstance(tree, dict):
        return dict(tree, head=_mlp_list(tree["head"]))
    return _mlp_list(tree)


def trunk_from_numpy(tree, device):
    """One trunk (an MLP or an attention encoder with its head) of numpy
    arrays -> the port's tensors."""
    return _trunk(tree_from_numpy(tree, device))


def adam_from_numpy(state, device, mlp: bool = True) -> AdamState:
    """An Adam state with ``m``, ``v``, ``t`` attributes -> the port's.
    ``mlp=False`` for the log_std optimizer, whose moments are one vector
    (of length 0 for a categorical policy)."""
    m = tree_from_numpy(state.m, device)
    v = tree_from_numpy(state.v, device)
    if mlp:
        m, v = _trunk(m), _trunk(v)
    return AdamState(m=m, v=v, t=int(np.asarray(state.t)))


def adam_to_numpy(state: AdamState) -> AdamState:
    return AdamState(m=tree_to_numpy(state.m), v=tree_to_numpy(state.v),
                     t=int(state.t))


def policy_from_numpy(policy_params, device) -> dict:
    """A policy's params of numpy arrays (``{"mlp", "log_std"}``, or
    ``{"mlp"}`` for a categorical policy) -> the port's tensors."""
    pol = tree_from_numpy(dict(policy_params), device)
    pol["mlp"] = _trunk(pol["mlp"])
    return pol


def train_state_from_numpy(ts, device):
    """A TrainState-shaped object of numpy arrays -> the port's TrainState,
    Gaussian (``log_std`` in the policy) or categorical (none), with MLP,
    mixture-of-experts or attention trunks."""
    from ppoc_tpu_torch.algo.ppo import TrainState

    return TrainState(
        policy_params=policy_from_numpy(ts.policy_params, device),
        v_params=_trunk(tree_from_numpy(ts.v_params, device)),
        opt_policy=adam_from_numpy(ts.opt_policy, device),
        opt_v=adam_from_numpy(ts.opt_v, device),
        opt_log_std=adam_from_numpy(ts.opt_log_std, device, mlp=False),
    )


def train_state_to_numpy(ts):
    """The port's TrainState -> the same structure of numpy arrays (Adam
    timesteps as ints)."""
    return type(ts)(
        policy_params=tree_to_numpy(ts.policy_params),
        v_params=tree_to_numpy(ts.v_params),
        opt_policy=adam_to_numpy(ts.opt_policy),
        opt_v=adam_to_numpy(ts.opt_v),
        opt_log_std=adam_to_numpy(ts.opt_log_std),
    )

"""Batched environment interface.

Counterpart of ``ppoc_tpu/envs/core.py``.  The JAX package writes one env
instance as pure functions and vectorises them with ``vmap``; here an
environment's functions take the whole batch at once, as tensors with a
leading env axis:

  * ``reset(n_envs, generator, device) -> (state, obs)``
  * ``step(state, action) -> (state, obs, reward, terminated, truncated)``

``state`` is a NamedTuple of ``[E]`` tensors that includes the env's own
step counter.  ``terminated``/``truncated`` are bool ``[E]`` tensors with
Gymnasium semantics (terminated: bootstrap with V=0; truncated: time limit,
bootstrap with V(s')).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    action_dim: int
    horizon: int          # max_episode_steps (truncation limit)
    gamma: float          # env-owned discount
    discrete: bool = False
    action_low: float = -1.0
    action_high: float = 1.0


@dataclasses.dataclass(frozen=True)
class Env:
    spec: EnvSpec
    reset: Callable[[int, torch.Generator, torch.device], Tuple[Any, torch.Tensor]]
    step: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]]


_REGISTRY: Dict[str, Callable[[], Env]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def vector_reset(env: Env, generator: torch.Generator, n_envs: int,
                 device: torch.device):
    """Reset ``n_envs`` independent instances; returns batched (state, obs)."""
    return env.reset(n_envs, generator, torch.device(device))


def vector_autoreset_step(env: Env, state, action: torch.Tensor, fresh):
    """Step, then reset every instance that finished.

    The reset states are ``fresh``, a batched ``(state, obs)`` pair drawn
    beforehand (``vector_reset``).  Returns ``(state', obs', next_obs,
    reward, terminated, truncated)``: ``next_obs`` is the true successor
    observation (for GAE bootstrapping) and ``obs'`` the observation the
    policy acts on next (the fresh-reset obs where done).
    """
    new_state, next_obs, reward, terminated, truncated = env.step(state, action)
    done = terminated | truncated
    reset_state, reset_obs = fresh

    def pick(fresh, kept):
        mask = done.reshape(done.shape + (1,) * (kept.dim() - 1))
        return torch.where(mask, fresh, kept)

    state_out = type(new_state)(*(pick(f, k) for f, k in
                                  zip(reset_state, new_state)))
    return (state_out, pick(reset_obs, next_obs), next_obs, reward,
            terminated, truncated)

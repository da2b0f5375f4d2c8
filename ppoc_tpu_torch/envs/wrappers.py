"""Environment wrappers (counterpart of ``ppoc_tpu/envs/wrappers.py``).

Ported: :func:`normalize_obs`, the STATIC affine observation
normalisation, and the ``mountain_car_norm`` env it makes; the
config-carried :func:`affine_obs` (``cfg.obs_loc``/``obs_scale``) and
:func:`calibrate`, which measures those statistics with a random policy;
the partial observability of the recurrent family, :func:`mask_obs` (the
``pendulum_po`` and ``cartpole_po`` envs) and :func:`stack_obs` (the
memoryless route, ``pendulum_po_stack``).  Physics, rewards and episode
structure are untouched.  The running normalisation of host environments
is not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .core import Env, make, register


def normalize_obs(env: Env, low, high, name: str = None) -> Env:
    """Affine-map observations from [low, high] to [-1, 1] per dimension
    (``low``/``high``: per-dimension bounds of length obs_dim)."""
    low = torch.as_tensor(np.asarray(low, np.float32))
    high = torch.as_tensor(np.asarray(high, np.float32))
    return _affine(env, (high + low) / 2.0, (high - low) / 2.0,
                   name or env.spec.name + "_norm")


def _affine(env: Env, loc, scale, name: str) -> Env:
    """``env`` with observations mapped to ``(obs - loc) / scale``
    (float32 tensors of length obs_dim), the spec renamed ``name``."""
    on = {}   # device -> (loc, scale) there

    def norm(obs):
        if obs.device not in on:
            on[obs.device] = (loc.to(obs.device), scale.to(obs.device))
        lo, sc = on[obs.device]
        return (obs - lo) / sc

    def reset(n_envs, generator, device):
        state, obs = env.reset(n_envs, generator, device)
        return state, norm(obs)

    def step(state, action):
        state2, obs, reward, term, trunc = env.step(state, action)
        return state2, norm(obs), reward, term, trunc

    return Env(spec=dataclasses.replace(env.spec, name=name), reset=reset,
               step=step)


def affine_obs(env: Env, loc, scale, name: str = None) -> Env:
    """Normalise observations as ``(obs - loc) / scale`` per dimension, the
    statistics carried in the config (``PPOConfig.obs_loc``/``obs_scale``,
    usually from :func:`calibrate`).  The spec's name gains ``#affine``,
    so no rollout lane (``ops/cuda_rollout.py``, keyed by env name) takes
    the wrapped env and emits the base env's raw observations: it rolls
    out through the env loop."""
    return _affine(env, torch.as_tensor(np.asarray(loc, np.float32)),
                   torch.as_tensor(np.asarray(scale, np.float32)),
                   name or env.spec.name + "#affine")


def calibrate(cfg, n_envs: int = 64, n_steps: int = 200, seed: int = 0,
              device=None):
    """Measure observation statistics with a uniform-random policy and
    return ``cfg`` with ``obs_loc``/``obs_scale`` set to them: ``n_envs`` x
    ``n_steps`` steps of the BASE env (autoreset on), the per-dimension
    mean and population std of every observation the policy would act on,
    std floored at 1e-6.  The env steps on ``device`` (``None``: CUDA
    device 0, as ``Trainer``; "cpu" pins the CPU).  The randomness is the
    port's own CPU ``torch.Generator`` seeded with ``seed`` (actions,
    resets; the draws move to ``device``), not the JAX package's key
    stream, so the two packages measure different samples of the same
    distribution."""
    from ppoc_tpu_torch.algo.trainer import resolve_device
    from .core import make, vector_autoreset_step, vector_reset

    device = resolve_device(device)
    env = make(cfg.env)
    spec = env.spec
    gen = torch.Generator().manual_seed(seed)
    state, obs = vector_reset(env, gen, n_envs, device)
    seen = []
    for _ in range(n_steps):
        if spec.discrete:
            action = torch.randint(0, spec.action_dim, (n_envs, 1),
                                   generator=gen, dtype=torch.int32)
        else:
            u = torch.rand((n_envs, spec.action_dim), generator=gen)
            action = spec.action_low + u * (spec.action_high
                                            - spec.action_low)
        seen.append(obs)
        fresh = vector_reset(env, gen, n_envs, device)
        state, obs, *_ = vector_autoreset_step(env, state, action.to(device),
                                               fresh)
    flat = torch.stack(seen).reshape(-1, spec.obs_dim)
    mean = flat.mean(dim=0)
    std = torch.clamp(flat.std(dim=0, unbiased=False), min=1e-6)
    return cfg.replace(obs_loc=tuple(mean.tolist()),
                       obs_scale=tuple(std.tolist()))


def mask_obs(env: Env, keep: Sequence[int],
             name: Optional[str] = None) -> Env:
    """Partial observability: expose only the observation dims in ``keep``
    (``ppoc_tpu/envs/wrappers.py:155-181``); the spec is renamed ``name``
    (default: the base name + ``_po``), so no rollout lane takes it."""
    keep = list(keep)

    def reset(n_envs, generator, device):
        state, obs = env.reset(n_envs, generator, device)
        return state, obs[:, keep]

    def step(state, action):
        state2, obs, reward, term, trunc = env.step(state, action)
        return state2, obs[:, keep], reward, term, trunc

    spec = dataclasses.replace(env.spec, name=name or env.spec.name + "_po",
                               obs_dim=len(keep))
    return Env(spec=spec, reset=reset, step=step)


_STACKED = {}   # inner state type -> its stacked state type


def _stacked_type(inner):
    """The state of a :func:`stack_obs` env: the inner state's fields and
    then the frame window, one NamedTuple of [E, ...] tensors, so the
    autoreset (``core.vector_autoreset_step``) picks it field by field."""
    if inner not in _STACKED:
        cls = collections.namedtuple("Stacked" + inner.__name__,
                                     inner._fields + ("window",))
        cls.inner = inner
        _STACKED[inner] = cls
    return _STACKED[inner]


def stack_obs(env: Env, k: int, name: Optional[str] = None) -> Env:
    """Frame stacking: observe the last ``k`` observations concatenated,
    newest last (``ppoc_tpu/envs/wrappers.py:198-236``).  The window
    [E, k, obs_dim] is the state's last field; reset fills it with the
    first observation, so a lane the autoreset restarts begins from its
    own first frame repeated."""

    def reset(n_envs, generator, device):
        state, obs = env.reset(n_envs, generator, device)
        window = obs[:, None, :].expand(-1, k, -1).contiguous()
        return (_stacked_type(type(state))(*state, window),
                window.reshape(n_envs, -1))

    def step(wrapped, action):
        state = type(wrapped).inner(*wrapped[:-1])
        state2, obs, reward, term, trunc = env.step(state, action)
        window = torch.cat([wrapped[-1][:, 1:], obs[:, None]], dim=1)
        return (type(wrapped)(*state2, window),
                window.reshape(window.shape[0], -1), reward, term, trunc)

    spec = dataclasses.replace(
        env.spec, name=name or f"{env.spec.name}_stack{k}",
        obs_dim=env.spec.obs_dim * k)
    return Env(spec=spec, reset=reset, step=step)


@register("pendulum_po")
def make_pendulum_po() -> Env:
    """Pendulum with the angular velocity hidden (obs = cos/sin theta): a
    memoryless policy cannot tell which way the pendulum swings."""
    return mask_obs(make("pendulum"), [0, 1], name="pendulum_po")


@register("cartpole_po")
def make_cartpole_po() -> Env:
    """CartPole with both velocities hidden (obs = cart position, pole
    angle)."""
    return mask_obs(make("cartpole"), [0, 2], name="cartpole_po")


@register("pendulum_po_stack")
def make_pendulum_po_stack() -> Env:
    """pendulum_po with 4 stacked frames: the frame-difference route to the
    hidden velocity, solvable by a plain MLP."""
    return stack_obs(make("pendulum_po"), 4, name="pendulum_po_stack")


@register("mountain_car_norm")
def make_mountain_car_norm() -> Env:
    """MountainCarContinuous with observations mapped to [-1, 1]: the raw
    scales differ by 26x (position in [-1.2, 0.6], velocity in
    [-0.07, 0.07]), which hides the velocity from the first layer."""
    from . import mountain_car as mc

    return normalize_obs(
        mc.make_mountain_car(),
        low=np.array([mc.MIN_POSITION, -mc.MAX_SPEED], np.float32),
        high=np.array([mc.MAX_POSITION, mc.MAX_SPEED], np.float32),
        name="mountain_car_norm",
    )

"""Environment wrappers (counterpart of ``ppoc_tpu/envs/wrappers.py``).

Ported: :func:`normalize_obs`, the STATIC affine observation
normalisation, and the ``mountain_car_norm`` env it makes; the
config-carried :func:`affine_obs` (``cfg.obs_loc``/``obs_scale``) and
:func:`calibrate`, which measures those statistics with a random policy.
Physics, rewards and episode structure are untouched.  The running
normalisation of host environments is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import Env, register


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

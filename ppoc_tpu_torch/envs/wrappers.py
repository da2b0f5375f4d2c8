"""Environment wrappers (counterpart of ``ppoc_tpu/envs/wrappers.py``).

Ported: :func:`normalize_obs`, the STATIC affine observation
normalisation, and the ``mountain_car_norm`` env it makes.  Physics,
rewards and episode structure are untouched; the observations are mapped
from [low, high] to [-1, 1] per dimension, with mid and half-width
computed in float32 as the JAX wrapper computes them.  The config-carried
``affine_obs``/``calibrate`` and the running normalisation of host
environments are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import Env, EnvSpec, register


def normalize_obs(env: Env, low, high, name: str = None) -> Env:
    """Affine-map observations from [low, high] to [-1, 1] per dimension
    (``low``/``high``: per-dimension bounds of length obs_dim)."""
    low = torch.as_tensor(np.asarray(low, np.float32))
    high = torch.as_tensor(np.asarray(high, np.float32))
    mid = (high + low) / 2.0
    half = (high - low) / 2.0

    def norm(obs):
        return (obs - mid.to(obs.device)) / half.to(obs.device)

    def reset(n_envs, generator, device):
        state, obs = env.reset(n_envs, generator, device)
        return state, norm(obs)

    def step(state, action):
        state2, obs, reward, term, trunc = env.step(state, action)
        return state2, norm(obs), reward, term, trunc

    spec = EnvSpec(
        name=name or env.spec.name + "_norm",
        obs_dim=env.spec.obs_dim,
        action_dim=env.spec.action_dim,
        horizon=env.spec.horizon,
        gamma=env.spec.gamma,
        discrete=env.spec.discrete,
        action_low=env.spec.action_low,
        action_high=env.spec.action_high,
    )
    return Env(spec=spec, reset=reset, step=step)


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

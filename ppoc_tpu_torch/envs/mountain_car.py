"""MountainCarContinuous-v0 dynamics as a batched PyTorch environment.

Counterpart of ``ppoc_tpu/envs/mountain_car.py``: the Gymnasium
classic-control equations in the same float32 operation order (power
0.0015, gravity term 0.0025 cos(3p), the wall at -1.2 zeroing a negative
velocity, +100 on reaching the goal, -0.1 a^2 on the RAW action).  The
reset draws the position uniformly in [-0.6, -0.4) from the generator.
Episodes terminate at the goal (p >= 0.45 and v >= 0) and truncate at 999
steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

MIN_POSITION = -1.2
MAX_POSITION = 0.6
MAX_SPEED = 0.07
GOAL_POSITION = 0.45
GOAL_VELOCITY = 0.0
POWER = 0.0015
HORIZON = 999


class MountainCarState(NamedTuple):
    position: torch.Tensor  # f32 [E]
    velocity: torch.Tensor  # f32 [E]
    t: torch.Tensor         # int32 [E], steps since reset


def obs_of(s: MountainCarState) -> torch.Tensor:
    return torch.stack([s.position, s.velocity], dim=-1)


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    u = torch.rand(n_envs, generator=generator,
                   dtype=torch.float32).to(device)
    s = MountainCarState(-0.6 + 0.2 * u, torch.zeros_like(u),
                         torch.zeros(n_envs, dtype=torch.int32, device=device))
    return s, obs_of(s)


def _step(s: MountainCarState, action: torch.Tensor):
    force = torch.clamp(action[:, 0], -1.0, 1.0)
    velocity = (s.velocity + force * POWER
                - 0.0025 * torch.cos(3.0 * s.position))
    velocity = torch.clamp(velocity, -MAX_SPEED, MAX_SPEED)
    position = torch.clamp(s.position + velocity, MIN_POSITION, MAX_POSITION)
    velocity = torch.where((position <= MIN_POSITION) & (velocity < 0.0),
                           torch.zeros_like(velocity), velocity)
    t = s.t + 1
    terminated = (position >= GOAL_POSITION) & (velocity >= GOAL_VELOCITY)
    truncated = (t >= HORIZON) & ~terminated
    # Gymnasium penalises the RAW action, not the clipped force
    reward = (torch.where(terminated, 100.0, 0.0)
              - 0.1 * action[:, 0] ** 2)
    s2 = MountainCarState(position, velocity, t)
    return s2, obs_of(s2), reward, terminated, truncated


@register("mountain_car")
def make_mountain_car() -> Env:
    spec = EnvSpec(
        name="mountain_car",
        obs_dim=2,
        action_dim=1,
        horizon=HORIZON,
        gamma=0.99,
        action_low=-1.0,
        action_high=1.0,
    )
    return Env(spec=spec, reset=_reset, step=_step)

"""Pendulum-v1 dynamics as a batched PyTorch environment.

Counterpart of ``ppoc_tpu/envs/pendulum.py``: the Gymnasium classic-control
equations (semi-implicit Euler, torque clip, speed clip, angle-normalised
cost).  Pendulum never terminates; episodes end by truncation at 200 steps.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0
HORIZON = 200


class PendulumState(NamedTuple):
    theta: torch.Tensor      # f32 [E]
    theta_dot: torch.Tensor  # f32 [E]
    t: torch.Tensor          # int32 [E], steps since reset


def obs_of(s: PendulumState) -> torch.Tensor:
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot],
                       dim=-1)


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    u = torch.rand((2, n_envs), generator=generator,
                   dtype=torch.float32).to(device)
    theta = -math.pi + 2.0 * math.pi * u[0]
    theta_dot = -1.0 + 2.0 * u[1]
    s = PendulumState(theta, theta_dot,
                      torch.zeros(n_envs, dtype=torch.int32, device=device))
    return s, obs_of(s)


def _step(s: PendulumState, action: torch.Tensor):
    u = torch.clamp(action[:, 0], -MAX_TORQUE, MAX_TORQUE)
    cost = (_angle_normalize(s.theta) ** 2 + 0.1 * s.theta_dot ** 2
            + 0.001 * u ** 2)
    new_theta_dot = s.theta_dot + (
        3.0 * G / (2.0 * L) * torch.sin(s.theta) + 3.0 / (M * L ** 2) * u
    ) * DT
    new_theta_dot = torch.clamp(new_theta_dot, -MAX_SPEED, MAX_SPEED)
    new_theta = s.theta + new_theta_dot * DT
    t = s.t + 1
    s2 = PendulumState(new_theta, new_theta_dot, t)
    terminated = torch.zeros_like(t, dtype=torch.bool)
    truncated = t >= HORIZON
    return s2, obs_of(s2), -cost, terminated, truncated


@register("pendulum")
def make_pendulum() -> Env:
    spec = EnvSpec(
        name="pendulum",
        obs_dim=3,
        action_dim=1,
        horizon=HORIZON,
        gamma=0.99,
        action_low=-MAX_TORQUE,
        action_high=MAX_TORQUE,
    )
    return Env(spec=spec, reset=_reset, step=_step)

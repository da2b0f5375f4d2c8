"""Two-link planar reacher as a batched PyTorch environment.

Counterpart of ``ppoc_tpu/envs/reacher.py``: a torque-controlled double
integrator per joint with viscous damping (explicit Euler, dt 0.05); the
fingertip must reach a target drawn in the reachable annulus.  The reward
is minus the fingertip's distance to the target minus 0.01 |u|^2 of the
clipped torque.  Episodes only truncate, at 150 steps.  The reset draws
the joint angles, then the target's radius, then its angle, as the JAX
env splits its key.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

L1 = 0.5          # link lengths
L2 = 0.5
DT = 0.05
DAMPING = 0.5
ACCEL_GAIN = 8.0  # torque-to-acceleration scale
MAX_TORQUE = 1.0
MAX_SPEED = 4.0
HORIZON = 150
OBS_DIM = 10      # cos/sin q1 q2, qd1 qd2, target xy, fingertip-target delta
ACT_DIM = 2


class ReacherState(NamedTuple):
    q: torch.Tensor       # f32 [E, 2] joint angles
    qd: torch.Tensor      # f32 [E, 2] joint velocities
    target: torch.Tensor  # f32 [E, 2] target xy
    t: torch.Tensor       # int32 [E], steps since reset


def _fingertip(q: torch.Tensor) -> torch.Tensor:
    x = L1 * torch.cos(q[:, 0]) + L2 * torch.cos(q[:, 0] + q[:, 1])
    y = L1 * torch.sin(q[:, 0]) + L2 * torch.sin(q[:, 0] + q[:, 1])
    return torch.stack([x, y], dim=-1)


def obs_of(s: ReacherState) -> torch.Tensor:
    return torch.cat([torch.cos(s.q), torch.sin(s.q), s.qd / MAX_SPEED,
                      s.target, _fingertip(s.q) - s.target], dim=-1)


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (lo + (hi - lo) * u).to(device)

    q = uniform((n_envs, 2), -math.pi, math.pi)
    # target uniformly in the reachable annulus, away from the degenerate rim
    radius = uniform((n_envs,), 0.1, 0.9 * (L1 + L2))
    angle = uniform((n_envs,), -math.pi, math.pi)
    target = radius[:, None] * torch.stack([torch.cos(angle),
                                            torch.sin(angle)], dim=-1)
    s = ReacherState(q, torch.zeros_like(q), target,
                     torch.zeros(n_envs, dtype=torch.int32, device=device))
    return s, obs_of(s)


def _step(s: ReacherState, action: torch.Tensor):
    u = torch.clamp(action, -MAX_TORQUE, MAX_TORQUE)
    qdd = ACCEL_GAIN * u - DAMPING * s.qd
    qd = torch.clamp(s.qd + qdd * DT, -MAX_SPEED, MAX_SPEED)
    q = s.q + qd * DT
    t = s.t + 1
    s2 = ReacherState(q, qd, s.target, t)
    dist = torch.linalg.vector_norm(_fingertip(q) - s.target, dim=-1)
    reward = -dist - 0.01 * torch.sum(torch.square(u), dim=-1)
    terminated = torch.zeros_like(t, dtype=torch.bool)
    truncated = t >= HORIZON
    return s2, obs_of(s2), reward, terminated, truncated


@register("reacher")
def make_reacher() -> Env:
    spec = EnvSpec(
        name="reacher",
        obs_dim=OBS_DIM,
        action_dim=ACT_DIM,
        horizon=HORIZON,
        gamma=0.99,
        action_low=-MAX_TORQUE,
        action_high=MAX_TORQUE,
    )
    return Env(spec=spec, reset=_reset, step=_step)

"""CartPole-v1 dynamics as a batched PyTorch environment (discrete actions).

Counterpart of ``ppoc_tpu/envs/cartpole.py``: the Gymnasium classic-control
equations (Euler integration) in the same float32 operation order.  The
action is int32 ``[E, 1]``: class 1 pushes right (+10 N), class 0 left.
Episodes terminate when the cart leaves +-2.4 or the pole tilts past 12
degrees, and truncate at 500 steps.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5  # half the pole length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12.0 * 2.0 * math.pi / 360.0
X_THRESHOLD = 2.4
HORIZON = 500


class CartPoleState(NamedTuple):
    x: torch.Tensor          # f32 [E]
    x_dot: torch.Tensor      # f32 [E]
    theta: torch.Tensor      # f32 [E]
    theta_dot: torch.Tensor  # f32 [E]
    t: torch.Tensor          # int32 [E], steps since reset


def obs_of(s: CartPoleState) -> torch.Tensor:
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    u = torch.rand((4, n_envs), generator=generator,
                   dtype=torch.float32).to(device)
    v = -0.05 + 0.1 * u
    s = CartPoleState(v[0], v[1], v[2], v[3],
                      torch.zeros(n_envs, dtype=torch.int32, device=device))
    return s, obs_of(s)


def _step(s: CartPoleState, action: torch.Tensor):
    a = action[:, 0].to(torch.float32)
    force = torch.where(a > 0.5, FORCE_MAG, -FORCE_MAG)
    costheta = torch.cos(s.theta)
    sintheta = torch.sin(s.theta)
    temp = (force + POLEMASS_LENGTH * s.theta_dot ** 2 * sintheta) / TOTAL_MASS
    theta_acc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta ** 2 / TOTAL_MASS))
    x_acc = temp - POLEMASS_LENGTH * theta_acc * costheta / TOTAL_MASS
    x = s.x + TAU * s.x_dot
    x_dot = s.x_dot + TAU * x_acc
    theta = s.theta + TAU * s.theta_dot
    theta_dot = s.theta_dot + TAU * theta_acc
    t = s.t + 1
    s2 = CartPoleState(x, x_dot, theta, theta_dot, t)
    terminated = (x.abs() > X_THRESHOLD) | (theta.abs() > THETA_THRESHOLD)
    truncated = (t >= HORIZON) & ~terminated
    return s2, obs_of(s2), torch.ones_like(x), terminated, truncated


@register("cartpole")
def make_cartpole() -> Env:
    spec = EnvSpec(
        name="cartpole",
        obs_dim=4,
        action_dim=2,  # number of discrete actions
        horizon=HORIZON,
        gamma=0.99,
        discrete=True,
    )
    return Env(spec=spec, reset=_reset, step=_step)

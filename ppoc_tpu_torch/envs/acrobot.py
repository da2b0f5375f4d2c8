"""Acrobot-v1 dynamics as a batched PyTorch environment (discrete actions).

Counterpart of ``ppoc_tpu/envs/acrobot.py``: Gymnasium's AcrobotEnv in the
"book" convention (Sutton & Barto), one RK4 step of the 4-state ODE per
env step, both angles wrapped to [-pi, pi), both angular velocities
clipped.  The action is int32 ``[E, 1]`` in {0, 1, 2}, the torque
``a - 1``.  The reward is -1 a step and 0 on the step that terminates,
which happens when the tip rises a link's length above the pivot
(``-cos th1 - cos(th1 + th2) > 1``).  Observations are
``[cos th1, sin th1, cos th2, sin th2, th1', th2']``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

DT = 0.2
LINK_LENGTH_1 = 1.0
LINK_MASS_1 = 1.0
LINK_MASS_2 = 1.0
LINK_COM_POS_1 = 0.5
LINK_COM_POS_2 = 0.5
LINK_MOI = 1.0
MAX_VEL_1 = 4.0 * math.pi
MAX_VEL_2 = 9.0 * math.pi
G = 9.8
HORIZON = 500


class AcrobotState(NamedTuple):
    s: torch.Tensor  # f32 [E, 4]: theta1, theta2, dtheta1, dtheta2
    t: torch.Tensor  # int32 [E], steps since reset


def obs_of(st: AcrobotState) -> torch.Tensor:
    s = st.s
    return torch.stack([torch.cos(s[:, 0]), torch.sin(s[:, 0]),
                        torch.cos(s[:, 1]), torch.sin(s[:, 1]),
                        s[:, 2], s[:, 3]], dim=-1)


def _dsdt(y, a):
    """Gymnasium AcrobotEnv._dsdt, book convention, on a list of [E]
    columns (theta1, theta2, dtheta1, dtheta2) and the torque ``a``."""
    m1, m2 = LINK_MASS_1, LINK_MASS_2
    l1 = LINK_LENGTH_1
    lc1, lc2 = LINK_COM_POS_1, LINK_COM_POS_2
    i1 = i2 = LINK_MOI
    theta1, theta2, dtheta1, dtheta2 = y
    d1 = (m1 * lc1 ** 2
          + m2 * (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * torch.cos(theta2))
          + i1 + i2)
    d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(theta2)) + i2
    phi2 = m2 * lc2 * G * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (-m2 * l1 * lc2 * dtheta2 ** 2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * G * torch.cos(theta1 - math.pi / 2.0)
            + phi2)
    ddtheta2 = (a + d2 / d1 * phi1
                - m2 * l1 * lc2 * dtheta1 ** 2 * torch.sin(theta2)
                - phi2) / (m2 * lc2 ** 2 + i2 - d2 ** 2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return [dtheta1, dtheta2, ddtheta1, ddtheta2]


def _rk4_step(y, a, dt: float):
    """One RK4 step (Gymnasium's rk4 with the two time points [0, dt])."""
    k1 = _dsdt(y, a)
    k2 = _dsdt([s + dt / 2.0 * k for s, k in zip(y, k1)], a)
    k3 = _dsdt([s + dt / 2.0 * k for s, k in zip(y, k2)], a)
    k4 = _dsdt([s + dt * k for s, k in zip(y, k3)], a)
    return [s + dt / 6.0 * (p + 2 * q + 2 * r + w)
            for s, p, q, r, w in zip(y, k1, k2, k3, k4)]


def _wrap(x, lo: float, hi: float):
    return torch.remainder(x - lo, hi - lo) + lo


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    u = torch.rand((n_envs, 4), generator=generator,
                   dtype=torch.float32).to(device)
    st = AcrobotState(-0.1 + 0.2 * u,
                      torch.zeros(n_envs, dtype=torch.int32, device=device))
    return st, obs_of(st)


def _step(st: AcrobotState, action: torch.Tensor):
    torque = action[:, 0].to(torch.float32) - 1.0
    ns = _rk4_step(list(st.s.unbind(dim=1)), torque, DT)
    ns[0] = _wrap(ns[0], -math.pi, math.pi)
    ns[1] = _wrap(ns[1], -math.pi, math.pi)
    ns[2] = torch.clamp(ns[2], -MAX_VEL_1, MAX_VEL_1)
    ns[3] = torch.clamp(ns[3], -MAX_VEL_2, MAX_VEL_2)
    t = st.t + 1
    st2 = AcrobotState(torch.stack(ns, dim=1), t)
    terminated = -torch.cos(ns[0]) - torch.cos(ns[1] + ns[0]) > 1.0
    truncated = (t >= HORIZON) & ~terminated
    reward = torch.where(terminated, 0.0, -1.0)
    return st2, obs_of(st2), reward, terminated, truncated


@register("acrobot")
def make_acrobot() -> Env:
    spec = EnvSpec(
        name="acrobot",
        obs_dim=6,
        action_dim=3,  # number of discrete actions
        horizon=HORIZON,
        gamma=0.99,
        discrete=True,
    )
    return Env(spec=spec, reset=_reset, step=_step)

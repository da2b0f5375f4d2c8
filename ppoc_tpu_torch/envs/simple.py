"""1-D integrator toy environment as a batched PyTorch environment.

Counterpart of ``ppoc_tpu/envs/simple.py`` (the reference's ``simple_env``):
the state accumulates the clipped action; reward 1 and terminate on
reaching s >= 5; truncate after 15 steps.  The reset is deterministic
(s = 0) and draws nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

HORIZON = 15


class SimpleState(NamedTuple):
    s: torch.Tensor  # f32 [E] position
    t: torch.Tensor  # int32 [E], steps since reset


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    del generator
    st = SimpleState(torch.zeros(n_envs, device=device),
                     torch.zeros(n_envs, dtype=torch.int32, device=device))
    return st, st.s[:, None].clone()


def _step(st: SimpleState, action: torch.Tensor):
    s = st.s + torch.clamp(action[:, 0], -1.0, 1.0)
    t = st.t + 1
    terminated = s >= 5.0
    truncated = (t >= HORIZON) & ~terminated
    reward = terminated.to(torch.float32)
    return SimpleState(s, t), s[:, None], reward, terminated, truncated


@register("simple")
def make_simple() -> Env:
    spec = EnvSpec(
        name="simple",
        obs_dim=1,
        action_dim=1,
        horizon=HORIZON,
        gamma=0.99,
        action_low=-1.0,
        action_high=1.0,
    )
    return Env(spec=spec, reset=_reset, step=_step)

"""Recall: the memory task of the sequence model family, as a batched
PyTorch environment.

Counterpart of ``ppoc_tpu/envs/recall.py``: at reset a cue bit b in
{-1, +1} is drawn and SHOWN ONCE, in the first observation; every later
observation is blank; the only reward is 1.0 at the final step, iff the
sign of the action matches the cue.  A memoryless policy can only guess
(expected return 0.5), a policy that carries the cue scores ~1.0.

Observation: [cue (b at t=0, else 0), is_first_step flag].  The variants
differ only in their horizon: ``recall`` (6), ``recall_long`` (512),
``recall_xl`` (1024, the window at which apply_seq takes the flash kernel
K7), ``recall_xxl`` (2048), ``recall_4k``, ``recall_8k`` and
``recall_16k``.  No rollout kernel (K1) lane exists for recall, in the JAX
package or here: a sequence trunk rolls out through the decode loop
(``algo/recurrent.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .core import Env, EnvSpec, register

HORIZON = 6


class RecallState(NamedTuple):
    b: torch.Tensor  # f32 [E] cue in {-1, +1}
    t: torch.Tensor  # int32 [E] steps since reset


def obs_of(s: RecallState) -> torch.Tensor:
    first = (s.t == 0).to(torch.float32)
    return torch.stack([s.b * first, first], dim=-1)


def _reset(n_envs: int, generator: torch.Generator, device: torch.device):
    u = torch.rand((n_envs,), generator=generator,
                   dtype=torch.float32).to(device)
    s = RecallState(torch.where(u < 0.5, 1.0, -1.0),
                    torch.zeros(n_envs, dtype=torch.int32, device=device))
    return s, obs_of(s)


def _make_step(horizon: int):
    def _step(s: RecallState, action: torch.Tensor):
        t = s.t + 1
        last = t >= horizon
        reward = (last & (s.b * action[:, 0] > 0.0)).to(torch.float32)
        s2 = RecallState(s.b, t)
        return s2, obs_of(s2), reward, last, torch.zeros_like(last)

    return _step


def _make_recall(name: str, horizon: int) -> Env:
    spec = EnvSpec(name=name, obs_dim=2, action_dim=1, horizon=horizon,
                   gamma=0.99, action_low=-1.0, action_high=1.0)
    return Env(spec=spec, reset=_reset, step=_make_step(horizon))


for _name, _horizon in (("recall", HORIZON), ("recall_long", 512),
                        ("recall_xl", 1024), ("recall_xxl", 2048),
                        ("recall_4k", 4096), ("recall_8k", 8192),
                        ("recall_16k", 16384)):
    register(_name)(lambda _n=_name, _h=_horizon: _make_recall(_n, _h))

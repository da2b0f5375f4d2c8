"""Environment wrappers (counterpart of ``ppoc_tpu/envs/wrappers.py``).

Ported: :func:`normalize_obs`, the STATIC affine observation
normalisation, and the ``mountain_car_norm`` env it makes; the
config-carried :func:`affine_obs` (``cfg.obs_loc``/``obs_scale``) and
:func:`calibrate`, which measures those statistics with a random policy;
the partial observability of the recurrent family, :func:`mask_obs` (the
``pendulum_po`` and ``cartpole_po`` envs) and :func:`stack_obs` (the
memoryless route, ``pendulum_po_stack``).  Physics, rewards and episode
structure are untouched.

The host actor's running normalisers, :class:`RunningStats`,
:class:`RunningObsNorm` and :class:`RunningRewardNorm`
(``ppoc_tpu/envs/wrappers.py:258-430``), wrap a host-protocol venv
(``envs/host.py``).  They are float64 numpy on the host, with the JAX
package's update order, so their outputs equal its bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import os
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


class RunningStats:
    """Running mean and variance over observation rows: batched Welford
    (Chan's merge) in float64 on the host.  One instance is shared between
    the training and the eval venv's wrappers, so evaluation sees the
    training feature space."""

    def __init__(self, dim: int):
        self.count = 0.0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, batch: np.ndarray) -> None:
        b = np.asarray(batch, np.float64).reshape(-1, self.mean.shape[0])
        n = b.shape[0]
        if n == 0:
            return
        bmean = b.mean(axis=0)
        bm2 = np.square(b - bmean).sum(axis=0)
        tot = self.count + n
        delta = bmean - self.mean
        self.mean = self.mean + delta * (n / tot)
        self.m2 = self.m2 + bm2 + np.square(delta) * (self.count * n / tot)
        self.count = tot

    def variance(self) -> np.ndarray:
        if self.count < 1:
            return np.ones_like(self.m2)
        return self.m2 / self.count

    def normalize(self, x: np.ndarray, clip: float, eps: float = 1e-8
                  ) -> np.ndarray:
        if self.count < 2:     # no information yet: identity
            return np.asarray(x, np.float32)
        z = (np.asarray(x, np.float64) - self.mean) / np.sqrt(
            self.variance() + eps)
        return np.clip(z, -clip, clip).astype(np.float32)

    def state_dict(self) -> dict:
        return {"count": np.float64(self.count), "mean": self.mean,
                "m2": self.m2}

    def load_state_dict(self, d) -> None:
        self.count = float(d["count"])
        self.mean = np.asarray(d["mean"], np.float64).copy()
        self.m2 = np.asarray(d["m2"], np.float64).copy()

    def save(self, path: str, **extra) -> None:
        """Write the sidecar atomically (a temporary file, then a rename),
        so a crash mid-save leaves the old sidecar or the new one, never a
        truncated zip; ``extra`` scalars (clip, eps) ride along so serving
        replays the exact normalisation."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **self.state_dict(), **extra)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "RunningStats":
        d = np.load(path)
        out = cls(int(np.asarray(d["mean"]).shape[0]))
        out.load_state_dict(d)
        return out


class RunningObsNorm:
    """Host-protocol venv wrapper: observations normalised by the running
    mean and variance.  The statistics update on the actor side only
    (``update=False``, with a shared ``stats``, for the eval venv, which
    reads them without writing)."""

    def __init__(self, venv, stats: Optional[RunningStats] = None,
                 update: bool = True, clip: float = 10.0, eps: float = 1e-8):
        self.venv = venv
        self.spec = venv.spec
        self.n_envs = venv.n_envs
        self.stats = RunningStats(venv.spec.obs_dim) if stats is None else stats
        self.update = update
        self.clip = float(clip)
        self.eps = float(eps)

    def _norm(self, x: np.ndarray) -> np.ndarray:
        return self.stats.normalize(x, self.clip, self.eps)

    def reset(self) -> np.ndarray:
        obs = self.venv.reset()
        if self.update:
            self.stats.update(obs)
        return self._norm(obs)

    def step(self, actions: np.ndarray):
        obs_after, next_obs, reward, term, trunc = self.venv.step(actions)
        if self.update:
            self.stats.update(obs_after)
        # both streams with the same (post-update) statistics, so the GAE
        # bootstrap V(next_obs) and the policy input agree; next_obs
        # differs from obs_after only at done rows, so only those are
        # normalised again
        n_after = self._norm(obs_after)
        done = np.nonzero(np.asarray(term) | np.asarray(trunc))[0]
        if done.size == 0:
            n_next = n_after
        else:
            n_next = n_after.copy()
            n_next[done] = self._norm(next_obs[done])
        return n_after, n_next, reward, term, trunc

    def close(self):
        self.venv.close()


class RunningRewardNorm:
    """Host-protocol venv wrapper: rewards divided (not centred) by the
    running standard deviation of the discounted return G_t = gamma
    G_{t-1} + r_t per env, reset at episode ends.  For the training venv
    only: evaluation reports raw-reward J and R.  The obs statistics of an
    inner :class:`RunningObsNorm` pass through as ``stats``."""

    def __init__(self, venv, gamma: float, clip: float = 10.0,
                 eps: float = 1e-8, update: bool = True,
                 ret_stats: Optional[RunningStats] = None):
        self.venv = venv
        self.spec = venv.spec
        self.n_envs = venv.n_envs
        self.gamma = float(gamma)
        self.clip = float(clip)
        self.eps = float(eps)
        self.update = update
        self.ret_stats = RunningStats(1) if ret_stats is None else ret_stats
        self._ret = np.zeros(venv.n_envs, np.float64)

    @property
    def stats(self):
        return getattr(self.venv, "stats", None)

    def reset(self) -> np.ndarray:
        self._ret[:] = 0.0
        return self.venv.reset()

    def step(self, actions: np.ndarray):
        obs_after, next_obs, reward, term, trunc = self.venv.step(actions)
        r = np.asarray(reward, np.float64)
        self._ret = self.gamma * self._ret + r
        if self.update:
            self.ret_stats.update(self._ret[:, None])
        done = np.asarray(term) | np.asarray(trunc)
        self._ret[done] = 0.0
        if self.ret_stats.count >= 2:
            scale = np.sqrt(self.ret_stats.variance()[0] + self.eps)
            r = np.clip(r / scale, -self.clip, self.clip)
        return obs_after, next_obs, r.astype(np.float32), term, trunc

    def close(self):
        self.venv.close()

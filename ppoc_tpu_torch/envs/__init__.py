"""Batched PyTorch environments (counterpart of ``ppoc_tpu.envs``).

Ported: Pendulum, the simple integrator, MountainCarContinuous (raw and
with normalised observations, ``mountain_car_norm``) and the two-link
reacher (continuous), CartPole and Acrobot (discrete), and the recall
memory tasks of the sequence trunks (``recall`` ... ``recall_16k``).  Of
the wrappers the static ``normalize_obs`` and the config-carried
``affine_obs`` (with ``calibrate``) are ported.
"""
from .core import (Env, EnvSpec, make, register, vector_autoreset_step,
                   vector_reset)
from . import acrobot as _acrobot  # noqa: F401  (registers "acrobot")
from . import cartpole as _cartpole  # noqa: F401  (registers "cartpole")
from . import mountain_car as _mountain_car  # noqa: F401  ("mountain_car")
from . import pendulum as _pendulum  # noqa: F401  (registers "pendulum")
from . import reacher as _reacher  # noqa: F401  (registers "reacher")
from . import recall as _recall  # noqa: F401  (registers "recall", ...)
from . import simple as _simple  # noqa: F401  (registers "simple")
from . import wrappers as _wrappers  # noqa: F401  ("mountain_car_norm")


def make_for(cfg) -> Env:
    """Build the env a config describes: the registry env, wrapped in the
    config-carried affine observation normalisation when ``cfg.obs_loc``
    is set (``wrappers.affine_obs``).  The one construction point for the
    Trainer and serving, as ``ppoc_tpu.envs.make_for``."""
    env = make(cfg.env)
    loc = getattr(cfg, "obs_loc", ())
    scale = getattr(cfg, "obs_scale", ())
    if bool(loc) != bool(scale):
        raise ValueError(
            "obs_loc and obs_scale must be set together (one without the "
            "other would silently skip normalization)")
    if loc:
        if len(loc) != env.spec.obs_dim or len(scale) != len(loc):
            raise ValueError(
                f"obs_loc/obs_scale must have length obs_dim "
                f"({env.spec.obs_dim}), got {len(loc)}/{len(scale)}")
        if any(s == 0.0 for s in scale):
            raise ValueError(
                f"obs_scale contains a zero (division by zero in the "
                f"affine map): {scale}")
        env = _wrappers.affine_obs(env, loc, scale)
    return env


__all__ = [
    "Env",
    "EnvSpec",
    "make",
    "make_for",
    "register",
    "vector_reset",
    "vector_autoreset_step",
]

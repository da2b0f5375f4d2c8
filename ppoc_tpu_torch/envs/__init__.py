"""Batched PyTorch environments (counterpart of ``ppoc_tpu.envs``).

Ported: Pendulum, the simple integrator, MountainCarContinuous (raw and
with normalised observations, ``mountain_car_norm``) and the two-link
reacher (continuous), CartPole and Acrobot (discrete), and the recall
memory tasks of the sequence trunks (``recall`` ... ``recall_16k``).  Of
the wrappers only the static ``normalize_obs`` is ported.
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
    """Build the env a config describes.  The affine observation wrapper
    (``cfg.obs_loc``/``cfg.obs_scale``) is not ported yet and is refused
    rather than skipped."""
    if getattr(cfg, "obs_loc", ()) or getattr(cfg, "obs_scale", ()):
        raise NotImplementedError(
            "obs_loc/obs_scale (envs.wrappers.affine_obs) are not ported yet")
    return make(cfg.env)


__all__ = [
    "Env",
    "EnvSpec",
    "make",
    "make_for",
    "register",
    "vector_reset",
    "vector_autoreset_step",
]

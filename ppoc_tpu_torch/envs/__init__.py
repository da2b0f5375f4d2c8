"""Batched PyTorch environments (counterpart of ``ppoc_tpu.envs``).

Ported: Pendulum (continuous), CartPole and Acrobot (discrete), and the
recall memory tasks of the sequence trunks (``recall`` ... ``recall_16k``).
The other environments (simple, mountain_car, reacher) and the wrappers
follow in later slices.
"""
from .core import (Env, EnvSpec, make, register, vector_autoreset_step,
                   vector_reset)
from . import acrobot as _acrobot  # noqa: F401  (registers "acrobot")
from . import cartpole as _cartpole  # noqa: F401  (registers "cartpole")
from . import pendulum as _pendulum  # noqa: F401  (registers "pendulum")
from . import recall as _recall  # noqa: F401  (registers "recall", ...)


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

"""Batched PyTorch environments (counterpart of ``ppoc_tpu.envs``).

Only Pendulum is ported so far; the other environments and the wrappers
follow in later slices.
"""
from .core import (Env, EnvSpec, make, register, vector_autoreset_step,
                   vector_reset)
from . import pendulum as _pendulum  # noqa: F401  (registers "pendulum")


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

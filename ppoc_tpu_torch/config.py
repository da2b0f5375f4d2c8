"""Training configuration, shared with the JAX package.

``ppoc_tpu.config`` is a plain dataclass module that imports neither jax nor
anything heavy, so the port re-exports it: one ``PPOConfig`` and one
``validate`` drive both packages and cannot drift apart.
"""
from ppoc_tpu.config import PPOConfig, reference_preset, tpu_preset, validate

__all__ = ["PPOConfig", "reference_preset", "tpu_preset", "validate"]

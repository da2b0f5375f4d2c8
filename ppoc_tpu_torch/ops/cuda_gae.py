"""K2: fused GAE + advantage normalisation (``csrc/gae.cu``) and its plain
version.

Counterpart of ``ppoc_tpu/ops/pallas_gae.py`` ``gae_norm_fused``: deltas,
the backward recurrence (``term`` gates the bootstrap, ``term | trunc`` the
recurrence), value targets V + A, then (A - mean) / (sqrt(var) + 1e-8) with
the population moments.  A CUDA tensor launches the kernel, a CPU tensor
runs :func:`gae_norm_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ppoc_tpu_torch.ops import _build, gae as gae_ops

launches = _build.LaunchCount("gae_norm")


def gae_norm_plain(rewards, values, next_values, terminated, truncated,
                   gamma: float, lam: float,
                   normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the sequential recurrence, then two-pass
    population moments, as the kernel computes them."""
    adv, tgt = gae_ops.gae_reference(rewards, values, next_values,
                                     terminated, truncated, gamma, lam)
    if normalize:
        n = adv.numel()
        mean = adv.sum() / n
        var = ((adv - mean) ** 2).sum() / n
        adv = (adv - mean) / (torch.sqrt(var) + 1e-8)
    return adv, tgt


def _declare() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_gae_declared", False):
        p = ctypes.c_void_p
        lib.ppoc_gae_norm.argtypes = [p, p, p, p, p, p, p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_int, p]
        lib.ppoc_gae_norm.restype = ctypes.c_int
        lib._gae_declared = True
    return lib


def gae_norm_kernel(rewards, values, next_values, terminated, truncated,
                    gamma: float, lam: float,
                    normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; same arguments and results as gae_norm_plain."""
    T, E = rewards.shape
    dev = rewards.device
    for name, t in (("rewards", rewards), ("values", values),
                    ("next_values", next_values)):
        _build.require(t, name, (T, E), device=dev)
    for name, t in (("terminated", terminated), ("truncated", truncated)):
        _build.require(t, name, (T, E), dtype=torch.bool, device=dev)
    adv = torch.empty(T, E, dtype=torch.float32, device=dev)
    tgt = torch.empty(T, E, dtype=torch.float32, device=dev)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, lib.ppoc_gae_norm(
        p(rewards), p(values), p(next_values), p(terminated), p(truncated),
        p(adv), p(tgt), T, E, gamma, gamma * lam, int(normalize),
        _build.stream_of(dev)), "gae kernel")
    launches.n += 1
    return adv, tgt


def gae_norm_fused(rewards, values, next_values, terminated, truncated,
                   gamma: float, lam: float,
                   normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, normalised if asked; value targets), [T, E]."""
    run = gae_norm_kernel if rewards.is_cuda else gae_norm_plain
    return run(rewards, values, next_values, terminated, truncated, gamma,
               lam, normalize)

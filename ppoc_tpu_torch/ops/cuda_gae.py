"""K2: fused GAE + advantage normalisation (``csrc/gae.cu``) and its plain
version.

Counterpart of ``ppoc_tpu/ops/pallas_gae.py`` ``gae_norm_fused``: deltas,
the backward recurrence (``term`` gates the bootstrap, ``term | trunc`` the
recurrence), value targets V + A, then (A - mean) / (sqrt(var) + 1e-8) with
the population moments.  A CUDA tensor launches the kernel, a CPU tensor
runs :func:`gae_norm_plain`.

The kernel is one thread-block cluster whose blocks split the env columns
(:func:`plan`, the kernel's own rule in Python): one block where the whole
buffer's deltas and done flags fit its shared memory, else up to 16 blocks
of a multiple of 32 columns each, taking the steps in chunks where a
block's columns do not fit.  The unnormalised advantages and the targets
are the same bits in every plan; the moments are summed in rank order over
the blocks, so with several blocks the normalised advantages may differ
from one block's in the last bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ppoc_tpu_torch.ops import _build, gae as gae_ops

launches = _build.LaunchCount("gae_norm")

# csrc/gae.cu: the largest cluster, a block's dynamic shared memory, and
# the bytes an element takes there (its delta and its done flag)
MAX_BLOCKS, SMEM, ELEMENT_BYTES = 16, 224 * 1024, 5


class Plan(NamedTuple):
    blocks: int   # blocks in the cluster
    cols: int     # env columns a block (the last may hold fewer)
    rows: int     # steps a chunk: T when every step fits shared memory
    smem: int     # dynamic shared-memory bytes a block


def plan(T: int, E: int) -> Plan:
    """The launch K2 takes for a [T, E] buffer (csrc/gae.cu ``gae_plan``):
    one block of every column where T * E elements fit its shared memory,
    else ceil(E / 16) columns a block rounded up to a multiple of 32 (so at
    most 16 blocks).  Past a block's shared memory the steps go in chunks
    of ``rows``, each column's carry in shared memory.  Raises where the
    kernel takes no launch."""
    if T < 1 or E < 1:
        raise ValueError(f"K2 takes T, E >= 1, got {T} x {E}")
    cols = E
    if ELEMENT_BYTES * T * E > SMEM:
        per = -(-E // MAX_BLOCKS)
        cols = min(E, 32 * -(-per // 32))
    blocks = -(-E // cols)
    rows = T
    if ELEMENT_BYTES * T * cols > SMEM:
        rows = (SMEM - 4 * cols - 4) // (ELEMENT_BYTES * cols)
        if rows < 1:
            raise ValueError(f"K2 cannot hold one step of {cols} columns")
    smem = 4 * rows * cols + ((rows * cols + 3) & ~3) + (
        4 * cols if rows < T else 0)
    return Plan(blocks, cols, rows, smem)


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
        lib.ppoc_gae_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_long)]
        lib.ppoc_gae_plan.restype = ctypes.c_int
        lib._gae_declared = True
    return lib


def kernel_plan(T: int, E: int) -> Plan:
    """The plan the built kernel takes (``ppoc_gae_plan``), for holding
    :func:`plan` to it on the card."""
    lib = _declare()
    out = (ctypes.c_long * 4)()
    _build.check(lib, lib.ppoc_gae_plan(T, E, out), "K2 plan")
    return Plan(*out)


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

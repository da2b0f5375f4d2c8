"""Tracing and throughput helpers (counterpart of
``ppoc_tpu/utils/profiling.py``).

The reference's whole observability layer is ``clock()`` around each epoch
printed as ``Time %fs`` (src/main.c:51-54).  Here: :func:`trace`, a
``torch.profiler`` window over the host and the card whose Chrome trace
(with each hand kernel's name) lands in a directory; :func:`sync`, which
waits for the work behind a tree of tensors; and :class:`ThroughputMeter`,
env-steps per second over timed sections that end in a sync.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Profile the enclosed work, CPU and CUDA activity, and write its
    Chrome trace (viewable in Perfetto or chrome://tracing) to
    ``log_dir/trace_<pid>.json``; yields the profiler.  The CUDA activity
    is recorded where CUDA is available.  Usage::

        with profiling.trace("traces"):
            trainer.train_epoch()
            sync(trainer.state)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def sync(tree: Any) -> None:
    """Wait until the work behind every tensor leaf of ``tree`` is done:
    ``torch.cuda.synchronize`` on each CUDA device the leaves live on (CPU
    tensors are complete when they exist)."""
    for dev in {t.device for t in _leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class ThroughputMeter:
    """Steps per second over timed sections: the reference's per-epoch
    clock() (src/main.c:51-54), with the env-steps/s the scaling metric
    needs.  A section ends with :func:`sync` of ``sync_on``, so the time
    covers the device's work and not only its launch."""

    def __init__(self) -> None:
        self.total_steps = 0
        self.total_seconds = 0.0
        self._t0: Optional[float] = None

    @contextlib.contextmanager
    def section(self, n_steps: int, sync_on: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            sync(sync_on)
        self.total_seconds += time.perf_counter() - t0
        self.total_steps += n_steps

    @property
    def steps_per_second(self) -> float:
        return (self.total_steps / self.total_seconds
                if self.total_seconds else 0.0)

    def report(self) -> Dict[str, float]:
        return {"env_steps": float(self.total_steps),
                "seconds": self.total_seconds,
                "env_steps_per_s": self.steps_per_second}

"""Numerical-safety tooling: NaN hunting and checked calls (counterpart of
``ppoc_tpu/utils/debug.py``).

The reference's sanitiser layer is ``cudaCheckErrors()``, a debug-build
device sync and error check after every kernel launch
(include/cuda_helper.h:4-19).  What remains to catch is numerical (NaN or
Inf from exploding ratios or bad advantages):

  * :func:`nan_guard`, the analogue of ``jax_debug_nans``: within its
    scope a ``TorchDispatchMode`` checks every floating output of every
    torch op and raises ``FloatingPointError`` at the op that first
    produced a NaN or an Inf (a host sync per op: a debugging tool);
  * :func:`checked`, the analogue of ``checkify``: ``checked(fn)(*args)``
    returns ``(error, output)``, where ``error.throw()`` raises when any op
    under it, or any floating leaf of the output, held a NaN or an Inf.

What they cannot see: the writes a hand kernel makes through a raw pointer
(``ops/cuda_*.py`` launch through ctypes, not as torch ops).  A kernel's
NaN shows only when a torch op reads the tensor it wrote, or when
``checked`` scans the outputs.  Uninitialised allocations (``empty`` and
its kin, whose bytes a kernel overwrites) and views are not checked: their
values are checked where an op writes them.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose outputs are uninitialised memory, for a kernel or a later op
# to fill: never checked
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "set_"}

# is the innermost nan_guard / checked scope of this thread checking?
_scopes = threading.local()


def _checking() -> bool:
    return getattr(_scopes, "on", False)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bad(t) -> bool:
    """Is ``t`` a floating tensor holding a NaN or an Inf?"""
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and not bool(torch.isfinite(t).all()))


def _unchecked(func) -> bool:
    """An op whose outputs hold no new values: an uninitialised allocation,
    or a view (its values were checked where they were written, or are an
    allocation's bytes not written yet); in-place ops are checked."""
    rets = func._schema.returns
    return (func.overloadpacket.__name__ in _UNINITIALISED
            or (bool(rets) and all(r.alias_info is not None
                                   and not r.alias_info.is_write
                                   for r in rets)))


class _NanMode(TorchDispatchMode):
    """Check each op's floating outputs; raise at the first NaN or Inf, or
    (``found`` given) note the first and go on."""

    def __init__(self, found: Optional[list] = None):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _checking() and not _unchecked(func) \
                and any(_bad(t) for t in _leaves(out)):
            msg = f"{func} produced NaN or Inf"
            if self.found is None:
                raise FloatingPointError(msg)
            if not self.found:
                self.found.append(msg)
        return out


@contextlib.contextmanager
def _scope(enable: bool, found: Optional[list] = None) -> Iterator[None]:
    prev = _checking()
    _scopes.on = enable
    try:
        if enable:
            with _NanMode(found):
                yield
        else:
            yield
    finally:
        _scopes.on = prev


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Within the scope every torch op's floating outputs are checked, and
    the op that first produces a NaN or an Inf raises FloatingPointError
    (``enable=False`` turns the checks off inside an enclosing guard); the
    previous state returns on exit."""
    with _scope(enable):
        yield


class CheckError:
    """The outcome of a :func:`checked` call: ``get()`` is the first
    fault's message or None; ``throw()`` raises FloatingPointError with it."""

    def __init__(self, msg: Optional[str] = None):
        self.msg = msg

    def get(self) -> Optional[str]:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise FloatingPointError(self.msg)


def checked(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` with NaN/Inf checks: the returned callable gives ``(error,
    output)``, the error noting the first op under it that produced a NaN
    or an Inf, else the first floating output leaf that holds one.  Use on
    ``ppo.fit_step`` when a run diverges::

        f = debug.checked(functools.partial(ppo.fit_step, cfg, env))
        err, (state, metrics) = f(state, draws)
        err.throw()
    """
    @functools.wraps(fn)
    def run(*args, **kwargs):
        found: list = []
        with _scope(True, found):
            out = fn(*args, **kwargs)
        if not found:
            bad = [i for i, t in enumerate(_leaves(out)) if _bad(t)]
            if bad:
                found.append(f"output leaf {bad[0]} holds NaN or Inf")
        return CheckError(found[0] if found else None), out

    return run

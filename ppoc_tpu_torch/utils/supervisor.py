"""Elastic recovery: checkpoint-based restart supervision.

Counterpart of ``ppoc_tpu/utils/supervisor.py``.  Frequent self-describing
checkpoints (``utils/checkpoint.py``, written with an ``epochs_done``
counter) and a supervisor that relaunches a crashed or preempted run from
the newest checkpoint until the original schedule completes:

  * :func:`supervise`, the restart loop: runs the training command; on a
    non-zero exit it relaunches with ``restart_argv`` once a checkpoint of
    this supervision exists (a crash before any checkpoint retries the
    original argv).  Exit code 0 stops; ``max_restarts`` bounds
    crash-looping.
  * CLI ``--supervise N`` (``ppoc_tpu_torch/cli.py``) builds the restart
    argv (:func:`build_restart_argv`): ``--resume CKPT``, bit for bit, the
    remaining epochs from the checkpoint's ``epochs_done``; a gym
    host-bridge env ``--load CKPT`` on its own flags.
  * Graceful preemption: the supervised child traps SIGTERM, finishes the
    epoch, checkpoints and exits with :data:`PREEMPTED_EXIT`.
    ``PPOC_FAULT_EPOCH=k`` hard-kills the child right after global epoch
    k's checkpoint, for drills.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

# child exited after a graceful SIGTERM checkpoint; always restartable
PREEMPTED_EXIT = 75  # EX_TEMPFAIL


def _default_runner(argv: Sequence[str]) -> int:
    return subprocess.call([sys.executable, "-m", "ppoc_tpu_torch", *argv])


def supervise(
    first_argv: Sequence[str],
    restart_argv: Sequence[str],
    checkpoint_path: str,
    max_restarts: int = 10,
    backoff_s: float = 1.0,
    runner: Optional[Callable[[Sequence[str]], int]] = None,
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr,
                                                 flush=True),
) -> int:
    """Run ``first_argv``; on failure, rerun ``restart_argv`` (or
    ``first_argv`` again while no checkpoint exists yet) until success or
    ``max_restarts`` restarts are spent.  Returns the final exit code.
    ``runner`` (argv -> exit code) defaults to ``python -m
    ppoc_tpu_torch`` in a subprocess; tests pass fakes."""
    runner = _default_runner if runner is None else runner
    argv: List[str] = list(first_argv)
    # only checkpoints written during this supervision count: a stale file
    # at the same path must not hijack the restart (on --resume the config
    # comes entirely from the file)
    started = time.time()

    def _fresh_checkpoint() -> bool:
        try:
            return os.path.getmtime(checkpoint_path) >= started
        except OSError:
            return False

    for attempt in range(max_restarts + 1):
        rc = runner(argv)
        if rc == 0:
            if attempt:
                log(f"supervisor: run completed after {attempt} restart(s)")
            return 0
        if attempt == max_restarts:
            log(f"supervisor: giving up after {max_restarts} restarts "
                f"(last exit code {rc})")
            return rc
        if _fresh_checkpoint():
            argv = list(restart_argv)
            why = "resuming from checkpoint"
        else:
            argv = list(first_argv)
            why = "no checkpoint from this run yet, retrying from scratch"
        kind = "preempted" if rc == PREEMPTED_EXIT else f"exit code {rc}"
        log(f"supervisor: run {kind}; restart {attempt + 1}/{max_restarts} "
            f"({why})")
        if backoff_s:
            time.sleep(backoff_s)
    return rc  # pragma: no cover (the loop always returns)


def build_restart_argv(argv: Sequence[str], checkpoint_path: str,
                       gym_env: bool = False) -> List[str]:
    """A CLI argv in its crash-restart form: any --load / --resume /
    --import-ref, --calibrate (a fresh-run flag: its statistics live in
    the checkpoint's config) and the --supervise flag itself are stripped,
    then the run is pointed at the checkpoint.  An on-device env restarts
    with ``--resume CKPT`` (bit for bit; --n-epochs is stripped too, since
    on --resume it means "this many more", and a restart finishes the
    original schedule from the file's epochs_done).  A gym host-bridge env
    (``gym_env``) restarts from its flags with ``--load CKPT``, keeping
    --n-epochs: the optimisation state exact, the episodes fresh
    (``ppoc_tpu/utils/supervisor.py:103-145``)."""
    out: List[str] = []
    skip = False
    drop_with_value = {"--load", "--resume", "--import-ref", "--supervise"}
    if not gym_env:
        drop_with_value.add("--n-epochs")
    for a in argv:
        if skip:
            skip = False
            continue
        if a in drop_with_value:
            skip = True
            continue
        if a == "--calibrate":
            continue
        if any(a.startswith(d + "=") for d in drop_with_value):
            continue
        out.append(a)
    return out + (["--load", checkpoint_path] if gym_env
                  else ["--resume", checkpoint_path])

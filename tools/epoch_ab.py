"""One epoch's wall on the card for each of several checkouts, in turn.

    python3 tools/epoch_ab.py ROOT [ROOT ...] [--config jnp]

For each ROOT (a checkout of this repo, e.g. a ``git archive`` of another
commit unpacked under ``build/``) in a process of its own: build
``Trainer`` on CUDA device 0 from that checkout's ``chip_smoke.py``
config (``jnp``: ``bench_config(0)`` on the "jnp" backend, no kernel and
so no build; ``stab``: ``stab_config(0)``), train one epoch to warm up,
then time one more epoch.  Prints one line per ROOT.  Give the roots as
A B B A to compare two trees on one host.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

CONFIGS = {"jnp": lambda cs: cs.bench_config(0).replace(kernel_backend="jnp"),
           "stab": lambda cs: cs.stab_config(0)}


def one(root: str, config: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    import ppoc_tpu_torch
    from ppoc_tpu_torch.algo.trainer import Trainer

    assert ppoc_tpu_torch.__file__.startswith(root), ppoc_tpu_torch.__file__
    tr = Trainer(CONFIGS[config](chip_smoke))
    tr.train_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_epoch()
    torch.cuda.synchronize()
    print(f"{root}: {config} epoch {time.perf_counter() - t0:.3f} s",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--config", choices=list(CONFIGS), default="jnp")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.roots[0], args.config)
        return 0
    for root in args.roots:
        root = str(Path(root).resolve())
        subprocess.run([sys.executable, __file__, root, "--one",
                        "--config", args.config], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

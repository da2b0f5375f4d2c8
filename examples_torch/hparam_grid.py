"""Hyperparameter grid search over lanes, each solving to the threshold.

The port of ``examples/hparam_grid.py``.  Runs the reference Pendulum
schedule (src/main.c:33-43 semantics) over a (lr_policy x clip_eps) grid
crossed with seeds -- every lane trains to the solve threshold
(``ppoc_tpu_torch.sweep.solve_grid``).  The JAX package runs a grid's
lanes as one vmapped program; the port runs them one after another, each
lane a ``Trainer.solve`` on the hand kernels (K1-K4), so a grid costs the
sum of its lanes' walls.  The second (zoomed) grid below changes only
the values.  The card's walls: PERF.md §6.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU.

Usage: python examples_torch/hparam_grid.py [max_epochs]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import sweep
from ppoc_tpu_torch.algo.trainer import platform_device
from ppoc_tpu_torch.config import reference_preset

CFG = reference_preset("pendulum")
AXES = {"lr_policy": [1e-4, 3e-4, 1e-3], "clip_eps": [0.1, 0.2, 0.3]}
SEEDS = [0, 1]


def show(tag, axes, out, secs):
    print(f"\n{tag}: {len(out['combos'])} lanes, one after another "
          f"({secs:.2f} s wall)")
    print(f"  axes: {axes}")
    for c, e, r in zip(out["combos"], out["epochs"], out["R"]):
        hp = {k: v for k, v in c.items() if k != "seed"}
        mark = " <- best" if c is out["combos"][out["best"]] else ""
        print(f"  {hp} seed={c['seed']}: epochs={e:3d} R={r:8.1f}{mark}")


def main(argv) -> int:
    max_epochs = int(argv[1]) if len(argv) > 1 else 30
    device = platform_device()

    t0 = time.perf_counter()
    out = sweep.solve_grid(CFG, AXES, target_R=-200.0, seeds=SEEDS,
                           max_epochs=max_epochs, device=device)
    show("grid 1", AXES, out, time.perf_counter() - t0)

    # zoom around the winner: the same axis names and lane count, new values
    best = out["combos"][out["best"]]
    lr, ce = best["lr_policy"], best["clip_eps"]
    axes2 = {"lr_policy": [lr / 1.5, lr, lr * 1.5],
             "clip_eps": [ce - 0.05, ce, ce + 0.05]}
    t0 = time.perf_counter()
    out2 = sweep.solve_grid(CFG, axes2, target_R=-200.0, seeds=SEEDS,
                            max_epochs=max_epochs, device=device)
    show("grid 2 (zoomed)", axes2, out2, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

"""Epochs to solve Pendulum of the JAX package, over seeds, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_seed_solve.py [--configs stab moe]
        [--seeds 0 1 2 3 4]

The reference figures beside ``tools/seed_parity.py``'s stabiliser and
mixture-of-experts runs on the card: ``ppoc_tpu``'s ``Trainer(cfg).solve(
-200, 40)`` on the "jnp" backend, where ``cfg`` is chip_smoke.py's
``stab_config(seed)`` (bench_config with max_grad_norm 0.5, clip_value 0.2,
target_kl 0.02, lr and entropy annealing, ent_coeff 0.01) or
``moe_config(seed)`` (examples/moe_expert_parallel.py's single-device
mixture: 4 experts, dense gating), each converted field for field.  Prints
one JSON line per (config, seed): epochs, final R and the wall on this
host's CPU, compile included.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SOLVE_R = -200.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["stab", "moe"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--max-epochs", type=int, default=40)
    args = ap.parse_args()

    import jax

    from chip_smoke import moe_config, stab_config
    from ppoc_tpu import PPOConfig
    from ppoc_tpu.algo.trainer import Trainer

    make = {"stab": stab_config, "moe": moe_config}
    for name in args.configs:
        for seed in args.seeds:
            cfg = PPOConfig(**dict(dataclasses.asdict(make[name](seed)),
                                   kernel_backend="jnp"))
            t0 = time.perf_counter()
            res = Trainer(cfg).solve(SOLVE_R, max_epochs=args.max_epochs)
            print(json.dumps({
                "config": name, "seed": seed, "epochs": int(res["epochs"]),
                "R": float(res["R"]), "wall_s": time.perf_counter() - t0,
                "jax": jax.__version__, "device": "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

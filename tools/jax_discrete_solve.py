"""Epochs to solve of the JAX package on the discrete envs, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_discrete_solve.py [--seeds 0 1 2]

The reference figures beside the port's own CartPole and Acrobot solves
(chip_smoke.py): ``ppoc_tpu``'s ``Trainer(cfg).solve(target, 40)`` at
chip_smoke's ``bench_config`` with ``env`` set and ``eval_len=500`` (64 envs
x 200 steps, minibatch 256, 4 fits per epoch), on the "jnp" backend
(interpret-mode Pallas would take hours on a CPU).  Targets: 475 for
cartpole (Gymnasium's CartPole-v1 threshold), -100 for acrobot.  Prints one
JSON line per (env, seed): epochs, final R and the wall on this host's CPU,
compile included.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TARGETS = {"cartpole": 475.0, "acrobot": -100.0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--envs", nargs="+", default=list(TARGETS))
    ap.add_argument("--max-epochs", type=int, default=40)
    args = ap.parse_args()

    import jax

    from ppoc_tpu import PPOConfig
    from ppoc_tpu.algo.trainer import Trainer

    for env in args.envs:
        for seed in args.seeds:
            cfg = PPOConfig(env=env, seed=seed, n_envs=64, rollout_len=200,
                            minibatch_size=256, fits_per_epoch=4,
                            eval_envs=64, eval_len=500, kernel_backend="jnp")
            t0 = time.perf_counter()
            res = Trainer(cfg).solve(TARGETS[env], max_epochs=args.max_epochs)
            print(json.dumps({
                "env": env, "seed": seed, "epochs": int(res["epochs"]),
                "R": float(res["R"]), "target": TARGETS[env],
                "wall_s": time.perf_counter() - t0,
                "jax": jax.__version__, "device": "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

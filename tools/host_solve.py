"""Epochs to solve Pendulum through the host actor, in either package.

    JAX_PLATFORMS=cpu python3 tools/host_solve.py --package jax [--seeds 0]
    python3 tools/host_solve.py --package port [--actor host --overlap]
        [--device cpu]

``HostTrainer(bench_config(seed), NativeHostVecEnv("pendulum", 64),
NativeHostVecEnv("pendulum", 64), actor=...).train(n_epochs=40,
stop_at_R=-200)``: chip_smoke.py's HOST_SOLVE (bench_config: 64 envs x 200
steps, minibatch 256, 4 fits an epoch), the trajectory stepped by the C++
engine on the host.  ``--package jax`` runs ``ppoc_tpu.envs.host`` on the
CPU on the "jnp" backend (its default); ``--package port`` runs
``ppoc_tpu_torch.envs.host`` on CUDA device 0 (``--device cpu``: the CPU)
on bench_config's "pallas".  Prints one JSON line a seed: the epochs, the
R curve, the wall (the JAX package's compiles included) and the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SOLVE_R = -200.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "port"], required=True)
    ap.add_argument("--actor", choices=["device", "host"], default="device")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--max-epochs", type=int, default=40)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    from chip_smoke import bench_config

    if args.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        from ppoc_tpu import PPOConfig
        from ppoc_tpu.envs import host

        version, where = f"jax {jax.__version__}", "cpu"
    else:
        import torch

        from ppoc_tpu_torch.envs import host

        version = f"torch {torch.__version__}"
        where = (torch.cuda.get_device_name(0) if args.device is None
                 else args.device)
    for seed in args.seeds:
        cfg = bench_config(seed)
        kw = dict(actor=args.actor, overlap=args.overlap)
        if args.package == "jax":
            cfg = PPOConfig(**dataclasses.asdict(cfg))
        else:
            kw["device"] = args.device
        tr = host.HostTrainer(cfg, host.NativeHostVecEnv("pendulum",
                                                         cfg.n_envs),
                              host.NativeHostVecEnv("pendulum",
                                                    cfg.eval_envs), **kw)
        t0 = time.perf_counter()
        hist = tr.train(n_epochs=args.max_epochs, log=False,
                        stop_at_R=SOLVE_R)
        print(json.dumps({
            "package": args.package, "seed": seed, "actor": args.actor,
            "overlap": args.overlap, "backend": tr.backend,
            "epochs": len(hist), "solved": hist[-1]["R"] >= SOLVE_R,
            "R": [round(h["R"], 3) for h in hist],
            "wall_s": time.perf_counter() - t0, "version": version,
            "device": where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Solve parity over seeds on the card: the port's epochs to solve Pendulum
against the JAX package's.

    python3 tools/seed_parity.py [--configs bench_config reference
        stab_bench moe_dense] [--seeds N]

Runs ``Trainer(cfg(seed)).solve(-200, 40)`` on CUDA device 0 for each
config: ``bench_config`` (64 envs x 200 steps, minibatch 256, 4 fits an
epoch; seeds 0..19), the reference schedule ``reference_preset`` (15 x
200, minibatch 64, 10 fits; 0..9), ``stab_bench`` (chip_smoke's
``stab_config``: bench_config with the five stabilisers; 0..4) and
``moe_dense`` (chip_smoke's ``moe_config``: the MoE example's 4-expert
mixture, dense gating; 0..4); ``--seeds`` caps every config's count.
Prints the card's name and power limit, the epochs and final R per seed,
each config's mean, and a two-sided Mann-Whitney U test against the JAX
package's epochs on its "jnp" backend (``JAX_JNP_EPOCHS``) and, where
tabulated, against the port's own plain versions on the CPU
(``PORT_CPU_EPOCHS``), all from CPU runs: bench_config and the reference
schedule's in ROADMAP.md §1 A item 2 (torch 2.13, jax 0.9.0, the tree at
2da26c8), stab_bench's and moe_dense's from ``tools/jax_seed_solve.py``
(jax 0.9.0); the JAX package is not rerun here.  Writes the same as JSON
to ``chiprun_out/seed_parity.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOLVE_R = -200.0
MAX_EPOCHS = 40
JAX_JNP_EPOCHS = {
    "bench_config": [6, 5, 6, 5, 5, 4, 5, 4, 4, 5, 5, 6, 4, 4, 5, 8, 6, 4, 4,
                     7],
    "reference": [6, 3, 4, 7, 3, 4, 5, 40, 13, 3],
    "stab_bench": [18, 20, 15, 21, 22],
    "moe_dense": [6, 4, 5, 4, 5],
}
PORT_CPU_EPOCHS = {
    "bench_config": [7, 6, 6, 5, 6, 8, 4, 5, 7, 10, 5, 4, 5, 7, 4, 6, 4, 5, 5,
                     10],
    "reference": [5, 4, 3, 3, 3, 4, 3, 6, 4, 4],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=list(JAX_JNP_EPOCHS),
                    choices=list(JAX_JNP_EPOCHS))
    ap.add_argument("--seeds", type=int, default=None,
                    help="at most this many seeds a config")
    args = ap.parse_args()

    import torch
    from scipy.stats import mannwhitneyu

    if not torch.cuda.is_available():
        print("seed_parity: CUDA is not available; this measures the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bench_config, card_line, moe_config, stab_config
    from ppoc_tpu_torch import reference_preset
    from ppoc_tpu_torch.algo.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    out = {"card": card, "torch": torch.__version__, "configs": {}}
    makers = {"bench_config": bench_config,
              "reference": lambda s: reference_preset(seed=s),
              "stab_bench": stab_config, "moe_dense": moe_config}
    for name in args.configs:
        make = makers[name]
        n = len(JAX_JNP_EPOCHS[name])
        n = n if args.seeds is None else min(n, args.seeds)
        rows = []
        for seed in range(n):
            tr = Trainer(make(seed))
            t0 = time.perf_counter()
            res = tr.solve(SOLVE_R, max_epochs=MAX_EPOCHS)
            torch.cuda.synchronize()
            rows.append({"seed": seed, "epochs": res["epochs"],
                         "R": res["R"], "solved": res["R"] >= SOLVE_R,
                         "wall_s": time.perf_counter() - t0})
            print(f"{name} seed {seed}: {json.dumps(rows[-1])}", flush=True)
        epochs = [r["epochs"] for r in rows]
        summary = {"seeds": n, "epochs": epochs,
                   "mean": statistics.mean(epochs),
                   "solved": sum(r["solved"] for r in rows), "rows": rows}
        for label, other in (("jax_jnp", JAX_JNP_EPOCHS[name][:n]),
                             ("port_cpu", PORT_CPU_EPOCHS.get(name, [])[:n])):
            if not other:
                continue
            u = mannwhitneyu(epochs, other, alternative="two-sided")
            summary[label] = {"epochs": other,
                              "mean": statistics.mean(other),
                              "U": float(u.statistic),
                              "p": float(u.pvalue)}
        out["configs"][name] = summary
        tests = "; ".join(
            f"against {label} (mean {summary[label]['mean']:.2f}) U "
            f"{summary[label]['U']} p {summary[label]['p']:.4f}"
            for label in ("jax_jnp", "port_cpu") if label in summary)
        print(f"{name}: epochs {epochs}, mean {summary['mean']:.2f}, solved "
              f"{summary['solved']}/{n}; {tests}", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "seed_parity.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({k: {kk: v[kk] for kk in ("epochs", "mean", "solved")}
                      for k, v in out["configs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

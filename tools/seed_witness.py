"""Seed witness: the port's training held epoch by epoch to the JAX
package's, from the same init on the same draws.

    JAX_PLATFORMS=cpu python3 tools/seed_witness.py jax [--seed 0]
        [--epochs 14] [--data build/witness/stab_bench_0.npz]
    python3 tools/seed_witness.py port [--data ...] [--device cuda]

``jax`` runs the JAX package's ``Trainer(cfg).solve`` schedule for
chip_smoke.py's ``stab_config(seed)`` (bench_config with the five
stabilisers) on its "jnp" backend on the CPU, one epoch at a time, with
the Trainer's key stream (init key, then solve's key split three ways an
epoch: the loop key, the epoch's fits, its evaluation).  It records each
epoch's Adam step counters (value, policy, log_std: the target_kl freeze
and the annealed rates read them) and evaluation R, and writes them with
the init state and every draw the epochs took, in the port's layout (the
env loop's start and reset states and action noise, the row-id streams,
the evaluations' draws), to ``--data``.

``port`` starts the port's "jnp" backend (``ppo.fit_step``,
``ppo.evaluate``) on ``--device`` (CUDA device 0 unless "cpu") from that
init on those draws and prints each epoch's counters and R beside the
JAX package's, the first epoch at which any part, and each side's first
epoch at R >= -200.  Writes the same as JSON to
``chiprun_out/seed_witness.json``.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOLVE_R = -200.0
COUNTERS = ("opt_v", "opt_policy", "opt_log_std")


def run_jax(args) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax

    from chip_smoke import stab_config
    from ppoc_tpu import PPOConfig
    from ppoc_tpu import envs as jenvs
    from ppoc_tpu.algo import ppo as jppo
    from ppoc_tpu.envs import core as jcore
    from ppoc_tpu.ops import pallas_update as jpu

    fields = dict(dataclasses.asdict(stab_config(args.seed)),
                  kernel_backend="jnp")
    cfg = PPOConfig(**fields)
    env = jenvs.make_for(cfg)
    spec = env.spec

    def loop_draws(key, n, length):
        # ppo.rollout's env loop: split -> (reset, scan); per step split
        # -> (act, env); noise normal(k_act); resets from split(k_env)[1]
        k_reset, k_scan = jax.random.split(key)
        start = jcore.vector_reset(env, k_reset, n)
        pairs = jax.vmap(jax.random.split)(jax.random.split(k_scan, length))
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (n, spec.action_dim)))(pairs[:, 0])
        fresh = jax.vmap(lambda k: jcore.vector_reset(
            env, jax.random.split(k)[1], n))(pairs[:, 1])
        return start, fresh, noise

    def fit_draws(key):
        # fit_step: split -> (roll, upd); upd split -> (value, policy)
        k_roll, k_upd = jax.random.split(key)
        streams = tuple(
            jpu._stream_ids(cfg, k, cfg.steps_per_fit, cfg.num_minibatches,
                            cfg.minibatch_size, n)[0]
            for k, n in zip(jax.random.split(k_upd),
                            (cfg.n_epochs_value, cfg.n_epochs_policy)))
        return streams, loop_draws(k_roll, cfg.n_envs, cfg.rollout_len)

    epoch_fn = jax.jit(lambda ts, k: jppo.train_epoch(cfg, env, ts, k,
                                                      backend="jnp"))
    eval_fn = jax.jit(lambda p, k: jppo.evaluate(cfg, env, p, k,
                                                 backend="jnp"))
    fit_draws_fn = jax.jit(lambda k: jax.vmap(fit_draws)(
        jax.random.split(k, cfg.fits_per_epoch)))
    eval_draws_fn = jax.jit(lambda k: loop_draws(k, cfg.eval_envs,
                                                 cfg.eval_len))

    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)             # Trainer.__init__
    ts = jppo.init_train_state(cfg, env, k_init)
    loop_key, key = jax.random.split(key)           # Trainer.solve
    out = {f"init_{i}": np.asarray(x)
           for i, x in enumerate(jax.tree.leaves(jax.device_get(ts)))}
    rows, per_epoch = [], []
    for epoch in range(1, args.epochs + 1):
        loop_key, k_train, k_eval = jax.random.split(loop_key, 3)
        per_epoch.append((jax.device_get(fit_draws_fn(k_train)),
                          jax.device_get(eval_draws_fn(k_eval))))
        ts, _ = epoch_fn(ts, k_train)
        ev = eval_fn(ts.policy_params, k_eval)
        row = {"epoch": epoch, "R": float(ev.R)}
        row.update({c: int(getattr(ts, c).t) for c in COUNTERS})
        rows.append(row)
        print(json.dumps(row), flush=True)

    def put(prefix, draws):
        (start, start_obs), (fresh, fresh_obs), noise = draws
        for f in start._fields:
            out[f"{prefix}start_{f}"] = np.asarray(getattr(start, f))
            out[f"{prefix}fresh_{f}"] = np.asarray(getattr(fresh, f))
        out[f"{prefix}start_obs"] = np.asarray(start_obs)
        out[f"{prefix}fresh_obs"] = np.asarray(fresh_obs)
        out[f"{prefix}noise"] = np.asarray(noise)

    for e, ((s_val, s_pol), loop), ev in (
            (e, *p) for e, p in enumerate(per_epoch)):
        out[f"e{e}_value_idx"] = np.asarray(s_val, np.int32)
        out[f"e{e}_policy_idx"] = np.asarray(s_pol, np.int32)
        put(f"e{e}_fit_", loop)
        put(f"e{e}_eval_", ev)
    out["meta"] = np.asarray(json.dumps({
        "cfg": fields, "rows": rows, "jax": jax.__version__,
        "n_init": len(jax.tree.leaves(ts)), "epochs": args.epochs}))
    dest = Path(args.data)
    dest.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dest, **out)
    print(f"wrote {dest} ({dest.stat().st_size} bytes)", flush=True)
    return 0


def run_port(args) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from ppoc_tpu_torch import PPOConfig, envs
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import resolve_device
    from ppoc_tpu_torch.ops import adam
    from ppoc_tpu_torch.utils import params as conv

    dev = resolve_device(None if args.device == "cuda" else args.device)
    data = np.load(args.data)
    meta = json.loads(str(data["meta"]))
    cfg = PPOConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in meta["cfg"].items()})
    env = envs.make_for(cfg)
    cls = type(env.reset(1, torch.Generator(), "cpu")[0])

    # the init: the port's own tree, its leaves (in jax.tree.leaves order:
    # sorted dict keys, as adam.tree_leaves) replaced by the JAX init's
    shell = conv.train_state_to_numpy(ppo.init_train_state(
        cfg, env, torch.Generator().manual_seed(0), "cpu"))
    leaves = iter(data[f"init_{i}"] for i in range(meta["n_init"]))

    def swap(x):
        got = next(leaves)
        assert np.shape(got) == np.shape(x), (np.shape(got), np.shape(x))
        return got if isinstance(x, np.ndarray) else int(got)

    ts = conv.train_state_from_numpy(ppo.TrainState(*(
        adam.AdamState(*(adam.tree_map(swap, p) for p in part))
        if isinstance(part, adam.AdamState) else adam.tree_map(swap, part)
        for part in shell)), dev)

    def loop(prefix, fit=None):
        def arr(name):
            a = data[prefix + name]
            return torch.as_tensor(a if fit is None else a[fit], device=dev)

        def state(which):
            return cls(*(arr(f"{which}_{k}") for k in cls._fields))

        return ppo.LoopDraws((state("start"), arr("start_obs")),
                             (state("fresh"), arr("fresh_obs")),
                             arr("noise"))

    def ids(name, fit, n_epochs):
        return torch.as_tensor(data[name][fit], device=dev).long().reshape(
            n_epochs, cfg.num_minibatches, -1)

    rows, parted = [], None
    for e, want in enumerate(meta["rows"]):
        for f in range(cfg.fits_per_epoch):
            draws = ppo.FitDraws(
                None, ids(f"e{e}_value_idx", f, cfg.n_epochs_value),
                ids(f"e{e}_policy_idx", f, cfg.n_epochs_policy),
                loop(f"e{e}_fit_", f))
            ts, _ = ppo.fit_step(cfg, env, ts, draws)
        ev = ppo.evaluate(cfg, env, ts.policy_params, loop(f"e{e}_eval_"))
        row = {"epoch": want["epoch"], "R": float(ev.R)}
        row.update({c: int(getattr(ts, c).t) for c in COUNTERS})
        same = all(row[c] == want[c] for c in COUNTERS)
        if not same and parted is None:
            parted = want["epoch"]
        rows.append(row)
        print(f"epoch {row['epoch']:3d}: port R {row['R']:9.3f} counters "
              f"{[row[c] for c in COUNTERS]} | JAX R {want['R']:9.3f} "
              f"counters {[want[c] for c in COUNTERS]}"
              f"{'' if same else '  <- counters part'}", flush=True)

    def solved(rs):
        return next((r["epoch"] for r in rs if r["R"] >= SOLVE_R), None)

    summary = {"device": str(dev), "cfg": meta["cfg"], "jax": meta["jax"],
               "port": rows, "jax_rows": meta["rows"],
               "counters_part_at": parted,
               "solved_port": solved(rows), "solved_jax": solved(meta["rows"])}
    if dev.type == "cuda":
        from chip_smoke import card_line

        summary["card"] = card_line()
        print(summary["card"], flush=True)
    print(f"counters part at epoch {parted}; first epoch at R >= {SOLVE_R}: "
          f"port {summary['solved_port']}, JAX {summary['solved_jax']}",
          flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "seed_witness.json").write_text(json.dumps(summary, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=["jax", "port"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--data", default=str(ROOT / "build" / "witness" /
                                          "stab_bench_0.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    return run_jax(args) if args.side == "jax" else run_port(args)


if __name__ == "__main__":
    sys.exit(main())

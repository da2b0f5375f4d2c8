"""Command-line driver (counterpart of ``ppoc_tpu/cli.py``).

    python -m ppoc_tpu_torch --env pendulum --n-epochs 10 --save model.bin
    python -m ppoc_tpu_torch --resume model.bin --n-epochs 5
    python -m ppoc_tpu_torch --eval-only --load model.bin --det-eval
    python -m ppoc_tpu_torch --env gym:Pendulum-v1 --actor host --overlap
    python -m ppoc_tpu_torch --sweep 4 --solve-R -200

Builds the env and trainer, evaluates, trains n_epochs with per-epoch
metrics lines and saves the model.  Every PPOConfig field is a flag, on
top of a preset.  Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the
CPU (the JAX CLI's "pin the platform").  ``--save`` / ``--load`` /
``--resume`` / ``--import-ref`` / ``--export-ref`` read and write the
JAX package's checkpoint files and the reference ppo.c format
(``utils/checkpoint.py``, ``utils/ref_interop.py``); ``--supervise``
restarts a crashed or preempted run from its checkpoint
(``utils/supervisor.py``).  SIGTERM with ``--save`` finishes the epoch,
checkpoints and exits with ``supervisor.PREEMPTED_EXIT``.  ``--env
gym:<id>`` trains on a Gymnasium env through the host bridge
(``envs/gym_bridge.GymTrainer``, with ``--actor``, ``--overlap``,
``--vector-mode``, ``--obs-norm``, ``--reward-norm``); ``--sweep`` /
``--grid`` run seed and hyperparameter sweeps (``sweep.py``); ``--profile
DIR`` writes a profiler trace of the training run (``utils/profiling``).
All under the JAX CLI's guards.

The JAX CLI's multi-device flags are kept and refused by name, with the
ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import sys

from ppoc_tpu_torch.config import (PPOConfig, reference_preset, tpu_preset,
                                   tuned_preset)

# flags (argparse dests) of the JAX CLI whose modules are not ported yet
_NOT_PORTED = (
    (("mesh", "coordinator", "num_processes", "process_id"),
     "multi-device and multi-host training (parallel/; ROADMAP.md §1 "
     "item 16)"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppoc_tpu_torch",
        description="PPO trainer, the PyTorch/CUDA port of ppoc_tpu")
    p.add_argument("--preset", choices=["reference", "tpu", "tuned"],
                   default="reference",
                   help="base config: 'reference' = the reference driver's "
                        "hyperparameters; 'tpu' = throughput-sized; "
                        "'tuned' = the JAX package's sweep winner")
    p.add_argument("--save", metavar="PATH", default=None,
                   help="checkpoint path written after training")
    p.add_argument("--load", metavar="PATH", default=None,
                   help="checkpoint to load weights and optimizers from "
                        "before training (config comes from the flags)")
    p.add_argument("--resume", metavar="PATH", default=None,
                   help="rebuild the trainer entirely from a checkpoint "
                        "(config, state, generator position: "
                        "Trainer.from_checkpoint) and continue training bit "
                        "for bit; other config flags are ignored")
    p.add_argument("--import-ref", metavar="PATH", default=None,
                   help="build the trainer from a reference-format "
                        "checkpoint (ppo.c's save_ppo binary): net shapes, "
                        "weights, log_std and all three Adam states from "
                        "the file, the rollout schedule from the flags")
    p.add_argument("--export-ref", metavar="PATH", default=None,
                   help="after training, also write the model in the "
                        "reference's load_ppo format (Gaussian policies)")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate (optionally after --load) and exit")
    p.add_argument("--stop-at-R", type=float, default=None,
                   help="stop once mean undiscounted eval return reaches this")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="with --save: also checkpoint every N epochs")
    p.add_argument("--solve-R", type=float, default=None,
                   help="train until eval R reaches this "
                        "(Trainer.solve), at most n_epochs; prints epochs")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="run training in a supervised subprocess and "
                        "restart it from the --save checkpoint on crash or "
                        "preemption, up to N times; needs --save and "
                        "--checkpoint-every.  PPOC_FAULT_EPOCH=k injects a "
                        "hard crash after global epoch k")
    p.add_argument("--score-episodes", type=int, default=0, metavar="N",
                   help="with --eval-only: aggregate evaluation over at "
                        "least N completed episodes")
    p.add_argument("--jsonl", action="store_true",
                   help="emit per-epoch metrics as JSON lines instead of text")
    p.add_argument("--det-eval", action="store_true",
                   help="evaluate with the mean policy instead of the "
                        "stochastic evaluator (per-epoch metrics, "
                        "--stop-at-R, --eval-only)")
    p.add_argument("--hidden", type=int, nargs="+", default=None,
                   metavar="W", help="hidden layer widths")
    nyp = "not ported yet: refused"
    p.add_argument("--mesh", type=int, default=0, metavar="N", help=nyp)
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help=nyp)
    p.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help=nyp)
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help=nyp)
    p.add_argument("--sweep", type=int, default=0, metavar="S",
                   help="seed sweep: train S seeds (seed..seed+S-1), one "
                        "Trainer a lane (sweep.py); with --solve-R per-seed "
                        "epochs and R, else per-seed learning curves. "
                        "On-device envs")
    p.add_argument("--grid", action="append", default=None,
                   metavar="HP=V1,V2,...",
                   help="hyperparameter grid axis (repeatable): train every "
                        "combination of the values, crossed with --sweep S "
                        "seeds if given (sweep.solve_grid / train_grid); HP "
                        "is one of sweep.SWEEPABLE_HPARAMS")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "training run into DIR (utils/profiling.trace)")
    p.add_argument("--actor", choices=["host", "device"], default="host",
                   help="gym:* envs only: 'host', a numpy policy on the "
                        "host, weights copied once a fit; 'device', one "
                        "batched policy forward a step on the card")
    p.add_argument("--overlap", action="store_true",
                   help="gym:* envs: collect window i+1 on the host while "
                        "the card fits window i (one-fit-stale actor "
                        "weights; requires --actor host)")
    p.add_argument("--vector-mode", choices=["sync", "async"],
                   default="sync",
                   help="gym:* envs only: gymnasium.vector stepping mode")
    p.add_argument("--calibrate", action="store_true",
                   help="on-device envs only: measure observation "
                        "statistics with a random policy before training "
                        "and bake them into obs_loc/obs_scale "
                        "(envs.wrappers.calibrate)")
    p.add_argument("--obs-norm", action="store_true",
                   help="gym:* envs only: running observation "
                        "normalisation (envs.wrappers.RunningObsNorm), its "
                        "statistics saved as an .obsnorm.npz sidecar")
    p.add_argument("--reward-norm", action="store_true",
                   help="gym:* envs only: training rewards scaled by the "
                        "running std of the discounted return "
                        "(envs.wrappers.RunningRewardNorm); evaluation "
                        "reports raw-reward J/R")

    # every config field becomes a flag
    for f in dataclasses.fields(PPOConfig):
        if f.name == "hidden":
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(arg, type=lambda s: s.lower() in ("1", "true",
                                                             "yes"),
                           default=None, metavar="BOOL")
        elif isinstance(f.default, int):
            p.add_argument(arg, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(arg, type=float, default=None)
        elif isinstance(f.default, tuple):
            # float-tuple fields (obs_loc/obs_scale): comma-separated
            p.add_argument(arg, type=lambda s: tuple(float(x)
                                                     for x in s.split(",")),
                           default=None, metavar="F[,F...]")
        else:
            p.add_argument(arg, type=str, default=None)
    return p


def config_from_args(args: argparse.Namespace) -> PPOConfig:
    cfg = {"reference": reference_preset, "tpu": tpu_preset,
           "tuned": tuned_preset}[args.preset]()
    overrides = {f.name: getattr(args, f.name)
                 for f in dataclasses.fields(PPOConfig)
                 if f.name != "hidden" and getattr(args, f.name, None)
                 is not None}
    if args.hidden is not None:
        overrides["hidden"] = tuple(args.hidden)
    return cfg.replace(**overrides)


def platform_device(parser: argparse.ArgumentParser):
    """The device ``PPOC_PLATFORM`` pins (``algo/trainer.platform_device``),
    its refusals as parser errors."""
    from ppoc_tpu_torch.algo import trainer as trainer_mod

    try:
        return trainer_mod.platform_device()
    except (ValueError, RuntimeError) as e:
        parser.error(str(e))


def _json_safe(row: dict) -> dict:
    """Non-finite floats (eval R/J are -inf when no episode completes)
    as None, so strict JSON parsers read the line."""
    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in row.items()}


def _sweep(parser, args, cfg, device) -> int:
    """--sweep / --grid: the JAX CLI's sweep branch (``ppoc_tpu/cli.py:
    288-360``), its guards and its output lines, one Trainer a lane."""
    from ppoc_tpu_torch import sweep as sweep_mod

    if args.sweep and args.sweep < 1:
        parser.error(f"--sweep needs a positive seed count, got {args.sweep}")
    if (cfg.env.startswith("gym:") or args.load or args.resume
            or args.import_ref or args.eval_only):
        parser.error("--sweep/--grid run fresh on-device single-device "
                     "training only (no gym:/--mesh/--load/--resume/"
                     "--import-ref/--eval-only)")
    if args.save or args.export_ref or args.det_eval \
            or args.stop_at_R is not None:
        parser.error("--save/--export-ref/--det-eval/--stop-at-R do not "
                     "apply to --sweep/--grid (per-lane statistics only; "
                     "use --solve-R for the stop threshold, then train the "
                     "winning config normally to get a checkpoint)")
    seeds = list(range(cfg.seed, cfg.seed + max(args.sweep, 1)))
    if args.grid:
        axes = {}
        for spec in args.grid:
            name, eq, vals = spec.partition("=")
            name = name.replace("-", "_")
            if not eq or not vals:
                parser.error(f"--grid expects HP=V1,V2,... , got {spec!r}")
            if name not in sweep_mod.SWEEPABLE_HPARAMS:
                parser.error(f"--grid {name}: not sweepable; choose from "
                             f"{', '.join(sweep_mod.SWEEPABLE_HPARAMS)}")
            try:
                axes[name] = [float(v) for v in vals.split(",")]
            except ValueError:
                parser.error(f"--grid {spec!r}: values must be numbers")
        if args.solve_R is not None:
            out = sweep_mod.solve_grid(cfg, axes, target_R=args.solve_R,
                                       seeds=seeds, max_epochs=cfg.n_epochs,
                                       device=device)
            for c, e, r in zip(out["combos"], out["epochs"], out["R"]):
                hp = {k: v for k, v in c.items() if k != "seed"}
                print(f"{hp} seed={c['seed']} solved={r >= args.solve_R} "
                      f"epochs={e} R={r:f}")
            best = out["combos"][out["best"]]
            print(f"best: {best} (epochs={out['epochs'][out['best']]}, "
                  f"R={out['R'][out['best']]:f})")
            return 0
        out = sweep_mod.train_grid(cfg, axes, seeds=seeds,
                                   n_epochs=args.n_epochs, device=device)
        for c, curve in zip(out["combos"], out["R"]):
            row = dict(c)
            row["R"] = [round(float(x), 3) if math.isfinite(float(x))
                        else None for x in curve]
            print(json.dumps(row))
        return 0
    if args.solve_R is not None:
        out = sweep_mod.solve_many(cfg, seeds, target_R=args.solve_R,
                                   max_epochs=cfg.n_epochs, device=device)
        for s, e, r in zip(seeds, out["epochs"], out["R"]):
            print(f"seed={s} solved={r >= args.solve_R} epochs={e} R={r:f}")
        return 0
    out = sweep_mod.train_many(cfg, seeds, n_epochs=args.n_epochs,
                               device=device)
    R = out["R"]
    for i, s in enumerate(seeds):
        print(json.dumps({"seed": s,
                          "R": [round(float(x), 3) for x in R[i]]}))
    if R.shape[1]:   # --n-epochs 0 has no final epoch to summarise
        print(f"final R over {len(seeds)} seeds: "
              f"mean={float(R[:, -1].mean()):.3f} "
              f"std={float(R[:, -1].std()):.3f} "
              f"min={float(R[:, -1].min()):.3f} "
              f"max={float(R[:, -1].max()):.3f}")
    return 0


def main(argv=None) -> int:
    from ppoc_tpu_torch import config as config_mod
    from ppoc_tpu_torch.algo import trainer as trainer_mod
    from ppoc_tpu_torch.ops import resolve_backend
    from ppoc_tpu_torch.utils import checkpoint, ref_interop, supervisor

    parser = build_parser()
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    for names, what in _NOT_PORTED:
        for name in names:
            if getattr(args, name) != parser.get_default(name):
                parser.error(f"--{name.replace('_', '-')}: {what} is not "
                             f"ported to ppoc_tpu_torch yet")
    if args.checkpoint_every > 0 and not args.save:
        parser.error("--checkpoint-every requires --save PATH (the "
                     "checkpoint destination)")
    if args.score_episodes and not args.eval_only:
        parser.error("--score-episodes applies to --eval-only scoring; "
                     "pass both")
    if args.checkpoint_every > 0 and args.solve_R is not None:
        print("warning: --checkpoint-every has no effect with --solve-R "
              "(a checkpoint is written at the end when --save is given)",
              file=sys.stderr)
    cfg = config_from_args(args)
    gym = cfg.env.startswith("gym:")
    if args.calibrate:
        if gym or args.resume or args.import_ref or args.load:
            parser.error("--calibrate applies to fresh on-device-env runs "
                         "(gym:* envs use --obs-norm; --resume/--import-ref/"
                         "--load carry weights trained under their OWN "
                         "normalization -- calibrating underneath them "
                         "would skew every observation the policy sees)")
        if cfg.obs_loc or cfg.obs_scale:
            parser.error("--calibrate would overwrite the explicit "
                         "--obs-loc/--obs-scale values; pass one or the "
                         "other")
        from ppoc_tpu_torch.envs.wrappers import calibrate

        cfg = calibrate(cfg, device=platform_device(parser))
        print(f"calibrated obs_loc={tuple(round(x, 4) for x in cfg.obs_loc)} "
              f"obs_scale={tuple(round(x, 4) for x in cfg.obs_scale)}",
              file=sys.stderr)
    # fail fast, as a parser error, on what Trainer(cfg) would refuse
    try:
        config_mod.validate(cfg)
        trainer_mod.check_ported(cfg)
        resolve_backend(cfg.kernel_backend)
    except (ValueError, NotImplementedError) as e:
        parser.error(str(e))

    if args.supervise:
        # this process becomes the supervisor; training runs in children
        # restarted from the checkpoint on failure
        if not (args.save and args.checkpoint_every > 0):
            parser.error("--supervise requires --save PATH and "
                         "--checkpoint-every N (the restart source)")
        if args.solve_R is not None or args.eval_only or args.sweep \
                or args.grid:
            parser.error("--supervise applies to epoch-loop training, not "
                         "--solve-R/--eval-only/--sweep/--grid (sweeps "
                         "write no checkpoint to restart from)")
        first = [a for i, a in enumerate(raw_argv)
                 if a != "--supervise" and not a.startswith("--supervise=")
                 and not (i > 0 and raw_argv[i - 1] == "--supervise")]
        restart = supervisor.build_restart_argv(raw_argv, args.save,
                                                gym_env=gym)
        return supervisor.supervise(first, restart, args.save,
                                    max_restarts=args.supervise)

    device = platform_device(parser)
    if args.sweep or args.grid:
        return _sweep(parser, args, cfg, device)
    Trainer = trainer_mod.Trainer
    epoch_offset = 0  # cumulative epochs_done carried across restarts
    if gym:
        # the host bridge on any Gymnasium env (the reference's
        # create_gym_env path, src/main.c:25)
        if args.solve_R is not None or args.resume or args.import_ref:
            parser.error("gym:* envs use the host bridge; --solve-R, "
                         "--resume, --import-ref and --mesh apply to "
                         "on-device envs only")
        from ppoc_tpu_torch.envs.gym_bridge import GymTrainer

        trainer = GymTrainer(cfg, cfg.env[4:], vector_mode=args.vector_mode,
                             actor=args.actor, obs_norm=args.obs_norm,
                             reward_norm=args.reward_norm,
                             overlap=args.overlap, device=device)
        if args.load:
            trainer.load(args.load)
    elif args.obs_norm or args.reward_norm:
        parser.error("--obs-norm/--reward-norm apply to gym:* host-bridge "
                     "envs; on-device envs use --calibrate (config-carried "
                     "static normalization)")
    elif args.overlap:
        parser.error("--overlap (host actor/learner pipelining) applies to "
                     "gym:* host-bridge envs; on-device envs have no host "
                     "actor to overlap")
    elif args.import_ref:
        if args.load or args.resume:
            parser.error("--import-ref replaces --load/--resume")
        # hyperparameters the reference file carries win unless the
        # matching flag was passed; the rollout schedule (not in the file)
        # comes from the flags and preset
        file_fields = ("hidden", "activation", "lam", "clip_eps",
                       "ent_coeff", "lr_policy", "lr_v", "adam_beta1",
                       "adam_beta2")
        overrides = {}
        for f in dataclasses.fields(PPOConfig):
            if f.name == "env":
                continue
            explicit = (args.hidden is not None if f.name == "hidden"
                        else getattr(args, f.name, None) is not None)
            if f.name in file_fields and not explicit:
                continue
            overrides[f.name] = getattr(cfg, f.name)
        trainer = ref_interop.load_trainer(args.import_ref, cfg.env,
                                           device=device, **overrides)
        cfg = trainer.cfg
    elif args.resume:
        saved = checkpoint.load(args.resume)
        if saved.cfg is not None and saved.cfg.env.startswith("gym:"):
            parser.error(f"{args.resume} was trained on the host bridge "
                         f"({saved.cfg.env}); --resume is device-only — use "
                         f"--env {saved.cfg.env} --load {args.resume} "
                         f"instead")
        # config flags are ignored on --resume, but for --n-epochs (below)
        # and --kernel-backend
        resume_kw = ({} if args.kernel_backend is None
                     else {"kernel_backend": args.kernel_backend})
        trainer = Trainer.from_checkpoint(args.resume, device=device,
                                          **resume_kw)
        cfg = trainer.cfg
        epoch_offset = int(saved.meta.get("epochs_done", 0))
        if args.n_epochs is None and epoch_offset:
            # a mid-run checkpoint (elastic restart): finish the original
            # schedule rather than training cfg.n_epochs more
            remaining = cfg.n_epochs - epoch_offset
            if remaining <= 0:
                print(f"{args.resume}: all {cfg.n_epochs} epochs already "
                      f"done; nothing to resume", file=sys.stderr)
                return 0
            args.n_epochs = remaining
    else:
        trainer = Trainer(cfg, device)
        if args.load:
            trainer.load(args.load)

    if args.eval_only:
        if args.score_episodes:
            s = trainer_mod.score(trainer, episodes=args.score_episodes,
                                  deterministic=args.det_eval)
            print(f"J: {s['J']:f} R: {s['R']:f} Episodes: {s['episodes']} "
                  f"(over {s['rounds']} eval rounds)")
            return 0
        m = trainer.evaluate(deterministic=args.det_eval)
        print(f"J: {m.J:f} R: {m.R:f} Episodes: {int(m.episodes)}")
        return 0

    if args.solve_R is not None:
        if args.det_eval:
            print("warning: --det-eval has no effect with --solve-R (the "
                  "solve loop evaluates stochastically)", file=sys.stderr)
        res = trainer.solve(target_R=args.solve_R, max_epochs=cfg.n_epochs)
        print(f"solved={res['R'] >= args.solve_R} epochs={res['epochs']} "
              f"R={res['R']:f}")
        if args.save:
            trainer.save(args.save)
        if args.export_ref:
            ref_interop.export_trainer(trainer, args.export_ref)
        return 0

    train_kw = {}
    if args.save and args.checkpoint_every > 0:
        train_kw = dict(checkpoint_path=args.save,
                        checkpoint_every=args.checkpoint_every,
                        epoch_offset=epoch_offset)
    if args.resume and args.n_epochs is not None:
        # config flags are otherwise ignored on --resume, but an explicit
        # --n-epochs means "train this many more epochs"
        train_kw["n_epochs"] = args.n_epochs
    # graceful preemption: finish the epoch, checkpoint, exit restartable;
    # PPOC_FAULT_EPOCH=k hard-kills right after global epoch k's checkpoint
    preempted = {"flag": False}
    fault_epoch = int(os.environ.get("PPOC_FAULT_EPOCH", "0"))

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = None
    if args.save:
        # trap SIGTERM only with something to checkpoint: a run without
        # --save keeps dying at once on kill
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread (embedding)
            pass

    def on_epoch_end(i, row):
        # global epochs, so a drill crash fires once across restarts
        if fault_epoch and epoch_offset + i + 1 == fault_epoch:
            os._exit(98)  # a simulated hard crash: no cleanup, no save
        return preempted["flag"]

    prof_ctx = contextlib.nullcontext()
    if args.profile:
        from ppoc_tpu_torch.utils import profiling

        prof_ctx = profiling.trace(args.profile)
    try:
        with prof_ctx:
            # a gym env skips the pre-training evaluation: a whole host
            # rollout (HostTrainer.train's default too)
            history = trainer.train(log=not args.jsonl,
                                    stop_at_R=args.stop_at_R,
                                    initial_eval=not (args.resume or gym),
                                    eval_deterministic=args.det_eval,
                                    on_epoch_end=on_epoch_end, **train_kw)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    if args.profile:
        print(f"profiler trace written to {args.profile} (open with "
              f"Perfetto or chrome://tracing)", file=sys.stderr)
    if preempted["flag"]:
        if args.save:
            n_done = epoch_offset + len(history)
            trainer.save(args.save, meta={"epochs_done": n_done})
            print(f"preempted: checkpointed {n_done} epoch(s) to "
                  f"{args.save}", file=sys.stderr)
        return supervisor.PREEMPTED_EXIT
    if args.jsonl:
        for row in history:
            print(json.dumps(_json_safe(row)), flush=True)
    if args.save:
        # cumulative epochs_done: a --resume of a finished run knows there
        # is nothing left of the original schedule
        trainer.save(args.save,
                     meta={"epochs_done": epoch_offset + len(history)})
        print(f"saved checkpoint to {args.save}", file=sys.stderr)
    if args.export_ref:
        ref_interop.export_trainer(trainer, args.export_ref)
        print(f"exported reference-format model to {args.export_ref}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

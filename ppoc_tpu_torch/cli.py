"""Command-line driver (counterpart of ``ppoc_tpu/cli.py``).

    python -m ppoc_tpu_torch --env pendulum --n-epochs 10 --save model.bin
    python -m ppoc_tpu_torch --resume model.bin --n-epochs 5
    python -m ppoc_tpu_torch --eval-only --load model.bin --det-eval

Builds the env and trainer, evaluates, trains n_epochs with per-epoch
metrics lines and saves the model.  Every PPOConfig field is a flag, on
top of a preset.  Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the
CPU (the JAX CLI's "pin the platform").  ``--save`` / ``--load`` /
``--resume`` / ``--import-ref`` / ``--export-ref`` read and write the
JAX package's checkpoint files and the reference ppo.c format
(``utils/checkpoint.py``, ``utils/ref_interop.py``); ``--supervise``
restarts a crashed or preempted run from its checkpoint
(``utils/supervisor.py``).  SIGTERM with ``--save`` finishes the epoch,
checkpoints and exits with ``supervisor.PREEMPTED_EXIT``.

The JAX CLI's flags whose modules are not ported are kept and refused by
name, with the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
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
    (("sweep", "grid"),
     "seed and hyperparameter sweeps (sweep.py; ROADMAP.md §1 item 10)"),
    (("profile",), "profiler traces (utils/profiling.py; ROADMAP.md §1 "
                   "item 9)"),
    (("obs_norm", "reward_norm", "overlap", "actor", "vector_mode"),
     "the host actor and its gym:* envs (envs/gym_bridge.py, envs/host.py; "
     "ROADMAP.md §1 item 13)"),
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
    p.add_argument("--sweep", type=int, default=0, metavar="S", help=nyp)
    p.add_argument("--grid", action="append", default=None,
                   metavar="HP=V1,V2,...", help=nyp)
    p.add_argument("--profile", metavar="DIR", default=None, help=nyp)
    p.add_argument("--actor", choices=["host", "device"], default=None,
                   help=nyp)
    p.add_argument("--overlap", action="store_true", help=nyp)
    p.add_argument("--vector-mode", choices=["sync", "async"], default=None,
                   help=nyp)
    p.add_argument("--calibrate", action="store_true",
                   help="measure observation statistics with a random "
                        "policy before training and bake them into "
                        "obs_loc/obs_scale (envs.wrappers.calibrate)")
    p.add_argument("--obs-norm", action="store_true", help=nyp)
    p.add_argument("--reward-norm", action="store_true", help=nyp)

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
    """The device ``PPOC_PLATFORM`` pins: "cpu" -> the CPU; unset, "cuda"
    or "gpu" -> None, CUDA device 0, a parser error without CUDA."""
    import torch

    plat = os.environ.get("PPOC_PLATFORM", "")
    if plat == "cpu":
        return "cpu"
    if plat not in ("", "cuda", "gpu"):
        parser.error(f"PPOC_PLATFORM={plat!r}: the port runs on 'cpu' or "
                     f"'cuda'")
    if not torch.cuda.is_available():
        parser.error("the port runs on CUDA device 0, and CUDA is not "
                     "available; set PPOC_PLATFORM=cpu to run on the CPU")
    return None


def _json_safe(row: dict) -> dict:
    """Non-finite floats (eval R/J are -inf when no episode completes)
    as None, so strict JSON parsers read the line."""
    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in row.items()}


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
    if cfg.env.startswith("gym:"):
        parser.error(f"--env {cfg.env}: the host bridge's gym:* envs are not "
                     f"ported to ppoc_tpu_torch yet (ROADMAP.md §1 item 13)")
    if args.calibrate:
        if args.resume or args.import_ref or args.load:
            parser.error("--calibrate applies to fresh runs (--resume/"
                         "--import-ref/--load carry weights trained under "
                         "their OWN normalization -- calibrating underneath "
                         "them would skew every observation the policy "
                         "sees)")
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
        if args.solve_R is not None or args.eval_only:
            parser.error("--supervise applies to epoch-loop training, not "
                         "--solve-R/--eval-only")
        first = [a for i, a in enumerate(raw_argv)
                 if a != "--supervise" and not a.startswith("--supervise=")
                 and not (i > 0 and raw_argv[i - 1] == "--supervise")]
        restart = supervisor.build_restart_argv(raw_argv, args.save)
        return supervisor.supervise(first, restart, args.save,
                                    max_restarts=args.supervise)

    device = platform_device(parser)
    Trainer = trainer_mod.Trainer
    epoch_offset = 0  # cumulative epochs_done carried across restarts
    if args.import_ref:
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
                         f"({saved.cfg.env}), which is not ported "
                         f"(ROADMAP.md §1 item 13)")
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

    try:
        history = trainer.train(log=not args.jsonl, stop_at_R=args.stop_at_R,
                                initial_eval=not args.resume,
                                eval_deterministic=args.det_eval,
                                on_epoch_end=on_epoch_end, **train_kw)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
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

"""K1's pendulum lane, bit for bit against another checkout's build.

    python3 tools/k1_pendulum_bits.py --root OTHER --save FILE [--time]
    python3 tools/k1_pendulum_bits.py --compare FILE [--time]

Runs the rollout kernel (``ops/cuda_rollout.rollout_kernel``, pendulum
lane) of the checkout at ``--root`` (default: this one) on one CUDA device
at fixed seeds and weights: 64 envs x 200 steps with the V planes (the
bench shape), 1024 x 200 (the throughput shape) and 64 x 40 from a carried
state across the horizon.  ``--save`` writes every output with
torch.save; ``--compare`` checks each against the saved one with
torch.equal, prints one line per case and exits 1 on any difference.  Use
it to show that a change to csrc/rollout.cu left the pendulum lane's
arithmetic as it was.  ``--time`` also prints each case's device time per
launch, with this checkout's ``chip_smoke.queued_ms`` (CUDA events around
20 launches queued behind a spin kernel): run parent, change, change,
parent in one call to compare two builds on one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


def runs(torch, mlp):
    """name -> rollout_kernel arguments of each fixed rollout."""
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    pol = mlp.init((3, 128, 128, 1), g, dev)
    val = mlp.init((3, 128, 128, 1), g, dev)
    log_std = torch.full((1,), -0.3, device=dev)
    st0 = (torch.rand(64, 2, generator=g) * 4 - 2).to(dev)
    steps0 = torch.full((64,), 180.0, device=dev)
    return {
        "bench 64x200, V planes": (pol, log_std, val, (7, 9), 64, 200),
        "throughput 1024x200": (pol, log_std, None, (1, 2), 1024, 200),
        "carried 64x40 across the horizon": (pol, log_std, val, (3, 4), 64,
                                             40, "relu", st0, steps0),
    }


def cases(torch, cr, mlp):
    """(name, outputs) of each fixed rollout."""
    for name, args in runs(torch, mlp).items():
        raw = cr.rollout_kernel(*args)
        torch.cuda.synchronize()
        yield name, {k: v.cpu() for k, v in raw._asdict().items()
                     if v is not None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save")
    mode.add_argument("--compare")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    got = dict(cases(torch, cr, mlp))
    if args.time:
        here = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", here)
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
        print(cs.card_line())
        for name, rargs in runs(torch, mlp).items():
            ms = cs.queued_ms(lambda: cr.rollout_kernel(*rargs), 20)
            print(f"{name}: {ms:.4f} ms a launch ({args.root})")
    if args.save:
        torch.save(got, args.save)
        print(f"saved {len(got)} rollouts of {args.root} to {args.save}")
        return 0
    want = torch.load(args.compare)
    bad = 0
    for name, outs in want.items():
        diff = [k for k, v in outs.items() if not torch.equal(got[name][k], v)]
        bad += bool(diff)
        print(f"{name}: {'identical' if not diff else 'DIFFER: ' + str(diff)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Solve MountainCarContinuous with generic observation calibration.

The port of ``examples/calibrated_mountain_car.py``.  The sparse-reward
task fails with raw observations (position and velocity scales differ
~26x, so the shared trunk wastes its early epochs learning the scale).
Instead of the hand-derived `mountain_car_norm` wrapper, this uses the
framework's generic recipe: `envs.wrappers.calibrate` measures
per-dimension statistics with a random-policy rollout on the device and
bakes them into the config (`obs_loc`/`obs_scale`), which every consumer
-- trainer, sweep lanes, serving -- replays exactly.  An `#affine` env
rolls out through the env loop (K5's forward a step), then K2, K5's
generic minibatch steps (mb 8192 is past the fused phases' 2048 rows).
The card's wall and R: PERF.md §6.  CLI equivalent:

    python -m ppoc_tpu_torch --env mountain_car --calibrate --n-envs 512 \\
        --rollout-len 999 --minibatch-size 8192 --fits-per-epoch 1 \\
        --eval-envs 256 --eval-len 999 --ent-coeff 0.005 --stop-at-R 90

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU.

Usage: python examples_torch/calibrated_mountain_car.py [n_epochs]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device
from ppoc_tpu_torch.envs import wrappers

BASE = PPOConfig(env="mountain_car", n_envs=512, rollout_len=999,
                 minibatch_size=8192, fits_per_epoch=1, eval_envs=256,
                 eval_len=999, ent_coeff=0.005, seed=0)
CALIBRATE = dict(n_envs=256, n_steps=999)


def main(argv) -> int:
    n_epochs = int(argv[1]) if len(argv) > 1 else 20
    device = platform_device()

    t0 = time.time()
    cfg = wrappers.calibrate(BASE, device=device, **CALIBRATE)
    print(f"calibrated in {time.time() - t0:.1f}s: "
          f"loc={tuple(round(x, 3) for x in cfg.obs_loc)} "
          f"scale={tuple(round(x, 3) for x in cfg.obs_scale)}")
    hist = Trainer(cfg, device).train(n_epochs=n_epochs, stop_at_R=90.0)
    print(f"final R {hist[-1]['R']:.1f} at epoch {hist[-1]['epoch']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

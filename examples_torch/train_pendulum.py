"""Solve Pendulum-v1 on one H100 -- the reference's src/main.c workload.

The port of ``examples/train_pendulum.py``: the reference hyperparameters
with 64 vectorized on-device envs and ``Trainer.solve``, whose fits run
the hand kernels K1 (rollout), K2 (GAE), K3 and K4 (the value and policy
phases); saves a checkpoint like the reference does (ppo_model.bin,
src/main.c:58), in the JAX package's file format.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU (the kernels'
plain PyTorch versions).  Card walls: PERF.md §6.

Usage: python examples_torch/train_pendulum.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device

CFG = PPOConfig(env="pendulum", n_envs=64, rollout_len=200,
                minibatch_size=256, fits_per_epoch=4, eval_envs=64)
MAX_EPOCHS = 60


def main(argv) -> int:
    trainer = Trainer(CFG, platform_device())
    result = trainer.solve(target_R=-200.0, max_epochs=MAX_EPOCHS)
    print(f"solved={result['R'] >= -200} after {result['epochs']} epochs, "
          f"R={result['R']:.1f}")
    trainer.save("ppo_model.bin")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

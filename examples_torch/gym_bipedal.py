"""Train BipedalWalker-v3 through the host bridge (reference env id 1,
scripts/gym_env.py:15-16).

The port of ``examples/gym_bipedal.py``.  Actor/learner split: numpy
policy on the host (weights synced once per fit -- the reference's
policy_to_host pattern, src/ppo.cu:536-538), Box2D physics in
gymnasium.vector workers, the learner in PyTorch.  Swap in any Gymnasium
id (``ENV_ID``).  Needs ``gymnasium`` with Box2D, which the card's
machine does not have, so it runs on the CPU there too
(``PPOC_PLATFORM=cpu``); unset, the learner runs on CUDA device 0.

Usage: python examples_torch/gym_bipedal.py [n_epochs] [seed] [obs_norm(0|1)] [save_path] [reward_norm(0|1)]
"""
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import platform_device
from ppoc_tpu_torch.envs.gym_bridge import GymTrainer

ENV_ID = "BipedalWalker-v3"


def config(n_epochs: int, seed: int) -> PPOConfig:
    return PPOConfig(n_envs=16, rollout_len=256, minibatch_size=256,
                     fits_per_epoch=4, n_epochs=n_epochs, eval_envs=8,
                     eval_len=1600, seed=seed,
                     reset_per_fit=False,  # 1600-step horizon >> window
                     ent_coeff=0.001, kernel_backend="jnp")


def main(argv) -> int:
    n_epochs = int(argv[1]) if len(argv) > 1 else 60
    seed = int(argv[2]) if len(argv) > 2 else 0
    obs_norm = bool(int(argv[3])) if len(argv) > 3 else False
    save_path = argv[4] if len(argv) > 4 else None
    reward_norm = bool(int(argv[5])) if len(argv) > 5 else False

    tr = GymTrainer(config(n_epochs, seed), ENV_ID, actor="host",
                    vector_mode="sync", obs_norm=obs_norm,
                    reward_norm=reward_norm, device=platform_device())
    hist = tr.train(checkpoint_path=save_path,
                    checkpoint_every=25 if save_path else 1)
    if save_path:
        tr.save(save_path)
    print(json.dumps([
        {k: (round(float(v), 2) if math.isfinite(float(v)) else None)
         for k, v in row.items()}
        for row in hist
    ]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

"""Refine a trained host-bridge checkpoint toward an env's canonical bar.

The port of ``examples/gym_bipedal_refine.py``.  Loads a checkpoint
produced by ``examples_torch/gym_bipedal.py``, the JAX script or either
CLI (with its obs/reward normalization sidecars), continues training with
ent_coeff=0 so the policy can shed the exploration noise it no longer
needs, and scores the MEAN policy (deterministic eval -- the canonical
benchmark protocol) every few epochs, keeping the best-scoring
checkpoint.  Needs ``gymnasium`` with Box2D, which the card's machine
does not have, so it runs on the CPU there too (``PPOC_PLATFORM=cpu``);
unset, the learner runs on CUDA device 0.

Usage: python examples_torch/gym_bipedal_refine.py <in_ckpt> <out_ckpt>
           [n_epochs] [seed] [det_every] [lr] [stop_R] [env_id] [eval_len]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import platform_device
from ppoc_tpu_torch.envs.gym_bridge import GymTrainer


def config(n_epochs, seed, lr, eval_len) -> PPOConfig:
    return PPOConfig(n_envs=16, rollout_len=256, minibatch_size=256,
                     fits_per_epoch=4, n_epochs=n_epochs, eval_envs=8,
                     eval_len=eval_len, seed=seed, reset_per_fit=False,
                     ent_coeff=0.0, lr_policy=lr, lr_v=lr,
                     kernel_backend="jnp")


def main(argv) -> int:
    in_ckpt = argv[1]
    out_ckpt = argv[2]
    n_epochs = int(argv[3]) if len(argv) > 3 else 200
    seed = int(argv[4]) if len(argv) > 4 else 7
    det_every = int(argv[5]) if len(argv) > 5 else 10
    lr = float(argv[6]) if len(argv) > 6 else 3e-4
    stop_R = float(argv[7]) if len(argv) > 7 else 300.0
    env_id = argv[8] if len(argv) > 8 else "BipedalWalker-v3"
    eval_len = int(argv[9]) if len(argv) > 9 else 1600

    tr = GymTrainer(config(n_epochs, seed, lr, eval_len), env_id,
                    actor="host", vector_mode="sync",
                    obs_norm=os.path.exists(in_ckpt + ".obsnorm.npz"),
                    reward_norm=os.path.exists(in_ckpt + ".retnorm.npz"),
                    device=platform_device())
    tr.load(in_ckpt)

    best = -np.inf
    history = []
    for block in range((n_epochs + det_every - 1) // det_every):
        tr.train(n_epochs=det_every, log=True)
        # canonical scoring: mean policy, 3 eval rounds of 8 envs x 1600
        # steps; rounds with zero completed episodes carry the R=-inf
        # sentinel -- skip them instead of poisoning the episode-weighted
        # mean
        rounds = [m for m in (tr.evaluate(deterministic=True)
                              for _ in range(3))
                  if int(m.episodes) > 0]
        n_eps = sum(int(m.episodes) for m in rounds)
        det_R = (sum(m.R * m.episodes for m in rounds) / n_eps
                 if n_eps else float("-inf"))
        epoch = (block + 1) * det_every
        history.append({"epoch": epoch, "det_R": round(float(det_R), 2),
                        "episodes": n_eps,
                        "round_R": [round(float(m.R), 2) for m in rounds]})
        print(f"[det] epoch {epoch}: R {det_R:.2f} over {n_eps} eps "
              f"(rounds: {[round(float(m.R), 1) for m in rounds]})",
              flush=True)
        if det_R > best:
            best = det_R
            tr.save(out_ckpt)
            print(f"[det] new best {best:.2f} -> {out_ckpt}", flush=True)
        if best >= stop_R:
            break
    print(json.dumps({
        "best_det_R": round(float(best), 2) if np.isfinite(best) else None,
        "history": history,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

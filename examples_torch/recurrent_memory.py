"""Recurrent (GRU) policies on partially-observable tasks.

The port of ``examples/recurrent_memory.py``.  The third model family
(models/gru.py + algo/recurrent.py): PPOConfig(rnn_hidden=H) swaps both
trunks for a GRU encoder + MLP head, rollouts thread the hidden state
(zeroed at episode boundaries), and updates replay whole env sequences
with BPTT instead of shuffled transitions.  A GRU trunk runs no hand
kernel: its cell is a loop of PyTorch ops.

Two demos:
  1. `recall` (envs/recall.py) -- a cue shown once must be remembered to
     the final step.  A memoryless MLP is a coin flip (~0.5); the GRU
     solves it.
  2. `pendulum_po` (envs/wrappers.mask_obs) -- Pendulum with the angular
     velocity hidden.  The GRU recovers the velocity from consecutive
     angles.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU:
PPOC_PLATFORM=cpu python examples_torch/recurrent_memory.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device

RECALL = PPOConfig(env="recall", n_envs=128, rollout_len=6,
                   minibatch_size=192, fits_per_epoch=8, n_epochs=5,
                   eval_envs=256, eval_len=6, hidden=(32,), lr_policy=1e-3,
                   lr_v=1e-3, seed=0)
PO = PPOConfig(env="pendulum_po", n_envs=64, rollout_len=200,
               minibatch_size=800, fits_per_epoch=4, n_epochs=15,
               eval_envs=64, rnn_hidden=32, hidden=(64,), seed=0)


def main(argv) -> int:
    device = platform_device()
    # 1. the memory differentiator
    print("== memoryless MLP on recall (can only guess, R ~ 0.5) ==")
    Trainer(RECALL, device).train()

    print("== GRU on recall (remembers the cue, R -> 1.0) ==")
    Trainer(RECALL.replace(rnn_hidden=16), device).train()

    # 2. pendulum with hidden velocity
    print("== GRU on pendulum_po (velocity must be inferred from memory) ==")
    Trainer(PO, device).train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

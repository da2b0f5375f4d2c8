"""Train mixture-of-experts trunks on one device.

The port of the single-device half of ``examples/moe_expert_parallel.py``.
The MoE family (models/moe.py) swaps both the policy mean-net and the
value net for a gated mixture of expert MLPs: the four experts of a layer
run as one ``einsum`` over every row, and the trainer's backend is
"moe:<topk>".  The expert-parallel run (``ep_size=2``, the experts
sharded over an 'ep' mesh axis) waits for the port's multi-device modes
(ROADMAP.md §1 item 16) and is left out.  The card's walls and R:
PERF.md §6.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU:
PPOC_PLATFORM=cpu python examples_torch/moe_expert_parallel.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device

# single-device mixture: 4 experts, dense softmax gating
CFG = PPOConfig(env="pendulum", n_envs=64, rollout_len=200,
                minibatch_size=256, fits_per_epoch=4, n_epochs=6,
                eval_envs=64, n_experts=4)


def main(argv) -> int:
    device = platform_device()
    Trainer(CFG, device).train()

    # top-2 gating: the gate keeps the 2 largest expert weights per input
    Trainer(CFG.replace(moe_topk=2), device).train(n_epochs=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

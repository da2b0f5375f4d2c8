"""Long-context memory with the attention model family.

The port of ``examples/attn_long_context.py``.  Reproduces the
`recall_long` differentiator table (docs/RESULTS.md): the cue is shown at
t=0 and must be answered at t=511 -- a one-hop attention lookup over the
window, but a 511-step BPTT carry for a recurrent cell.  The attention
trunk climbs toward R ~ 0.94 while the GRU and the memoryless MLP stay at
the 0.5 coin-flip baseline.  The card's walls and each leg's R: PERF.md §6.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU.

Usage: python examples_torch/attn_long_context.py [n_epochs] [trunks...]
       python examples_torch/attn_long_context.py 20 attn gru mlp
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device

BASE = PPOConfig(env="recall_long", n_envs=32, rollout_len=512,
                 minibatch_size=2048, fits_per_epoch=2, eval_envs=64,
                 eval_len=512, hidden=(32,), seed=0,
                 lr_policy=1e-3, lr_v=1e-3)


def main(argv) -> int:
    n_epochs = int(argv[1]) if len(argv) > 1 else 20
    trunks = argv[2:] or ["attn", "gru", "mlp"]
    device = platform_device()

    variants = {
        # kernel_backend "auto" (the hand kernels) routes windows >=
        # attn.FLASH_MIN_T (1024) through K7; at T=512 the attention core
        # is the plain masked softmax
        "attn": BASE.replace(attn_dim=32, attn_layers=2, attn_heads=4),
        "gru": BASE.replace(rnn_hidden=32),
        "mlp": BASE,
    }
    for name in trunks:
        cfg = variants[name]
        t0 = time.time()
        hist = Trainer(cfg, device).train(n_epochs=n_epochs, log=False)
        rs = [h["R"] for h in hist]
        print(f"{name:5s}: final R {rs[-1]:.2f}  best {max(rs):.2f}  "
              f"({time.time() - t0:.0f}s)  curve "
              f"{[round(r, 2) for r in rs[:: max(1, n_epochs // 10)]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

"""bf16 long-context bisect: WHICH tensor's rounding kills recall_long's
cue gradient under the bf16 backend?

The port of ``examples/recall_bf16_bisect.py``.  The JAX package's
round-3/4 record: bf16 trains short-window memory identically but never
lifts on the 512-step recall_long where f32 lifts at ~17 epochs.  This
script trains the standard recipe with the bf16 backend while promoting
ONE attention GEMM site at a time back to f32 (the port's
``models/attn.BF16_SITES``): if removing a site restores learning, that
site's rounding is the killer.  Controls: all-bf16 (expected: stuck) and
all-f32 (the "jnp" backend, expected: solves).  Nine legs.  The card's
walls: PERF.md §6.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU.

Usage: python examples_torch/recall_bf16_bisect.py [epochs] [seed]
Prints one line per leg.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device
from ppoc_tpu_torch.models import attn as attn_mod

ALL = ("embed", "qkv", "scores", "av", "out", "ff", "head")


def recipe(seed, backend):
    return PPOConfig(env="recall_long", rollout_len=512, eval_len=512,
                     n_envs=32, minibatch_size=4096, fits_per_epoch=2,
                     eval_envs=64, hidden=(32,), seed=seed,
                     lr_policy=1e-3, lr_v=1e-3, kernel_backend=backend,
                     attn_dim=32, attn_layers=2, attn_heads=4)


def leg(name, sites, backend, seed, n_epochs, device):
    attn_mod.BF16_SITES = frozenset(sites)
    tr = Trainer(recipe(seed, backend), device)
    t0 = time.time()
    best, curve = 0.0, []
    for ep in range(n_epochs):
        tr.train_epoch()
        if ep % 3 == 2 or ep == n_epochs - 1:
            r = tr.evaluate().R
            best = max(best, r)
            curve.append(round(r, 3))
    print(f"{name:28s} best R {best:.3f}  curve {curve}  "
          f"({time.time()-t0:.0f}s)", flush=True)
    return best


def main(argv) -> int:
    n_epochs = int(argv[1]) if len(argv) > 1 else 30
    seed = int(argv[2]) if len(argv) > 2 else 0
    device = platform_device()
    try:
        leg("control f32 (jnp)", ALL, "jnp", seed, n_epochs, device)
        leg("control all-bf16", ALL, "bf16", seed, n_epochs, device)
        for drop in ALL:
            leg(f"bf16 minus {drop}", [s for s in ALL if s != drop],
                "bf16", seed, n_epochs, device)
    finally:
        attn_mod.BF16_SITES = frozenset(ALL)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

"""Long-context recall via the window-DOUBLING curriculum (512 -> 16384).

The port of ``examples/recall_xl_curriculum.py``.  Direct training at
T >= 1024 stalls at R ~ 0.72: the cue's attention weight starts at 1/T of
the softmax mass and the retrieval gradient's SNR falls with the window
(docs/RESULTS.md round-3 record).  The fix is a curriculum through the
product surface, no new machinery:

  phase 1   train `recall_long` (T=512, where the recipe solves) with a
            RIGHT-SIZED window;
  doubling  ``Trainer.from_checkpoint(ckpt, env=next, rollout_len=2T)``
            GROWS the positional table on load (zero rows + zero Adam
            moments for the new positions -- utils/checkpoint
            .adapt_to_template) and fine-tunes.  At T >= 1024 every
            parallel pass (the value planes, the value and policy phases)
            runs the attention core through the flash kernel K7.

The stage configs set the JAX package's program-size relief valves as its
script does (fits_per_program=1 at T=8192, fit_dispatch="phased" +
rollout_chunk=4096 at T=16384).  The port runs every fit eagerly, so they
change nothing here but what the config accepts.  Phase 1 ships with
PPOConfig(transplant_patience=10): a trapped draw is rescued by the
critic->policy encoder transplant.

Two departures from the JAX script:
  * a stage whose checkpoint exists is RESUMED BY EVALUATION: its trainer
    is built from the file and evaluated, and that R is the stage's
    result.  The JAX script takes R = 0.95 on resume without evaluating
    (``examples/recall_xl_curriculum.py:82``), so a poor checkpoint exits
    0 there; here it exits 1;
  * a stage whose file exists is never rewritten.  Run from the repo root
    at seed 0, the script resumes every committed rung
    (``recall_curriculum_*_s0.bin``, written by the JAX package) and
    writes nothing.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU.  The card's
walls and each committed rung's R: PERF.md §6.

Usage: python examples_torch/recall_xl_curriculum.py [seed] [max_T]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device

STAGES = {1024: "recall_xl", 2048: "recall_xxl", 4096: "recall_4k",
          8192: "recall_8k", 16384: "recall_16k"}
PHASE1 = ("recall_long", 512)   # phase 1's env and window
MB_MIN = 4096                   # a stage's least minibatch

# the recipe; the plateau stabilizer (transplant_patience) rescues the
# trapped draws (8/8 seeds solve phase 1 with it -- docs/RESULTS.md r5)
BASE = dict(n_envs=32, minibatch_size=4096, fits_per_epoch=2,
            eval_envs=64, hidden=(32,), lr_policy=1e-3, lr_v=1e-3,
            transplant_patience=10,
            attn_dim=32, attn_layers=2, attn_heads=4)


def relief(T: int) -> dict:
    """The stage's relief valves, as the JAX script sets them."""
    if T >= 16384:
        return dict(fit_dispatch="phased", rollout_chunk=4096,
                    fits_per_program=0)
    return dict(fits_per_program=1 if T >= 8192 else 0)


def main(argv) -> int:
    seed = int(argv[1]) if len(argv) > 1 else 0
    max_t = int(argv[2]) if len(argv) > 2 else 4096
    device = platform_device()

    env1, t1 = PHASE1
    ckpt = f"recall_curriculum_{t1}_s{seed}.bin"
    if os.path.exists(ckpt):
        print(f"phase 1 (T={t1}): resuming from {ckpt}")
    else:
        t0 = time.time()
        tr = Trainer(PPOConfig(env=env1, rollout_len=t1, eval_len=t1,
                               seed=seed, **BASE), device)
        h = tr.train(n_epochs=60, log=False, stop_at_R=0.85)
        print(f"phase 1 (T={t1}): {len(h)} epochs, final R "
              f"{h[-1]['R']:.3f} ({time.time() - t0:.0f}s)")
        if h[-1]["R"] < 0.8:
            print("phase 1 did not reach R >= 0.8 — reseed (recall_long's "
                  "known seed variance) before fine-tuning")
            return 1
        tr.save(ckpt)

    best = 0.0
    for T, env in STAGES.items():
        if T > max_t:
            break
        nxt = f"recall_curriculum_{T}_s{seed}.bin"
        # sequence minibatches need mb >= window (one sequence per
        # minibatch at the top rungs)
        stage = dict(env=env, rollout_len=T, eval_len=T,
                     minibatch_size=max(MB_MIN, T), **relief(T))
        t0 = time.time()
        if os.path.exists(nxt):
            tr = Trainer.from_checkpoint(nxt, device, **stage)
            best = tr.evaluate().R
            print(f"T={T} ({env}): resumed from {nxt}, evaluated R "
                  f"{best:.3f} ({time.time() - t0:.0f}s)")
            ckpt = nxt
            continue
        tr = Trainer.from_checkpoint(ckpt, device, **stage)
        h = tr.train(n_epochs=40, log=False, stop_at_R=0.95)
        best = max(x["R"] for x in h)
        print(f"T={T} ({env}, flash): {len(h)} epochs, best R {best:.3f} "
              f"({time.time() - t0:.0f}s)")
        ckpt = nxt
        tr.save(ckpt)
    return 0 if best >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))

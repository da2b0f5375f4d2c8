"""Each single-device example of the port (``examples_torch/``) on the card:
its wall, its printed results and its launches by kernel.

    python3 tools/examples_on_card.py [--only NAME ...] [--out PATH]

Builds the kernels once, then runs every example's ``main`` in a fresh
temporary directory (the curriculum's holds copies of the six committed
``recall_curriculum_*_s0.bin`` rungs, so it resumes each by evaluation up
to T 16384 and writes nothing), with every launch counter read around it
and its standard output captured.  The Gymnasium pair is left out: the
card's machine has no ``gymnasium``.

Runs whose full length costs tens of minutes on the card take a cut,
named in each run's ``cut`` field: the GRU legs (the recurrent trunk is a
host-bound loop of PyTorch ops, ~30 s a 200-step fit), the bf16 bisect's
nine legs and the seed diagnosis.  Each run is one JSON line on standard
output; all of them, with the card's name and power limit, go to
``--out`` (default ``chiprun_out/examples_on_card.json``).
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RUNGS = (512, 1024, 2048, 4096, 8192, 16384)

# (run label, example, argv after the script name, module patches, cut)
RUNS = (
    ("train_pendulum", "train_pendulum", [], {}, None),
    ("recall_xl_curriculum", "recall_xl_curriculum", ["0", "16384"], {},
     None),
    ("attn_long_context attn mlp", "attn_long_context",
     ["20", "attn", "mlp"], {}, None),
    ("attn_long_context gru", "attn_long_context", ["3", "gru"], {},
     "the gru leg 3 epochs of 20"),
    ("recurrent_memory", "recurrent_memory", [],
     {"PO": dict(n_epochs=2)}, "pendulum_po 2 epochs of 15"),
    ("calibrated_mountain_car", "calibrated_mountain_car", [], {}, None),
    ("hparam_grid", "hparam_grid", [], {}, None),
    ("moe_expert_parallel", "moe_expert_parallel", [], {}, None),
    ("recall_bf16_bisect", "recall_bf16_bisect", ["3", "0"], {},
     "3 epochs a leg of 30"),
    ("recall_seed_diag", "recall_seed_diag", ["1", "6", "2"], {},
     "6 epochs of 40"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", default=None,
                    help="run labels to run (default: all)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "examples_on_card.json"))
    args = ap.parse_args()

    import warnings

    import torch

    import chip_smoke
    from ppoc_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("examples_on_card: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = _build.build()
    _build.load()
    print(f"build {info['seconds']:.1f} s", flush=True)
    counters = chip_smoke.launch_counters()
    rows = []
    for label, name, argv, patches, cut in RUNS:
        if args.only and label not in args.only:
            continue
        mod = chip_smoke.load_example(name)
        for attr, kw in patches.items():
            setattr(mod, attr, getattr(mod, attr).replace(**kw))
        with tempfile.TemporaryDirectory() as tmp:
            if name == "recall_xl_curriculum":
                for T in RUNGS:
                    shutil.copy(ROOT / f"recall_curriculum_{T}_s0.bin", tmp)
            chip_smoke.header(f"[{label}: {name}.py {' '.join(argv)}]")
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rc, out, counts, wall = chip_smoke.run_example(
                    mod, [f"{name}.py", *argv], tmp, counters)
            left = sorted(p.name for p in Path(tmp).iterdir())
        row = {"run": label, "example": f"examples_torch/{name}.py",
               "argv": argv, "cut": cut, "exit": rc, "wall_s": wall,
               "launches": chip_smoke.nonzero(counts), "files": left,
               "output": out.splitlines(), "card": card,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "output"}),
              flush=True)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"card": card, "runs": rows}, indent=1))
    print(f"wrote {out_path}", flush=True)
    return 0 if all(r["exit"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

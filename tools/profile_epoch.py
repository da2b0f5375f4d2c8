"""Profile one training epoch on the card.

    python3 tools/profile_epoch.py [--config bench|throughput|reacher|reacher_ref|reacher_bf16|recall_xl]
                                   [--root OTHER]

Needs a CUDA device.  ``bench`` (the default) is bench.py's bench_config:
three warm epochs, each with its stochastic evaluation, timed without the
profiler; then one more under torch.profiler; then K3's microseconds per
minibatch step (100-step phases) at mb 256/128/64 with hidden 128 and at
hidden 64/32 with mb 256.  ``throughput`` is tpu_preset("pendulum"): three
warm training epochs and three evaluate(deterministic=True) timed alone,
then one of each under the profiler.  ``reacher`` is the reacher regime
(chip_smoke.REACHER: 4096 envs x 150, minibatch 16384 in blocks of 4096,
2x256 nets): one warm epoch, then three training epochs timed alone and
one under the profiler; ``reacher_ref`` the same for chip_smoke.REACHER_REF
(the reference schedule at 2x256: 10 fits an epoch through K3 and K4 in
their global-memory variants), ``reacher_bf16`` for chip_smoke.REACHER_BF16
(the reacher regime under kernel_backend "bf16": K1, K2 and bf16 library
products).  ``recall_xl`` is chip_smoke.RECALL_XL (K7 in every pass): one
warm epoch, then two epochs split by phase (chip_smoke.PhaseClock) with
K7's launches, without the profiler.  ``--root`` runs the package of
another checkout (a parent's ``git archive``) with this checkout's
harness, to compare two builds in one call.  Each profiled window prints its wall
time, summed device-kernel time, the count of device kernels and each
kernel's share of device time, and the device's idle share two ways: 1 -
device time / the mean unprofiled wall of the same window (the path's own
idle share) and 1 - device time / the profiled wall (which the profiler's
host overhead inflates).  The gzipped chrome traces go to chiprun_out/
under the checkout.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _harness():
    """This checkout's chip_smoke.py as a module, whatever ``--root``
    puts first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _harness()
sys.path.insert(0, str(ROOT))
if "--root" in sys.argv:   # the package of another checkout, first
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1])
                           .resolve()))


def profiled(name: str, fn, walls) -> None:
    """Run ``fn`` once under torch.profiler and print its device split;
    ``walls`` are its unprofiled wall times (s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    plain = sum(walls) / len(walls)
    print(f"profiled {name}: wall {wall:.4f} s, device-kernel time "
          f"{busy:.4f} s, idle share {1 - busy / plain:.4f} of the mean "
          f"unprofiled wall {plain:.4f} s ({1 - busy / wall:.4f} of the "
          f"profiled wall), {len(events)} device events", flush=True)
    per = {}
    for e in events:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    for kname, sec in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {sec:.4f} s  {100 * sec / busy:.2f}%  {kname[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"{name.replace(' ', '_')}_trace.json.gz"))


def recall_xl_phases(root: str) -> int:
    """chip_smoke.RECALL_XL: a warm epoch, then two epochs timed by phase
    with K7's launches read around each."""
    import torch

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.ops import cuda_attn

    counters = [cuda_attn.fwd_launches, cuda_attn.dq_launches,
                cuda_attn.dkv_launches]
    tr = Trainer(PPOConfig(**cs.RECALL_XL))
    tr.train_epoch()
    torch.cuda.synchronize()
    for i in range(2):
        clock = cs.PhaseClock(counters)
        t = time.perf_counter()
        with clock:
            tr.train_epoch()
            torch.cuda.synchronize()
        split = clock.split(time.perf_counter() - t)
        k7 = {ph: n for ph, n in clock.launches.items() if any(n.values())}
        print(f"recall_xl epoch {i} ({root}): wall split (s) "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; K7 launches {k7}", flush=True)
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="bench",
                    choices=["bench", "throughput", "reacher", "reacher_ref",
                             "reacher_bf16", "recall_xl"])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ppoc_tpu_torch import PPOConfig, tpu_preset
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import init as adam_init

    print(cs.card_line(), flush=True)
    if args.config == "recall_xl":
        return recall_xl_phases(args.root)
    dev = torch.device("cuda", 0)
    throughput = args.config != "bench"
    tr = Trainer({"bench": cs.bench_config,
                  "throughput": lambda: tpu_preset("pendulum"),
                  "reacher": lambda: PPOConfig(**cs.REACHER),
                  "reacher_ref": lambda: cs.wide_config("reacher"),
                  "reacher_bf16": lambda: PPOConfig(**cs.REACHER_BF16),
                  }[args.config]())

    def epoch():
        t = time.perf_counter()
        tr.train_epoch()
        if not throughput:
            tr.evaluate()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def det_eval():
        t = time.perf_counter()
        tr.evaluate(deterministic=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    epoch()
    what = "epoch" if throughput else "epoch + eval"
    walls = [epoch() for _ in range(3)]
    print(f"{what} wall, no profiler (s):", [round(w, 4) for w in walls],
          flush=True)
    profiled(what, epoch, walls)
    if args.config in ("reacher", "reacher_ref", "reacher_bf16"):
        return 0
    if throughput:
        det_eval()
        walls = [det_eval() for _ in range(3)]
        print("mean-policy eval wall, no profiler (s):",
              [round(w, 4) for w in walls], flush=True)
        profiled("mean-policy eval", det_eval, walls)
        return 0

    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    g = torch.Generator().manual_seed(0)
    n = 100
    for mb, hid in [(256, 128), (128, 128), (64, 128), (256, 64), (256, 32)]:
        p = mlp.init((3, hid, hid, 1), g, dev)
        x = torch.randn(n * mb, 3, generator=g).to(dev)
        y = torch.randn(n * mb, generator=g).to(dev)
        ms = cs.timed_ms(lambda: cu.value_phase_kernel(
            x, y, p, adam_init(p), n, mb, "relu", h), 3)
        print(f"K3 mb={mb} hidden={hid}: {1000 * ms / n:.1f} us/step",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

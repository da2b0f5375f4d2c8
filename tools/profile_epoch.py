"""Profile one training epoch on the card.

    python3 tools/profile_epoch.py [--config bench|throughput]

Needs a CUDA device.  ``bench`` (the default) is bench.py's bench_config:
three warm epochs, each with its stochastic evaluation, timed without the
profiler; then one more under torch.profiler; then K3's microseconds per
minibatch step (100-step phases) at mb 256/128/64 with hidden 128 and at
hidden 64/32 with mb 256.  ``throughput`` is tpu_preset("pendulum"): three
warm training epochs and three evaluate(deterministic=True) timed alone,
then one of each under the profiler.  Each profiled window prints its wall
time, summed device-kernel time, the count of device kernels and each
kernel's share of device time, and the device's idle share two ways: 1 -
device time / the mean unprofiled wall of the same window (the path's own
idle share) and 1 - device time / the profiled wall (which the profiler's
host overhead inflates).  The gzipped chrome traces go to chiprun_out/
under the checkout.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=["bench", "throughput"],
                    default="bench")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ppoc_tpu_torch import tpu_preset
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import init as adam_init

    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    throughput = args.config == "throughput"
    tr = Trainer(tpu_preset("pendulum") if throughput else cs.bench_config())

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

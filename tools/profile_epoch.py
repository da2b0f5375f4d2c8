"""Profile one training epoch of the bench configuration, and time K3 per
minibatch step against the minibatch size and hidden width.

    python3 tools/profile_epoch.py

Needs a CUDA device.  Prints the wall time of three warm epochs (each with
its evaluation) without the profiler; then, under torch.profiler, one more
epoch's wall time, its summed device-kernel time, the device's idle share
and each kernel's share of device time; then K3's microseconds per
minibatch step (100-step phases) at mb 256/128/64 with hidden 128 and at
hidden 64/32 with mb 256.  The chrome trace goes to
chiprun_out/epoch_trace.json under the checkout.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import init as adam_init

    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    tr = Trainer(cs.bench_config(), dev)

    def epoch():
        t = time.perf_counter()
        tr.train_epoch()
        tr.evaluate()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    epoch()
    print("epoch + eval wall, no profiler (s):",
          [round(epoch(), 4) for _ in range(3)], flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = epoch()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    print(f"profiled epoch + eval: wall {wall:.4f} s, device-kernel time "
          f"{busy:.4f} s, idle share {1 - busy / wall:.4f}, "
          f"{len(events)} device events", flush=True)
    per = {}
    for e in events:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    for name, sec in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {sec:.4f} s  {100 * sec / busy:.2f}%  {name[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "epoch_trace.json"))

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

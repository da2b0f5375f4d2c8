"""Kernel outputs bit for bit against another checkout's build: K1's
pendulum lane, K5, K7's float32 variant, and the fused update phases.

    python3 tools/kernel_bits.py --kernel k1|k5|k7|phases --root OTHER
                                 --save FILE [--time]
    python3 tools/kernel_bits.py --kernel k1|k5|k7|phases --compare FILE
                                 [--time]

Launches the kernels of the checkout at ``--root`` (default: this one) on
one CUDA device at fixed seeds and weights.  ``k1``: the rollout kernel
(``ops/cuda_rollout.rollout_kernel``, pendulum lane) at 64 envs x 200
steps with the V planes (the bench shape), 1024 x 200 (the throughput
shape) and 64 x 40 from a carried state across the horizon.  ``k5``: the
whole-MLP forward and backward (``ops/cuda_mlp.mlp_forward_kernel``,
``mlp_backward_kernel``) in both variants at 8192 rows of [3,128,128,1],
in shared memory at 256 rows of it, and in global memory at 16384 rows of
[10,256,256,1] and 256 rows of [10,256,256,2] (the backward on the plain
forward's hiddens).  ``k7``: the
float32 forward, dq and dk/dv kernels (``ops/cuda_attn.flash_*_kernel``)
at this checkout's ``chip_smoke.py`` timed shapes (the recall_xl minibatch
and value pass, the X-ray shape) and a ring block of rel -1, same seeds.
``phases``: the fused update phases (``ops/cuda_update``): K3, K4 and
K6 in both variants (the replicated cluster, where the net fits it, and
the "global" slot: the sharded cluster, or in an older checkout one block
staging the weights from global memory; K6 in an older checkout one block
in both), on the bench nets (20 steps of 256 rows), at [3,192,192,1] and
at 2x256 (10 steps of 64), on seeded rows and weights.
``--save`` writes every output with torch.save; ``--compare`` checks each
against the saved one with torch.equal, prints one line per launch (for
each output that differs, the largest |difference|, or the count of
unequal elements of an integer or boolean output) and exits 1 on any
difference.  Use it to show that a change to a kernel's
source left its arithmetic as it was.  ``--time`` also prints each
launch's device time, with this checkout's ``chip_smoke.queued_ms`` (CUDA
events around 20 launches queued behind a spin kernel): run parent,
change, change, parent in one call to compare two builds on one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def k1_launches(torch, cs, dev):
    """name -> a launch of K1's pendulum lane returning its outputs."""
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    g = torch.Generator().manual_seed(0)
    pol = mlp.init((3, 128, 128, 1), g, dev)
    val = mlp.init((3, 128, 128, 1), g, dev)
    log_std = torch.full((1,), -0.3, device=dev)
    st0 = (torch.rand(64, 2, generator=g) * 4 - 2).to(dev)
    steps0 = torch.full((64,), 180.0, device=dev)
    runs = {
        "bench 64x200, V planes": (pol, log_std, val, (7, 9), 64, 200),
        "throughput 1024x200": (pol, log_std, None, (1, 2), 1024, 200),
        "carried 64x40 across the horizon": (pol, log_std, val, (3, 4), 64,
                                             40, "relu", st0, steps0),
    }

    def launch(args):
        return lambda: {k: v for k, v in cr.rollout_kernel(
            *args)._asdict().items() if v is not None}

    return {name: launch(args) for name, args in runs.items()}


def k5_launches(torch, cs, dev):
    """name -> a launch of K5's forward or backward returning its
    outputs.  The backward takes the plain forward's hiddens, so it is
    timed alone and both builds see the same inputs."""
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_mlp as cm

    runs = {}
    for widths, rows, variants in (((3, 128, 128, 1), 8192,
                                    ("smem", "global")),
                                   ((3, 128, 128, 1), 256, ("smem",)),
                                   ((10, 256, 256, 1), 16384, ("global",)),
                                   ((10, 256, 256, 2), 256, ("global",))):
        g = torch.Generator().manual_seed(widths[-1])
        params = mlp.init(widths, g, dev)
        x = torch.randn(rows, widths[0], generator=g).to(dev)
        cot = torch.randn(rows, widths[-1], generator=g).to(dev)
        _, hid = cm.mlp_forward_plain(params, x, "relu")
        for v in variants:
            tag = f"{list(widths)} x {rows}, {v}"

            def fwd(v=v, params=params, x=x):
                out, hid = cm.mlp_forward_kernel(params, x, "relu", v)
                return {"out": out, **{f"h{i}": h for i, h in
                                       enumerate(hid)}}

            def bwd(v=v, params=params, x=x, cot=cot, hid=hid):
                grads, dx = cm.mlp_backward_kernel(params, x, hid, cot,
                                                   "relu", True, v)
                return {"grads": mlp.flatten(grads), "dx": dx}

            runs[f"K5 forward, {tag}"] = fwd
            runs[f"K5 backward, {tag}"] = bwd
    return runs


def k7_launches(torch, cs, dev):
    """name -> a launch of one of K7's float32 kernels returning its
    outputs, on chip_smoke's cases (the backward from the forward's lse)."""
    from ppoc_tpu_torch.ops import cuda_attn as ca

    xl = cs.dones_of_rollout("recall_xl", 1024, 32, dev)
    cases = {
        "recall_xl minibatch": (cs.flash_case(1024, 4, 4, 8, xl[:, :4], 1,
                                              dev), 0, 4),
        "recall_xl value pass": (cs.flash_case(1024, 32, 4, 8, xl, 4, dev),
                                 0, 4),
        "X-ray": (cs.flash_case(2048, 16, 8, 64, cs.random_dones(
            2048, 16, 0.02, 7, dev), 8, dev), 0, 8),
        "ring block rel -1": (cs.flash_case(
            1024, 4, 4, 8, cs.random_dones(1024, 4, 0.02, 9, dev), 11, dev,
            k_dones=cs.random_dones(1024, 4, 0.02, 10, dev)), -1, 4),
    }
    runs = {}
    for name, ((q, k, v, dout, g_lse, ep_q, ep_k), rel, H) in cases.items():
        kargs = (q, k, v, ep_q, ep_k, rel, H)
        out, lse = ca.flash_fwd_kernel(*kargs)
        bargs = kargs + (dout, ca.dsum_of(dout, out, g_lse).contiguous(),
                         lse)
        runs[f"{name}, forward"] = lambda a=kargs: dict(
            zip(("out", "lse"), ca.flash_fwd_kernel(*a)))
        runs[f"{name}, dq"] = lambda a=bargs: {"dq": ca.flash_dq_kernel(*a)}
        runs[f"{name}, dk/dv"] = lambda a=bargs: dict(
            zip(("dk", "dv"), ca.flash_dkv_kernel(*a)))
    return runs


def phase_launches(torch, cs, dev):
    """name -> a launch of a one-block update phase returning its outputs
    (the trained tensors, Adam's moments and the stats)."""
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import AdamState

    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)

    def state(widths, g):
        params = mlp.init(widths, g, dev)
        m = [(0.01 * torch.randn(w.shape, generator=g).to(dev),
              0.01 * torch.randn(b.shape, generator=g).to(dev))
             for w, b in params]
        v = [(x * x, y * y) for x, y in m]
        return params, AdamState(m, v, 5)

    def outputs(out):
        """Every output as a flat tensor, an Adam state as its m and v."""
        flat = {}
        for i, x in enumerate(out):
            parts = ({"m": x.m, "v": x.v} if isinstance(x, AdamState)
                     else {"": x})
            for k, t in parts.items():
                flat[f"{i}{k}"] = (mlp.flatten(t) if isinstance(t, list)
                                   else t.reshape(-1))
        return flat

    runs = {}
    for hidden, n, mb in (((128, 128), 20, 256), ((192, 192), 10, 64),
                          ((256, 256), 10, 64)):
        g = torch.Generator().manual_seed(hidden[0])
        rows = n * mb
        x = torch.randn(rows, 3, generator=g).to(dev)
        tgt = (10 * torch.randn(rows, generator=g)).to(dev)
        act = torch.randn(rows, 1, generator=g).to(dev)
        cls = torch.randint(0, 2, (rows, 1), generator=g,
                            dtype=torch.int32).to(dev)
        lp = (0.3 * torch.randn(rows, generator=g)).to(dev)
        adv = torch.randn(rows, generator=g).to(dev)
        vp, vo = state((3, *hidden, 1), g)
        pp, po = state((3, *hidden, 1), g)
        cp, co = state((3, *hidden, 2), g)
        ls = torch.full((1,), -0.5, device=dev)
        lso = AdamState(torch.full((1,), 0.01, device=dev),
                        torch.full((1,), 1e-4, device=dev), 7)
        tag = f"{hidden[0]}x2, {n} x {mb}"
        for variant in ("smem", "global") if hidden == (128, 128) else (
                "global",):
            runs[f"K3 {variant}, {tag}"] = lambda a=(
                x, tgt, vp, vo, n, mb), v=variant: outputs(
                cu.value_phase_kernel(*a, "relu", h, variant=v))
            runs[f"K4 {variant}, {tag}"] = lambda a=(
                x, act, lp, adv, pp, ls, po, lso, n, mb), v=variant: outputs(
                cu.policy_phase_kernel(*a, "relu", h, 0.2, 0.01, variant=v))
        for variant in ("smem", "global") if hidden == (128, 128) else (
                "global",):
            runs[f"K6 {variant}, {tag}"] = lambda a=(
                x, cls, lp, adv, cp, co, n, mb), v=variant: outputs(
                cu.policy_phase_categorical_kernel(*a, "relu", h, 0.2, 0.01,
                                                   variant=v))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k1", "k5", "k7", "phases"),
                    required=True)
    ap.add_argument("--root", default=str(HERE))
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save")
    mode.add_argument("--compare")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    launches = {"k1": k1_launches, "k5": k5_launches, "k7": k7_launches,
                "phases": phase_launches}[args.kernel](torch, cs, dev)
    got = {}
    for name, fn in launches.items():
        outs = fn()
        torch.cuda.synchronize()
        got[name] = {k: v.cpu() for k, v in outs.items()}
    if args.time:
        print(cs.card_line())
        for name, fn in launches.items():
            print(f"{name}: {cs.queued_ms(fn, 20):.4f} ms a launch "
                  f"({args.root})", flush=True)
    if args.save:
        torch.save(got, args.save)
        print(f"saved {len(got)} launches' outputs of {args.root} to "
              f"{args.save}")
        return 0
    want = torch.load(args.compare)
    bad = 0
    for name, outs in want.items():
        diff = {k: distance(got[name][k], v) for k, v in outs.items()
                if not torch.equal(got[name][k], v)}
        bad += bool(diff)
        apart = ", ".join(f"{k} {d}" for k, d in diff.items())
        print(f"{name}: {'DIFFER: ' + apart if diff else 'identical'}")
    return 1 if bad else 0


def distance(a, b) -> str:
    """How far two outputs of one launch are apart: the largest |a - b| of
    float outputs, the count of unequal elements of the others."""
    import torch

    if a.shape != b.shape:
        return f"shape {tuple(a.shape)} vs {tuple(b.shape)}"
    if a.is_floating_point():
        return f"max |diff| {float((a.double() - b.double()).abs().max()):.3e}"
    return f"{int((a != b).sum())} of {a.numel()} elements"


if __name__ == "__main__":
    sys.exit(main())

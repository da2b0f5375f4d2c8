"""Where one step of K6, the categorical policy phase, parts from float64,
and how much of that is the float32 rounding of its loss head.

    python3 tools/head_rounding.py [--cpu] [CASE ...]

A CASE is ``classes:hidden:mb:rows_seed:step``, e.g. ``2:128x128:64:0:0``:
a policy of that many classes (2: cartpole's inputs, more: acrobot's) with
the hidden widths, seeded rows as the card tests make them
(``tests/test_torch_cuda.py`` ``_categorical_case``, 20 minibatches of
``mb`` rows), one step at minibatch ``step`` from the walk's state (the
kernel's own, on a card; on the CPU the starting state).  The default is
the case the replicated cluster's walk flagged at step 0, and the three
sharded-cluster cases whose single steps once parted from the plain
version's by more than 1e-6.

For each case, on a CUDA device (unless ``--cpu``): the kernel's and the
plain version's step against the float64 step, the weight farthest
outside the float64 band (``chip_smoke.band_reading``), and the plain step
with the minibatch's rows in 32 other orders at that weight (the same
float64 step).  On any device: the logit gradient computed four ways, with
the forward, the backward's sums and Adam in float64, and each step's
largest distance from the float64 step: the reference formula in float32
on the float32 logits, in double on the float32 logits rounded once (what
``csrc/cluster.cuh`` ``categorical_head`` does), in double on the float64
logits rounded once (the storage alone), and in float32 on the float64
logits (the formula alone).
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = ("2:128x128:64:0:0", "2:256x256:64:0:0", "2:160x160x160:64:0:0",
         "2:448x448x448:64:0:0")


def chip_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def case(torch, K, hidden, n_rows, dev, seed=0):
    """(policy net, its Adam state at t 4, rows) as the card tests'
    _categorical_case and _phase_case make them."""
    from ppoc_tpu_torch import PPOConfig, envs
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import adam

    env = "cartpole" if K == 2 else "acrobot"
    ts = ppo.init_train_state(PPOConfig(env=env, hidden=hidden),
                              envs.make(env), torch.Generator().manual_seed(0),
                              dev)
    d0 = envs.make(env).spec.obs_dim
    net, opt = ts.policy_params["mlp"], ts.opt_policy
    if K > 3:
        net = mlp.init((d0, *hidden, K), torch.Generator().manual_seed(0),
                       dev)
        opt = adam.init(net)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n_rows, d0, generator=g).to(dev)
    a = torch.randint(0, K, (n_rows, 1), generator=g,
                      dtype=torch.int32).to(dev)
    lp = (torch.log(torch.full((n_rows,), 1.0 / K))
          + 0.3 * torch.randn(n_rows, generator=g)).to(dev)
    adv = torch.randn(n_rows, generator=g).to(dev)
    return net, opt._replace(t=4), (x, a, lp, adv)


def head_ways(torch, cs, net, opt, rows, hp, extra):
    """Each way of computing the logit gradient -> the step's largest
    distance from the float64 step, and where."""
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    W = [w.double() for w, _ in net]
    B = [b.double() for _, b in net]
    x, a, lp, adv = (c.double() if c.is_floating_point() else c
                     for c in rows)
    L, mb, K = len(W), x.shape[0], W[-1].shape[1]
    clip_eps, ent_coeff = extra

    def forward(dtype):
        h, hs = x.to(dtype), []
        for l in range(L - 1):
            h = torch.relu(h @ W[l].to(dtype) + B[l].to(dtype))
            hs.append(h)
        return hs, h @ W[-1].to(dtype) + B[-1].to(dtype)

    def head(z):
        """The reference formula in z's dtype."""
        zmax = z.max(dim=1, keepdim=True).values
        lse = zmax + torch.log(torch.exp(z - zmax).sum(dim=1, keepdim=True))
        lpa = z - lse
        p = torch.exp(lpa)
        onehot = (torch.arange(K, device=z.device)[None] == a).to(z.dtype)
        ratio = torch.exp((onehot * lpa).sum(dim=1) - lp.to(z.dtype))
        ra = ratio * adv.to(z.dtype)
        ca = ratio.clamp(1 - clip_eps, 1 + clip_eps) * adv.to(z.dtype)
        H = -(p * lpa).sum(dim=1)
        dlogp = -(adv.to(z.dtype) * ratio / mb) * (ra <= ca).to(z.dtype)
        return (dlogp[:, None] * (onehot - p)
                + (ent_coeff / mb) * p * (lpa + H[:, None]))

    hs, z64 = forward(torch.float64)
    _, z32 = forward(torch.float32)

    def step(dz):
        out, g = [None] * (2 * L), dz.double()
        for l in range(L - 1, -1, -1):
            out[2 * l] = (x if l == 0 else hs[l - 1]).T @ g
            out[2 * l + 1] = g.sum(dim=0)
            if l > 0:
                g = (g @ W[l].T) * (hs[l - 1] > 0)
        g = torch.cat([o.reshape(-1) for o in out])
        bc1, bc2 = cu._bias_corrections(opt.t + 1, hp)
        m = hp.b1 * mlp.flatten(opt.m).double() + hp.omb1 * g
        v = hp.b2 * mlp.flatten(opt.v).double() + hp.omb2 * g * g
        return hp.lr * (m / bc1) / ((v / bc2).sqrt() + hp.eps)

    exact = step(head(z64))
    ways = {"reference formula in float32": head(z32),
            "double from the float32 logits": head(z32.double()).float(),
            "double from the float64 logits": head(z64).float(),
            "float32 from the float64 logits": head(z64.float())}
    out = []
    for name, dz in ways.items():
        d = (step(dz) - exact).abs()
        out.append(f"{name} {float(d.max()):.3e} (at {int(d.argmax())})")
    return "; ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", default=list(CASES))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(HERE))
    from ppoc_tpu_torch.ops import cuda_update as cu

    cs = chip_smoke()
    card = torch.cuda.is_available() and not args.cpu
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0), flush=True)
    hp = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    extra = (0.2, 0.01)
    for spec in args.cases:
        K, hidden, mb, seed, s = spec.split(":")
        K, mb, seed, s = int(K), int(mb), int(seed), int(s)
        hidden = tuple(int(h) for h in hidden.split("x"))
        net, opt, cols = case(torch, K, hidden, 20 * mb, dev, seed)
        tail = (1, mb, "relu", hp, *extra)
        plain = cu.policy_phase_categorical_plain
        kernel = cu.policy_phase_categorical_kernel
        for j in range(s if card else 0):   # the walk's state at step s
            net, opt = kernel(*(c[j * mb:(j + 1) * mb] for c in cols), net,
                              opt, *tail)[:2]
        rows = [c[s * mb:(s + 1) * mb] for c in cols]
        print(f"{K} classes, {list(hidden)}, mb {mb}, rows seed {seed}, "
              f"step {s}", flush=True)
        if card:
            k1 = kernel(*rows, net, opt, *tail)[:2]
            p1 = plain(*rows, net, opt, *tail)[:2]
            x1 = plain(*cs.to_double((*rows, net, opt)), *tail)[:2]
            xw = cs.trained(x1, 2)

            def apart(r):
                return float((cs.trained(r, 2).double() - xw).abs().max())

            print(f"  from float64: kernel {apart(k1):.3e}, plain "
                  f"{apart(p1):.3e}; kernel "
                  + cs.band_reading((net, opt), rows, hp, extra, k1, p1, x1),
                  flush=True)
            band, _ = cs.gate_band((net, opt), rows, hp, extra)
            wk = cs.trained(k1, 2).double()
            i = int(torch.maximum(band[0] - wk, wk - band[1]).argmax())
            g = torch.Generator().manual_seed(1)
            at = sorted(
                abs(float(cs.trained(plain(*(c[perm] for c in rows), net,
                                           opt, *tail)[:2], 2)[i])
                    - float(xw[i]))
                for perm in (torch.randperm(mb, generator=g).to(dev)
                             for _ in range(32)))
            print(f"  at {i}: |kernel - float64| "
                  f"{abs(float(wk[i]) - float(xw[i])):.3e}, the plain step "
                  f"with the rows in 32 orders: median {at[16]:.3e}, max "
                  f"{at[-1]:.3e}", flush=True)
        print("  the head, the rest in float64, from float64: "
              + head_ways(torch, cs, net, opt, rows, hp, extra), flush=True)


if __name__ == "__main__":
    main()

"""Where a 200-step policy phase (kernel K4 or K6), or a 500-step value
phase (K3), drifts from exact arithmetic.

    python3 tools/policy_phase_drift.py [--lane pendulum] [--seeds 0 1 2]
    python3 tools/policy_phase_drift.py --lane cartpole|acrobot \
        [--seeds 0 1 2] [--draws 2 12] [--phase value]
    python3 tools/policy_phase_drift.py --lane reacher|cartpole \
        --hidden 256 256 [--draws 1 11] [--phase value]

Needs a CUDA device.  ``--lane pendulum`` (or ``reacher``, two action
dims) holds K4, the Gaussian phase; ``cartpole`` and ``acrobot`` hold K6,
the categorical phase, with chip_smoke.py's entropy coefficients (0 and
0.01); ``--phase value`` holds K3 on the same fit's value rows instead (no
clip branch: its counts are 0).  ``--env`` is another name for ``--lane``.
For each seed (the
weights) and each row draw it builds one fit's policy rows at the bench
configuration's shapes, or with ``--hidden`` at the reference schedule's
(``chip_smoke.wide_config``: 15 envs x 200, minibatch 64, 10 value and 4
policy epochs; nets past one block's shared memory take the kernels'
global-memory variant), (kernel rollout, kernel GAE) and runs the whole
phase five ways: the kernel; the plain version in float32 on the card and
on the CPU; the plain version in float64 (the exact answer); and float64
again from starting weights perturbed by one float32 rounding (relative
2^-24, random sign), which measures how far the phase itself amplifies a
rounding-sized difference.  Each run's distance from float64 is printed as
max |diff| and as L2 relative to the phase's weight travel, beside a
float64 run with the learning rate 1% off, and as the ratio of the two L2
distances (what chip_smoke.py's whole-phase check bounds).  At seed 0 and
the first draw the rows are chip_smoke.py's own.

Then it walks the kernel, plain float32 and float64 runs one step at a
time (one launch per step; the chained kernel must equal the single
launch bit for bit) and records per step: each run's max distance from
float64; how many rows take the other clip branch, and how many hidden
units of the minibatch's rows the other ReLU gate, than float64 does
(evaluated in float64 on each run's own weights); and the local error,
one kernel / plain-float32 step against one float64 step from the same
(kernel) state.  Writes everything to chiprun_out/policy_phase_drift.json
under the checkout (``<phase>_phase_drift_<lane>[_<hidden>].json``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", "--env", default="pendulum",
                    choices=["pendulum", "reacher", *DISCRETE])
    ap.add_argument("--hidden", type=int, nargs="+", default=None,
                    help="hidden widths: the reference schedule at these "
                         "widths in place of the bench configuration")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--draws", type=int, nargs="+", default=None,
                    help="row-draw seeds (default: seed + 1 for pendulum, "
                         "chip_smoke's and one more for a discrete lane)")
    ap.add_argument("--phase", default="policy", choices=["policy", "value"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    lane = args.lane
    value = args.phase == "value"

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_gae, cuda_rollout as cr
    from ppoc_tpu_torch.ops import cuda_update as cu

    print(cs.card_line(), flush=True)
    flat = mlp.flatten
    discrete = lane in DISCRETE
    if discrete:
        i, ent = DISCRETE[lane]
        kernel = cu.policy_phase_categorical_kernel
        plain = cu.policy_phase_categorical_plain
        draws = args.draws or [2 + i, 12 + i]
    else:
        kernel, plain = cu.policy_phase_kernel, cu.policy_phase_plain
    if value:
        kernel, plain = cu.value_phase_kernel, cu.value_phase_plain
    report = {"card": cs.card_line(), "lane": lane, "phase": args.phase,
              "hidden": args.hidden, "cases": {}}
    cases = [(seed, draw) for seed in args.seeds
             for draw in (draws if discrete else args.draws or [seed + 1])]
    for seed, draw in cases:
        if args.hidden:
            cfg = cs.wide_config(lane, tuple(args.hidden), seed)
        else:
            cfg = cs.bench_config(seed)
            if discrete:
                cfg = cfg.replace(env=lane, eval_len=500)
        if not discrete:
            ent = cfg.ent_coeff
        tr = Trainer(cfg, dev)
        ts = tr.state
        pp, vp = ts.policy_params, ts.v_params
        E, T, mb = cfg.n_envs, cfg.rollout_len, cfg.minibatch_size
        if discrete:     # chip_smoke.py's discrete rows at seed 0
            raw = cr.rollout_kernel(pp["mlp"], None, vp,
                                    (0x2545F491 + i, 0x9E3779B9 + seed), E,
                                    T, "relu", None, None, 0.99, lane)
            state0 = (pp["mlp"], ts.opt_policy)
        else:
            raw = cr.rollout_kernel(pp["mlp"], pp["log_std"], vp,
                                    (0x01234567 + seed, 0x89ABCDEF), E, T,
                                    lane=lane)
            state0 = (pp["mlp"], pp["log_std"], ts.opt_policy,
                      ts.opt_log_std)
        if value:
            state0 = (vp, ts.opt_v)
        ns = len(state0)
        trunc = raw.truncated.clone()
        trunc[-1] |= ~raw.terminated[-1]
        adv, tgt = cuda_gae.gae_norm_kernel(
            raw.reward, raw.value, raw.next_value, raw.terminated, trunc,
            0.99, cfg.lam)
        vcols, pcols = cs.phase_rows(cfg, raw, adv, tgt, dev,
                                     draw_seed=draw)
        cols = vcols if value else pcols
        extra = () if value else (cfg.clip_eps, ent)
        lr = cfg.lr_v if value else cfg.lr_policy
        n = cols[0].shape[0] // mb
        hp = cu.Hyper.of(lr, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps)

        def run(fn, state, s0, steps, cast=lambda x: x, hyper=hp,
                device=dev):
            rows = [cast(c[s0 * mb:(s0 + steps) * mb]).to(device)
                    for c in cols]
            st = cs.to_double(state) if cast is cs.to_double else state
            st = _to(st, device)
            out = fn(*rows, *st, steps, mb, cfg.activation, hyper, *extra)
            return out[:ns]

        def weights(state):
            ls = [] if discrete or value else [state[1].double().cpu()]
            return torch.cat([flat(state[0]).double().cpu()] + ls)

        # whole-phase runs
        w0 = weights(state0)
        exact = run(plain, state0, 0, n, cs.to_double)
        wx = weights(exact)
        travel = float((wx - w0).norm())
        runs = {
            "kernel": run(kernel, state0, 0, n),
            "plain_f32_card": run(plain, state0, 0, n),
            "plain_f32_cpu": run(plain, state0, 0, n,
                                 device=torch.device("cpu")),
            "f64_lr_plus_1pct": run(
                plain, state0, 0, n, cs.to_double,
                cu.Hyper.of(1.01 * lr, cfg.adam_beta1, cfg.adam_beta2,
                            cfg.adam_eps)),
        }
        gen = torch.Generator().manual_seed(100 + seed)
        for k in range(2):
            def nudge(t):
                t = t.double()
                sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
                return t * (1 + sign.to(t.device, torch.float64) * 2.0 ** -24)
            pert = ((_tmap(nudge, state0[0]), state0[1]) if ns == 2 else
                    (_tmap(nudge, state0[0]), nudge(state0[1]), state0[2],
                     state0[3]))
            runs[f"f64_rounding_nudge_{k}"] = run(
                plain, cs.to_double(pert), 0, n, cs.to_double)
        tag = f"seed {seed} draw {draw}"
        d_lr = float((weights(runs["f64_lr_plus_1pct"]) - wx).norm())
        whole = {}
        for name, st in runs.items():
            w = weights(st)
            whole[name] = {"max_abs": float((w - wx).abs().max()),
                           "rel_l2": float((w - wx).norm()) / travel,
                           "ratio_to_lr": float((w - wx).norm()) / d_lr,
                           "frac_gt_1e-5": float(((w - wx).abs() > 1e-5)
                                                 .double().mean())}
            print(f"{tag} {name:>22}: max |diff from f64| "
                  f"{whole[name]['max_abs']:.3e}, L2/travel "
                  f"{whole[name]['rel_l2']:.4f}, over the lr +1% run's "
                  f"{whole[name]['ratio_to_lr']:.4f}, share > 1e-5 "
                  f"{whole[name]['frac_gt_1e-5']:.3f}", flush=True)

        # step by step
        k_st, p_st, x_st = state0, state0, cs.to_double(state0)
        steps = []
        for s in range(n):
            one_x_from_k = run(plain, k_st, s, 1, cs.to_double)
            one_p_from_k = run(plain, k_st, s, 1)
            if value:       # no clip branch
                mask_k = mask_p = mask_x = torch.zeros(mb, dtype=torch.bool)
                near_x = 0
            else:
                mask_k = _branch(k_st, pcols, s, mb, cfg, discrete)
                mask_p = _branch(p_st, pcols, s, mb, cfg, discrete)
                mask_x, near_x = _branch(x_st, pcols, s, mb, cfg, discrete,
                                         near=True)
            gate_k, gate_p, gate_x = (_gates(st, cols, s, mb, cfg)
                                      for st in (k_st, p_st, x_st))
            k_st = run(kernel, k_st, s, 1)
            p_st = run(plain, p_st, s, 1)
            x_st = run(plain, x_st, s, 1, cs.to_double)
            wx_s = weights(x_st)
            wk1 = weights(k_st)
            steps.append({
                "kernel_dist": float((wk1 - wx_s).abs().max()),
                "plain_dist": float((weights(p_st) - wx_s).abs().max()),
                "kernel_branch_diff": int((mask_k != mask_x).sum()),
                "plain_branch_diff": int((mask_p != mask_x).sum()),
                "kernel_gate_diff": int((gate_k != gate_x).sum()),
                "plain_gate_diff": int((gate_p != gate_x).sum()),
                "near_boundary_rows": near_x,
                "kernel_local_err": float(
                    (wk1 - weights(one_x_from_k)).abs().max()),
                "plain_local_err": float(
                    (weights(one_p_from_k) - weights(one_x_from_k))
                    .abs().max()),
            })
        chained_equal = bool(torch.equal(weights(k_st),
                                         weights(runs["kernel"])))
        summary = _summarise(steps)
        summary["chained_kernel_equals_single_launch"] = chained_equal
        print(f"{tag} step by step: {json.dumps(summary)}", flush=True)
        report["cases"][f"{seed}/{draw}"] = {
            "ent_coeff": ent, "travel_l2": travel, "whole": whole,
            "summary": summary, "steps": steps}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    wide = "_" + "x".join(map(str, args.hidden)) if args.hidden else ""
    (out / f"{args.phase}_phase_drift_{lane}{wide}.json").write_text(
        json.dumps(report))
    return 0


def _tmap(fn, tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(_tmap(fn, x) for x in tree)


def _to(state, device):
    from ppoc_tpu_torch.ops.adam import AdamState

    def mv(tree):
        if isinstance(tree, AdamState):
            return AdamState(mv(tree.m), mv(tree.v), tree.t)
        return _tmap(lambda t: t.to(device), tree)
    return tuple(mv(x) for x in state)


def _branch(state, pcols, s, mb, cfg, discrete, near=False):
    """Which rows of step s's minibatch carry gradient (the unclipped
    branch), evaluated in float64 on ``state``'s weights; with ``near``
    also the count of rows whose ratio lies within 1e-5 (relative) of a
    clip bound."""
    import torch

    from ppoc_tpu_torch.models import mlp, policy

    o, a, lp, ad = (c[s * mb:(s + 1) * mb] for c in pcols)
    o, lp, ad = o.double(), lp.double(), ad.double()
    params = _to((cs.to_double(state[0]),), o.device)[0]
    out = mlp.apply(params, o, cfg.activation)
    if discrete:      # a holds int32 class ids
        logp = torch.log_softmax(out, -1).gather(-1, a.long())[:, 0]
    else:
        logp = policy.gaussian_log_prob_from_mean(
            out, state[1].double().to(o.device), a.double())
    ratio = torch.exp(logp - lp.reshape(-1))
    ad = ad.reshape(-1)
    lo, hi = 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps
    mask = (ratio * ad <= torch.clamp(ratio, lo, hi) * ad).cpu()
    if not near:
        return mask
    gap = torch.minimum((ratio - lo).abs() / lo, (ratio - hi).abs() / hi)
    return mask, int((gap < 1e-5).sum())


def _gates(state, pcols, s, mb, cfg):
    """The hidden units' ReLU gates (pre-activation > 0) over step s's
    minibatch, evaluated in float64 on ``state``'s weights, as one flat
    bool tensor."""
    import torch

    params = _to((cs.to_double(state[0]),), pcols[0].device)[0]
    h = pcols[0][s * mb:(s + 1) * mb].double()
    gates = []
    for W, b in params[:-1]:
        h = h @ W + b
        gates.append((h > 0).reshape(-1))
        h = torch.relu(h)
    return torch.cat(gates).cpu()


def _summarise(steps):
    def first(key, tol):
        return next((i for i, s in enumerate(steps) if s[key] > tol), None)

    def stats(key):
        xs = sorted(s[key] for s in steps)
        return {"median": xs[len(xs) // 2], "max": xs[-1],
                "mean": sum(xs) / len(xs)}

    return {
        "kernel_first_step_dist_gt": {str(t): first("kernel_dist", t)
                                      for t in (1e-6, 1e-5, 1e-4)},
        "plain_first_step_dist_gt": {str(t): first("plain_dist", t)
                                     for t in (1e-6, 1e-5, 1e-4)},
        "kernel_final_dist": steps[-1]["kernel_dist"],
        "plain_final_dist": steps[-1]["plain_dist"],
        "kernel_branch_diff_total": sum(s["kernel_branch_diff"]
                                        for s in steps),
        "plain_branch_diff_total": sum(s["plain_branch_diff"]
                                       for s in steps),
        "kernel_first_branch_diff_step": first("kernel_branch_diff", 0),
        "plain_first_branch_diff_step": first("plain_branch_diff", 0),
        "kernel_gate_diff_total": sum(s["kernel_gate_diff"] for s in steps),
        "plain_gate_diff_total": sum(s["plain_gate_diff"] for s in steps),
        "kernel_first_gate_diff_step": first("kernel_gate_diff", 0),
        "plain_first_gate_diff_step": first("plain_gate_diff", 0),
        "near_boundary_rows_total": sum(s["near_boundary_rows"]
                                        for s in steps),
        "kernel_local_err": stats("kernel_local_err"),
        "plain_local_err": stats("plain_local_err"),
        "steps_local_err_gt_1e-6": {
            "kernel": sum(s["kernel_local_err"] > 1e-6 for s in steps),
            "plain": sum(s["plain_local_err"] > 1e-6 for s in steps)},
    }


# the discrete lanes: (index in chip_smoke.py's loop, K6's ent_coeff there)
DISCRETE = {"cartpole": (0, 0.0), "acrobot": (1, 0.01)}


if __name__ == "__main__":
    sys.exit(main())

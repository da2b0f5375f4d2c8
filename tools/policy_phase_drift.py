"""Where a 200-step policy phase (kernel K4) drifts from exact arithmetic.

    python3 tools/policy_phase_drift.py [--seeds 0 1 2]

Needs a CUDA device.  For each seed it builds one fit's policy rows at the
bench configuration's shapes (kernel rollout, kernel GAE) and runs the
whole phase five ways: the kernel; the plain version in float32 on the
card and on the CPU; the plain version in float64 (the exact answer); and
float64 again from starting weights perturbed by one float32 rounding
(relative 2^-24, random sign), which measures how far the phase itself
amplifies a rounding-sized difference.  Each run's distance from float64
is printed as max |diff| and as L2 relative to the phase's weight travel,
beside a float64 run with the learning rate 1% off.

Then it walks the kernel, plain float32 and float64 runs one step at a
time (one launch per step; the chained kernel must equal the single
launch bit for bit) and records per step: each run's max distance from
float64; how many rows take the other clip branch, and how many hidden
units of the minibatch's rows the other ReLU gate, than float64 does
(evaluated in float64 on each run's own weights); and the local error,
one kernel / plain-float32 step against one float64 step from the same
(kernel) state.  Writes everything to chiprun_out/policy_phase_drift.json
under the checkout.
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
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

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
    report = {"card": cs.card_line(), "seeds": {}}
    for seed in args.seeds:
        cfg = cs.bench_config(seed)
        tr = Trainer(cfg, dev)
        ts = tr.state
        pp, vp = ts.policy_params, ts.v_params
        E, T, mb = cfg.n_envs, cfg.rollout_len, cfg.minibatch_size
        raw = cr.rollout_kernel(pp["mlp"], pp["log_std"], vp,
                                (0x01234567 + seed, 0x89ABCDEF), E, T)
        trunc = raw.truncated.clone()
        trunc[-1] |= ~raw.terminated[-1]
        adv, tgt = cuda_gae.gae_norm_kernel(
            raw.reward, raw.value, raw.next_value, raw.terminated, trunc,
            0.99, cfg.lam)
        _, pcols = cs.phase_rows(cfg, raw, adv, tgt, dev, draw_seed=seed + 1)
        n = pcols[0].shape[0] // mb
        hp = cu.Hyper.of(cfg.lr_policy, cfg.adam_beta1, cfg.adam_beta2,
                         cfg.adam_eps)
        state0 = (pp["mlp"], pp["log_std"], ts.opt_policy, ts.opt_log_std)

        def run(fn, state, s0, steps, cast=lambda x: x, hyper=hp,
                device=dev):
            rows = [cast(c[s0 * mb:(s0 + steps) * mb]).to(device)
                    for c in pcols]
            st = cs.to_double(state) if cast is cs.to_double else state
            st = _to(st, device)
            out = fn(*rows, *st, steps, mb, cfg.activation, hyper,
                     cfg.clip_eps, cfg.ent_coeff)
            return out[:4]

        def weights(state):
            return torch.cat([flat(state[0]).double().cpu(),
                              state[1].double().cpu()])

        # whole-phase runs
        w0 = weights(state0)
        exact = run(cu.policy_phase_plain, state0, 0, n, cs.to_double)
        wx = weights(exact)
        travel = float((wx - w0).norm())
        runs = {
            "kernel": run(cu.policy_phase_kernel, state0, 0, n),
            "plain_f32_card": run(cu.policy_phase_plain, state0, 0, n),
            "plain_f32_cpu": run(cu.policy_phase_plain, state0, 0, n,
                                 device=torch.device("cpu")),
            "f64_lr_plus_1pct": run(
                cu.policy_phase_plain, state0, 0, n, cs.to_double,
                cu.Hyper.of(1.01 * cfg.lr_policy, cfg.adam_beta1,
                            cfg.adam_beta2, cfg.adam_eps)),
        }
        gen = torch.Generator().manual_seed(100 + seed)
        for i in range(2):
            def nudge(t):
                t = t.double()
                sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
                return t * (1 + sign.to(t.device, torch.float64) * 2.0 ** -24)
            pert = (_tmap(nudge, state0[0]), nudge(state0[1]), state0[2],
                    state0[3])
            runs[f"f64_rounding_nudge_{i}"] = run(
                cu.policy_phase_plain, cs.to_double(pert), 0, n, cs.to_double)
        whole = {}
        for name, st in runs.items():
            w = weights(st)
            whole[name] = {"max_abs": float((w - wx).abs().max()),
                           "rel_l2": float((w - wx).norm()) / travel,
                           "frac_gt_1e-5": float(((w - wx).abs() > 1e-5)
                                                 .double().mean())}
            print(f"seed {seed} {name:>22}: max |diff from f64| "
                  f"{whole[name]['max_abs']:.3e}, L2/travel "
                  f"{whole[name]['rel_l2']:.4f}, share > 1e-5 "
                  f"{whole[name]['frac_gt_1e-5']:.3f}", flush=True)

        # step by step
        k_st, p_st, x_st = state0, state0, cs.to_double(state0)
        steps = []
        for s in range(n):
            one_x_from_k = run(cu.policy_phase_plain, k_st, s, 1,
                               cs.to_double)
            one_p_from_k = run(cu.policy_phase_plain, k_st, s, 1)
            mask_k = _branch(k_st, pcols, s, mb, cfg)
            mask_p = _branch(p_st, pcols, s, mb, cfg)
            mask_x, near_x = _branch(x_st, pcols, s, mb, cfg, near=True)
            gate_k, gate_p, gate_x = (_gates(st, pcols, s, mb, cfg)
                                      for st in (k_st, p_st, x_st))
            k_st = run(cu.policy_phase_kernel, k_st, s, 1)
            p_st = run(cu.policy_phase_plain, p_st, s, 1)
            x_st = run(cu.policy_phase_plain, x_st, s, 1, cs.to_double)
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
        print(f"seed {seed} step by step: {json.dumps(summary)}", flush=True)
        report["seeds"][seed] = {"travel_l2": travel, "whole": whole,
                                 "summary": summary, "steps": steps}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "policy_phase_drift.json").write_text(json.dumps(report))
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


def _branch(state, pcols, s, mb, cfg, near=False):
    """Which rows of step s's minibatch carry gradient (the unclipped
    branch), evaluated in float64 on ``state``'s weights; with ``near``
    also the count of rows whose ratio lies within 1e-5 (relative) of a
    clip bound."""
    import torch

    from ppoc_tpu_torch.models import mlp, policy

    params, log_std = cs.to_double(state[0]), state[1].double()
    o, a, lp, ad = (c[s * mb:(s + 1) * mb].double() for c in pcols)
    params = _to((params,), o.device)[0]
    log_std = log_std.to(o.device)
    mu = mlp.apply(params, o, cfg.activation)
    logp = policy.gaussian_log_prob_from_mean(mu, log_std, a)
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


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: prints the card's name and power limit; exits non-zero without
   a CUDA device.
2. Build: compiles ppoc_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. Bench path, kernels: K1 rollout, K2 GAE, K3 value phase and K4 policy
   phase against their plain PyTorch versions on the card, at the bench
   configuration's shapes, with TF32 off; prints both times.
4. Bench path: Trainer(bench config).solve(-200, max_epochs=40) on the card
   (64 envs x 200 steps, minibatch 256, 4 fits per epoch, kernel_backend
   "pallas"), with each kernel's launch count read around it; then two
   epochs of the reference schedule PPOConfig(env="pendulum").
5. Throughput path, kernels: K1 at 1024 envs, K2 at 200 x 1024 (past its
   shared-memory size, so the global-memory branch), and K5 (the
   whole-MLP forward and backward) at 8192 and 256 rows, each against its
   plain version; K5's backward twice, bit for bit.
6. Throughput path: Trainer(tpu_preset("pendulum")) on the card by default,
   10 epochs (minibatch 8192: the generic phases, K5 forward and backward
   per minibatch, no K3/K4), then Trainer.evaluate(deterministic=True),
   with the launch counts read around each, and the mean policy's actions
   held to the plain forward on the recorded obs.

Any failed check raises, so the script exits non-zero.  The last two lines
are a JSON object of per-kernel results and the JSON status line.  Per
kernel: "ms" and "plain_ms" are device-kernel time per call (the
profiler's kernel durations summed); "bound_ms" is the least time the card
could take for the same work, from the H100 SXM's FP32 and memory peaks;
"launches" come from the path's run.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SOLVE_R = -200.0
THROUGHPUT_EPOCHS = 10
# name -> (CUDA source, the TPU kernel it replaces: its pallas_call)
KERNELS = {
    "rollout_pendulum": ("ppoc_tpu_torch/csrc/rollout.cu",
                         "ppoc_tpu/ops/pallas_rollout.py:695"),
    "gae_norm": ("ppoc_tpu_torch/csrc/gae.cu",
                 "ppoc_tpu/ops/pallas_gae.py:134"),
    "value_phase": ("ppoc_tpu_torch/csrc/update.cu",
                    "ppoc_tpu/ops/pallas_update.py:396"),
    "policy_phase": ("ppoc_tpu_torch/csrc/update.cu",
                     "ppoc_tpu/ops/pallas_update.py:749"),
    "mlp_forward": ("ppoc_tpu_torch/csrc/mlp.cu",
                    "ppoc_tpu/ops/pallas_mlp.py:139"),
    "mlp_backward": ("ppoc_tpu_torch/csrc/mlp.cu",
                     "ppoc_tpu/ops/pallas_mlp.py:226"),
}
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor cores,
# HBM3 bandwidth.  Every kernel of the port computes in plain FP32.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(ops: float, nbytes: float):
    """(least ms, what sets it): the larger of operations over the FP32
    peak and bytes over the memory peak."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def products(widths) -> int:
    """Multiply-adds of one row through an MLP: sum of d_in * d_out."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def n_params(widths) -> int:
    return products(widths) + sum(widths[1:])


def rollout_bound(widths, raw, act_dim: int = 1):
    """K1 with the V planes, on the trajectory ``raw`` it produced (policy
    and value nets of the same ``widths``).  Forwards: the policy's T*E and
    the value net's T*E for V(s), plus V(s') only where it is not the next
    step's V(s): the last step's E and each earlier done step (2 FLOP per
    multiply-add).  Reads both nets, writes obs, next_obs, action,
    log_prob, reward, V, V' (float32), the two done planes (bytes) and the
    final state."""
    T, E = raw.reward.shape
    inner_done = int((raw.terminated | raw.truncated)[:-1].sum())
    ops = 2 * (2 * T * E + E + inner_done) * products(widths)
    nbytes = (4 * 2 * n_params(widths) + T * E * (4 * (3 + 3 + act_dim + 4)
                                                  + 2) + 4 * 3 * E)
    return bound_ms(ops, nbytes)


def gae_bound(T: int, E: int):
    """K2: reads r, V, V' (float32) and the two done planes, writes the
    advantages and targets; about 16 operations an element."""
    return bound_ms(16 * T * E, T * E * (4 * 3 + 2 + 4 * 2))


def phase_bound(widths, n_steps: int, mb: int, extra_cols: int):
    """K3/K4: per step the forward, dW/db and dX past layer 0 (2 FLOP per
    multiply-add) and ~12 operations an Adam parameter; reads each row
    once (d0 + extra_cols floats), reads and writes params and moments."""
    per_step = 2 * mb * (2 * products(widths) + products(widths[1:]))
    ops = n_steps * (per_step + 12 * n_params(widths))
    nbytes = 4 * (n_steps * mb * (widths[0] + extra_cols)
                  + 6 * n_params(widths))
    return bound_ms(ops, nbytes)


def mlp_bounds(widths, rows: int):
    """K5 forward (products; reads x and the params, writes out and the
    hidden post-activations) and backward with dX (dW/db and dX of every
    layer; reads x, the hiddens, the cotangent and params, writes the
    gradients and dX)."""
    hidden = sum(widths[1:-1])
    fwd = bound_ms(2 * rows * products(widths),
                   4 * (rows * (widths[0] + widths[-1] + hidden)
                        + n_params(widths)))
    bwd = bound_ms(4 * rows * products(widths),
                   4 * (rows * (2 * widths[0] + widths[-1] + hidden)
                        + 2 * n_params(widths)))
    return fwd, bwd


def bench_config(seed: int = 0):
    """bench.py's bench_config: pendulum, 64 envs x 200 steps, minibatch
    256, 4 fits per epoch, the fused kernels."""
    from ppoc_tpu_torch import PPOConfig

    return PPOConfig(env="pendulum", seed=seed, n_envs=64, rollout_len=200,
                     minibatch_size=256, fits_per_epoch=4, eval_envs=64,
                     eval_len=200, kernel_backend="pallas")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Milliseconds per call on the card (CUDA events), after a warm-up:
    what a caller waits, the host's launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Milliseconds of device-kernel time per call, after a warm-up: the
    durations of every kernel the call launches, summed from
    torch.profiler's CUDA events.  Unlike timed_ms it leaves out the gaps
    in which the device waits for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def timings(kernel, plain, reps: int, plain_reps: int):
    """{"ms", "plain_ms"}: device-kernel time per call of each side."""
    return {"ms": device_ms(kernel, reps),
            "plain_ms": device_ms(plain, plain_reps)}


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(name: str, err: float, tol: float, what: str = "max |diff|"
          ) -> float:
    print(f"  {name}: {what} {err:.3e} (tolerance {tol:.0e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err} exceeds {tol}")
    return err


def check_rollout(cfg, ts, env, dev):
    """K1 at the bench shape: exact RNG bits; the trajectory held to the
    plain physics by decoding each recorded obs and re-stepping it (robust
    to ulp drift in the transcendentals); log-probs and V planes held to
    the plain forward on the recorded obs; the first steps held to the
    plain version directly; the metrics held to the kernel's own
    trajectory."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.envs.pendulum import PendulumState
    from ppoc_tpu_torch.models import mlp, policy
    from ppoc_tpu_torch.ops import cuda_rollout as cr

    E, T = cfg.n_envs, cfg.rollout_len
    lanes = torch.arange(E * 4, dtype=torch.int64, device=dev)
    for s0, s1, t, draw in [(0, 0, 0, 0), (0xDEADBEEF, 0x12345678, 7, 1),
                            (0xFFFFFFFF, 0x9E3779B9, cr.T_INIT, 50),
                            (123456789, 987654321, 199, 51)]:
        got = cr.rng_bits_cuda(s0, s1, t, draw, E * 4, dev)
        want = cr.rng_bits(s0, s1, t, draw, lanes)
        if not torch.equal(got, want):
            raise AssertionError(f"RNG bits differ at {(s0, s1, t, draw)}")
    print("  RNG bits: identical to the plain version", flush=True)

    pp, vp = ts.policy_params, ts.v_params
    seed = (0x01234567, 0x89ABCDEF)
    raw = cr.rollout_kernel(pp["mlp"], pp["log_std"], vp, seed, E, T)
    ref = cr.rollout_plain(pp["mlp"], pp["log_std"], vp, seed, E, T)
    torch.cuda.synchronize()
    errs = {}  # absolute errors
    errs["obs[0]"] = check("first obs (reset draws)",
                           max_err(raw.obs[0], ref.obs[0]), 1e-6)
    errs["early"] = check("steps 0-9 vs plain", max(
        max_err(raw.action[:10], ref.action[:10]),
        max_err(raw.next_obs[:10], ref.next_obs[:10])), 1e-4)
    # decode obs -> state, re-step the plain physics with the kernel's action
    th = torch.atan2(raw.obs[..., 1], raw.obs[..., 0]).reshape(-1)
    st = PendulumState(th, raw.obs[..., 2].reshape(-1),
                       torch.zeros_like(th, dtype=torch.int32))
    _, nobs, rew, _, _ = env.step(st, raw.action.reshape(-1, 1))
    errs["physics"] = check("next_obs vs re-stepped physics",
                            max_err(nobs.reshape(T, E, 3), raw.next_obs), 1e-4)
    errs["reward"] = check("reward vs re-stepped physics",
                           max_err(rew.reshape(T, E), raw.reward), 1e-3)
    mu = mlp.apply(pp["mlp"], raw.obs, "relu")
    lp = policy.gaussian_log_prob_from_mean(mu, pp["log_std"], raw.action)
    errs["log_prob"] = check("log_prob vs plain forward",
                             max_err(lp, raw.log_prob), 1e-4)
    errs["value"] = check("V(s), V(s') vs plain forward", max(
        max_err(mlp.apply(vp, raw.obs, "relu")[..., 0], raw.value),
        max_err(mlp.apply(vp, raw.next_obs, "relu")[..., 0],
                raw.next_value)), 1e-4)
    if not (torch.equal(raw.truncated, ref.truncated)
            and raw.truncated[T - 1].all() and not raw.terminated.any()):
        raise AssertionError("truncation flags differ from the plain version")
    eps = ((raw.action[..., 0] - mu[..., 0]) / torch.exp(pp["log_std"][0]))
    if abs(float(eps.mean())) > 0.03 or abs(float(eps.std()) - 1) > 0.03:
        raise AssertionError(f"sampling noise not N(0,1): {eps.mean()}, "
                             f"{eps.std()}")
    # metrics: the kernel's completed-episode sums vs its own trajectory
    env_name = env.spec.name
    traj, _, (sum_r, sum_j, n_eps) = cr.rollout_fused(
        env_name, pp, seed, E, T, return_metrics=True)
    want = ppo.eval_metrics_from_traj(traj, env.spec.gamma)
    if float(n_eps) != float(want.episodes) or float(n_eps) < E:
        raise AssertionError(f"episode count {n_eps} vs {want.episodes}")
    check("R, J sums vs the trajectory (relative)", max(
        abs(float(sum_r / n_eps - want.R)) / abs(float(want.R)),
        abs(float(sum_j / n_eps - want.J)) / abs(float(want.J))), 1e-4)
    times = timings(
        lambda: cr.rollout_kernel(pp["mlp"], pp["log_std"], vp, seed, E, T),
        lambda: cr.rollout_plain(pp["mlp"], pp["log_std"], vp, seed, E, T),
        20, 1)
    return raw, max(errs.values()), times


def check_gae(cfg, raw, dev):
    """K2 on the kernel rollout's planes, to about 1e-5."""
    from ppoc_tpu_torch.ops import cuda_gae

    trunc = raw.truncated.clone()
    trunc[-1] |= ~raw.terminated[-1]
    args = (raw.reward, raw.value, raw.next_value, raw.terminated, trunc,
            0.99, cfg.lam)
    adv, tgt = cuda_gae.gae_norm_kernel(*args)
    adv_p, tgt_p = cuda_gae.gae_norm_plain(*args)
    err = check("advantages", max_err(adv, adv_p), 1e-5)
    check("targets (relative)",
          max_err(tgt, tgt_p) / float(tgt_p.abs().max()), 1e-5)
    times = timings(lambda: cuda_gae.gae_norm_kernel(*args),
                    lambda: cuda_gae.gae_norm_plain(*args), 50, 3)
    return adv, tgt, err, times


def phase_rows(cfg, raw, adv, tgt, dev, draw_seed: int = 1):
    """One fit's pre-gathered rows, in stream order: the value phase's
    (obs, target) and the policy phase's (obs, action, log_prob, adv)."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.data import buffer

    traj = ppo.Transition(raw.obs, raw.action, raw.log_prob, raw.next_obs,
                          raw.reward, raw.terminated, raw.truncated)
    buf = buffer.from_rollout(traj, adv, tgt)
    draws = ppo.draw_fit(cfg, torch.Generator().manual_seed(draw_seed), dev)
    vcols = buffer.gather_mb((buf.obs, buf.target), draws.value_idx)
    pcols = buffer.gather_mb(
        (buf.obs, buf.action, buf.log_prob, buf.advantage), draws.policy_idx)
    return vcols, pcols


def to_double(tree):
    """A copy of a tensor tree (lists, tuples, AdamStates) in float64."""
    import torch

    from ppoc_tpu_torch.ops.adam import AdamState

    if isinstance(tree, torch.Tensor):
        return tree.double()
    if isinstance(tree, AdamState):
        return AdamState(to_double(tree.m), to_double(tree.v), tree.t)
    return type(tree)(to_double(x) for x in tree)


def check_phases(cfg, ts, raw, adv, tgt, dev):
    """K3 and K4 against their plain versions.

    One step is held at 1e-6, 20 policy steps at 1e-4 and the 500-step
    value phase at 2e-4.  A whole 200-step policy phase cannot be held
    tightly: float32 rounding alone, in the plain version or in one
    rounding of the starting weights under float64, moves its end by up
    to 0.45 of what a 1% learning-rate error does (PERF.md).  So it is
    held two ways.  Tightly, step by step: the phase is walked one launch
    per step from the kernel's own state, each step must agree with one
    float64 step from that state to 2e-7 (a 1% learning-rate error moves
    one step by about 3e-6), and the chained launches must equal the
    single 200-step launch bit for bit.  Loosely, as a whole: the kernel's
    distance from float64 (L2, relative to the phase's weight travel) must
    stay under half the distance of the 1% learning-rate run, and its
    loss and entropy within 1e-4 of the plain version's."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu

    mb = cfg.minibatch_size
    hv = cu.Hyper.of(cfg.lr_v, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps)
    hp = cu.Hyper.of(cfg.lr_policy, cfg.adam_beta1, cfg.adam_beta2,
                     cfg.adam_eps)
    vcols, pcols = phase_rows(cfg, raw, adv, tgt, dev)
    n_v, n_p = vcols[0].shape[0] // mb, pcols[0].shape[0] // mb
    pol = ts.policy_params
    flat = mlp.flatten

    def value(fn, n):
        return fn(vcols[0][: n * mb], vcols[1][: n * mb], ts.v_params,
                  ts.opt_v, n, mb, cfg.activation, hv)

    def policy_(fn, n, ent_coeff=cfg.ent_coeff, hyper=hp, cast=lambda x: x):
        return fn(*(cast(c[: n * mb]) for c in pcols),
                  *cast((pol["mlp"], pol["log_std"], ts.opt_policy,
                         ts.opt_log_std)),
                  n, mb, cfg.activation, hyper, cfg.clip_eps, ent_coeff)

    v_err = 0.0
    for n, tol in ((1, 1e-6), (n_v, 2e-4)):
        k, pl = value(cu.value_phase_kernel, n), value(cu.value_phase_plain, n)
        v_err = max(v_err, check(f"value phase, {n} steps: weights",
                                 max_err(flat(k[0]), flat(pl[0])), tol))
        check(f"value phase, {n} steps: loss (relative)",
              abs(float(k[2] - pl[2])) / abs(float(pl[2])), 1e-5)
    p_err = 0.0
    for n, ent, tol in ((1, cfg.ent_coeff, 1e-6), (1, 0.01, 1e-6),
                        (20, cfg.ent_coeff, 1e-4), (20, 0.01, 1e-4)):
        k = policy_(cu.policy_phase_kernel, n, ent)
        pl = policy_(cu.policy_phase_plain, n, ent)
        p_err = max(p_err, check(
            f"policy phase, {n} steps, ent_coeff {ent}: weights, log_std",
            max(max_err(flat(k[0]), flat(pl[0])), max_err(k[1], pl[1])), tol))
        check(f"policy phase, {n} steps, ent_coeff {ent}: loss, entropy",
              max(abs(float(k[4] - pl[4])), abs(float(k[5] - pl[5]))), tol)
    k = policy_(cu.policy_phase_kernel, n_p)
    pl = policy_(cu.policy_phase_plain, n_p)
    exact = policy_(cu.policy_phase_plain, n_p, cast=to_double)
    lr_fault = policy_(cu.policy_phase_plain, n_p, cast=to_double,
                       hyper=cu.Hyper.of(1.01 * cfg.lr_policy, cfg.adam_beta1,
                                         cfg.adam_beta2, cfg.adam_eps))
    w0, wx = flat(pol["mlp"]).double(), flat(exact[0])
    travel = float((wx - w0).norm())

    def dist(run):
        return float((flat(run[0]).double() - wx).norm()) / travel

    d_k, d_p, d_lr = dist(k), dist(pl), dist(lr_fault)
    print(f"  policy phase, {n_p} steps, |run - float64| / |travel| (L2): "
          f"kernel {d_k:.4f}, plain float32 {d_p:.4f}, float64 with lr "
          f"+1% {d_lr:.4f}; max |kernel - float64| {max_err(flat(k[0]), wx):.3e}"
          f", max |plain - float64| {max_err(flat(pl[0]), wx):.3e}",
          flush=True)
    check(f"policy phase, {n_p} steps: kernel's distance from float64 over "
          f"the lr +1% run's", d_k / d_lr, 0.5, what="ratio")
    p_err = max(p_err, max_err(flat(k[0]), flat(pl[0])),
                max_err(k[1], pl[1]))
    check(f"policy phase, {n_p} steps: loss, entropy",
          max(abs(float(k[4] - pl[4])), abs(float(k[5] - pl[5]))), 1e-4)

    def one_step(fn, state, s, hyper=hp, cast=lambda x: x):
        return fn(*(cast(c[s * mb:(s + 1) * mb]) for c in pcols),
                  *cast(state), 1, mb, cfg.activation, hyper, cfg.clip_eps,
                  cfg.ent_coeff)[:4]

    def step_err(a, b):
        return max(max_err(flat(a[0]), flat(b[0])), max_err(a[1], b[1]))

    state = (pol["mlp"], pol["log_std"], ts.opt_policy, ts.opt_log_std)
    lr_step = step_err(
        one_step(cu.policy_phase_plain, state, 0, cast=to_double),
        one_step(cu.policy_phase_plain, state, 0, cast=to_double,
                 hyper=cu.Hyper.of(1.01 * cfg.lr_policy, cfg.adam_beta1,
                                   cfg.adam_beta2, cfg.adam_eps)))
    print(f"  policy phase, step 0: a 1% learning-rate error moves the "
          f"weights by {lr_step:.3e}", flush=True)
    local = 0.0
    for s in range(n_p):
        k1 = one_step(cu.policy_phase_kernel, state, s)
        local = max(local, step_err(
            k1, one_step(cu.policy_phase_plain, state, s, cast=to_double)))
        state = k1
    p_err = max(p_err, check(
        f"policy phase, each of {n_p} steps from the kernel's state vs one "
        f"float64 step", local, 2e-7))
    if not (torch.equal(flat(state[0]), flat(k[0]))
            and torch.equal(state[1], k[1])):
        raise AssertionError(f"{n_p} chained one-step launches differ from "
                             f"one {n_p}-step launch")
    print(f"  policy phase: {n_p} chained one-step launches equal one "
          f"{n_p}-step launch bit for bit", flush=True)
    v_times = timings(lambda: value(cu.value_phase_kernel, n_v),
                      lambda: value(cu.value_phase_plain, n_v), 5, 1)
    p_times = timings(lambda: policy_(cu.policy_phase_kernel, n_p),
                      lambda: policy_(cu.policy_phase_plain, n_p), 5, 1)
    return (v_err, v_times), (p_err, p_times)


def check_mlp(params, x, activation: str, dev):
    """K5 at one batch of the path: forward (output and saved hiddens) and
    backward (dW, db, dX) against the plain versions, with a seeded
    cotangent; the backward twice, equal bit for bit.  Then K5 as the
    path reaches it: ``mlp.apply(backend="pallas")`` and
    ``torch.autograd.grad`` with x not requiring grad, so the backward
    skips dX; its dW/db are held to the plain backward and to the
    dX-computing launch bit for bit.  Returns (max abs error, forward
    timings, backward timings)."""
    import torch

    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_mlp as cm

    rows = x.shape[0]
    ct = torch.randn(rows, mlp.dims(params)[-1],
                     generator=torch.Generator().manual_seed(rows)).to(dev)
    out, hid = cm.mlp_forward_kernel(params, x, activation)
    out_p, hid_p = cm.mlp_forward_plain(params, x, activation)
    torch.cuda.synchronize()
    err = check(f"K5 forward, {rows} rows: output and hiddens", max(
        max_err(a, b) for a, b in zip([out, *hid], [out_p, *hid_p])), 1e-5)
    grads, dx = cm.mlp_backward_kernel(params, x, hid, ct, activation)
    again, dx2 = cm.mlp_backward_kernel(params, x, hid, ct, activation)
    grads_p, dx_p = cm.mlp_backward_plain(params, x, hid, ct, activation)
    torch.cuda.synchronize()
    got = [t for pair in grads for t in pair] + [dx]
    want = [t for pair in grads_p for t in pair] + [dx_p]
    # float32 sums of up to `rows` terms, taken in another order
    check(f"K5 backward, {rows} rows: dW, db, dX, max |diff| over the "
          f"leaf's max |plain|", max(max_err(a, b) / float(b.abs().max())
                                     for a, b in zip(got, want)), 1e-4,
          what="ratio")
    err = max(err, *(max_err(a, b) for a, b in zip(got, want)))
    if not (torch.equal(mlp.flatten(grads), mlp.flatten(again))
            and torch.equal(dx, dx2)):
        raise AssertionError("two runs of K5's backward differ")
    print(f"  K5 backward, {rows} rows: two runs equal bit for bit",
          flush=True)
    leaves = [t.detach().clone().requires_grad_()
              for pair in params for t in pair]
    pairs = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    out_a = mlp.apply(pairs, x, activation, "pallas")
    auto = torch.autograd.grad(out_a, leaves, grad_outputs=ct)
    torch.cuda.synchronize()
    want = [t for pair in grads_p for t in pair]
    check(f"K5 through autograd (no dX), {rows} rows: dW, db, max |diff| "
          f"over the leaf's max |plain|", max(
              max_err(a, b) / float(b.abs().max())
              for a, b in zip(auto, want)), 1e-4, what="ratio")
    err = max(err, *(max_err(a, b) for a, b in zip(auto, want)))
    if not all(torch.equal(a, b) for a, b in
               zip(auto, [t for pair in grads for t in pair])):
        raise AssertionError("K5's backward without dX differs from the "
                             "launch with dX")
    print(f"  K5 through autograd (no dX), {rows} rows: dW, db equal the "
          f"launch with dX bit for bit", flush=True)
    fwd = timings(lambda: cm.mlp_forward_kernel(params, x, activation),
                  lambda: cm.mlp_forward_plain(params, x, activation), 50, 20)
    bwd = timings(
        lambda: cm.mlp_backward_kernel(params, x, hid, ct, activation),
        lambda: cm.mlp_backward_plain(params, x, hid, ct, activation), 50, 20)
    return err, fwd, bwd


def throughput_path(cfg, dev, counters):
    """Trainer(cfg) on the card by default: THROUGHPUT_EPOCHS epochs, then
    the mean-policy evaluation, each with the launch counts read around
    it; the mean policy's actions held to the plain forward."""
    import torch

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp

    tr = Trainer(cfg)
    if tr.device != torch.device("cuda", 0):
        raise AssertionError(f"Trainer(cfg) chose {tr.device}, not cuda:0")
    names = [c.kernel for c in counters]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.train(n_epochs=THROUGHPUT_EPOCHS, log=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_n = dict(zip(names, (c.n for c in counters)))
    train_s = sum(h["time_s"] for h in hist)
    steps = len(hist) * cfg.steps_per_epoch
    print(f"  {len(hist)} epochs: R {[round(h['R'], 3) for h in hist]}",
          flush=True)
    print(f"  training time per epoch (s) "
          f"{[round(h['time_s'], 4) for h in hist]}; {train_s:.3f} s of "
          f"training, {steps / train_s:.0f} env-steps/s; {wall:.3f} s with "
          f"the evaluations; launches {train_n}", flush=True)
    if not all(math.isfinite(h["R"]) for h in hist):
        raise AssertionError("non-finite eval return on the throughput path")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]),
            tr.state.policy_params["log_std"])):
        raise AssertionError("non-finite weights on the throughput path")
    if (min(train_n[k] for k in ("rollout_pendulum", "gae_norm",
                                 "mlp_forward", "mlp_backward")) < 1
            or train_n["value_phase"] or train_n["policy_phase"]):
        raise AssertionError(f"the throughput path must run K1, K2 and K5 "
                             f"and no K3/K4: {train_n}")

    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = tr.evaluate(deterministic=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_n = dict(zip(names, (c.n for c in counters)))
    print(f"  evaluate(deterministic=True): R {ev.R:.3f}, J {ev.J:.3f}, "
          f"episodes {int(ev.episodes)}, {eval_s:.3f} s; launches {eval_n}",
          flush=True)
    if not (math.isfinite(ev.R) and ev.episodes == cfg.eval_envs):
        raise AssertionError(f"mean-policy evaluation failed: {ev}")
    if eval_n["mlp_forward"] != cfg.eval_len or eval_n["rollout_pendulum"]:
        raise AssertionError(f"the mean-policy evaluation must be "
                             f"{cfg.eval_len} K5 forwards: {eval_n}")
    pp = tr.state.policy_params
    draws = ppo.draw_eval(cfg, tr.env, torch.Generator().manual_seed(7), dev,
                          deterministic=True)
    traj = ppo.rollout_env_loop(cfg, tr.env, pp, draws)
    act_err = check("mean-policy actions vs the plain forward on the "
                    "recorded obs", max_err(traj.action, mlp.apply(
                        pp["mlp"], traj.obs, cfg.activation)), 1e-5)
    return tr, train_n, eval_n, act_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ppoc_tpu_torch import PPOConfig, tpu_preset
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.data import buffer
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import (_build, cuda_gae, cuda_mlp, cuda_rollout,
                                    cuda_update)

    print("[build]", flush=True)
    info = _build.build()
    print(f"  {info['path']}: {'built' if info['built'] else 'up to date'} "
          f"in {info['seconds']:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print("  nvcc:", line.strip(), flush=True)
    _build.load()
    counters = [cuda_rollout.launches, cuda_gae.launches,
                cuda_update.value_launches, cuda_update.policy_launches,
                cuda_mlp.fwd_launches, cuda_mlp.bwd_launches]
    results = []

    def record(name, path, shape, launches, err, times, bound):
        # library_ms: no single PyTorch call computes any of these
        src, replaces = KERNELS[name]
        results.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, **times,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "path": path, "shape": shape})
        print(f"  {name} ({path}, {shape}): device time kernel "
              f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms; "
              f"bound {bound[0]:.4f} ms ({bound[1]}); launches {launches}",
              flush=True)

    cfg = bench_config()
    tr = Trainer(cfg, dev)
    widths = mlp.dims(tr.state.v_params)
    print("[K1 rollout]", flush=True)
    raw, k1_err, k1_t = check_rollout(cfg, tr.state, tr.env, dev)
    k1_bound = rollout_bound(widths, raw)
    print("[K2 gae]", flush=True)
    adv, tgt, k2_err, k2_t = check_gae(cfg, raw, dev)
    print("[K3 value phase, K4 policy phase]", flush=True)
    (k3_err, k3_t), (k4_err, k4_t) = check_phases(cfg, tr.state, raw, adv,
                                                  tgt, dev)

    print("[bench path: Trainer(bench_config).solve(-200, max_epochs=40)]",
          flush=True)
    tr = Trainer(bench_config(), dev)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.solve(SOLVE_R, max_epochs=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.kernel: c.n for c in counters}
    steps = res["epochs"] * cfg.steps_per_epoch
    print(f"  epochs {res['epochs']}, final R {res['R']:.3f}, wall "
          f"{wall:.3f} s, {steps / wall:.0f} env-steps/s (training), "
          f"launches {launches}", flush=True)
    if not (math.isfinite(res["R"]) and res["R"] >= SOLVE_R):
        raise AssertionError(f"not solved in 40 epochs: R {res['R']}")
    if min(launches[k] for k in ("rollout_pendulum", "gae_norm",
                                 "value_phase", "policy_phase")) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]),
            tr.state.policy_params["log_std"])):
        raise AssertionError("non-finite weights after the solve")
    T, E, mb = cfg.rollout_len, cfg.n_envs, cfg.minibatch_size
    n_v = cfg.n_epochs_value * cfg.num_minibatches
    n_p = cfg.n_epochs_policy * cfg.num_minibatches
    bench = f"bench, {E} envs x {T} steps, mb {mb}"
    record("rollout_pendulum", bench, [T, E], launches["rollout_pendulum"],
           k1_err, k1_t, k1_bound)
    record("gae_norm", bench, [T, E], launches["gae_norm"], k2_err, k2_t,
           gae_bound(T, E))
    record("value_phase", bench, [n_v, mb], launches["value_phase"], k3_err,
           k3_t, phase_bound(widths, n_v, mb, 1))
    record("policy_phase", bench, [n_p, mb], launches["policy_phase"],
           k4_err, k4_t, phase_bound(widths, n_p, mb, 3))

    print("[reference schedule: PPOConfig(env='pendulum'), 2 epochs]",
          flush=True)
    ref = Trainer(PPOConfig(env="pendulum"), dev)
    t0 = time.perf_counter()
    hist = ref.train(n_epochs=2, log=False)
    torch.cuda.synchronize()
    print(f"  R {[round(h['R'], 3) for h in hist]}, wall "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not all(math.isfinite(h["R"]) for h in hist):
        raise AssertionError("non-finite eval return on the reference run")

    tcfg = tpu_preset("pendulum")
    T, E, mb = tcfg.rollout_len, tcfg.n_envs, tcfg.minibatch_size
    tr = Trainer(tcfg)
    print(f"[K1 at the throughput shape: {E} envs x {T} steps]", flush=True)
    raw, t1_err, t1_t = check_rollout(tcfg, tr.state, tr.env, dev)
    t1_bound = rollout_bound(widths, raw)
    print(f"[K2 at {T} x {E}: the global-memory branch]", flush=True)
    adv, tgt, t2_err, t2_t = check_gae(tcfg, raw, dev)
    print(f"[K5 mlp_forward at {mb} and {tcfg.eval_envs} rows, widths "
          f"{widths}]", flush=True)
    draws = ppo.draw_fit(tcfg, torch.Generator().manual_seed(3), dev)
    x_mb, = buffer.gather_mb((raw.obs.reshape(-1, 3),), draws.value_idx[0, 0],
                             tcfg.shuffle_block)
    k5_err, k5_fwd, k5_bwd = check_mlp(tr.state.v_params, x_mb,
                                       tcfg.activation, dev)
    x_ev = raw.obs[0, : tcfg.eval_envs].contiguous()
    k5e_err, k5e_fwd, _ = check_mlp(tr.state.policy_params["mlp"], x_ev,
                                    tcfg.activation, dev)

    print(f"[throughput path: Trainer(tpu_preset('pendulum')), "
          f"{THROUGHPUT_EPOCHS} epochs, then evaluate(deterministic=True)]",
          flush=True)
    tr, train_n, eval_n, act_err = throughput_path(tcfg, dev, counters)
    thr = f"throughput, {E} envs x {T} steps, mb {mb}"
    fwd_b, bwd_b = mlp_bounds(widths, mb)
    record("rollout_pendulum", thr, [T, E], train_n["rollout_pendulum"],
           t1_err, t1_t, t1_bound)
    record("gae_norm", thr, [T, E], train_n["gae_norm"], t2_err, t2_t,
           gae_bound(T, E))
    record("mlp_forward", thr, [mb] + widths, train_n["mlp_forward"], k5_err,
           k5_fwd, fwd_b)
    record("mlp_backward", thr, [mb] + widths, train_n["mlp_backward"],
           k5_err, k5_bwd, bwd_b)
    pwidths = mlp.dims(tr.state.policy_params["mlp"])
    record("mlp_forward", "mean-policy evaluation",
           [tcfg.eval_envs] + pwidths, eval_n["mlp_forward"],
           max(k5e_err, act_err), k5e_fwd,
           mlp_bounds(pwidths, tcfg.eval_envs)[0])

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: prints the card's name and power limit; exits non-zero without
   a CUDA device.
2. Build: compiles ppoc_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. Each kernel of the training path (K1 rollout, K2 GAE, K3 value phase,
   K4 policy phase) against its plain PyTorch version on the card, at the
   bench configuration's shapes, with TF32 off; prints both times.
4. Main path: Trainer(bench config).solve(-200, max_epochs=40) on the card
   (64 envs x 200 steps, minibatch 256, 4 fits per epoch, kernel_backend
   "pallas"), with each kernel's launch count read around it; then two
   epochs of the reference schedule PPOConfig(env="pendulum").

Any failed check raises, so the script exits non-zero.  The last two lines
are a JSON object of per-kernel results and the JSON status line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SOLVE_R = -200.0
# (name, CUDA source, the TPU kernel it replaces: its pallas_call)
KERNELS = [
    ("rollout_pendulum", "ppoc_tpu_torch/csrc/rollout.cu",
     "ppoc_tpu/ops/pallas_rollout.py:695"),
    ("gae_norm", "ppoc_tpu_torch/csrc/gae.cu",
     "ppoc_tpu/ops/pallas_gae.py:134"),
    ("value_phase", "ppoc_tpu_torch/csrc/update.cu",
     "ppoc_tpu/ops/pallas_update.py:396"),
    ("policy_phase", "ppoc_tpu_torch/csrc/update.cu",
     "ppoc_tpu/ops/pallas_update.py:749"),
]


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
    """Milliseconds per call on the card (CUDA events), after a warm-up."""
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
    ms = timed_ms(lambda: cr.rollout_kernel(
        pp["mlp"], pp["log_std"], vp, seed, E, T), 20)
    plain_ms = timed_ms(lambda: cr.rollout_plain(
        pp["mlp"], pp["log_std"], vp, seed, E, T), 3)
    return raw, max(errs.values()), ms, plain_ms


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
    ms = timed_ms(lambda: cuda_gae.gae_norm_kernel(*args), 50)
    plain_ms = timed_ms(lambda: cuda_gae.gae_norm_plain(*args), 3)
    return adv, tgt, err, ms, plain_ms


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
    v_ms = timed_ms(lambda: value(cu.value_phase_kernel, n_v), 5)
    v_plain = timed_ms(lambda: value(cu.value_phase_plain, n_v), 1)
    p_ms = timed_ms(lambda: policy_(cu.policy_phase_kernel, n_p), 5)
    p_plain = timed_ms(lambda: policy_(cu.policy_phase_plain, n_p), 1)
    return (v_err, v_ms, v_plain), (p_err, p_ms, p_plain)


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

    from ppoc_tpu_torch import PPOConfig
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import _build, cuda_gae, cuda_rollout, cuda_update

    print("[build]", flush=True)
    info = _build.build()
    print(f"  {info['path']}: {'built' if info['built'] else 'up to date'} "
          f"in {info['seconds']:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print("  nvcc:", line.strip(), flush=True)
    _build.load()

    cfg = bench_config()
    tr = Trainer(cfg, dev)
    print("[K1 rollout]", flush=True)
    raw, k1_err, k1_ms, k1_plain = check_rollout(cfg, tr.state, tr.env, dev)
    print("[K2 gae]", flush=True)
    adv, tgt, k2_err, k2_ms, k2_plain = check_gae(cfg, raw, dev)
    print("[K3 value phase, K4 policy phase]", flush=True)
    (k3_err, k3_ms, k3_plain), (k4_err, k4_ms, k4_plain) = check_phases(
        cfg, tr.state, raw, adv, tgt, dev)
    for name, ms, plain in (("K1 rollout", k1_ms, k1_plain),
                            ("K2 gae", k2_ms, k2_plain),
                            ("K3 value phase", k3_ms, k3_plain),
                            ("K4 policy phase", k4_ms, k4_plain)):
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms", flush=True)

    print("[main path: Trainer(bench_config).solve(-200, max_epochs=40)]",
          flush=True)
    counters = [cuda_rollout.launches, cuda_gae.launches,
                cuda_update.value_launches, cuda_update.policy_launches]
    tr = Trainer(bench_config(), dev)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.solve(SOLVE_R, max_epochs=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.n for c in counters]
    steps = res["epochs"] * cfg.steps_per_epoch
    print(f"  epochs {res['epochs']}, final R {res['R']:.3f}, wall "
          f"{wall:.3f} s, {steps / wall:.0f} env-steps/s (training), "
          f"launches {dict(zip([c.kernel for c in counters], launches))}",
          flush=True)
    if not (math.isfinite(res["R"]) and res["R"] >= SOLVE_R):
        raise AssertionError(f"not solved in 40 epochs: R {res['R']}")
    if min(launches) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if not all(torch.isfinite(t).all() for t in (
            mlp.flatten(tr.state.v_params),
            mlp.flatten(tr.state.policy_params["mlp"]),
            tr.state.policy_params["log_std"])):
        raise AssertionError("non-finite weights after the solve")

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

    results = []
    for (name, src, replaces), n, err, ms, plain in zip(
            KERNELS, launches, (k1_err, k2_err, k3_err, k4_err),
            (k1_ms, k2_ms, k3_ms, k4_ms),
            (k1_plain, k2_plain, k3_plain, k4_plain)):
        results.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

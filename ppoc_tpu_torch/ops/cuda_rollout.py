"""K1: the whole-rollout kernel (``csrc/rollout.cu``) and its plain version.

Counterpart of ``ppoc_tpu/ops/pallas_rollout.py`` ``rollout_fused`` for
every lane of the JAX package's ``LANE_ENVS`` (:data:`LANES`, the port's
own copy: pendulum, simple, cartpole, mountain_car, mountain_car_norm,
acrobot, reacher).  One launch runs all T steps: policy forward,
sampling and log-prob (Box-Muller for a continuous lane; Gumbel-max over
the class logits with an exact log-softmax for a discrete one), the
lane's physics, termination, truncation and auto-reset,
plus either the value planes V(s), V(s') (``v_params``) or the
completed-episode R/J sums (``return_metrics``).

Randomness is the JAX kernel's counter RNG, bit for bit: a murmur3
finalizer over (seed words, step, draw, env lane).  Draws 0.. are the
sampler's (2j, 2j+1 for Gaussian dim j; k for class k), draws 50 + j the
resets' (state row j, at step t, or at ``T_INIT`` for the entry reset).
The caller passes the two 32-bit seed words; given the JAX package's seed
words (its ``fold_in(key, 0)`` key data) both packages draw the same
uniforms.

A CUDA tensor launches the kernel, a CPU tensor runs :func:`rollout_plain`,
which repeats the kernel's arithmetic op for op in PyTorch (uint32
arithmetic done in int64 with masks, products split so none overflows).
The kernel has two variants: nets that fit in one block's shared memory
stay there, larger ones (reacher's 2x256) are read from global memory
over a wider env tile; the launch picks by size
(``_build.pick_variant``).  In shared memory a block runs 1, 2, 4 or 8
envs, the fewest whose grid the card holds at once (:func:`tile_for`);
in global memory 32.  Each layer's input sums are split into
:func:`layer_split` parts from the widths alone, so an env's outputs are
the same bits at any env count, tile and variant.  The kernel takes V(s')
from the next step's V(s) wherever a step did not end;
:func:`rollout_kernel_vnext_every_step` runs the value net's V(s') pass
at every step instead, for the card tests that hold the two equal.
:func:`replay_plain` steps a lane's plain physics on recorded actions,
the trajectory the kernel must have produced from them.
"""
from __future__ import annotations

import ctypes
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ppoc_tpu_torch.envs import acrobot as ac, cartpole as cp
from ppoc_tpu_torch.envs import mountain_car as mc, pendulum as pd
from ppoc_tpu_torch.envs import reacher as rc, simple as sp
from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import _build

_TWO_PI = 2.0 * math.pi
_M32 = 0xFFFFFFFF
T_INIT = 0xFFFF0000          # the step counter of the entry reset
# the Gumbel draws' clip [1e-12, 1 - 1e-7], as float32 rounds the bounds
U_LO, U_HI = float(np.float32(1e-12)), float(np.float32(1.0 - 1e-7))


# --- counter RNG (pallas_rollout._fmix32 / _uniform01) --------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): 16-bit halves, so no
    product leaves int64."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def rng_bits(s0: int, s1: int, t: int, draw: int,
             lanes: torch.Tensor) -> torch.Tensor:
    """The 32 hashed bits for (seed words, step t, draw, lane) as int64."""
    base = (s0 + t * 0x632BE59B + draw * 0x9E3779B9) & _M32
    return fmix32((base + _mul32(lanes ^ s1, 0x2545F491)) & _M32)


def uniform01(s0: int, s1: int, t: int, draw: int,
              lanes: torch.Tensor) -> torch.Tensor:
    """U[0,1) with a 24-bit mantissa, exact in float32."""
    bits = rng_bits(s0, s1, t, draw, lanes)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def seed_words(generator: torch.Generator) -> Tuple[int, int]:
    """Two fresh 32-bit seed words for one rollout."""
    s = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)
    return int(s[0]), int(s[1])


def gumbel_max_plain(h: torch.Tensor, s0: int, s1: int, t: int,
                     lanes: torch.Tensor):
    """The discrete lanes' sampler on logits ``h`` [E, K] at step t:
    Gumbel-max with draws k = 0..K-1 (the strict > keeps the lower class
    on a tie) and the log-softmax log-prob of the pick.  Returns (class ids
    int64 [E], log-probs [E])."""
    K = h.shape[1]
    zmax = h[:, 0]
    for k in range(1, K):
        zmax = torch.maximum(zmax, h[:, k])
    total = torch.zeros_like(zmax)
    for k in range(K):
        total = total + torch.exp(h[:, k] - zmax)
    lse = zmax + torch.log(total)
    best = idx = None
    for k in range(K):
        u = torch.clamp(uniform01(s0, s1, t, k, lanes).to(h.device),
                        U_LO, U_HI)
        y = h[:, k] - torch.log(-torch.log(u))
        if best is None:
            best, idx = y, torch.zeros(h.shape[0], dtype=torch.int64,
                                       device=h.device)
        else:
            take = y > best
            best = torch.where(take, y, best)
            idx = torch.where(take, k, idx)
    return idx, h.gather(1, idx[:, None])[:, 0] - lse


def gumbel_gap(h: torch.Tensor, s0: int, s1: int, t: int,
               lanes: torch.Tensor) -> torch.Tensor:
    """How far the sampler's pick is from a tie at step t: the top
    perturbed logit minus the runner-up, per env [E].  Two samplers whose
    logits differ by less than this draw the same class."""
    ys = torch.stack([
        h[:, k] - torch.log(-torch.log(torch.clamp(
            uniform01(s0, s1, t, k, lanes).to(h.device), U_LO, U_HI)))
        for k in range(h.shape[1])], dim=1)
    top2 = torch.topk(ys, 2, dim=1).values
    return top2[:, 0] - top2[:, 1]


# --- lanes (pallas_rollout.LANE_ENVS) --------------------------------------

class Lane(NamedTuple):
    """An env as functions on lists of [E] rows, in the JAX lane's own
    operation order (which may differ from the env module's)."""
    code: int            # the kernel's lane id (csrc/rollout.cu RolloutArgs)
    state_dim: int
    obs_dim: int
    n_actions: int       # class count (0: continuous)
    horizon: int
    reset: Callable      # rand(j) -> state rows
    obs: Callable        # state rows -> obs rows
    step: Callable       # (rows, action rows) -> (rows, reward, term)
    pack: Callable       # env state -> ([E, state_dim] float, steps [E])
    unpack: Callable     # ([E, state_dim], int32 steps [E]) -> env state


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one float32 division, as the kernel and XLA divide.
    (On CUDA, PyTorch multiplies by the reciprocal when the divisor is a
    Python scalar, which can differ in the last bit.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _pendulum_step(s, act):
    th, thd = s
    u = torch.clamp(act[0], -pd.MAX_TORQUE, pd.MAX_TORQUE)
    v = th + math.pi
    an = v - _TWO_PI * torch.floor(_div(v, _TWO_PI)) - math.pi
    cost = an * an + 0.1 * thd * thd + 0.001 * u * u
    thd2 = torch.clamp(thd + (15.0 * torch.sin(th) + 3.0 * u) * 0.05,
                       -pd.MAX_SPEED, pd.MAX_SPEED)
    return [th + thd2 * 0.05, thd2], -cost, torch.zeros_like(th)


def _cartpole_step(s, act):
    x, xd, th, thd = s
    force = torch.where(act[0] > 0.5, cp.FORCE_MAG, -cp.FORCE_MAG)
    c, si = torch.cos(th), torch.sin(th)
    temp = _div(force + cp.POLEMASS_LENGTH * thd * thd * si, cp.TOTAL_MASS)
    th_acc = (cp.GRAVITY * si - c * temp) / (
        cp.LENGTH * (4.0 / 3.0 - _div(cp.MASSPOLE * c * c, cp.TOTAL_MASS)))
    x_acc = temp - _div(cp.POLEMASS_LENGTH * th_acc * c, cp.TOTAL_MASS)
    x2, th2 = x + cp.TAU * xd, th + cp.TAU * thd
    term = ((x2.abs() > cp.X_THRESHOLD)
            | (th2.abs() > cp.THETA_THRESHOLD)).to(torch.float32)
    return ([x2, xd + cp.TAU * x_acc, th2, thd + cp.TAU * th_acc],
            torch.ones_like(x2), term)


def _acrobot_dsdt(th1, th2, d1_, d2_, torque):
    m1 = m2 = 1.0
    l1 = 1.0
    lc1 = lc2 = 0.5
    i1 = i2 = 1.0
    g = 9.8
    c2, s2 = torch.cos(th2), torch.sin(th2)
    d1 = m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * c2) + i1 + i2
    d2 = m2 * (lc2 ** 2 + l1 * lc2 * c2) + i2
    phi2 = m2 * lc2 * g * torch.cos(th1 + th2 - math.pi / 2.0)
    phi1 = (-m2 * l1 * lc2 * d2_ ** 2 * s2
            - 2 * m2 * l1 * lc2 * d2_ * d1_ * s2
            + (m1 * lc1 + m2 * l1) * g * torch.cos(th1 - math.pi / 2.0)
            + phi2)
    dd2 = (torque + d2 / d1 * phi1 - m2 * l1 * lc2 * d1_ ** 2 * s2 - phi2) / (
        m2 * lc2 ** 2 + i2 - d2 ** 2 / d1)
    dd1 = -(d2 * dd2 + phi1) / d1
    return d1_, d2_, dd1, dd2


def _acrobot_wrap(x):
    v = x + math.pi
    return v - _TWO_PI * torch.floor(_div(v, _TWO_PI)) - math.pi


def _acrobot_step(s, act):
    torque = act[0] - 1.0                      # class id {0, 1, 2}
    dt = ac.DT
    y = tuple(s)
    k1 = _acrobot_dsdt(*y, torque)
    k2 = _acrobot_dsdt(*(a + dt / 2.0 * b for a, b in zip(y, k1)), torque)
    k3 = _acrobot_dsdt(*(a + dt / 2.0 * b for a, b in zip(y, k2)), torque)
    k4 = _acrobot_dsdt(*(a + dt * b for a, b in zip(y, k3)), torque)
    out = [a + dt / 6.0 * (p + 2 * q + 2 * r + w)
           for a, p, q, r, w in zip(y, k1, k2, k3, k4)]
    out[0] = _acrobot_wrap(out[0])
    out[1] = _acrobot_wrap(out[1])
    out[2] = torch.clamp(out[2], -ac.MAX_VEL_1, ac.MAX_VEL_1)
    out[3] = torch.clamp(out[3], -ac.MAX_VEL_2, ac.MAX_VEL_2)
    term = ((-torch.cos(out[0]) - torch.cos(out[1] + out[0])) > 1.0
            ).to(torch.float32)
    return out, term - 1.0, term


def _mountain_car_obs(norm: bool):
    # the JAX lane's Python-float mid/half (pallas_rollout.py:200-209), not
    # the float32 arrays of envs.wrappers.normalize_obs
    mid_p = (mc.MAX_POSITION + mc.MIN_POSITION) / 2.0
    half_p = (mc.MAX_POSITION - mc.MIN_POSITION) / 2.0

    def obs(s):
        pos, vel = s
        if norm:
            return [_div(pos - mid_p, half_p), _div(vel, mc.MAX_SPEED)]
        return [pos, vel]

    return obs


def _mountain_car_step(s, act):
    pos, vel = s
    force = torch.clamp(act[0], -1.0, 1.0)
    vel2 = torch.clamp(vel + force * mc.POWER
                       - 0.0025 * torch.cos(3.0 * pos),
                       -mc.MAX_SPEED, mc.MAX_SPEED)
    pos2 = torch.clamp(pos + vel2, mc.MIN_POSITION, mc.MAX_POSITION)
    vel2 = torch.where((pos2 <= mc.MIN_POSITION) & (vel2 < 0.0),
                       torch.zeros_like(vel2), vel2)
    term = ((pos2 >= mc.GOAL_POSITION)
            & (vel2 >= mc.GOAL_VELOCITY)).to(torch.float32)
    return [pos2, vel2], term * 100.0 - 0.1 * act[0] * act[0], term


def _reacher_tip(q1, q2):
    return (rc.L1 * torch.cos(q1) + rc.L2 * torch.cos(q1 + q2),
            rc.L1 * torch.sin(q1) + rc.L2 * torch.sin(q1 + q2))


def _reacher_reset(rand):
    q1 = -math.pi + _TWO_PI * rand(0)
    q2 = -math.pi + _TWO_PI * rand(1)
    radius = 0.1 + (0.9 * (rc.L1 + rc.L2) - 0.1) * rand(2)
    angle = -math.pi + _TWO_PI * rand(3)
    z = torch.zeros_like(q1)
    return [q1, q2, z, z, radius * torch.cos(angle), radius * torch.sin(angle)]


def _reacher_obs(s):
    q1, q2, qd1, qd2, tx, ty = s
    tx_, ty_ = _reacher_tip(q1, q2)
    return [torch.cos(q1), torch.cos(q2), torch.sin(q1), torch.sin(q2),
            _div(qd1, rc.MAX_SPEED), _div(qd2, rc.MAX_SPEED), tx, ty,
            tx_ - tx, ty_ - ty]


def _reacher_step(s, act):
    q1, q2, qd1, qd2, tx, ty = s
    u1 = torch.clamp(act[0], -rc.MAX_TORQUE, rc.MAX_TORQUE)
    u2 = torch.clamp(act[1], -rc.MAX_TORQUE, rc.MAX_TORQUE)
    qd1n = torch.clamp(qd1 + (rc.ACCEL_GAIN * u1 - rc.DAMPING * qd1) * rc.DT,
                       -rc.MAX_SPEED, rc.MAX_SPEED)
    qd2n = torch.clamp(qd2 + (rc.ACCEL_GAIN * u2 - rc.DAMPING * qd2) * rc.DT,
                       -rc.MAX_SPEED, rc.MAX_SPEED)
    q1n, q2n = q1 + qd1n * rc.DT, q2 + qd2n * rc.DT
    tx_, ty_ = _reacher_tip(q1n, q2n)
    dist = torch.sqrt(torch.square(tx_ - tx) + torch.square(ty_ - ty))
    reward = -dist - 0.01 * (u1 * u1 + u2 * u2)
    return [q1n, q2n, qd1n, qd2n, tx, ty], reward, torch.zeros_like(q1)


def _simple_step(s, act):
    x = s[0] + torch.clamp(act[0], -1.0, 1.0)
    term = (x >= 5.0).to(torch.float32)
    return [x], term, term                  # reward 1 iff terminated


def _mountain_car_lane(code: int, norm: bool) -> Lane:
    return Lane(
        code, 2, 2, 0, mc.HORIZON,
        reset=lambda rand: [-0.6 + 0.2 * rand(0), torch.zeros_like(rand(0))],
        obs=_mountain_car_obs(norm),
        step=_mountain_car_step,
        pack=lambda st: (torch.stack([st.position, st.velocity], 1), st.t),
        unpack=lambda m, t: mc.MountainCarState(m[:, 0], m[:, 1], t))


LANES: Dict[str, Lane] = {
    "pendulum": Lane(
        0, 2, 3, 0, pd.HORIZON,
        reset=lambda rand: [-math.pi + _TWO_PI * rand(0),
                            -1.0 + 2.0 * rand(1)],
        obs=lambda s: [torch.cos(s[0]), torch.sin(s[0]), s[1]],
        step=_pendulum_step,
        pack=lambda st: (torch.stack([st.theta, st.theta_dot], 1), st.t),
        unpack=lambda m, t: pd.PendulumState(m[:, 0], m[:, 1], t)),
    "cartpole": Lane(
        1, 4, 4, 2, cp.HORIZON,
        reset=lambda rand: [-0.05 + 0.1 * rand(j) for j in range(4)],
        obs=list,
        step=_cartpole_step,
        pack=lambda st: (torch.stack(list(st[:4]), 1), st.t),
        unpack=lambda m, t: cp.CartPoleState(*m.unbind(1), t)),
    "acrobot": Lane(
        2, 4, 6, 3, ac.HORIZON,
        reset=lambda rand: [-0.1 + 0.2 * rand(j) for j in range(4)],
        obs=lambda s: [torch.cos(s[0]), torch.sin(s[0]), torch.cos(s[1]),
                       torch.sin(s[1]), s[2], s[3]],
        step=_acrobot_step,
        pack=lambda st: (st.s, st.t),
        unpack=lambda m, t: ac.AcrobotState(m, t)),
    "simple": Lane(
        3, 1, 1, 0, sp.HORIZON,
        reset=lambda rand: [torch.zeros_like(rand(0))],
        obs=list,
        step=_simple_step,
        pack=lambda st: (st.s[:, None], st.t),
        unpack=lambda m, t: sp.SimpleState(m[:, 0], t)),
    "mountain_car": _mountain_car_lane(4, False),
    "mountain_car_norm": _mountain_car_lane(5, True),
    "reacher": Lane(
        6, 6, 10, 0, rc.HORIZON,
        reset=_reacher_reset,
        obs=_reacher_obs,
        step=_reacher_step,
        pack=lambda st: (torch.cat([st.q, st.qd, st.target], 1), st.t),
        unpack=lambda m, t: rc.ReacherState(m[:, 0:2], m[:, 2:4], m[:, 4:6],
                                            t)),
}
SUPPORTED = frozenset(LANES)

# one launch count per lane and mode for each variant: the kernel is one
# template, run per lane, with the V planes ("values", the training
# rollouts) or without them ("metrics": the kernel sums the completed
# episodes' returns, which the evaluation rollouts read; the "bf16"
# backend's training rollouts, which take no value net, count here too),
# with the nets in shared memory (lane_launches) or in global memory
# (global_launches)
MODES = ("values", "metrics")
lane_launches = {(name, mode): _build.LaunchCount(f"rollout[{name}]/{mode}")
                 for name in LANES for mode in MODES}
global_launches = {
    (name, mode): _build.LaunchCount(f"rollout_global[{name}]/{mode}")
    for name in LANES for mode in MODES}


# envs a block: the shared-memory variant's tiles (csrc/rollout.cu ET_MAX is
# the largest, which sizes its shared memory) and the global-memory
# variant's ET_L
TILES = (1, 2, 4, 8)
_ET, _ET_L = TILES[-1], 32
_STATIC_SMEM = 1024     # the kernel's static shared memory (the nets' shapes)


def tile_for(n_envs: int, resident: int) -> int:
    """The shared-memory variant's envs a block for ``n_envs`` envs on a
    card that holds ``resident`` of its blocks at once: the smallest tile
    of :data:`TILES` whose grid fits in one wave (each block runs all T
    steps, so a second wave would double the rollout), else the largest."""
    for et in TILES:
        if -(-n_envs // et) <= resident:
            return et
    return TILES[-1]


def variant_bytes(pwidths: Sequence[int],
                  vwidths: Optional[Sequence[int]] = None) -> List[int]:
    """Shared memory one rollout launch needs in each variant
    (``_build.VARIANTS``), in bytes, the static share included: per net
    two ping-pong hidden tiles and the output tile over the block's envs,
    plus the obs tile, plus the nets themselves in the shared-memory
    variant.  ``vwidths``: the value net of a launch with the V planes
    (``None``: with the metrics, which needs less).  The same as
    csrc/rollout.cu ``rollout_smem`` (a card test holds the two
    together)."""
    nets = [pwidths] + ([vwidths] if vwidths is not None else [])
    hmax = max([1] + [w for n in nets for w in n[1:-1]])
    out = []
    for variant, et in enumerate((_ET, _ET_L)):
        floats = pwidths[0] * et
        for n in nets:
            floats += 2 * hmax * et + n[-1] * et
            if variant == 0:
                floats += sum(a * b + b for a, b in zip(n[:-1], n[1:]))
        out.append(4 * floats + _STATIC_SMEM)
    return out


# --- raw outputs shared by the kernel and the plain version ---------------

class RawRollout(NamedTuple):
    obs: torch.Tensor          # [T, E, O]
    next_obs: torch.Tensor     # [T, E, O]
    action: torch.Tensor       # [T, E, A] unclipped mu + eps * sigma, or
                               # int32 [T, E, 1] class ids
    log_prob: torch.Tensor     # [T, E]
    reward: torch.Tensor       # [T, E]
    terminated: torch.Tensor   # [T, E] bool
    truncated: torch.Tensor    # [T, E] bool
    value: Optional[torch.Tensor]       # [T, E] V(s) or None
    next_value: Optional[torch.Tensor]  # [T, E] V(s') or None
    st_final: torch.Tensor     # [E, D] lane state
    steps_final: torch.Tensor  # [E] float
    metrics: torch.Tensor      # [3, E] completed-episode R sum, J sum, count


def _outputs(ln: Lane, A: int, T: int, E: int, with_v: bool,
             dev) -> RawRollout:
    f32 = dict(dtype=torch.float32, device=dev)
    O = ln.obs_dim
    action = (torch.empty(T, E, 1, dtype=torch.int32, device=dev)
              if ln.n_actions else torch.empty(T, E, A, **f32))
    return RawRollout(
        obs=torch.empty(T, E, O, **f32), next_obs=torch.empty(T, E, O, **f32),
        action=action, log_prob=torch.empty(T, E, **f32),
        reward=torch.empty(T, E, **f32),
        terminated=torch.empty(T, E, dtype=torch.bool, device=dev),
        truncated=torch.empty(T, E, dtype=torch.bool, device=dev),
        value=torch.empty(T, E, **f32) if with_v else None,
        next_value=torch.empty(T, E, **f32) if with_v else None,
        st_final=torch.empty(E, ln.state_dim, **f32),
        steps_final=torch.empty(E, **f32), metrics=torch.empty(3, E, **f32))


def _entry(ln: Lane, s0: int, s1: int, lanes, st0, steps0):
    """The lane state rows and step counts a rollout starts from: the entry
    reset (draws 50 + j at T_INIT) or the carried ``st0``/``steps0``."""
    if st0 is None:
        rows = ln.reset(lambda j: uniform01(s0, s1, T_INIT, 50 + j, lanes))
        return rows, torch.zeros(lanes.shape[0], dtype=torch.float32,
                                 device=lanes.device)
    return [st0[:, d].clone() for d in range(ln.state_dim)], steps0.clone()


def _advance(ln: Lane, s0: int, s1: int, t: int, lanes, rows, steps,
             act_rows):
    """Step t of the lane on actions ``act_rows``: physics, horizon
    truncation and auto-reset with draws 50 + j at step t.  Returns
    (successor rows, reward, term, trunc, done, rows and steps the next
    step starts from)."""
    new_rows, reward, term = ln.step(rows, act_rows)
    steps2 = steps + 1.0
    trunc = torch.clamp_min(
        (steps2 >= ln.horizon).to(torch.float32) - term, 0.0)
    done = torch.maximum(term, trunc)
    fresh = ln.reset(lambda j: uniform01(s0, s1, t, 50 + j, lanes))
    rows = [torch.where(done > 0, f, n) for f, n in zip(fresh, new_rows)]
    steps = torch.where(done > 0, torch.zeros_like(steps), steps2)
    return new_rows, reward, term, trunc, done, rows, steps


def rollout_plain(params, log_std: Optional[torch.Tensor], v_params, seed,
                  n_envs: int, length: int, activation: str = "relu",
                  st0: Optional[torch.Tensor] = None,
                  steps0: Optional[torch.Tensor] = None,
                  gamma: float = 0.99, lane: str = "pendulum") -> RawRollout:
    """Plain PyTorch version of the kernel, step for step.  ``log_std`` is
    None for a discrete lane; ``st0`` is the carried [E, D] lane state."""
    ln = LANES[lane]
    s0, s1 = seed[0] & _M32, seed[1] & _M32
    E, T = n_envs, length
    dev = params[0][0].device
    discrete = ln.n_actions > 0
    A = 1 if discrete else log_std.shape[0]
    lanes = torch.arange(E, dtype=torch.int64, device=dev)
    rows, steps = _entry(ln, s0, s1, lanes, st0, steps0)
    racc, jacc = torch.zeros_like(steps), torch.zeros_like(steps)
    gpow = torch.ones_like(steps)
    with_v = v_params is not None
    out = _outputs(ln, A, T, E, with_v, dev)
    out.metrics.zero_()
    lp0 = -0.5 * A * math.log(_TWO_PI)
    for t in range(T):
        ob = torch.stack(ln.obs(rows), dim=-1)
        out.obs[t] = ob
        h = mlp.apply(params, ob, activation)
        if with_v:
            out.value[t] = mlp.apply(v_params, ob, activation)[:, 0]
        if discrete:
            idx, lp = gumbel_max_plain(h, s0, s1, t, lanes)
            out.action[t, :, 0] = idx
            act_rows = [idx.to(torch.float32)]
        else:
            lp = torch.full((E,), lp0, dtype=torch.float32, device=dev)
            for j in range(A):
                ls = log_std[j]
                sigma = torch.exp(ls)
                u1 = torch.clamp_min(uniform01(s0, s1, t, 2 * j, lanes),
                                     1e-12)
                u2 = uniform01(s0, s1, t, 2 * j + 1, lanes)
                eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
                    _TWO_PI * u2)
                a = h[:, j] + eps * sigma
                z = (a - h[:, j]) / sigma
                lp = lp - ls - 0.5 * z * z
                out.action[t, :, j] = a
            act_rows = list(out.action[t].unbind(1))
        out.log_prob[t] = lp
        new_rows, reward, term, trunc, done, rows, steps = _advance(
            ln, s0, s1, t, lanes, rows, steps, act_rows)
        out.reward[t] = reward
        out.terminated[t] = term > 0
        out.truncated[t] = trunc > 0
        nob = torch.stack(ln.obs(new_rows), dim=-1)
        out.next_obs[t] = nob
        if with_v:
            out.next_value[t] = mlp.apply(v_params, nob, activation)[:, 0]
        racc2 = racc + reward
        jacc2 = jacc + gpow * reward
        out.metrics[0] += done * racc2
        out.metrics[1] += done * jacc2
        out.metrics[2] += done
        racc = (1.0 - done) * racc2
        jacc = (1.0 - done) * jacc2
        gpow = torch.where(done > 0, torch.ones_like(gpow), gpow * gamma)
    out.st_final.copy_(torch.stack(rows, dim=1))
    out.steps_final.copy_(steps)
    return out


def replay_plain(lane: str, action: torch.Tensor, seed,
                 st0: Optional[torch.Tensor] = None,
                 steps0: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The lane's plain physics stepped on recorded actions ``action``
    [T, E, A] (float32; a discrete lane's class ids as they are) with the
    rollout's resets: what a rollout that drew these actions must have
    recorded.  Returns {"obs", "next_obs", "reward", "terminated",
    "truncated", "st_final", "steps_final"}; the kernel's physics rounds as
    these PyTorch ops do, so on the card the two agree bit for bit."""
    ln = LANES[lane]
    s0, s1 = seed[0] & _M32, seed[1] & _M32
    T, E = action.shape[:2]
    lanes = torch.arange(E, dtype=torch.int64, device=action.device)
    rows, steps = _entry(ln, s0, s1, lanes, st0, steps0)
    cols = {k: [] for k in ("obs", "next_obs", "reward", "terminated",
                            "truncated")}
    for t in range(T):
        cols["obs"].append(torch.stack(ln.obs(rows), dim=-1))
        act_rows = list(action[t].to(torch.float32).unbind(1))
        new_rows, reward, term, trunc, _, rows, steps = _advance(
            ln, s0, s1, t, lanes, rows, steps, act_rows)
        cols["next_obs"].append(torch.stack(ln.obs(new_rows), dim=-1))
        cols["reward"].append(reward)
        cols["terminated"].append(term > 0)
        cols["truncated"].append(trunc > 0)
    out = {k: torch.stack(v) for k, v in cols.items()}
    out["st_final"] = torch.stack(rows, dim=1)
    out["steps_final"] = steps
    return out


# --- the kernel -----------------------------------------------------------

class _RolloutArgs(ctypes.Structure):
    """Mirror of `struct RolloutArgs` in csrc/rollout.cu."""
    _fields_ = [
        ("policy_params", ctypes.c_void_p), ("value_params", ctypes.c_void_p),
        ("log_std", ctypes.c_void_p), ("st0", ctypes.c_void_p),
        ("steps0", ctypes.c_void_p),
        ("policy_dims", ctypes.POINTER(ctypes.c_int)),
        ("value_dims", ctypes.POINTER(ctypes.c_int)),
        ("lane", ctypes.c_int), ("variant", ctypes.c_int),
        ("tile", ctypes.c_int), ("n_layers", ctypes.c_int),
        ("act_dim", ctypes.c_int),
        ("activation", ctypes.c_int), ("T", ctypes.c_int), ("E", ctypes.c_int),
        ("s0", ctypes.c_uint32), ("s1", ctypes.c_uint32),
        ("gamma", ctypes.c_float), ("lp0", ctypes.c_float),
        ("obs", ctypes.c_void_p), ("next_obs", ctypes.c_void_p),
        ("action", ctypes.c_void_p), ("log_prob", ctypes.c_void_p),
        ("reward", ctypes.c_void_p), ("value", ctypes.c_void_p),
        ("next_value", ctypes.c_void_p), ("action_idx", ctypes.c_void_p),
        ("terminated", ctypes.c_void_p),
        ("truncated", ctypes.c_void_p), ("st_final", ctypes.c_void_p),
        ("steps_final", ctypes.c_void_p), ("metrics", ctypes.c_void_p),
    ]


def _declare() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_rollout_declared", False):
        lib.ppoc_rollout_args_size.restype = ctypes.c_int
        if lib.ppoc_rollout_args_size() != ctypes.sizeof(_RolloutArgs):
            raise RuntimeError("RolloutArgs layout differs between "
                               "csrc/rollout.cu and cuda_rollout.py")
        args = [ctypes.POINTER(_RolloutArgs)]
        lib.ppoc_rollout_smem_bytes.argtypes = args + [ctypes.c_int]
        lib.ppoc_rollout_smem_bytes.restype = ctypes.c_long
        for entry in (lib.ppoc_rollout, lib.ppoc_rollout_vnext_every_step):
            entry.argtypes = args + [ctypes.c_void_p]
            entry.restype = ctypes.c_int
        lib.ppoc_rollout_resident.argtypes = args
        lib.ppoc_rollout_resident.restype = ctypes.c_int
        lib.ppoc_rollout_layer_split.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ppoc_rollout_layer_split.restype = ctypes.c_int
        u32 = ctypes.c_uint32
        lib.ppoc_rng_bits.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, u32,
                                      u32, u32, ctypes.c_void_p]
        lib.ppoc_rng_bits.restype = ctypes.c_int
        lib.ppoc_gumbel_max.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, u32, u32, u32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.ppoc_gumbel_max.restype = ctypes.c_int
        lib._rollout_declared = True
    return lib


def layer_split(din: int, dout: int) -> int:
    """How many parts the built kernel splits each unit's input sum into,
    for a layer of ``din`` inputs and ``dout`` units (csrc/rollout.cu
    ``layer_split``, whose arguments are the widths alone); for the card
    tests."""
    return _declare().ppoc_rollout_layer_split(din, dout)


def rng_bits_cuda(s0: int, s1: int, t: int, draw: int, n: int,
                  device) -> torch.Tensor:
    """The kernel's RNG bits for lanes 0..n-1 (int64 holding uint32), from
    a one-line kernel that calls the same device function as the rollout;
    for checking the bits exactly on the card."""
    lib = _declare()
    out = torch.empty(n, dtype=torch.int32, device=device)
    _build.check(lib, lib.ppoc_rng_bits(out.data_ptr(), n, s0, s1, t, draw,
                                        _build.stream_of(device)),
                 "rng_bits kernel")
    return out.to(torch.int64) & _M32


def gumbel_max_cuda(logits: torch.Tensor, s0: int, s1: int, t: int):
    """The kernel's sampler alone (the device function the discrete lanes
    call) on logits [n, K] for lanes 0..n-1 at step t: (class ids int64,
    log-probs); for checking the sampler exactly on the card."""
    lib = _declare()
    dev = logits.device
    n, K = logits.shape
    _build.require(logits, "logits", device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    lp = torch.empty(n, dtype=torch.float32, device=dev)
    _build.check(lib, lib.ppoc_gumbel_max(
        logits.data_ptr(), n, K, s0 & _M32, s1 & _M32, t, idx.data_ptr(),
        lp.data_ptr(), _build.stream_of(dev)), "gumbel_max kernel")
    return idx.to(torch.int64), lp


# the last launch's variant index, tile (envs a block), blocks and (shared
# memory variant) the blocks the card holds at once, for the callers that
# report them
last_launch: Dict[str, int] = {}
_resident: Dict[Tuple, int] = {}    # (device, lane, smem bytes) -> blocks


def _resident_blocks(lib, args, dev) -> int:
    """How many blocks of the shared-memory variant ``args`` launches the
    card holds at once, the least over :data:`TILES` (their register
    counts differ), from the occupancy query; cached per device, lane and
    shared memory."""
    key = (dev.index, args.lane,
           lib.ppoc_rollout_smem_bytes(ctypes.byref(args), 0))
    if key not in _resident:
        counts = []
        for et in TILES:
            args.tile = et
            n = lib.ppoc_rollout_resident(ctypes.byref(args))
            _build.check(lib, max(-n, 0), "rollout kernel's occupancy query")
            if n == 0:
                raise RuntimeError(f"no {et}-env block of the rollout "
                                   f"kernel fits an SM")
            counts.append(n)
        _resident[key] = min(counts)
    return _resident[key]


def _launch(entry: str, params, log_std, v_params, seed, n_envs: int,
            length: int, activation: str, st0, steps0, gamma: float,
            lane: str, variant: Optional[str],
            tile: Optional[int]) -> RawRollout:
    ln = LANES[lane]
    E, T = n_envs, length
    widths = mlp.dims(params)
    flat = mlp.flatten(params)
    dev = flat.device
    _build.require(flat, "policy params", device=dev)
    if ln.n_actions:
        A = out_w = ln.n_actions
    else:
        A = out_w = log_std.shape[0]
        _build.require(log_std, "log_std", (A,), device=dev)
    if widths[0] != ln.obs_dim or widths[-1] != out_w:
        raise ValueError(f"the {lane} policy net must map {ln.obs_dim} -> "
                         f"{out_w}, got {widths}")
    if not 1 <= A <= 8 or len(widths) - 1 > 8:
        raise ValueError("the rollout kernel takes 1-8 action dims or "
                         "classes and 1-8 layers")
    vflat, vwidths = None, None
    if v_params is not None:
        vflat, vwidths = mlp.flatten(v_params), mlp.dims(v_params)
        _build.require(vflat, "value params", device=dev)
        if (len(vwidths) != len(widths) or vwidths[0] != ln.obs_dim
                or vwidths[-1] != 1):
            raise ValueError(f"value net {vwidths} must map {ln.obs_dim} -> 1 "
                             f"with the policy net's depth {len(widths) - 1}")
    if st0 is not None:
        _build.require(st0, "st0", (E, ln.state_dim), device=dev)
        _build.require(steps0, "steps0", (E,), device=dev)
    out = _outputs(ln, A, T, E, v_params is not None, dev)
    pdims = (ctypes.c_int * len(widths))(*widths)
    vdims = (ctypes.c_int * len(widths))(*(vwidths or widths))
    p = _build.ptr
    discrete = ln.n_actions > 0
    args = _RolloutArgs(
        p(flat), p(vflat), None if discrete else p(log_std), p(st0),
        p(steps0), pdims, vdims, ln.code, 0, _ET, len(widths) - 1, A,
        _build.ACTIVATIONS[activation], T, E, seed[0] & _M32, seed[1] & _M32,
        gamma, -0.5 * A * math.log(_TWO_PI),
        p(out.obs), p(out.next_obs), None if discrete else p(out.action),
        p(out.log_prob), p(out.reward), p(out.value), p(out.next_value),
        p(out.action) if discrete else None, p(out.terminated),
        p(out.truncated), p(out.st_final), p(out.steps_final),
        p(out.metrics))
    lib = _declare()
    sizes = [lib.ppoc_rollout_smem_bytes(ctypes.byref(args), v)
             for v in range(len(_build.VARIANTS))]
    sizes = [n + _STATIC_SMEM if n >= 0 else n for n in sizes]
    args.variant = _build.pick_variant(
        sizes, _build.smem_optin(dev), variant,
        f"rollout kernel for nets {widths}/{vwidths}")
    allowed = TILES if args.variant == 0 else (_ET_L,)
    if tile is not None and tile not in allowed:
        raise ValueError(f"the {_build.VARIANTS[args.variant]!r} variant "
                         f"runs {allowed} envs a block, not {tile}")
    resident = None
    if args.variant == 1:
        tile = _ET_L
    else:
        resident = _resident_blocks(lib, args, dev)
        tile = tile_for(E, resident) if tile is None else tile
    args.tile = tile
    _build.check(lib, getattr(lib, entry)(ctypes.byref(args),
                                          _build.stream_of(dev)),
                 "rollout kernel")
    mode = "values" if v_params is not None else "metrics"
    counts = global_launches if args.variant else lane_launches
    counts[lane, mode].n += 1
    last_launch.update(variant=args.variant, tile=tile,
                       blocks=-(-E // tile), resident=resident)
    return out


def rollout_kernel(params, log_std: Optional[torch.Tensor], v_params, seed,
                   n_envs: int, length: int, activation: str = "relu",
                   st0: Optional[torch.Tensor] = None,
                   steps0: Optional[torch.Tensor] = None,
                   gamma: float = 0.99, lane: str = "pendulum",
                   variant: Optional[str] = None,
                   tile: Optional[int] = None) -> RawRollout:
    """Launch the kernel; same arguments and results as rollout_plain.
    The variant (``_build.VARIANTS``: the nets in shared memory, or in
    global memory) is the first whose shared memory fits, unless
    ``variant`` names one.  ``tile`` forces the envs a block (one of
    :data:`TILES` in shared memory, 32 in global memory), for tests and
    timing; by default :func:`tile_for` picks it from the card's resident
    blocks.  An env's outputs do not depend on either."""
    return _launch("ppoc_rollout", params, log_std, v_params, seed, n_envs,
                   length, activation, st0, steps0, gamma, lane, variant,
                   tile)


def rollout_kernel_vnext_every_step(
        params, log_std: Optional[torch.Tensor], v_params, seed,
        n_envs: int, length: int, activation: str = "relu",
        st0: Optional[torch.Tensor] = None,
        steps0: Optional[torch.Tensor] = None, gamma: float = 0.99,
        lane: str = "pendulum", variant: Optional[str] = None,
        tile: Optional[int] = None) -> RawRollout:
    """:func:`rollout_kernel` with the value net's V(s') pass at every
    step, where the kernel takes V(s') from the next step's V(s) wherever
    a step did not end.  Not on any path: the card tests hold the two
    launches equal bit for bit."""
    return _launch("ppoc_rollout_vnext_every_step", params, log_std,
                   v_params, seed, n_envs, length, activation, st0, steps0,
                   gamma, lane, variant, tile)


def rollout_fused(env_name: str, policy_params, seed, n_envs: int,
                  length: int, activation: str = "relu", env_carry=None,
                  gamma: float = 0.99, return_metrics: bool = False,
                  v_params=None):
    """One-kernel rollout; returns (Transition, env_carry), plus
    ``(sum_R, sum_J, n_episodes)`` over COMPLETED episodes with
    ``return_metrics`` or the ``(values, next_values)`` planes with
    ``v_params`` -- the JAX ``rollout_fused`` contract, with the two seed
    words in place of the key.  A discrete lane's actions are int32
    [T, E, 1] class ids."""
    from ppoc_tpu_torch.algo.ppo import Transition

    if return_metrics and v_params is not None:
        raise ValueError("return_metrics and v_params are mutually exclusive")
    if env_name not in SUPPORTED:
        raise NotImplementedError(
            f"no rollout lane for {env_name!r} (lanes: {sorted(SUPPORTED)})")
    ln = LANES[env_name]
    params = policy_params["mlp"]
    st0 = steps0 = None
    if env_carry is not None:
        state, _ = env_carry
        mat, steps = ln.pack(state)
        st0 = mat.to(torch.float32).contiguous()
        steps0 = steps.to(torch.float32)
    run = rollout_kernel if params[0][0].is_cuda else rollout_plain
    raw = run(params, policy_params.get("log_std"), v_params, seed, n_envs,
              length, activation, st0, steps0, gamma, env_name)
    traj = Transition(obs=raw.obs, action=raw.action, log_prob=raw.log_prob,
                      next_obs=raw.next_obs, reward=raw.reward,
                      terminated=raw.terminated, truncated=raw.truncated)
    state = ln.unpack(raw.st_final, raw.steps_final.to(torch.int32))
    carry = (state, torch.stack(ln.obs(list(raw.st_final.unbind(1))), -1))
    if return_metrics:
        return traj, carry, tuple(raw.metrics.sum(dim=1))
    if v_params is not None:
        return traj, carry, (raw.value, raw.next_value)
    return traj, carry

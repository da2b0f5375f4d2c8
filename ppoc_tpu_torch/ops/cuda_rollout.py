"""K1: the whole-rollout kernel (``csrc/rollout.cu``) and its plain version.

Counterpart of ``ppoc_tpu/ops/pallas_rollout.py`` ``rollout_fused``, the
Pendulum lane.  One launch runs all T steps: policy forward, Box-Muller
sampling and log-prob, physics, truncation and auto-reset, plus either the
value planes V(s), V(s') (``v_params``) or the completed-episode R/J sums
(``return_metrics``).

Randomness is the JAX kernel's counter RNG, bit for bit: a murmur3
finalizer over (seed words, step, draw, env lane).  The caller passes the
two 32-bit seed words; given the JAX package's seed words (its
``fold_in(key, 0)`` key data) both packages draw the same uniforms.

A CUDA tensor launches the kernel, a CPU tensor runs :func:`rollout_plain`,
which repeats the kernel's arithmetic op for op in PyTorch (uint32
arithmetic done in int64 with masks, products split so none overflows).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ppoc_tpu_torch.envs.pendulum import HORIZON, PendulumState, obs_of
from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import _build

launches = _build.LaunchCount("rollout_pendulum")

_TWO_PI = 2.0 * math.pi
_M32 = 0xFFFFFFFF
T_INIT = 0xFFFF0000          # the step counter of the entry reset
SUPPORTED = frozenset({"pendulum"})


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


def seed_words(generator: torch.Generator) -> Tuple[int, int]:
    """Two fresh 32-bit seed words for one rollout."""
    s = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)
    return int(s[0]), int(s[1])


# --- raw outputs shared by the kernel and the plain version ---------------

class RawRollout(NamedTuple):
    obs: torch.Tensor          # [T, E, 3]
    next_obs: torch.Tensor     # [T, E, 3]
    action: torch.Tensor       # [T, E, A]  unclipped mu + eps * sigma
    log_prob: torch.Tensor     # [T, E]
    reward: torch.Tensor       # [T, E]
    terminated: torch.Tensor   # [T, E] bool
    truncated: torch.Tensor    # [T, E] bool
    value: Optional[torch.Tensor]       # [T, E] V(s) or None
    next_value: Optional[torch.Tensor]  # [T, E] V(s') or None
    st_final: torch.Tensor     # [E, 2] (theta, theta_dot)
    steps_final: torch.Tensor  # [E] float
    metrics: torch.Tensor      # [3, E] completed-episode R sum, J sum, count


def rollout_plain(params, log_std: torch.Tensor, v_params, seed, n_envs: int,
                  length: int, activation: str = "relu",
                  st0: Optional[torch.Tensor] = None,
                  steps0: Optional[torch.Tensor] = None,
                  gamma: float = 0.99) -> RawRollout:
    """Plain PyTorch version of the kernel, step for step."""
    s0, s1 = seed[0] & _M32, seed[1] & _M32
    E, T, A = n_envs, length, log_std.shape[0]
    dev = log_std.device
    lanes = torch.arange(E, dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if st0 is None:
        th = -math.pi + _TWO_PI * uniform01(s0, s1, T_INIT, 50, lanes)
        thd = -1.0 + 2.0 * uniform01(s0, s1, T_INIT, 51, lanes)
        steps = torch.zeros(E, **f32)
    else:
        th, thd, steps = st0[:, 0].clone(), st0[:, 1].clone(), steps0.clone()
    racc, jacc = torch.zeros(E, **f32), torch.zeros(E, **f32)
    gpow = torch.ones(E, **f32)
    metrics = torch.zeros(3, E, **f32)
    obs = torch.empty(T, E, 3, **f32)
    next_obs = torch.empty(T, E, 3, **f32)
    action = torch.empty(T, E, A, **f32)
    log_prob = torch.empty(T, E, **f32)
    reward = torch.empty(T, E, **f32)
    truncated = torch.empty(T, E, dtype=torch.bool, device=dev)
    with_v = v_params is not None
    value = torch.empty(T, E, **f32) if with_v else None
    next_value = torch.empty(T, E, **f32) if with_v else None
    lp0 = -0.5 * A * math.log(_TWO_PI)
    for t in range(T):
        ob = torch.stack([torch.cos(th), torch.sin(th), thd], dim=-1)
        obs[t] = ob
        mu = mlp.apply(params, ob, activation)
        if with_v:
            value[t] = mlp.apply(v_params, ob, activation)[:, 0]
        lp = torch.full((E,), lp0, **f32)
        for j in range(A):
            ls = log_std[j]
            sigma = torch.exp(ls)
            u1 = torch.clamp_min(uniform01(s0, s1, t, 2 * j, lanes), 1e-12)
            u2 = uniform01(s0, s1, t, 2 * j + 1, lanes)
            eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
            a = mu[:, j] + eps * sigma
            z = (a - mu[:, j]) / sigma
            lp = lp - ls - 0.5 * z * z
            action[t, :, j] = a
        log_prob[t] = lp
        # pendulum physics, the lane's operation order
        u = torch.clamp(action[t, :, 0], -2.0, 2.0)
        v = th + math.pi
        an = v - _TWO_PI * torch.floor(v / _TWO_PI) - math.pi
        cost = an * an + 0.1 * thd * thd + 0.001 * u * u
        thd2 = torch.clamp(thd + (15.0 * torch.sin(th) + 3.0 * u) * 0.05,
                           -8.0, 8.0)
        th2 = th + thd2 * 0.05
        reward[t] = -cost
        steps2 = steps + 1.0
        done = steps2 >= HORIZON          # pendulum never terminates
        truncated[t] = done
        nob = torch.stack([torch.cos(th2), torch.sin(th2), thd2], dim=-1)
        next_obs[t] = nob
        if with_v:
            next_value[t] = mlp.apply(v_params, nob, activation)[:, 0]
        d = done.to(torch.float32)
        racc2 = racc + reward[t]
        jacc2 = jacc + gpow * reward[t]
        metrics[0] += d * racc2
        metrics[1] += d * jacc2
        metrics[2] += d
        racc = (1.0 - d) * racc2
        jacc = (1.0 - d) * jacc2
        gpow = torch.where(done, torch.ones_like(gpow), gpow * gamma)
        fth = -math.pi + _TWO_PI * uniform01(s0, s1, t, 50, lanes)
        fthd = -1.0 + 2.0 * uniform01(s0, s1, t, 51, lanes)
        th = torch.where(done, fth, th2)
        thd = torch.where(done, fthd, thd2)
        steps = torch.where(done, torch.zeros_like(steps), steps2)
    return RawRollout(obs, next_obs, action, log_prob, reward,
                      torch.zeros_like(truncated), truncated, value,
                      next_value, torch.stack([th, thd], dim=1), steps,
                      metrics)


# --- the kernel -----------------------------------------------------------

class _RolloutArgs(ctypes.Structure):
    """Mirror of `struct RolloutArgs` in csrc/rollout.cu."""
    _fields_ = [
        ("policy_params", ctypes.c_void_p), ("value_params", ctypes.c_void_p),
        ("log_std", ctypes.c_void_p), ("st0", ctypes.c_void_p),
        ("steps0", ctypes.c_void_p),
        ("policy_dims", ctypes.POINTER(ctypes.c_int)),
        ("value_dims", ctypes.POINTER(ctypes.c_int)),
        ("n_layers", ctypes.c_int), ("act_dim", ctypes.c_int),
        ("activation", ctypes.c_int), ("T", ctypes.c_int), ("E", ctypes.c_int),
        ("s0", ctypes.c_uint32), ("s1", ctypes.c_uint32),
        ("gamma", ctypes.c_float), ("lp0", ctypes.c_float),
        ("obs", ctypes.c_void_p), ("next_obs", ctypes.c_void_p),
        ("action", ctypes.c_void_p), ("log_prob", ctypes.c_void_p),
        ("reward", ctypes.c_void_p), ("value", ctypes.c_void_p),
        ("next_value", ctypes.c_void_p), ("terminated", ctypes.c_void_p),
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
        lib.ppoc_rollout_smem_bytes.argtypes = args
        lib.ppoc_rollout_smem_bytes.restype = ctypes.c_long
        lib.ppoc_rollout_pendulum.argtypes = args + [ctypes.c_void_p]
        lib.ppoc_rollout_pendulum.restype = ctypes.c_int
        lib.ppoc_rng_bits.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_uint32, ctypes.c_uint32,
                                      ctypes.c_uint32, ctypes.c_uint32,
                                      ctypes.c_void_p]
        lib.ppoc_rng_bits.restype = ctypes.c_int
        lib._rollout_declared = True
    return lib


def rollout_kernel(params, log_std: torch.Tensor, v_params, seed,
                   n_envs: int, length: int, activation: str = "relu",
                   st0: Optional[torch.Tensor] = None,
                   steps0: Optional[torch.Tensor] = None,
                   gamma: float = 0.99) -> RawRollout:
    """Launch the kernel; same arguments and results as rollout_plain."""
    dev = log_std.device
    E, T, A = n_envs, length, log_std.shape[0]
    widths = mlp.dims(params)
    flat = mlp.flatten(params)
    _build.require(log_std, "log_std", (A,))
    _build.require(flat, "policy params", device=dev)
    if widths[0] != 3 or widths[-1] != A:
        raise ValueError(f"pendulum policy net must map 3 -> {A}, got "
                         f"{widths}")
    if not 1 <= A <= 8 or len(widths) - 1 > 8:
        raise ValueError("the rollout kernel takes 1-8 action dims and "
                         "1-8 layers")
    vflat, vwidths = None, None
    if v_params is not None:
        vflat, vwidths = mlp.flatten(v_params), mlp.dims(v_params)
        _build.require(vflat, "value params", device=dev)
        if len(vwidths) != len(widths) or vwidths[0] != 3 or vwidths[-1] != 1:
            raise ValueError(f"value net {vwidths} must map 3 -> 1 with the "
                             f"policy net's depth {len(widths) - 1}")
    if st0 is not None:
        _build.require(st0, "st0", (E, 2), device=dev)
        _build.require(steps0, "steps0", (E,), device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    with_v = v_params is not None
    out = RawRollout(
        obs=torch.empty(T, E, 3, **f32), next_obs=torch.empty(T, E, 3, **f32),
        action=torch.empty(T, E, A, **f32), log_prob=torch.empty(T, E, **f32),
        reward=torch.empty(T, E, **f32),
        terminated=torch.empty(T, E, dtype=torch.bool, device=dev),
        truncated=torch.empty(T, E, dtype=torch.bool, device=dev),
        value=torch.empty(T, E, **f32) if with_v else None,
        next_value=torch.empty(T, E, **f32) if with_v else None,
        st_final=torch.empty(E, 2, **f32), steps_final=torch.empty(E, **f32),
        metrics=torch.empty(3, E, **f32),
    )
    pdims = (ctypes.c_int * len(widths))(*widths)
    vdims = (ctypes.c_int * len(widths))(*(vwidths or widths))
    p = _build.ptr
    args = _RolloutArgs(
        p(flat), p(vflat), p(log_std), p(st0), p(steps0), pdims, vdims,
        len(widths) - 1, A, _build.ACTIVATIONS[activation], T, E,
        seed[0] & _M32, seed[1] & _M32, gamma, -0.5 * A * math.log(_TWO_PI),
        p(out.obs), p(out.next_obs), p(out.action), p(out.log_prob),
        p(out.reward), p(out.value), p(out.next_value), p(out.terminated),
        p(out.truncated), p(out.st_final), p(out.steps_final),
        p(out.metrics))
    lib = _declare()
    smem = lib.ppoc_rollout_smem_bytes(ctypes.byref(args))
    if smem < 0 or smem + 1024 > _build.smem_optin(dev):
        raise ValueError(
            f"rollout kernel needs {smem} B of shared memory for nets "
            f"{widths}/{vwidths}; more than one block can hold")
    _build.check(lib, lib.ppoc_rollout_pendulum(ctypes.byref(args),
                                                _build.stream_of(dev)),
                 "rollout kernel")
    launches.n += 1
    return out


def rollout_fused(env_name: str, policy_params, seed, n_envs: int,
                  length: int, activation: str = "relu", env_carry=None,
                  gamma: float = 0.99, return_metrics: bool = False,
                  v_params=None):
    """One-kernel rollout; returns (Transition, env_carry), plus
    ``(sum_R, sum_J, n_episodes)`` over COMPLETED episodes with
    ``return_metrics`` or the ``(values, next_values)`` planes with
    ``v_params`` -- the JAX ``rollout_fused`` contract, with the two seed
    words in place of the key."""
    from ppoc_tpu_torch.algo.ppo import Transition

    if return_metrics and v_params is not None:
        raise ValueError("return_metrics and v_params are mutually exclusive")
    if env_name not in SUPPORTED:
        raise NotImplementedError(
            f"the {env_name!r} rollout lane is not ported yet "
            f"(ported: {sorted(SUPPORTED)})")
    log_std = policy_params["log_std"]
    st0 = steps0 = None
    if env_carry is not None:
        state, _ = env_carry
        st0 = torch.stack([state.theta, state.theta_dot], dim=1).float()
        steps0 = state.t.float()
    run = rollout_kernel if log_std.is_cuda else rollout_plain
    raw = run(policy_params["mlp"], log_std, v_params, seed, n_envs, length,
              activation, st0, steps0, gamma)
    traj = Transition(obs=raw.obs, action=raw.action, log_prob=raw.log_prob,
                      next_obs=raw.next_obs, reward=raw.reward,
                      terminated=raw.terminated, truncated=raw.truncated)
    state = PendulumState(raw.st_final[:, 0], raw.st_final[:, 1],
                          raw.steps_final.to(torch.int32))
    carry = (state, obs_of(state))
    if return_metrics:
        return traj, carry, tuple(raw.metrics.sum(dim=1))
    if v_params is not None:
        return traj, carry, (raw.value, raw.next_value)
    return traj, carry

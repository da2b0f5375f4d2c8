"""K3 and K4: whole update phases (``csrc/update.cu``) and their plain
versions.

Counterparts of ``ppoc_tpu/ops/pallas_update.py`` ``value_phase_fused``
(K3) and ``policy_phase_fused`` (K4, Gaussian).  The caller gathers the
rows of every epoch x minibatch step in order beforehand (as the JAX
wrappers do); one launch then runs every step: forward, the loss gradient
in closed form, backward and Adam, with the weights in shared memory.

Adam here is the kernels' own: bias corrections 1 - exp(t log b) folded
into the step size, eps outside the sqrt; K4 runs a second Adam for
log_std with its own timestep.  A CUDA tensor launches the kernel, a CPU
tensor runs the plain version beside it, which spells out the same
forward, backward and update in PyTorch.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import _build
from ppoc_tpu_torch.ops.cuda_mlp import backward_layers, forward_layers
from ppoc_tpu_torch.ops.adam import AdamState

value_launches = _build.LaunchCount("value_phase")
policy_launches = _build.LaunchCount("policy_phase")

_LOG_2PI = math.log(2.0 * math.pi)


class Hyper(ctypes.Structure):
    """Mirror of `struct AdamHyper` in csrc/mlp_step.cuh.  The derived
    constants are computed here in double precision and rounded once to
    float32, as the JAX kernels' Python-float constants are."""
    _fields_ = [(n, ctypes.c_float) for n in
                ("lr", "b1", "b2", "omb1", "omb2", "logb1", "logb2", "eps")]

    @classmethod
    def of(cls, lr: float, b1: float, b2: float, eps: float) -> "Hyper":
        return cls(lr, b1, b2, 1.0 - b1, 1.0 - b2, math.log(b1),
                   math.log(b2), eps)


# --- plain versions -------------------------------------------------------

def _bias_corrections(t: int, h: Hyper) -> Tuple[float, float]:
    """(1 - b1^t, 1 - b2^t) as the kernels form them: float32 exp(t log b)."""
    tf = np.float32(t)
    bc1 = np.float32(1.0) - np.exp(tf * np.float32(h.logb1))
    bc2 = np.float32(1.0) - np.exp(tf * np.float32(h.logb2))
    return float(bc1), float(bc2)


def _adam_(params: Sequence[torch.Tensor], grads, ms, vs, t: int,
           h: Hyper) -> None:
    """In-place Adam step on lists of tensors."""
    bc1, bc2 = _bias_corrections(t, h)
    step = float(np.float32(h.lr) / np.float32(bc1))
    for p, g, m, v in zip(params, grads, ms, vs):
        m.mul_(h.b1).add_(h.omb1 * g)
        v.mul_(h.b2).add_(h.omb2 * (g * g))
        p.sub_(step * m / (torch.sqrt(v / bc2) + h.eps))


def _unpack(params, opt: AdamState):
    """Private copies [W0, b0, W1, ...] of the params and both moments."""
    def flat(tree):
        return [t.clone() for pair in tree for t in pair]
    return flat(params), flat(opt.m), flat(opt.v)


def _pack(flat: List[torch.Tensor]):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def value_phase_plain(obs_seq, tgt_seq, params, opt: AdamState, n_steps: int,
                      mb: int, activation: str, hyper: Hyper):
    """Plain PyTorch version of K3; returns (params', opt', mean loss)."""
    P, M, V = _unpack(params, opt)
    tgt_seq = tgt_seq.reshape(-1)
    loss = torch.zeros((), dtype=torch.float32, device=obs_seq.device)
    for s in range(n_steps):
        x = obs_seq[s * mb: (s + 1) * mb]
        hs = forward_layers(x, P[0::2], P[1::2], activation)
        diff = hs[-1][:, 0] - tgt_seq[s * mb: (s + 1) * mb]
        loss = loss + (diff * diff).sum()
        g = (2.0 / mb) * diff[:, None]
        grads, _ = backward_layers(x, hs, g, P[0::2], activation)
        _adam_(P, grads, M, V, opt.t + s + 1, hyper)
    return (_pack(P), AdamState(_pack(M), _pack(V), opt.t + n_steps),
            loss / (n_steps * mb))


def policy_phase_plain(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
                       opt_policy: AdamState, opt_log_std: AdamState,
                       n_steps: int, mb: int, activation: str, hyper: Hyper,
                       clip_eps: float, ent_coeff: float):
    """Plain PyTorch version of K4; returns (params', log_std', opt_policy',
    opt_log_std', mean loss, mean entropy)."""
    P, M, V = _unpack(params, opt_policy)
    ls = log_std.clone()
    mls, vls = opt_log_std.m.clone(), opt_log_std.v.clone()
    k = ls.shape[0]
    lp_seq, adv_seq = lp_seq.reshape(-1), adv_seq.reshape(-1)
    lp0 = -0.5 * k * _LOG_2PI
    ent0 = 0.5 * k * (1.0 + _LOG_2PI)
    loss = torch.zeros((), dtype=torch.float32, device=obs_seq.device)
    ent_sum = torch.zeros_like(loss)
    for s in range(n_steps):
        rows = slice(s * mb, (s + 1) * mb)
        x, adv = obs_seq[rows], adv_seq[rows]
        sum_ls = ls.sum()
        ent = ent0 + sum_ls
        ent_sum = ent_sum + ent
        loss = loss + (-ent_coeff) * ent
        inv_sigma = torch.exp(-ls)
        hs = forward_layers(x, P[0::2], P[1::2], activation)
        z = (act_seq[rows] - hs[-1]) * inv_sigma
        logp = lp0 - sum_ls - 0.5 * (z * z).sum(dim=1)
        ratio = torch.exp(logp - lp_seq[rows])
        clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
        ra, ca = ratio * adv, clipped * adv
        loss = loss + (-torch.minimum(ra, ca).sum()) / mb
        # only the unclipped branch carries gradient
        dlogp = -(adv * ratio / mb) * (ra <= ca).to(torch.float32)
        gls = (dlogp[:, None] * (z * z - 1.0)).sum(dim=0) - ent_coeff
        g = dlogp[:, None] * z * inv_sigma
        grads, _ = backward_layers(x, hs, g, P[0::2], activation)
        _adam_(P, grads, M, V, opt_policy.t + s + 1, hyper)
        _adam_([ls], [gls], [mls], [vls], opt_log_std.t + s + 1, hyper)
    return (_pack(P), ls,
            AdamState(_pack(M), _pack(V), opt_policy.t + n_steps),
            AdamState(mls, vls, opt_log_std.t + n_steps),
            loss / n_steps, ent_sum / n_steps)


# --- the kernels ----------------------------------------------------------

class _PhaseArgs(ctypes.Structure):
    """Mirror of `struct PhaseArgs` in csrc/update.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "x", "tgt", "act", "lp_old", "adv", "p_in", "m_in", "v_in",
            "p_out", "m_out", "v_out", "ls_in", "mls_in", "vls_in", "ls_out",
            "mls_out", "vls_out", "scratch", "stats")]
        + [("dims", ctypes.POINTER(ctypes.c_int))]
        + [(n, ctypes.c_int) for n in (
            "n_layers", "activation", "n_steps", "mb", "t0", "t0_ls",
            "k_act")]
        + [(n, ctypes.c_float) for n in (
            "two_over_mb", "lp0", "ent0", "clip_lo", "clip_hi", "ent_coeff")]
        + [("hyper", Hyper)]
    )


def _declare() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_phase_declared", False):
        lib.ppoc_phase_args_size.restype = ctypes.c_int
        if lib.ppoc_phase_args_size() != ctypes.sizeof(_PhaseArgs):
            raise RuntimeError("PhaseArgs layout differs between "
                               "csrc/update.cu and cuda_update.py")
        args = [ctypes.POINTER(_PhaseArgs)]
        lib.ppoc_phase_sizes.argtypes = args + [ctypes.POINTER(ctypes.c_long)]
        lib.ppoc_phase_sizes.restype = ctypes.c_int
        for fn in (lib.ppoc_value_phase, lib.ppoc_policy_phase):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._phase_declared = True
    return lib


def _launch(kind: str, args: _PhaseArgs, dev, keep) -> None:
    """Size the scratch, check shared memory, launch.  ``keep`` holds the
    tensors and host arrays the launch reads until it is enqueued."""
    lib = _declare()
    sizes = (ctypes.c_long * 2)()
    if not lib.ppoc_phase_sizes(ctypes.byref(args), sizes):
        raise ValueError("update kernels take 1-8 layers and mb >= 1")
    if sizes[1] + 1024 > _build.smem_optin(dev):
        raise ValueError(f"{kind} kernel needs {sizes[1]} B of shared "
                         f"memory for the weights; more than one block holds")
    scratch = torch.empty(sizes[0], dtype=torch.float32, device=dev)
    args.scratch = scratch.data_ptr()
    fn = lib.ppoc_value_phase if kind == "value" else lib.ppoc_policy_phase
    _build.check(lib, fn(ctypes.byref(args), _build.stream_of(dev)),
                 f"{kind} phase kernel")
    del keep


def _common_args(x, params, opt: AdamState, n_steps: int, mb: int,
                 activation: str, hyper: Hyper):
    dev = x.device
    widths = mlp.dims(params)
    flat = [mlp.flatten(params), mlp.flatten(opt.m), mlp.flatten(opt.v)]
    _build.require(x, "obs rows", (n_steps * mb, widths[0]), device=dev)
    for name, t in zip(("params", "adam m", "adam v"), flat):
        _build.require(t, name, flat[0].shape, device=dev)
    outs = [torch.empty_like(t) for t in flat]
    dims = (ctypes.c_int * len(widths))(*widths)
    p = _build.ptr
    args = _PhaseArgs(
        x=p(x), p_in=p(flat[0]), m_in=p(flat[1]), v_in=p(flat[2]),
        p_out=p(outs[0]), m_out=p(outs[1]), v_out=p(outs[2]), dims=dims,
        n_layers=len(widths) - 1, activation=_build.ACTIVATIONS[activation],
        n_steps=n_steps, mb=mb, t0=opt.t, hyper=hyper)
    new_opt = AdamState(mlp.unflatten(outs[1], widths),
                        mlp.unflatten(outs[2], widths), opt.t + n_steps)
    return args, mlp.unflatten(outs[0], widths), new_opt, (flat, dims)


def value_phase_kernel(obs_seq, tgt_seq, params, opt: AdamState,
                       n_steps: int, mb: int, activation: str, hyper: Hyper):
    """Launch K3; same arguments and results as value_phase_plain."""
    dev = obs_seq.device
    tgt_seq = tgt_seq.reshape(-1).contiguous()
    _build.require(tgt_seq, "targets", (n_steps * mb,), device=dev)
    args, new_params, new_opt, keep = _common_args(
        obs_seq, params, opt, n_steps, mb, activation, hyper)
    stats = torch.empty(1, dtype=torch.float32, device=dev)
    args.tgt, args.stats = tgt_seq.data_ptr(), stats.data_ptr()
    args.two_over_mb = 2.0 / mb
    _launch("value", args, dev, keep)
    value_launches.n += 1
    return new_params, new_opt, stats[0] / (n_steps * mb)


def policy_phase_kernel(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
                        opt_policy: AdamState, opt_log_std: AdamState,
                        n_steps: int, mb: int, activation: str, hyper: Hyper,
                        clip_eps: float, ent_coeff: float):
    """Launch K4; same arguments and results as policy_phase_plain."""
    dev = obs_seq.device
    k = log_std.shape[0]
    rows = n_steps * mb
    lp_seq = lp_seq.reshape(-1).contiguous()
    adv_seq = adv_seq.reshape(-1).contiguous()
    _build.require(act_seq, "action rows", (rows, k), device=dev)
    _build.require(lp_seq, "log-prob rows", (rows,), device=dev)
    _build.require(adv_seq, "advantage rows", (rows,), device=dev)
    ls_in = (log_std, opt_log_std.m, opt_log_std.v)
    for name, t in zip(("log_std", "log_std m", "log_std v"), ls_in):
        _build.require(t, name, (k,), device=dev)
    if mlp.dims(params)[-1] != k or not 1 <= k <= 8:
        raise ValueError(f"policy head width {mlp.dims(params)[-1]} must equal "
                         f"the action dim {k} (1-8)")
    args, new_params, new_opt, keep = _common_args(
        obs_seq, params, opt_policy, n_steps, mb, activation, hyper)
    ls_out = [torch.empty_like(t) for t in ls_in]
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    p = _build.ptr
    args.act, args.lp_old, args.adv = p(act_seq), p(lp_seq), p(adv_seq)
    args.ls_in, args.mls_in, args.vls_in = (p(t) for t in ls_in)
    args.ls_out, args.mls_out, args.vls_out = (p(t) for t in ls_out)
    args.stats = p(stats)
    args.t0_ls, args.k_act = opt_log_std.t, k
    args.lp0 = -0.5 * k * _LOG_2PI
    args.ent0 = 0.5 * k * (1.0 + _LOG_2PI)
    args.clip_lo, args.clip_hi = 1.0 - clip_eps, 1.0 + clip_eps
    args.ent_coeff = ent_coeff
    _launch("policy", args, dev, keep)
    policy_launches.n += 1
    return (new_params, ls_out[0], new_opt,
            AdamState(ls_out[1], ls_out[2], opt_log_std.t + n_steps),
            stats[0] / n_steps, stats[1] / n_steps)


def value_phase(obs_seq, tgt_seq, params, opt: AdamState, n_steps: int,
                mb: int, activation: str, hyper: Hyper):
    """The whole value phase on pre-gathered rows: kernel on CUDA, plain
    version on the CPU."""
    run = value_phase_kernel if obs_seq.is_cuda else value_phase_plain
    return run(obs_seq, tgt_seq, params, opt, n_steps, mb, activation, hyper)


def policy_phase(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
                 opt_policy: AdamState, opt_log_std: AdamState, n_steps: int,
                 mb: int, activation: str, hyper: Hyper, clip_eps: float,
                 ent_coeff: float):
    """The whole Gaussian policy phase on pre-gathered rows: kernel on CUDA,
    plain version on the CPU."""
    run = policy_phase_kernel if obs_seq.is_cuda else policy_phase_plain
    return run(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
               opt_policy, opt_log_std, n_steps, mb, activation, hyper,
               clip_eps, ent_coeff)

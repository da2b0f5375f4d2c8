"""K3, K4 and K6: whole update phases and their plain versions.

Counterparts of ``ppoc_tpu/ops/pallas_update.py`` ``value_phase_fused``
(K3), ``policy_phase_fused`` (K4, Gaussian) and
``policy_phase_fused_categorical`` (K6, categorical).  The caller gathers
the rows of every epoch x minibatch step in order beforehand (as the JAX
wrappers do); one launch then runs every step: forward, the loss gradient
in closed form, backward and Adam.

Each kernel has two variants (``_build.VARIANTS``), for the nets that fit
one block's shared memory and for larger ones (2x256: the [10,256,256,1]
value net is 277.5 KB padded against the H100's 227 KB), and the three
phases are three kinds of the same two thread-block cluster kernels,
which differ only in the loss head.  With the nets in shared memory
(``csrc/update_cluster.cu``) each block of the cluster holds a replica of
the weights and its own rows of every minibatch (CLUSTER blocks whatever
the minibatch size; :func:`phase_cluster_plan` gives the whole launch),
and the blocks sum their weight gradients and the loss head's row sums
over distributed shared memory in rank order.  Past that
(``csrc/update_shard.cuh``, the "global" slot) the weights are sharded
over SHARDS blocks (:func:`shard_layout`): layer 0 replicated, the next
layer split by output column, the head by input row, the head's partial
outputs summed over the cluster, every block walking every row (so K6's
softmax and its sums are the same bits in every block);
:func:`phase_shard_plan` gives the launch.  The launch takes the first
variant whose shared memory fits (:func:`variant_bytes` gives the same
bytes from the widths alone); ``variant=`` forces one, and ``cluster=``
the block count, for tests and measurements.  The two variants sum in
different orders, so they agree to rounding, not bit for bit.  The
launch counts are kept per kind and variant.

Adam here is the kernels' own: bias corrections 1 - exp(t log b) folded
into the step size, eps outside the sqrt; K4 runs a second Adam for
log_std with its own timestep, K6 has no log_std.  K6 reads the actions as
int32 class ids, the buffer's own type, so nothing converts them.  A CUDA
tensor launches the kernel, a CPU tensor runs the plain version beside it,
which spells out the same forward, backward and update in PyTorch.

K3 bf16 and K4 bf16 (``csrc/update_bf16.cu``) are the ports of the same
two Pallas kernels called with ``bf16=True``, the large-minibatch
(throughput) regime: every product on bf16 operands with float32
accumulation, float32 master weights, moments and gradient sums, row tiles
of up to ``MAX_TILE_BF16``.  Their steps are far too large for one block
(the reacher regime's value phase is ~2.5 TFLOP), so each is one
cooperative launch over every SM with a grid-wide barrier between the
gradient and the Adam half of each step; their hidden layers' products
are Hopper's warpgroup products (``wgmma``) with W staged by bulk copies
(:func:`wgmma_product` runs one on its own).  As in the JAX package no trainer
path selects them: ``algo/ppo.value_phase_fused`` / ``policy_phase_fused``
call them directly.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import _build
from ppoc_tpu_torch.ops.cuda_mlp import (act, act_grad, backward_layers,
                                        forward_layers)
from ppoc_tpu_torch.ops.adam import AdamState

value_launches = _build.LaunchCount("value_phase")
policy_launches = _build.LaunchCount("policy_phase")
categorical_launches = _build.LaunchCount("policy_phase_categorical")
value_global_launches = _build.LaunchCount("value_phase_global")
policy_global_launches = _build.LaunchCount("policy_phase_global")
categorical_global_launches = _build.LaunchCount(
    "policy_phase_categorical_global")

value_bf16_launches = _build.LaunchCount("value_phase_bf16")
policy_bf16_launches = _build.LaunchCount("policy_phase_bf16")

_STATIC_SMEM = 1024  # the kernels' static shared memory, rounded up

# csrc/update_cluster.cu: blocks in the phases' cluster (the most a forced
# size may take), rows of a sub-tile, a row's extras and stats (row
# stride), the largest action dim or class count
CLUSTER, CLUSTER_MAX = 16, 16
CLUSTER_SUB = 32
_ES, _RSS, _NS, _MAX_ACT = 12, 12, 9, 8
# csrc/update_shard.cuh: blocks in the sharded cluster and threads a block,
# the sub-tile rows it tries (largest first; with the weights in shared
# memory down to the third), and the dynamic shared memory a block may take
SHARDS, SHARD_THREADS = 16, 512
SHARD_SUBS = (64, 32, 16, 8, 4, 2, 1)
_SHARD_BUDGET = 232448 - 1024

_LOG_2PI = math.log(2.0 * math.pi)

# The JAX package's row tiles (ppoc_tpu/ops/pallas_update.py:59-73): the f32
# kernels' and the bf16 throughput kernels' (half-size activations, so
# twice the rows).  The port's own copies.
_MAX_TILE = 2048
MAX_TILE_BF16 = 4096
# K3 bf16 / K4 bf16 take 1-8 layers (csrc/common.cuh MAX_LAYERS), each at
# most this wide (csrc/update_bf16.cu MAX_WIDTH)
MAX_WIDTH_BF16 = 512


def bigmb_ok(mb: int) -> bool:
    """Can the bf16 throughput kernels tile this minibatch?  Past the f32
    kernels' tile and with a row tile of >= 1024 aligned rows
    (``pallas_update.bigmb_ok``; no caller routes by it, as there)."""
    return mb > _MAX_TILE and any(mb % t == 0 for t in (4096, 2048, 1024))


def bf16_tile(mb: int) -> int:
    """The bf16 kernels' row tile: ``mb`` if it is at most MAX_TILE_BF16,
    else the largest divisor of ``mb`` that is (``_phase_layout`` with
    ``allow_unroll=False``)."""
    if mb <= MAX_TILE_BF16:
        return mb
    return max(d for d in range(1, MAX_TILE_BF16 + 1) if mb % d == 0)


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


def policy_phase_categorical_plain(obs_seq, act_seq, lp_seq, adv_seq, params,
                                   opt_policy: AdamState, n_steps: int,
                                   mb: int, activation: str, hyper: Hyper,
                                   clip_eps: float, ent_coeff: float):
    """Plain PyTorch version of K6 (``_policy_kernel_cat``): per step the
    logits, their log-softmax, the one-hot log-prob of the int32 class ids
    ``act_seq`` [rows, 1], the clipped surrogate with gradient only through
    the unclipped branch, the entropy bonus, the closed-form logit gradient
    dlogp (onehot - p) + (ent_coeff / mb) p (log p + H), backward and one
    Adam.  Returns (params', opt_policy', mean loss, mean entropy)."""
    P, M, V = _unpack(params, opt_policy)
    lp_seq, adv_seq = lp_seq.reshape(-1), adv_seq.reshape(-1)
    loss = torch.zeros((), dtype=P[0].dtype, device=obs_seq.device)
    ent_sum = torch.zeros_like(loss)
    classes = torch.arange(P[-1].shape[0], device=obs_seq.device)
    for s in range(n_steps):
        rows = slice(s * mb, (s + 1) * mb)
        x, adv = obs_seq[rows], adv_seq[rows]
        hs = forward_layers(x, P[0::2], P[1::2], activation)
        logits = hs[-1]
        zmax = logits.max(dim=1, keepdim=True).values
        lse = zmax + torch.log(torch.exp(logits - zmax).sum(dim=1,
                                                             keepdim=True))
        logp_all = logits - lse
        p = torch.exp(logp_all)
        onehot = (classes == act_seq[rows]).to(logits.dtype)
        logp = (onehot * logp_all).sum(dim=1)
        ratio = torch.exp(logp - lp_seq[rows])
        clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
        ra, ca = ratio * adv, clipped * adv
        H = -(p * logp_all).sum(dim=1)
        loss = loss + (-torch.minimum(ra, ca).sum() - ent_coeff * H.sum()) / mb
        ent_sum = ent_sum + H.sum() / mb
        dlogp = -(adv * ratio / mb) * (ra <= ca).to(logits.dtype)
        g = (dlogp[:, None] * (onehot - p)
             + (ent_coeff / mb) * p * (logp_all + H[:, None]))
        grads, _ = backward_layers(x, hs, g, P[0::2], activation)
        _adam_(P, grads, M, V, opt_policy.t + s + 1, hyper)
    return (_pack(P), AdamState(_pack(M), _pack(V), opt_policy.t + n_steps),
            loss / n_steps, ent_sum / n_steps)


# --- plain versions of K3 bf16 and K4 bf16 -----------------------------------

def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (to nearest even, as ``astype(bfloat16)``) and back."""
    return t.to(torch.bfloat16).float()


def _dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bf16-rounded operands with float32 products and sums: one
    bf16 tensor-core product with a float32 output on the card, float32
    products of the bf16 values on the CPU (a bf16 x bf16 product is exact
    in float32, so the two differ only in the order of the sums).  3-D
    operands multiply batch by batch."""
    if a.is_cuda:
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                  out_dtype=torch.float32)
    return _bf(a) @ _bf(b)


def _forward_bf16(x, W, B, activation: str) -> List[torch.Tensor]:
    """``pallas_update._fwd_refs(..., bf16=True)``: each layer's input and W
    rounded to bf16, float32 products plus the float32 bias; the hidden
    post-activations stored rounded to bf16, the last layer's output
    float32."""
    hs, h = [], x
    for l, (w, b) in enumerate(zip(W, B)):
        h = _dot_bf16(h, w) + b
        if l < len(W) - 1:
            h = _bf(act(h, activation))
        hs.append(h)
    return hs


def _tile_sum(parts: torch.Tensor, group: int) -> torch.Tensor:
    """The kernels' sum of per-tile partials parts[T, ...]: the tiles in
    groups of ``group`` in order, each group summed from zero, then the
    groups in order (``group`` 1: every tile added in turn)."""
    n_groups = -(-parts.shape[0] // group)
    pad = n_groups * group - parts.shape[0]   # zero tiles add nothing
    if pad:
        parts = torch.cat([parts, parts.new_zeros((pad,) + parts.shape[1:])])
    parts = parts.reshape(n_groups, group, *parts.shape[1:])
    part = torch.zeros_like(parts[:, 0])
    for t in range(group):
        part = part + parts[:, t]
    total = torch.zeros_like(part[0])
    for j in range(n_groups):
        total = total + part[j]
    return total


def _backward_bf16(x, hs, g, W, activation: str,
                   round_cotangent: bool = True, tiles: int = 1,
                   group: int = 1) -> List[torch.Tensor]:
    """The bf16 kernels' backward from the float32 output cotangent ``g``:
    per layer dW from the bf16-rounded input and cotangent, db summed from
    the float32 cotangent, and the next cotangent from the bf16-rounded
    cotangent and W times the activation derivative of the bf16-stored
    post-activation.  Over ``tiles`` equal row tiles dW and db are each
    tile's sum, summed as :func:`_tile_sum` sums them.
    ``round_cotangent=False`` keeps the cotangent float32 in both products
    (a control, not the kernel's arithmetic).  Returns flat [dW0, db0,
    dW1, ...]."""
    grads = [None] * (2 * len(W))
    for l in range(len(W) - 1, -1, -1):
        a_in = x if l == 0 else hs[l - 1]
        if tiles > 1:
            a_t = a_in.reshape(tiles, -1, a_in.shape[1]).transpose(1, 2)
            g_t = g.reshape(tiles, -1, g.shape[1])
        else:
            a_t, g_t = a_in.T, g
        dw = _dot_bf16(a_t, g_t) if round_cotangent else _bf(a_t) @ g_t
        db = g_t.sum(dim=-2)
        grads[2 * l] = _tile_sum(dw, group) if tiles > 1 else dw
        grads[2 * l + 1] = _tile_sum(db, group) if tiles > 1 else db
        if l > 0:
            gw = (_dot_bf16(g, W[l].T) if round_cotangent
                  else g @ _bf(W[l]).T)
            g = gw * act_grad(hs[l - 1], activation)
    return grads


def _tiles(mb: int, tile: Optional[int], group: int) -> int:
    if group < 1:
        raise ValueError(f"the partial sum's group {group} must be >= 1")
    if tile is None:
        return mb // bf16_tile(mb)
    if tile < 1 or mb % tile:
        raise ValueError(f"the row tile {tile} must divide the minibatch "
                         f"size {mb}")
    return mb // tile


def value_phase_bf16_plain(obs_seq, tgt_seq, params, opt: AdamState,
                           n_steps: int, mb: int, activation: str,
                           hyper: Hyper, tile: Optional[int] = None, *,
                           group: int = 1, round_cotangent: bool = True):
    """Plain PyTorch version of K3 bf16 (``_value_kernel(..., bf16=True)``):
    per step the bf16 forward, the MSE gradient 2/mb (v - target) and the
    bf16 backward over the minibatch, dW and db summed in float32 per row
    tile of ``tile`` rows (the JAX rule's, ``bf16_tile(mb)``, by default),
    the tiles in groups of ``group`` and then the groups (the kernel's
    order: ``phase_bf16_plan``'s rows and group); then one Adam.
    ``round_cotangent=False`` is the control of ``_backward_bf16``.
    Returns (params', opt', mean loss)."""
    n_sub = _tiles(mb, tile, group)
    P, M, V = _unpack(params, opt)
    tgt_seq = tgt_seq.reshape(-1)
    loss = torch.zeros((), dtype=torch.float32, device=obs_seq.device)
    for s in range(n_steps):
        rows = slice(s * mb, (s + 1) * mb)
        x = obs_seq[rows]
        hs = _forward_bf16(x, P[0::2], P[1::2], activation)
        diff = hs[-1][:, 0] - tgt_seq[rows]
        loss = loss + (diff * diff).sum()
        g = (2.0 / mb) * diff[:, None]
        grads = _backward_bf16(x, hs, g, P[0::2], activation, round_cotangent,
                               n_sub, group)
        _adam_(P, grads, M, V, opt.t + s + 1, hyper)
    return (_pack(P), AdamState(_pack(M), _pack(V), opt.t + n_steps),
            loss / (n_steps * mb))


def policy_phase_bf16_plain(obs_seq, act_seq, lp_seq, adv_seq, params,
                            log_std, opt_policy: AdamState,
                            opt_log_std: AdamState, n_steps: int, mb: int,
                            activation: str, hyper: Hyper, clip_eps: float,
                            ent_coeff: float, tile: Optional[int] = None, *,
                            group: int = 1, round_cotangent: bool = True):
    """Plain PyTorch version of K4 bf16 (``_policy_kernel(...,
    bf16=True)``): per step the closed-form entropy once, then over the
    minibatch the bf16 mu forward, the clipped-surrogate gradient (float32,
    only the unclipped branch) and the bf16 backward, summed as
    value_phase_bf16_plain sums them; then the net's Adam and log_std's,
    each with its own timestep.  Returns (params', log_std', opt_policy',
    opt_log_std', mean loss, mean entropy)."""
    n_sub = _tiles(mb, tile, group)
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
        sum_ls = ls.sum()
        ent = ent0 + sum_ls
        ent_sum = ent_sum + ent
        loss = loss + (-ent_coeff) * ent
        inv_sigma = torch.exp(-ls)
        rows = slice(s * mb, (s + 1) * mb)
        x, adv = obs_seq[rows], adv_seq[rows]
        hs = _forward_bf16(x, P[0::2], P[1::2], activation)
        z = (act_seq[rows] - hs[-1]) * inv_sigma
        logp = lp0 - sum_ls - 0.5 * (z * z).sum(dim=1)
        ratio = torch.exp(logp - lp_seq[rows])
        clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
        ra, ca = ratio * adv, clipped * adv
        loss = loss + (-torch.minimum(ra, ca).sum()) / mb
        # only the unclipped branch carries gradient
        dlogp = -(adv * ratio / mb) * (ra <= ca).to(torch.float32)
        gls = (dlogp[:, None] * (z * z - 1.0)).sum(dim=0)
        g = dlogp[:, None] * z * inv_sigma
        grads = _backward_bf16(x, hs, g, P[0::2], activation, round_cotangent,
                               n_sub, group)
        _adam_(P, grads, M, V, opt_policy.t + s + 1, hyper)
        _adam_([ls], [gls - ent_coeff], [mls], [vls], opt_log_std.t + s + 1,
               hyper)
    return (_pack(P), ls,
            AdamState(_pack(M), _pack(V), opt_policy.t + n_steps),
            AdamState(mls, vls, opt_log_std.t + n_steps),
            loss / n_steps, ent_sum / n_steps)


# --- the kernels ----------------------------------------------------------

def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def cluster_bytes(widths: Sequence[int]) -> int:
    """Dynamic shared memory of one block of the phases' cluster kernel (K3,
    K4 or K6) on the net ``widths`` in a cluster of CLUSTER blocks
    (csrc/update_cluster.cu ``smem_floats``), in bytes: the weights and the
    gradient partial, each W_l with r4(d_l) rows of 4 * odd floats and
    each b_l r4(d_{l+1}); the activations of a 32-row sub-tile (+8); two
    sub-tiles of rows and their extras; the row stats, the block's stats
    and log_std's state; m and v of the block's Adam slice (a 1/CLUSTER
    share of the padded layout, in float4s; a smaller forced cluster takes
    more).  The minibatch size does not enter."""
    hs = [_r4(d) for d in widths]
    padded = sum(hs[l] * 4 * (((widths[l + 1] + 3) // 4) | 1) + hs[l + 1]
                 for l in range(len(widths) - 1))
    sub = CLUSTER_SUB
    floats = (2 * padded + sub * sum(hs[1:]) + 8 + 2 * sub * hs[0]
              + 2 * sub * _ES + sub * _RSS + _r4(_NS) + 4 * _MAX_ACT
              + 8 * -(-(padded // 4) // CLUSTER))
    return 4 * floats


def _w_ld(n: int) -> int:
    """csrc/cluster.cuh w_ld: 4 floats times an odd number, at least n."""
    return 4 * (((n + 3) // 4) | 1)


class ShardLayout(NamedTuple):
    kinds: List[str]   # each layer's: "REP", "COL" or "ROW"
    sub: int           # rows of a sub-tile
    spill: bool        # COL and ROW weights in a global scratch
    moments: bool      # the block's own Adam moments in shared memory
    nbytes: int        # a block's dynamic shared memory


def shard_layout(widths: Sequence[int],
                 cluster: Optional[int] = None) -> ShardLayout:
    """How the phases' sharded cluster kernel (csrc/update_shard.cuh
    ``shard_layout``) lays out the net ``widths`` over ``cluster`` blocks
    (None: SHARDS).  The kinds, set from the head down: the head "ROW" (a
    block holds its share of W's rows), the layer below "COL" (its share
    of the columns), alternating, with layer 0 "REP" (replicated) where it
    would be a ROW below a COL.  A shard is ceil(width / cluster) units
    rounded up to 4.  A block holds its W_l (r4 or shard rows x 4 * odd
    floats, zero past its units) and b_l, and their gradient; the output
    tile of every layer (sub rows x 4 * odd); two exchange tiles (sub x
    the widest ROW's stride) and a zero bias of that stride; two sub-tiles
    of x and of the row extras; the row stats; log_std's state; m and v of
    the ROW biases; where they fit, m and v of the block's own elements
    (its shards, and its quarter-float4-aligned 1/cluster slice of a REP
    layer) in shared memory, else in the output moments.  The sub-tile is
    the largest of SHARD_SUBS down to 16 whose block fits 227 KB (with the
    own moments if they fit at that sub-tile); else, with every COL and
    ROW weight and its gradient spilled to global memory, the largest that
    fits; else the spilled 1-row block (which the launch refuses).  The
    minibatch size does not enter."""
    c = cluster or SHARDS
    n = len(widths) - 1
    kinds = ["ROW"] * n
    for l in range(n - 2, -1, -1):
        kinds[l] = "COL" if kinds[l + 1] == "ROW" else "ROW"
    if n >= 2 and kinds[0] == "ROW":
        kinds[0] = "REP"

    def shard(width):
        return _r4(-(-width // c))

    params, spilled, strides, bias_moments, own, xw = 0, 0, 0, 0, 0, 4
    for kind, din, dout in zip(kinds, widths[:-1], widths[1:]):
        rows = shard(din) if kind == "ROW" else _r4(din)
        cols = shard(dout) if kind == "COL" else dout
        floats = rows * _w_ld(cols) + _r4(cols)
        params += floats
        spilled += floats if kind != "REP" else 0
        strides += _w_ld(cols)
        own += {"REP": 4 * -(-(floats // 4) // c),
                "COL": (rows + 1) * cols, "ROW": rows * dout}[kind]
        if kind == "ROW":
            bias_moments += _r4(dout)
            xw = max(xw, _w_ld(cols))
    for spill in (False, True):
        for sub in SHARD_SUBS[:None if spill else SHARD_SUBS.index(16) + 1]:
            for moments in (True, False)[spill:]:
                floats = (2 * (params - spill * spilled) + sub * strides + 8
                          + 2 * sub * xw + xw + 2 * sub * _w_ld(widths[0])
                          + 2 * sub * _ES + sub * _RSS + 4 * _MAX_ACT
                          + 2 * bias_moments + moments * 2 * _r4(own))
                if 4 * floats <= _SHARD_BUDGET:
                    return ShardLayout(kinds, sub, spill, moments,
                                       4 * floats)
    return ShardLayout(kinds, sub, spill, moments, 4 * floats)


def shard_bytes(widths: Sequence[int]) -> int:
    """Dynamic shared memory of one block of the phases' sharded cluster
    kernel (K3, K4 or K6) on the net ``widths`` (:func:`shard_layout`,
    SHARDS blocks), in bytes; the same as csrc/update_shard.cuh
    ``ppoc_phase_shard_smem``."""
    return shard_layout(widths).nbytes


def variant_bytes(widths: Sequence[int]) -> List[int]:
    """Shared memory one launch of K3, K4 or K6 on the net ``widths``
    needs in each variant (``_build.VARIANTS``), in bytes, with the
    kernels' static share: the replicated cluster's block
    (:func:`cluster_bytes`), then the sharded cluster's
    (:func:`shard_bytes`).  The three kinds share both maps (a row's
    extras hold K4's actions or K6's class id, its stats K4's log_std
    terms or K6's entropy).  The same as the kernels' size functions (a
    card test holds them together); the minibatch size does not enter."""
    return [n + _STATIC_SMEM for n in (cluster_bytes(widths),
                                      shard_bytes(widths))]


class _PhaseArgs(ctypes.Structure):
    """Mirror of `struct PhaseArgs` in csrc/phase_args.cuh."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "x", "tgt", "act", "lp_old", "adv", "p_in", "m_in", "v_in",
            "p_out", "m_out", "v_out", "ls_in", "mls_in", "vls_in", "ls_out",
            "mls_out", "vls_out", "scratch", "stats", "act_idx")]
        + [("dims", ctypes.POINTER(ctypes.c_int))]
        + [(n, ctypes.c_int) for n in (
            "n_layers", "activation", "n_steps", "mb", "t0", "t0_ls",
            "k_act", "cluster")]
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
                               "csrc/phase_args.cuh and cuda_update.py")
        args = [ctypes.POINTER(_PhaseArgs)]
        lib.ppoc_phase_cluster_smem.argtypes = args
        lib.ppoc_phase_cluster_smem.restype = ctypes.c_long
        for fn in (lib.ppoc_phase_cluster_plan, lib.ppoc_phase_shard_plan):
            fn.argtypes = args + [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_long)]
            fn.restype = ctypes.c_int
        lib.ppoc_phase_shard_smem.argtypes = args
        lib.ppoc_phase_shard_smem.restype = ctypes.c_long
        for names, _, _ in _KINDS.values():
            for name in names:
                fn = getattr(lib, name)
                fn.argtypes = args + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib._phase_declared = True
    return lib


# per kind: (the launchers by variant, the shared-memory variant's launch
# count, the other's)
_KINDS = {"value": (("ppoc_value_phase_cluster", "ppoc_value_phase_shard"),
                    value_launches, value_global_launches),
          "policy": (("ppoc_policy_phase_cluster", "ppoc_policy_phase_shard"),
                     policy_launches, policy_global_launches),
          "categorical policy": (("ppoc_policy_phase_categorical_cluster",
                                  "ppoc_policy_phase_categorical_shard"),
                                 categorical_launches,
                                 categorical_global_launches)}
# the plans' kind (csrc/cluster.cuh Kind)
_CLUSTER = {"value": 0, "policy": 1, "categorical policy": 2}
# the plans of the two cluster kernels (by variant): the replicated cluster
# gives rows a block, the sharded one rows a sub-tile (every block walks
# every row)
_PLAN_OF = ("ppoc_phase_cluster_plan", "ppoc_phase_shard_plan")
_CLUSTER_KEYS = (("cluster", "rows", "sub_tiles", "threads", "smem",
                  "max_active_clusters"),
                 ("cluster", "sub_rows", "sub_tiles", "threads", "smem",
                  "max_active_clusters", "scratch"))
_CLUSTER_NAMES = ("cluster", "sharded cluster")


def _cluster_plan(lib, args: _PhaseArgs, kind: str, widths,
                  variant: int) -> dict:
    """The cluster launch of ``args`` in ``variant`` (see
    :func:`phase_cluster_plan`, :func:`phase_shard_plan`); raises if the
    card cannot hold one such cluster."""
    keys = _CLUSTER_KEYS[variant]
    out = (ctypes.c_long * len(keys))()
    what = (f"{kind} phase {_CLUSTER_NAMES[variant]} kernel for the net "
            f"{list(widths)}, mb {args.mb}, cluster "
            f"{args.cluster or (CLUSTER, SHARDS)[variant]}")
    _build.check(lib, getattr(lib, _PLAN_OF[variant])(
        ctypes.byref(args), _CLUSTER[kind], out), what)
    plan = dict(zip(keys, out))
    if plan["max_active_clusters"] < 1:
        raise ValueError(f"{what}: a cluster of {plan['cluster']} blocks of "
                         f"{plan['smem']} B shared memory cannot be "
                         f"scheduled on this card "
                         f"(cudaOccupancyMaxActiveClusters 0)")
    return plan


def phase_cluster_plan(kind: str, widths: Sequence[int], mb: int,
                       cluster: Optional[int] = None, device=None) -> dict:
    """How K3 (``kind`` "value"), K4 ("policy") or K6 ("categorical
    policy") launches with the weights in shared memory, on the net
    ``widths`` and minibatch ``mb``: blocks in
    the cluster (``cluster``, or CLUSTER), rows a block,
    32-row sub-tiles a block, threads a block, dynamic shared-memory bytes
    and how many such clusters the card holds at once.  Raises if the card
    holds none."""
    return _plan(kind, widths, mb, cluster, device, 0)


def phase_shard_plan(kind: str, widths: Sequence[int], mb: int,
                     cluster: Optional[int] = None, device=None) -> dict:
    """How K3 (``kind`` "value"), K4 ("policy") or K6 ("categorical
    policy") launches with the weights sharded over the cluster (the
    "global" slot), on the net ``widths``
    and minibatch ``mb``: blocks in the cluster (``cluster``, or SHARDS),
    rows of a sub-tile, sub-tiles a minibatch (each block walks every
    row), threads a block, dynamic shared-memory bytes, how many such
    clusters the card holds at once and the floats of global scratch the
    launch allocates (0 unless the weights spill: :func:`shard_layout`).
    Raises if the card holds none."""
    return _plan(kind, widths, mb, cluster, device, 1)


def _plan(kind, widths, mb, cluster, device, variant: int) -> dict:
    if kind not in _KINDS:
        raise ValueError(f"no {kind!r} phase: the kinds are {list(_KINDS)}")
    lib = _declare()
    dims = (ctypes.c_int * len(widths))(*widths)
    args = _PhaseArgs(dims=dims, n_layers=len(widths) - 1, mb=mb,
                      cluster=cluster or 0)
    with torch.cuda.device(device if device is not None else 0):
        return _cluster_plan(lib, args, kind, widths, variant)


def _launch(kind: str, args: _PhaseArgs, widths, dev, keep,
            variant: Optional[str], cluster: Optional[int] = None) -> None:
    """Pick the variant by shared memory (or take ``variant``), launch as a
    cluster of ``cluster`` blocks (None: CLUSTER or SHARDS; a size without
    ``variant`` forces the shared-memory one), count.  ``keep`` holds the
    tensors and host arrays the launch reads until it is enqueued."""
    lib = _declare()
    if cluster is not None:
        if not 1 <= cluster <= CLUSTER_MAX:
            raise ValueError(f"cluster {cluster}: the cluster kernels take "
                             f"1-{CLUSTER_MAX} blocks")
        args.cluster, variant = cluster, variant or "smem"
    if args.mb < 1 or not 1 <= args.n_layers <= 8:
        raise ValueError("update kernels take 1-8 layers and mb >= 1")
    both = (lib.ppoc_phase_cluster_smem(ctypes.byref(args)),
            lib.ppoc_phase_shard_smem(ctypes.byref(args)))
    v = _build.pick_variant(
        [n + _STATIC_SMEM for n in both], _build.smem_optin(dev), variant,
        f"{kind} phase kernel for the net {list(widths)}")
    names, smem_count, global_count = _KINDS[kind]
    with torch.cuda.device(dev):
        plan = _cluster_plan(lib, args, kind, widths, v)
        if plan.get("scratch"):
            scratch = torch.empty(plan["scratch"], dtype=torch.float32,
                                  device=dev)
            args.scratch = scratch.data_ptr()
        _build.check(lib, getattr(lib, names[v])(
            ctypes.byref(args), _build.stream_of(dev)),
            f"{kind} phase {_CLUSTER_NAMES[v]} kernel "
            f"({plan['cluster']} blocks)")
    (global_count if v else smem_count).n += 1
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
    return args, widths, mlp.unflatten(outs[0], widths), new_opt, (flat, dims)


def value_phase_kernel(obs_seq, tgt_seq, params, opt: AdamState,
                       n_steps: int, mb: int, activation: str, hyper: Hyper,
                       variant: Optional[str] = None,
                       cluster: Optional[int] = None):
    """Launch K3; same arguments and results as value_phase_plain.  The
    variant is the first whose shared memory fits, unless ``variant``
    (``"smem"``: the replicated cluster, or ``"global"``: the sharded one)
    names one; ``cluster`` sets the block count of the variant's cluster
    (default CLUSTER or SHARDS; alone, it forces ``"smem"``)."""
    dev = obs_seq.device
    tgt_seq = tgt_seq.reshape(-1).contiguous()
    _build.require(tgt_seq, "targets", (n_steps * mb,), device=dev)
    args, widths, new_params, new_opt, keep = _common_args(
        obs_seq, params, opt, n_steps, mb, activation, hyper)
    stats = torch.empty(1, dtype=torch.float32, device=dev)
    args.tgt, args.stats = tgt_seq.data_ptr(), stats.data_ptr()
    args.two_over_mb = 2.0 / mb
    _launch("value", args, widths, dev, keep, variant, cluster)
    return new_params, new_opt, stats[0] / (n_steps * mb)


def policy_phase_kernel(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
                        opt_policy: AdamState, opt_log_std: AdamState,
                        n_steps: int, mb: int, activation: str, hyper: Hyper,
                        clip_eps: float, ent_coeff: float,
                        variant: Optional[str] = None,
                        cluster: Optional[int] = None):
    """Launch K4; same arguments and results as policy_phase_plain
    (``variant``, ``cluster``: see :func:`value_phase_kernel`)."""
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
    args, widths, new_params, new_opt, keep = _common_args(
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
    _launch("policy", args, widths, dev, keep, variant, cluster)
    return (new_params, ls_out[0], new_opt,
            AdamState(ls_out[1], ls_out[2], opt_log_std.t + n_steps),
            stats[0] / n_steps, stats[1] / n_steps)


def policy_phase_categorical_kernel(obs_seq, act_seq, lp_seq, adv_seq, params,
                                    opt_policy: AdamState, n_steps: int,
                                    mb: int, activation: str, hyper: Hyper,
                                    clip_eps: float, ent_coeff: float,
                                    variant: Optional[str] = None,
                                    cluster: Optional[int] = None):
    """Launch K6; same arguments and results as
    policy_phase_categorical_plain (``variant``, ``cluster``: see
    :func:`value_phase_kernel`).  The kernel reads the int32 class ids as
    they are."""
    dev = obs_seq.device
    k = mlp.dims(params)[-1]
    rows = n_steps * mb
    lp_seq = lp_seq.reshape(-1).contiguous()
    adv_seq = adv_seq.reshape(-1).contiguous()
    _build.require(act_seq, "class ids", (rows, 1), dtype=torch.int32,
                   device=dev)
    _build.require(lp_seq, "log-prob rows", (rows,), device=dev)
    _build.require(adv_seq, "advantage rows", (rows,), device=dev)
    if not 1 <= k <= 8:
        raise ValueError(f"the categorical policy phase takes 1-8 classes, "
                         f"got a head of width {k}")
    args, widths, new_params, new_opt, keep = _common_args(
        obs_seq, params, opt_policy, n_steps, mb, activation, hyper)
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    p = _build.ptr
    args.act_idx, args.lp_old, args.adv = p(act_seq), p(lp_seq), p(adv_seq)
    args.stats, args.k_act = p(stats), k
    args.clip_lo, args.clip_hi = 1.0 - clip_eps, 1.0 + clip_eps
    args.ent_coeff = ent_coeff
    _launch("categorical policy", args, widths, dev, keep, variant, cluster)
    return new_params, new_opt, stats[0] / n_steps, stats[1] / n_steps


class _Bf16PhaseArgs(ctypes.Structure):
    """Mirror of `struct Bf16PhaseArgs` in csrc/update_bf16.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "x", "tgt", "act", "lp_old", "adv", "p_in", "m_in", "v_in",
            "p_out", "m_out", "v_out", "ls_in", "mls_in", "vls_in", "ls_out",
            "mls_out", "vls_out", "scratch", "stats")]
        + [("dims", ctypes.POINTER(ctypes.c_int)),
           ("scratch_bytes", ctypes.c_long)]
        + [(n, ctypes.c_int) for n in (
            "n_layers", "activation", "n_steps", "mb", "t0", "t0_ls",
            "k_act", "cluster")]
        + [(n, ctypes.c_float) for n in (
            "two_over_mb", "lp0", "ent0", "clip_lo", "clip_hi", "ent_coeff")]
        + [("hyper", Hyper)]
    )


_BF16_KINDS = {"value": (0, "ppoc_value_phase_bf16", value_bf16_launches),
               "policy": (1, "ppoc_policy_phase_bf16", policy_bf16_launches)}
_PLAN_KEYS = ("rows", "grid", "threads", "smem", "scratch_bytes",
              "blocks_per_sm", "sms", "rounds", "group", "stages",
              "stage_bytes", "cluster")


def _declare_bf16() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_phase_bf16_declared", False):
        lib.ppoc_phase_bf16_args_size.restype = ctypes.c_int
        if lib.ppoc_phase_bf16_args_size() != ctypes.sizeof(_Bf16PhaseArgs):
            raise RuntimeError("Bf16PhaseArgs layout differs between "
                               "csrc/update_bf16.cu and cuda_update.py")
        args = [ctypes.POINTER(_Bf16PhaseArgs)]
        lib.ppoc_phase_bf16_plan.argtypes = args + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
        lib.ppoc_phase_bf16_plan.restype = ctypes.c_int
        for fn in (lib.ppoc_value_phase_bf16, lib.ppoc_policy_phase_bf16):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ppoc_wgmma_test.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ppoc_wgmma_test.restype = ctypes.c_int
        lib._phase_bf16_declared = True
    return lib


def _check_widths_bf16(widths: Sequence[int]) -> None:
    """Raise ValueError unless K3 bf16 / K4 bf16 take the net ``widths``:
    1-8 layers, each at most MAX_WIDTH_BF16 wide."""
    n = len(widths) - 1
    if not 1 <= n <= 8:
        raise ValueError(f"K3 bf16 / K4 bf16 take 1-8 layers, got {n} "
                         f"({list(widths)})")
    if max(widths) > MAX_WIDTH_BF16:
        raise ValueError(f"K3 bf16 / K4 bf16 take layers at most "
                         f"{MAX_WIDTH_BF16} wide, got {list(widths)}")


def _bf16_plan(lib, args: _Bf16PhaseArgs, kind: str, widths):
    out = (ctypes.c_long * len(_PLAN_KEYS))()
    _build.check(lib, lib.ppoc_phase_bf16_plan(
        ctypes.byref(args), _BF16_KINDS[kind][0], out),
        f"{kind} phase bf16 plan for the net {list(widths)}")
    return dict(zip(_PLAN_KEYS, out))


def phase_bf16_plan(kind: str, widths: Sequence[int], mb: int,
                    device=None, cluster: Optional[int] = None) -> dict:
    """How K3 bf16 (``kind`` "value") or K4 bf16 ("policy") launches on the
    card for the net ``widths`` and minibatch ``mb``: rows per block, the
    cooperative grid, threads, dynamic shared memory and scratch bytes,
    blocks per SM and the card's SMs, row tiles a block takes, the group
    of the partial sum (the plain versions' ``group``), the W ring's stages
    and a stage's bytes, and the thread-block cluster's blocks, among which
    each W stage is multicast (csrc/update_bf16.cu ``make_plan``, the one
    place the rule is written); ``route`` names the products.
    ``cluster`` forces a cluster size (1, 2, 4, 8 or 16; the grid then as
    the rule sizes it for that one)."""
    _check_widths_bf16(widths)
    dims = (ctypes.c_int * len(widths))(*widths)
    args = _Bf16PhaseArgs(dims=dims, n_layers=len(widths) - 1, mb=mb,
                          cluster=cluster or 0)
    with torch.cuda.device(device if device is not None else 0):
        plan = _bf16_plan(_declare_bf16(), args, kind, widths)
    return dict(plan, route="wgmma")


# ppoc_wgmma_test's modes: the hidden layers' products (the 128-byte
# swizzle) and the head's (W_L and g_L 16 columns wide, the 32-byte one)
WGMMA_MODES = {"forward": 0, "dx": 1, "dw": 2, "head_forward": 3,
               "head_dx": 4, "head_dw": 5}


def wgmma_product(mode: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One product of csrc/wgmma.cuh as K3 bf16 / K4 bf16 run it, on bf16
    roundings of float32 operands with float32 sums: "forward" a [64, K] @
    b [K, N] (K <= 64), "dx" a [64, K] @ b.T with b [64, K] (K <= 256),
    "dw" a.T @ b with a [K, 64], b [K, N] (K <= 128, a multiple of 16); N
    64, 128, 192 or 256.  The head's: "head_forward" a [64, K] @ b [K, 16]
    (K <= 64), "head_dx" a [64, 16] @ b.T with b [N, 16], "head_dw" a.T @
    b with a [K, 64], b [K, 16] (K as "dw").  On a CPU tensor the same
    products of the rounded operands in float32."""
    at = a.T if mode in ("dw", "head_dw") else a
    bt = b.T if mode in ("dx", "head_dx") else b
    if not a.is_cuda:
        return _bf(at) @ _bf(bt)
    lib = _declare_bf16()
    a, b = a.contiguous(), b.contiguous()
    for t, name in ((a, "A"), (b, "B")):
        _build.require(t, name, device=a.device)
    out = torch.empty(at.shape[0], bt.shape[1], dtype=torch.float32,
                      device=a.device)
    k = a.shape[0] if mode in ("dw", "head_dw") else a.shape[1]
    with torch.cuda.device(a.device):
        _build.check(lib, lib.ppoc_wgmma_test(
            WGMMA_MODES[mode], a.data_ptr(), b.data_ptr(), out.data_ptr(), k,
            out.shape[1], _build.stream_of(a.device)),
            f"wgmma {mode} product {tuple(a.shape)} x {tuple(b.shape)}")
    return out


def _bf16_args(x, params, opt: AdamState, n_steps: int, mb: int,
               activation: str, hyper: Hyper, cluster: Optional[int]):
    """Check what both kinds take and fill their shared fields."""
    widths = mlp.dims(params)
    _check_widths_bf16(widths)
    dev = x.device
    flat = [mlp.flatten(params), mlp.flatten(opt.m), mlp.flatten(opt.v)]
    _build.require(x, "obs rows", (n_steps * mb, widths[0]), device=dev)
    for name, t in zip(("params", "adam m", "adam v"), flat):
        _build.require(t, name, flat[0].shape, device=dev)
    outs = [torch.empty_like(t) for t in flat]
    stats = torch.zeros(2, dtype=torch.float32, device=dev)
    dims = (ctypes.c_int * len(widths))(*widths)
    p = _build.ptr
    args = _Bf16PhaseArgs(
        x=p(x), p_in=p(flat[0]), m_in=p(flat[1]), v_in=p(flat[2]),
        p_out=p(outs[0]), m_out=p(outs[1]), v_out=p(outs[2]),
        stats=p(stats), dims=dims, n_layers=len(widths) - 1,
        activation=_build.ACTIVATIONS[activation], n_steps=n_steps, mb=mb,
        t0=opt.t, cluster=cluster or 0, hyper=hyper)
    new_opt = AdamState(mlp.unflatten(outs[1], widths),
                        mlp.unflatten(outs[2], widths), opt.t + n_steps)
    return (args, widths, mlp.unflatten(outs[0], widths), new_opt, stats,
            (flat, dims))


def _launch_bf16(kind: str, args: _Bf16PhaseArgs, widths, dev, keep) -> None:
    """Plan, allocate the scratch, launch K3 bf16 or K4 bf16 once, count.
    ``keep`` holds the tensors and host arrays the launch reads until it
    is enqueued."""
    lib = _declare_bf16()
    _, name, counter = _BF16_KINDS[kind]
    with torch.cuda.device(dev):
        plan = _bf16_plan(lib, args, kind, widths)
        scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                              device=dev)
        args.scratch, args.scratch_bytes = scratch.data_ptr(), scratch.numel()
        _build.check(lib, getattr(lib, name)(ctypes.byref(args),
                                             _build.stream_of(dev)),
                     f"{kind} phase bf16 kernel ({plan['grid']} blocks)")
    counter.n += 1
    del keep


def value_phase_bf16_kernel(obs_seq, tgt_seq, params, opt: AdamState,
                            n_steps: int, mb: int, activation: str,
                            hyper: Hyper, cluster: Optional[int] = None):
    """Launch K3 bf16; the arguments and results of value_phase_bf16_plain
    but its row tile and group: the kernel sums its own row tiles'
    partials in its plan's order (``phase_bf16_plan``'s rows and group).
    ``cluster`` forces a cluster size (tests and measurements)."""
    args, widths, new_params, new_opt, stats, keep = _bf16_args(
        obs_seq, params, opt, n_steps, mb, activation, hyper, cluster)
    tgt_seq = tgt_seq.reshape(-1).contiguous()
    _build.require(tgt_seq, "targets", (n_steps * mb,), device=obs_seq.device)
    if widths[-1] != 1:
        raise ValueError("the value phase takes a net with one output")
    args.tgt, args.two_over_mb = tgt_seq.data_ptr(), 2.0 / mb
    _launch_bf16("value", args, widths, obs_seq.device, (keep, tgt_seq))
    return new_params, new_opt, stats[0] / (n_steps * mb)


def policy_phase_bf16_kernel(obs_seq, act_seq, lp_seq, adv_seq, params,
                             log_std, opt_policy: AdamState,
                             opt_log_std: AdamState, n_steps: int, mb: int,
                             activation: str, hyper: Hyper, clip_eps: float,
                             ent_coeff: float, cluster: Optional[int] = None):
    """Launch K4 bf16; the arguments and results of policy_phase_bf16_plain
    but its row tile and group (see value_phase_bf16_kernel)."""
    args, widths, new_params, new_opt, stats, keep = _bf16_args(
        obs_seq, params, opt_policy, n_steps, mb, activation, hyper,
        cluster)
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
    if widths[-1] != k or not 1 <= k <= 8:
        raise ValueError(f"policy head width {widths[-1]} must equal the "
                         f"action dim {k} (1-8)")
    ls_out = [torch.empty_like(t) for t in ls_in]
    p = _build.ptr
    args.act, args.lp_old, args.adv = p(act_seq), p(lp_seq), p(adv_seq)
    args.ls_in, args.mls_in, args.vls_in = (p(t) for t in ls_in)
    args.ls_out, args.mls_out, args.vls_out = (p(t) for t in ls_out)
    args.t0_ls, args.k_act = opt_log_std.t, k
    args.lp0 = -0.5 * k * _LOG_2PI
    args.ent0 = 0.5 * k * (1.0 + _LOG_2PI)
    args.clip_lo, args.clip_hi = 1.0 - clip_eps, 1.0 + clip_eps
    args.ent_coeff = ent_coeff
    _launch_bf16("policy", args, widths, dev, (keep, lp_seq, adv_seq))
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


def value_phase_bf16(obs_seq, tgt_seq, params, opt: AdamState, n_steps: int,
                     mb: int, activation: str, hyper: Hyper):
    """The whole bf16 value phase on pre-gathered rows: K3 bf16 on CUDA,
    its plain version (the JAX row tile) on the CPU."""
    run = (value_phase_bf16_kernel if obs_seq.is_cuda
           else value_phase_bf16_plain)
    return run(obs_seq, tgt_seq, params, opt, n_steps, mb, activation, hyper)


def policy_phase_bf16(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
                      opt_policy: AdamState, opt_log_std: AdamState,
                      n_steps: int, mb: int, activation: str, hyper: Hyper,
                      clip_eps: float, ent_coeff: float):
    """The whole bf16 Gaussian policy phase on pre-gathered rows: K4 bf16
    on CUDA, its plain version on the CPU."""
    run = (policy_phase_bf16_kernel if obs_seq.is_cuda
           else policy_phase_bf16_plain)
    return run(obs_seq, act_seq, lp_seq, adv_seq, params, log_std,
               opt_policy, opt_log_std, n_steps, mb, activation, hyper,
               clip_eps, ent_coeff)


def policy_phase_categorical(obs_seq, act_seq, lp_seq, adv_seq, params,
                             opt_policy: AdamState, n_steps: int, mb: int,
                             activation: str, hyper: Hyper, clip_eps: float,
                             ent_coeff: float):
    """The whole categorical policy phase on pre-gathered rows (class ids
    int32 [rows, 1]): K6 on CUDA, plain version on the CPU.  Returns
    (params', opt_policy', mean loss, mean entropy)."""
    run = (policy_phase_categorical_kernel if obs_seq.is_cuda
           else policy_phase_categorical_plain)
    return run(obs_seq, act_seq, lp_seq, adv_seq, params, opt_policy,
               n_steps, mb, activation, hyper, clip_eps, ent_coeff)

"""K7: causal episode-masked flash attention (``csrc/attn.cu``), forward
and backward, and its plain version.

Counterpart of ``ppoc_tpu/ops/pallas_attn.py``: query t attends key s iff
s <= t and both carry the same episode id (``models/attn.episode_ids``);
the forward returns the softmax output and the row logsumexp (lse), the
backward recomputes the weights from lse.  ``rel`` is the key block's time
relation of ring attention (-1 every key precedes every query, 0 one
window, +1 nothing valid), as in the Pallas kernels; only ``flash_mha``
(rel 0) is on the port's path so far.

Three kernels, each a C entry of the port's library: the forward
(out, lse), dq, and dk/dv.  ``dsum = rowsum(dout * out) - g_lse`` is
computed here in PyTorch between the forward and the two backward
launches, as ``pallas_attn._bwd`` does.  :class:`FlashAttention` binds
them as a ``torch.autograd.Function``.  A CUDA tensor launches the kernels
or raises; a CPU tensor runs :func:`attention_plain`, whose gradients come
from autograd through it.

Tensors travel folded: q, k, v [B*H, T, hd] (row-major, float32), the
episode ids [B, T] int32 per side (the head's batch row is bh // H).  The
kernel takes hd in ``SUPPORTED_HD`` and masks the ragged edge of T itself:
nothing is padded.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ppoc_tpu_torch.ops import _build

NEG = -1e9                      # pallas_attn.NEG
SUPPORTED_HD = (8, 16, 32, 64)  # csrc/attn.cu PPOC_HD_SWITCH

fwd_launches = _build.LaunchCount("flash_fwd")
dq_launches = _build.LaunchCount("flash_bwd_dq")
dkv_launches = _build.LaunchCount("flash_bwd_dkv")


# --- layouts ----------------------------------------------------------------

def fold(x: torch.Tensor) -> torch.Tensor:
    """[T, ..., H, hd] -> [B*H, T, hd] contiguous (B the product of the
    batch dims)."""
    T, H, hd = x.shape[0], x.shape[-2], x.shape[-1]
    return x.reshape(T, -1, H, hd).permute(1, 2, 0, 3).reshape(
        -1, T, hd).contiguous()


def unfold(x: torch.Tensor, like_shape) -> torch.Tensor:
    """Inverse of :func:`fold`: [B*H, T, ...] -> [T, ..., H, ...] with the
    batch dims and H of ``like_shape`` ([T, ..., H, hd])."""
    T, H = like_shape[0], like_shape[-2]
    rest = x.shape[2:]
    y = x.reshape(-1, H, T, *rest).permute(2, 0, 1, *range(3, 3 + len(rest)))
    return y.reshape(tuple(like_shape[:-1]) + tuple(rest))


def fold_ep(ep: torch.Tensor) -> torch.Tensor:
    """[T, ...] episode ids -> [B, T] int32 contiguous."""
    return ep.reshape(ep.shape[0], -1).T.to(torch.int32).contiguous()


# --- plain version ------------------------------------------------------------

def valid_mask(ep_q, ep_k, rel: int, H: int) -> torch.Tensor:
    """[B*H, T, T] bool: which (query t, key s) pairs are valid."""
    T = ep_q.shape[1]
    if rel > 0:
        return torch.zeros(ep_q.shape[0] * H, T, T, dtype=torch.bool,
                           device=ep_q.device)
    same = ep_q[:, :, None] == ep_k[:, None, :]                  # [B, T, T]
    if rel == 0:
        pos = torch.arange(T, device=ep_q.device)
        same = same & (pos[None, :] <= pos[:, None])
    return same.repeat_interleave(H, dim=0)


def attention_plain(q, k, v, ep_q, ep_k, rel: int, H: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [BH, T, hd], lse [BH, T]) with the [T, T] scores materialised,
    NEG at the invalid pairs and the invalid weights zeroed explicitly, so
    a row with no valid key gets out 0 and lse NEG (the kernel's
    semantics).  Differentiable in q, k, v through autograd."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = valid_mask(ep_q, ep_k, rel, H)
    s = torch.where(valid, (q @ k.transpose(1, 2)) * scale,
                    torch.full((), NEG, dtype=q.dtype, device=q.device))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), dtype=q.dtype,
                                                         device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (p @ v) / l_safe, (m + torch.log(l_safe))[..., 0]


# --- the kernels --------------------------------------------------------------

def _declare() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_attn_declared", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, i, f, p]       # BH, H, T, hd, rel, scale, stream
        lib.ppoc_flash_fwd.argtypes = [p] * 7 + tail
        lib.ppoc_flash_bwd_dq.argtypes = [p] * 9 + tail
        lib.ppoc_flash_bwd_dkv.argtypes = [p] * 10 + tail
        for fn in (lib.ppoc_flash_fwd, lib.ppoc_flash_bwd_dq,
                   lib.ppoc_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib._attn_declared = True
    return lib


def _check_inputs(q, k, v, ep_q, ep_k, H: int):
    """Raise unless the folded inputs are what the kernels take; returns
    (BH, T, hd)."""
    if q.dim() != 3:
        raise ValueError(f"q must be folded [BH, T, hd], got {tuple(q.shape)}")
    BH, T, hd = q.shape
    if hd not in SUPPORTED_HD:
        raise ValueError(f"K7 takes head dims {SUPPORTED_HD}, got {hd}")
    if H < 1 or BH % H or BH > 65535:
        raise ValueError(f"K7 takes B*H <= 65535 rows in whole heads, got "
                         f"BH {BH}, H {H}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, (BH, T, hd), device=dev)
    for name, t in (("ep_q", ep_q), ("ep_k", ep_k)):
        _build.require(t, name, (BH // H, T), dtype=torch.int32, device=dev)
    return BH, T, hd


def flash_fwd_kernel(q, k, v, ep_q, ep_k, rel: int, H: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward; same arguments and results as
    :func:`attention_plain`."""
    BH, T, hd = _check_inputs(q, k, v, ep_q, ep_k, H)
    out = torch.empty_like(q)
    lse = torch.empty(BH, T, dtype=torch.float32, device=q.device)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, lib.ppoc_flash_fwd(
        p(q), p(k), p(v), p(ep_q), p(ep_k), p(out), p(lse), BH, H, T, hd,
        int(rel), 1.0 / math.sqrt(hd), _build.stream_of(q.device)),
        "K7 forward")
    fwd_launches.n += 1
    return out, lse


def _check_grads(q, dout, dsum, lse):
    BH, T, _ = q.shape
    _build.require(dout, "dout", tuple(q.shape), device=q.device)
    for name, t in (("dsum", dsum), ("lse", lse)):
        _build.require(t, name, (BH, T), device=q.device)


def flash_dq_kernel(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum, lse
                    ) -> torch.Tensor:
    """Launch the dq kernel: dq [BH, T, hd] from the output cotangent
    ``dout``, ``dsum`` = rowsum(dout * out) - g_lse and the forward's lse."""
    BH, T, hd = _check_inputs(q, k, v, ep_q, ep_k, H)
    _check_grads(q, dout, dsum, lse)
    dq = torch.empty_like(q)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, lib.ppoc_flash_bwd_dq(
        p(q), p(k), p(v), p(ep_q), p(ep_k), p(dout), p(dsum), p(lse), p(dq),
        BH, H, T, hd, int(rel), 1.0 / math.sqrt(hd),
        _build.stream_of(q.device)), "K7 dq")
    dq_launches.n += 1
    return dq


def flash_dkv_kernel(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum, lse
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel; arguments as :func:`flash_dq_kernel`."""
    BH, T, hd = _check_inputs(q, k, v, ep_q, ep_k, H)
    _check_grads(q, dout, dsum, lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, lib.ppoc_flash_bwd_dkv(
        p(q), p(k), p(v), p(ep_q), p(ep_k), p(dout), p(dsum), p(lse), p(dk),
        p(dv), BH, H, T, hd, int(rel), 1.0 / math.sqrt(hd),
        _build.stream_of(q.device)), "K7 dk/dv")
    dkv_launches.n += 1
    return dk, dv


def dsum_of(dout: torch.Tensor, out: torch.Tensor,
            g_lse: Optional[torch.Tensor]) -> torch.Tensor:
    """rowsum(dout * out) - g_lse, [BH, T]: the lse cotangent folds into
    the backward's ``dsum`` (d lse / d s is the softmax weight)."""
    dsum = (dout * out).sum(dim=-1)
    return dsum if g_lse is None else dsum - g_lse


class FlashAttention(torch.autograd.Function):
    """K7 on CUDA tensors: ``apply(q, k, v, ep_q, ep_k, rel, H)`` ->
    (out, lse); the backward is the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, ep_q, ep_k, rel: int, H: int):
        out, lse = flash_fwd_kernel(q, k, v, ep_q, ep_k, rel, H)
        ctx.save_for_backward(q, k, v, ep_q, ep_k, out, lse)
        ctx.rel, ctx.H = rel, H
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, ep_q, ep_k, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g.contiguous()
        dsum = dsum_of(g, out, g_lse).contiguous()
        args = (q, k, v, ep_q, ep_k, ctx.rel, ctx.H, g, dsum, lse)
        dq = flash_dq_kernel(*args)
        dk, dv = flash_dkv_kernel(*args)
        return dq, dk, dv, None, None, None, None


def attention_folded(q, k, v, ep_q, ep_k, rel: int, H: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) on folded tensors: K7 for a CUDA tensor, the plain
    version for a CPU one."""
    if q.is_cuda:
        return FlashAttention.apply(q, k, v, ep_q, ep_k, rel, H)
    return attention_plain(q, k, v, ep_q, ep_k, rel, H)


# --- public entries -----------------------------------------------------------

def flash_mha_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_ep: torch.Tensor, k_ep: torch.Tensor, rel: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of a ring-attention pass (``pallas_attn.flash_mha_block``):
    q, k, v [T, ..., H, hd], the two sides' episode ids [T, ...] and the
    key block's relation ``rel``; returns (out [T, ..., H, hd],
    lse [T, ..., H]), NEG where a query has no valid key."""
    H = q.shape[-2]
    out, lse = attention_folded(fold(q), fold(k), fold(v), fold_ep(q_ep),
                                fold_ep(k_ep), int(rel), H)
    return unfold(out, q.shape), unfold(lse, q.shape)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ep: torch.Tensor) -> torch.Tensor:
    """Causal episode-masked multi-head attention
    (``pallas_attn.flash_mha``): q, k, v [T, ..., H, hd], ep [T, ...];
    returns [T, ..., H, hd]."""
    return flash_mha_block(q, k, v, ep, ep, 0)[0]

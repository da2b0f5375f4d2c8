"""K7: causal episode-masked flash attention (``csrc/attn.cu``), forward
and backward, and its plain versions.

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
or raises; a float32 CPU tensor runs :func:`attention_plain`, whose
gradients come from autograd through it.

Each kernel has a bf16 variant (``compute_dtype=torch.bfloat16`` on the
public entries, as ``pallas_attn.flash_mha(..., compute_dtype=bfloat16)``):
q, k, v and dout travel as bf16, every score and sum is float32, p is
rounded to bf16 for the P.V product only, ds and w for the backward's
products, and dq, dk, dv come back as bf16; out, lse and dsum stay
float32.  Its kernels run the products on the tensor cores, a warp's 16
rows against a tile of ``TILE`` rows of the other side.  Its plain
versions, for a bf16 CPU tensor, are :func:`attention_plain_bf16` (an
online softmax over key chunks: the rounding of p depends on the running
max when it is rounded, so on the chunking; the kernel rescales once per
key tile, ``BF16_CHUNK`` keys from key 0, the Pallas kernel once per its
own key tile) and the explicit backward :func:`flash_dq_plain_bf16` and
:func:`flash_dkv_plain_bf16`, which :class:`FlashAttention` binds on the
CPU too: autograd through the plain forward would round at other places
than the kernels do.  The two variants count their launches apart.  The
f32 kernels run their products on the tensor cores too, as 3xTF32 (each
float32 operand split into two tf32 values, float32-accurate), a warp's 16
rows against a tile; a block's walk over the other side's tiles is dealt
to ``f32_plan(hd).splits`` warp groups in turn (:func:`deal`), whose
partial results are merged in group order.  The f32 forward rescales once
per key tile of a group; its plain version materialises the scores, so no
chunk of it shows here.

Both variants skip the other side's tiles that share no episode with a
block's rows (the episode-id ranges do not meet); :func:`visited_tiles` is
that rule.  A skipped tile holds no valid pair and adds exactly nothing,
so the plain versions, which visit everything, are the same function.

Tensors travel folded: q, k, v [B*H, T, hd] (row-major, float32 or bf16),
the episode ids [B, T] int32 per side (the head's batch row is bh // H).
The kernel takes hd in ``SUPPORTED_HD`` and masks the ragged edge of T
itself: nothing is padded.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ppoc_tpu_torch.ops import _build

NEG = -1e9                      # pallas_attn.NEG
SUPPORTED_HD = (8, 16, 32, 64)  # csrc/attn.cu PPOC_HD_SWITCH
# csrc/attn.cu: a block's own rows in each variant (f32 ROWS, 16 a warp and
# F32_RG 2 row groups; bf16 16 a warp, BF16_WARPS 4 warps) and the other
# side's rows a tile (TILE)
ROWS, BF16_ROWS, TILE = 32, 64, 64
BF16_CHUNK = TILE               # keys a bf16 softmax rescale: its key tile


class F32Plan(NamedTuple):
    """The f32 kernels' launch at one head dim (csrc/attn.cu ``F32``)."""
    rows: int      # own rows a block (ROWS)
    tile: int      # the other side's rows a tile (TILE)
    splits: int    # warp groups the walk is dealt to
    stages: int    # tile buffers a group (2: the next tile loads ahead)
    threads: int   # threads a block
    smem: int      # dynamic shared-memory bytes a block


def f32_plan(hd: int) -> F32Plan:
    """The f32 kernels' plan at head dim ``hd`` (csrc/attn.cu ``F32<HD>``):
    2 row groups of 16 rows, 4 warp groups to hd 16 and 2 past it, one
    tile buffer a group at hd 64 (shared memory), a buffer two
    [TILE, hd + 4] float tiles and three TILE-long vectors."""
    if hd not in SUPPORTED_HD:
        raise ValueError(f"K7 takes head dims {SUPPORTED_HD}, got {hd}")
    splits = 4 if hd <= 16 else 2
    stages = 1 if hd == 64 else 2
    buffer = 2 * TILE * (hd + 4) + 3 * TILE
    return F32Plan(ROWS, TILE, splits, stages, 32 * 2 * splits,
                   4 * splits * stages * buffer)


def deal(visited: Sequence[int], splits: int) -> List[List[int]]:
    """The f32 kernels' key split: a block's visited tiles, in rising
    order, dealt to ``splits`` warp groups in turn (group g takes the g-th,
    the (g + splits)-th, ...)."""
    return [list(visited[g::splits]) for g in range(splits)]

fwd_launches = _build.LaunchCount("flash_fwd")
dq_launches = _build.LaunchCount("flash_bwd_dq")
dkv_launches = _build.LaunchCount("flash_bwd_dkv")
fwd_bf16_launches = _build.LaunchCount("flash_fwd_bf16")
dq_bf16_launches = _build.LaunchCount("flash_bwd_dq_bf16")
dkv_bf16_launches = _build.LaunchCount("flash_bwd_dkv_bf16")

# element type of q, k, v -> (C entry suffix, forward, dq, dk/dv counters)
_VARIANT = {
    torch.float32: ("", fwd_launches, dq_launches, dkv_launches),
    torch.bfloat16: ("_bf16", fwd_bf16_launches, dq_bf16_launches,
                     dkv_bf16_launches),
}


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


def _window_ranges(ep: torch.Tensor, width: int):
    """(lo, hi) [B, T]: min and max of ep[:, s:s + width] (cut at T) for
    every start s."""
    B = ep.shape[0]
    info = torch.iinfo(torch.int32)

    def pad(fill):
        tail = torch.full((B, width - 1), fill, dtype=ep.dtype,
                          device=ep.device)
        return torch.cat([ep, tail], dim=1).unfold(1, width, 1)

    return pad(info.max).amin(-1), pad(info.min).amax(-1)


def visited_tiles(ep_q, ep_k, rel: int, rows: int = ROWS, span: int = TILE,
                  keys: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' tile-visit rule (``csrc/attn.cu``, ``list_visits``), in
    Python: (visited, in_range), bool [B, n_blocks, n_slots].

    A block owns ``rows`` rows of one side: queries for the forward and dq
    (``keys=False``), keys for dk/dv (``keys=True``); block i its rows
    [i rows, (i + 1) rows) cut at T.  It walks the other side's tiles of
    ``span`` rows: the forward and dq key tiles m span from 0 while below
    the causal bound (T for rel -1, the block's end for rel 0, none for
    +1); dk/dv query tiles q_start + m span below T, q_start 0, the block's
    first key or T.  ``in_range`` marks the slots m the loop has; a block
    visits one of them iff the tile's [min, max] episode id meets its own
    rows' (ids ``ep_q`` and ``ep_k``, [B, T] each side, any values)."""
    own, other = (ep_k, ep_q) if keys else (ep_q, ep_k)
    B, T = own.shape
    dev = own.device
    i = torch.arange(-(-T // rows), device=dev)[:, None]
    m = torch.arange(-(-T // span), device=dev)[None, :]
    r0 = i * rows
    if keys:
        start = (torch.zeros_like(r0) if rel < 0 else r0 if rel == 0
                 else torch.full_like(r0, T)) + m * span
        in_range = start < T
    else:
        n_keys = (torch.full_like(r0, T) if rel < 0
                  else torch.clamp(r0 + rows, max=T) if rel == 0
                  else torch.zeros_like(r0))
        start = m * span + torch.zeros_like(r0)
        in_range = start < n_keys
    lo, hi = _window_ranges(own, rows)
    tlo, thi = _window_ranges(other, span)
    at = start.clamp(max=T - 1)
    lo, hi = lo[:, r0[:, 0]][:, :, None], hi[:, r0[:, 0]][:, :, None]
    meets = (tlo[:, at] <= hi) & (thi[:, at] >= lo)
    in_range = in_range.expand(B, -1, -1)
    return in_range & meets, in_range


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


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand carried in float32: its products are exact there."""
    return t.to(torch.float32)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (nearest even) and carried in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _sum_toward_zero(a, b, acc, step: int = 16) -> torch.Tensor:
    """acc + a @ b in float32 (a [..., M, K], b [..., K, N] bf16 values
    carried in float32), the K axis ``step`` at a time: each step's sum
    (exact in float64) is added to the running sum, rounded toward zero.
    That is a kernel that chains every ``mma.sync`` k-step into its
    accumulator, since the tensor cores round their sums toward zero."""
    for k0 in range(0, a.shape[-1], step):
        x = acc.double() + (a[..., k0:k0 + step].double()
                            @ b[..., k0:k0 + step, :].double())
        y = x.float()
        acc = torch.where(y.double().abs() > x.abs(),
                          torch.nextafter(y, torch.zeros_like(y)), y)
    return acc


def _product(a, b, toward_zero: bool) -> torch.Tensor:
    """a @ b with float32 sums, or :func:`_sum_toward_zero` from 0."""
    if not toward_zero:
        return a @ b
    return _sum_toward_zero(a, b, torch.zeros(
        a.shape[:-1] + b.shape[-1:], device=a.device))


def attention_plain_bf16(q, k, v, ep_q, ep_k, rel: int, H: int,
                         chunk: int = BF16_CHUNK, round_l: bool = False,
                         toward_zero: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 variant's forward on bf16 q, k, v: (out [BH, T, hd],
    lse [BH, T]), both float32.  An online softmax over key chunks of
    ``chunk`` (vectorised over the rows): per chunk the running max m2,
    p = exp(s - m2) at the valid pairs, l rescaled plus the unrounded p,
    the accumulator rescaled plus bf16(p) @ v.  ``chunk`` = BF16_CHUNK is
    the kernel's schedule; the Pallas kernel's key tile (128, 256 or 512 by
    T) its own; ``chunk`` >= T the materialised bf16 core's
    (``models/attn._mha``).  ``round_l=True`` is a control, not a version:
    l sums bf16(p), as a kernel that rounded p before its row sum would,
    which the checks must tell apart from the kernel.  ``toward_zero=True``
    is another: P.V summed toward zero 16 keys at a time
    (:func:`_sum_toward_zero`), every output leaning toward zero."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = valid_mask(ep_q, ep_k, rel, H)
    qf, kf, vf = _f32(q), _f32(k), _f32(v)
    BH, T, hd = q.shape
    neg = torch.full((), NEG, device=q.device)
    zero = torch.zeros((), device=q.device)
    m = torch.full((BH, T, 1), NEG, device=q.device)
    l = torch.zeros(BH, T, 1, device=q.device)
    acc = torch.zeros(BH, T, hd, device=q.device)
    for c0 in range(0, T, chunk):
        ok = valid[:, :, c0:c0 + chunk]
        s = torch.where(ok, (qf @ kf[:, c0:c0 + chunk].transpose(1, 2))
                        * scale, neg)
        m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m2), zero)
        alpha = torch.exp(m - m2)
        l = l * alpha + (_bf16(p) if round_l else p).sum(dim=-1,
                                                        keepdim=True)
        if toward_zero:
            acc = _sum_toward_zero(_bf16(p), vf[:, c0:c0 + chunk],
                                   acc * alpha)
        else:
            acc = acc * alpha + _bf16(p) @ vf[:, c0:c0 + chunk]
        m = m2
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l_safe, (m + torch.log(l_safe))[..., 0]


def _bwd_terms_bf16(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum,
                    lse):
    """(w, bf16(ds), q, k, dout) of the bf16 backward, float32: the weights
    w = exp(s - lse) at the valid pairs and ds = w (dout.v - dsum) scale,
    [BH, T, T], rounded for the products as pallas_attn.py:241-245 and
    :294-299 round them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = valid_mask(ep_q, ep_k, rel, H)
    qf, kf, vf, dof = _f32(q), _f32(k), _f32(v), _f32(dout)
    s = (qf @ kf.transpose(1, 2)) * scale
    w = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    ds = _bf16(w * (dof @ vf.transpose(1, 2) - dsum[..., None]) * scale)
    return w, ds, qf, kf, dof


def flash_dq_plain_bf16(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum,
                        lse, toward_zero: bool = False) -> torch.Tensor:
    """The bf16 dq kernel's plain version: dq = bf16(ds) k with float32
    sums, returned as bf16; arguments as :func:`flash_dq_kernel`.
    ``toward_zero=True`` is a control: the sums rounded toward zero 16 keys
    at a time (:func:`_sum_toward_zero`)."""
    _, ds, _, kf, _ = _bwd_terms_bf16(q, k, v, ep_q, ep_k, rel, H, dout,
                                      dsum, lse)
    return _product(ds, kf, toward_zero).to(torch.bfloat16)


def flash_dkv_plain_bf16(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum,
                         lse, toward_zero: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 dk/dv kernel's plain version: dk = bf16(ds)^T q and
    dv = bf16(w)^T dout with float32 sums, returned as bf16;
    ``toward_zero`` as :func:`flash_dq_plain_bf16` (16 queries a step)."""
    w, ds, qf, _, dof = _bwd_terms_bf16(q, k, v, ep_q, ep_k, rel, H, dout,
                                        dsum, lse)
    return (_product(ds.transpose(1, 2), qf, toward_zero).to(torch.bfloat16),
            _product(_bf16(w).transpose(1, 2), dof, toward_zero).to(
                torch.bfloat16))


# --- the kernels --------------------------------------------------------------

def _declare() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_attn_declared", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, i, f, p]       # BH, H, T, hd, rel, scale, stream
        for suffix, _, _, _ in _VARIANT.values():
            for name, n_ptr in (("fwd", 7), ("bwd_dq", 9), ("bwd_dkv", 10)):
                fn = getattr(lib, f"ppoc_flash_{name}{suffix}")
                fn.argtypes = [p] * n_ptr + tail
                fn.restype = ctypes.c_int
        lib._attn_declared = True
    return lib


def _check_inputs(q, k, v, ep_q, ep_k, H: int):
    """Raise unless the folded inputs are what the kernels take; returns
    (BH, T, hd)."""
    if q.dim() != 3:
        raise ValueError(f"q must be folded [BH, T, hd], got {tuple(q.shape)}")
    BH, T, hd = q.shape
    if q.dtype not in _VARIANT:
        raise ValueError(f"K7 takes float32 or bfloat16 q, k, v, got "
                         f"{q.dtype}")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"K7 takes head dims {SUPPORTED_HD}, got {hd}")
    if H < 1 or BH % H or BH > 65535:
        raise ValueError(f"K7 takes B*H <= 65535 rows in whole heads, got "
                         f"BH {BH}, H {H}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, (BH, T, hd), dtype=q.dtype, device=dev)
    for name, t in (("ep_q", ep_q), ("ep_k", ep_k)):
        _build.require(t, name, (BH // H, T), dtype=torch.int32, device=dev)
    return BH, T, hd


def flash_fwd_kernel(q, k, v, ep_q, ep_k, rel: int, H: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward (the variant of q's dtype); same arguments and
    results as :func:`attention_plain` (float32) or
    :func:`attention_plain_bf16` (bf16; out and lse float32)."""
    BH, T, hd = _check_inputs(q, k, v, ep_q, ep_k, H)
    suffix, count, _, _ = _VARIANT[q.dtype]
    out = torch.empty(BH, T, hd, dtype=torch.float32, device=q.device)
    lse = torch.empty(BH, T, dtype=torch.float32, device=q.device)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, getattr(lib, "ppoc_flash_fwd" + suffix)(
        p(q), p(k), p(v), p(ep_q), p(ep_k), p(out), p(lse), BH, H, T, hd,
        int(rel), 1.0 / math.sqrt(hd), _build.stream_of(q.device)),
        "K7 forward" + suffix)
    count.n += 1
    return out, lse


def _check_grads(q, dout, dsum, lse):
    BH, T, _ = q.shape
    _build.require(dout, "dout", tuple(q.shape), dtype=q.dtype,
                   device=q.device)
    for name, t in (("dsum", dsum), ("lse", lse)):
        _build.require(t, name, (BH, T), device=q.device)


def flash_dq_kernel(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum, lse
                    ) -> torch.Tensor:
    """Launch the dq kernel: dq [BH, T, hd] from the output cotangent
    ``dout`` (q's dtype), ``dsum`` = rowsum(dout * out) - g_lse and the
    forward's lse (both float32); dq in q's dtype."""
    BH, T, hd = _check_inputs(q, k, v, ep_q, ep_k, H)
    _check_grads(q, dout, dsum, lse)
    suffix, _, count, _ = _VARIANT[q.dtype]
    dq = torch.empty_like(q)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, getattr(lib, "ppoc_flash_bwd_dq" + suffix)(
        p(q), p(k), p(v), p(ep_q), p(ep_k), p(dout), p(dsum), p(lse), p(dq),
        BH, H, T, hd, int(rel), 1.0 / math.sqrt(hd),
        _build.stream_of(q.device)), "K7 dq" + suffix)
    count.n += 1
    return dq


def flash_dkv_kernel(q, k, v, ep_q, ep_k, rel: int, H: int, dout, dsum, lse
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel; arguments as :func:`flash_dq_kernel`."""
    BH, T, hd = _check_inputs(q, k, v, ep_q, ep_k, H)
    _check_grads(q, dout, dsum, lse)
    suffix, _, _, count = _VARIANT[q.dtype]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _declare()
    p = _build.ptr
    _build.check(lib, getattr(lib, "ppoc_flash_bwd_dkv" + suffix)(
        p(q), p(k), p(v), p(ep_q), p(ep_k), p(dout), p(dsum), p(lse), p(dk),
        p(dv), BH, H, T, hd, int(rel), 1.0 / math.sqrt(hd),
        _build.stream_of(q.device)), "K7 dk/dv" + suffix)
    count.n += 1
    return dk, dv


def dsum_of(dout: torch.Tensor, out: torch.Tensor,
            g_lse: Optional[torch.Tensor]) -> torch.Tensor:
    """rowsum(dout * out) - g_lse, [BH, T]: the lse cotangent folds into
    the backward's ``dsum`` (d lse / d s is the softmax weight)."""
    dsum = (dout * out).sum(dim=-1)
    return dsum if g_lse is None else dsum - g_lse


class FlashAttention(torch.autograd.Function):
    """K7 as ``apply(q, k, v, ep_q, ep_k, rel, H)`` -> (out, lse): on CUDA
    tensors the kernels of q's dtype, the backward the dq and dk/dv
    kernels; on bf16 CPU tensors the bf16 plain forward and its explicit
    backward.  The output cotangent is float32: ``dsum`` is taken from it,
    then it is cast to q's dtype for the backward's products."""

    @staticmethod
    def forward(ctx, q, k, v, ep_q, ep_k, rel: int, H: int):
        if q.is_cuda:
            out, lse = flash_fwd_kernel(q, k, v, ep_q, ep_k, rel, H)
        else:   # the kernel's chunking, read at call time
            out, lse = attention_plain_bf16(q, k, v, ep_q, ep_k, rel, H,
                                            BF16_CHUNK)
        ctx.save_for_backward(q, k, v, ep_q, ep_k, out, lse)
        ctx.rel, ctx.H = rel, H
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, ep_q, ep_k, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g
        dsum = dsum_of(g, out, g_lse).contiguous()
        args = (q, k, v, ep_q, ep_k, ctx.rel, ctx.H,
                g.to(q.dtype).contiguous(), dsum, lse)
        if q.is_cuda:
            dq, (dk, dv) = flash_dq_kernel(*args), flash_dkv_kernel(*args)
        else:
            dq, (dk, dv) = (flash_dq_plain_bf16(*args),
                            flash_dkv_plain_bf16(*args))
        return dq, dk, dv, None, None, None, None


def attention_folded(q, k, v, ep_q, ep_k, rel: int, H: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse), both float32, on folded tensors: K7 for a CUDA tensor
    (the variant of q's dtype), the plain version for a CPU one (the bf16
    variant's for bf16 q, k, v)."""
    if q.is_cuda or q.dtype == torch.bfloat16:
        return FlashAttention.apply(q, k, v, ep_q, ep_k, rel, H)
    return attention_plain(q, k, v, ep_q, ep_k, rel, H)


# --- public entries -----------------------------------------------------------

def flash_mha_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_ep: torch.Tensor, k_ep: torch.Tensor, rel: int,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of a ring-attention pass (``pallas_attn.flash_mha_block``):
    q, k, v [T, ..., H, hd], the two sides' episode ids [T, ...] and the
    key block's relation ``rel``; returns (out [T, ..., H, hd] in q's
    dtype, lse [T, ..., H]), NEG where a query has no valid key.
    ``compute_dtype=torch.bfloat16`` folds q, k, v to bf16 blocks (the bf16
    variant)."""
    H = q.shape[-2]

    def blocks(x):
        x = fold(x)
        return x if compute_dtype is None else x.to(compute_dtype)

    out, lse = attention_folded(blocks(q), blocks(k), blocks(v),
                                fold_ep(q_ep), fold_ep(k_ep), int(rel), H)
    return unfold(out, q.shape).to(q.dtype), unfold(lse, q.shape)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ep: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Causal episode-masked multi-head attention
    (``pallas_attn.flash_mha``): q, k, v [T, ..., H, hd], ep [T, ...];
    returns [T, ..., H, hd]; ``compute_dtype`` as :func:`flash_mha_block`."""
    return flash_mha_block(q, k, v, ep, ep, 0, compute_dtype)[0]

"""Attention trunks: a causal Transformer encoder and a dense MLP head.

Counterpart of ``ppoc_tpu/models/attn.py`` (single device, float32).  Pre-LN
blocks with a learned positional embedding:

  tokens  h0 = obs @ We + be + pos[t]
  block:  h  = h + Wo MHA(LN1(h)) + bo;  h = h + FF(LN2(h))
  out     head(LNf(h))                  # dense MLP head, models/mlp.py

Parameters keep the JAX package's tree, so the two packages exchange them
leaf by leaf (``utils/params.py``):

  {"attn": {"embed": (We [in, d], be [d]),
            "pos": [T_max, d],
            "blocks": [{"wqkv": [d, 3, H, hd], "bqkv": [3, H, hd],
                        "wo": [d, d], "bo": [d],
                        "ln1": (g, b), "ln2": (g, b),
                        "ff1": (W [d, f], b [f]), "ff2": (W [f, d], b [d])},
                       ...],
            "lnf": (g, b)},
   "head": mlp.Params}                                 # [d, *hidden, out]

Masking, shared by the parallel pass and the decode so replayed log-probs
match the stored ones: token t attends token s iff s <= t and both lie in
the same episode; ``reset_after[t]`` true means the episode ended AT step
t.  Positions are window-absolute.

``apply_seq`` on the "pallas" backend sends the attention core of a
window of at least ``FLASH_MIN_T`` steps to the flash kernel K7
(``ops/cuda_attn.flash_mha``); shorter windows, and the "jnp" backend,
materialise the [T, T] mask (:func:`_mha`).  The decode paths
(:func:`decode_next`, :func:`step`) are plain PyTorch, as they are plain jnp
in the JAX package.  The head is the plain MLP forward (the JAX package's
``mlp.apply(..., "jnp")``).

The "bf16" backend takes the GEMM sites named in ``BF16_SITES`` on bf16
operands with float32 output (``mlp.bf16_dot``; softmax statistics and
sums stay float32): the flash core then runs K7's bf16 variant when both
"scores" and "av" are sites, else the materialised core with bf16 q, k
(scores) and v and the weights (av).  :func:`decode_next` gates its
embed, qkv, out, ff and head sites by ``BF16_SITES`` too (the JAX
package's decode rounds all five whatever the set, ``ROADMAP.md`` §3);
its scores and P.V stay float32, as there; :func:`step`, the rollout's
decode, is float32.  Not ported yet: the sequence-parallel forms
(``apply_seq_sp``, ``decode_next_sp``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from . import mlp

AttnParams = Dict[str, object]

NEG_INF = -1e9   # mask value: exp() underflows to exactly 0 in float32

FLASH_MIN_T = 1024   # the JAX package's choice of path (models/attn.py:63),
                     # a TPU crossover not re-derived on the H100 (PERF.md)

_DECODE_CHUNK = 128

# The GEMM sites the "bf16" backend runs in bf16 (the JAX package's
# default set, ppoc_tpu/models/attn.py:74): embed | qkv | scores (the Q.K
# logits) | av (the weights x V product) | out (the attention output
# projection) | ff | head.  A bisect removes sites to keep their operands
# float32.
BF16_SITES = frozenset({"embed", "qkv", "scores", "av", "out", "ff",
                        "head"})


def is_attn(params) -> bool:
    """Structural test: does this trunk tree hold an attention encoder?"""
    return isinstance(params, dict) and "attn" in params


def init(obs_dim: int, d: int, n_layers: int, n_heads: int, ff: int,
         t_max: int, head_sizes: Sequence[int], generator: torch.Generator,
         device: torch.device) -> AttnParams:
    """Causal Transformer encoder of width ``d`` + MLP head, with the JAX
    package's bounds: weights U(+-sqrt(3) sqrt(2 / (fan_in + fan_out))),
    biases U(+-1/sqrt(fan_in)), LayerNorm gains 1 and offsets 0, positions
    U(+-0.02), the head ``mlp.init``.  Drawn from ``generator`` per block
    (wqkv, bqkv, wo, bo, ff1, ff2), then embed, pos and the head."""
    if d % n_heads:
        raise ValueError(f"attn_dim ({d}) must be divisible by attn_heads "
                         f"({n_heads})")
    hd = d // n_heads

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).to(device)

    def unif(fan_in, fan_out, shape):
        return uniform(shape, math.sqrt(3.0) * math.sqrt(
            2.0 / (fan_in + fan_out)))

    def bias(fan_in, shape):
        return uniform(shape, 1.0 / math.sqrt(fan_in))

    def ln():
        return (torch.ones(d, device=device), torch.zeros(d, device=device))

    blocks: List[Dict[str, object]] = []
    for _ in range(n_layers):
        wqkv = unif(d, d, (d, 3, n_heads, hd))
        bqkv = bias(d, (3, n_heads, hd))
        wo = unif(d, d, (d, d))
        bo = bias(d, (d,))
        ff1 = (unif(d, ff, (d, ff)), bias(d, (ff,)))
        ff2 = (unif(ff, d, (ff, d)), bias(ff, (d,)))
        blocks.append({"wqkv": wqkv, "bqkv": bqkv, "wo": wo, "bo": bo,
                       "ln1": ln(), "ln2": ln(), "ff1": ff1, "ff2": ff2})
    embed = (unif(obs_dim, d, (obs_dim, d)), bias(obs_dim, (d,)))
    pos = uniform((t_max, d), 0.02)
    return {"attn": {"embed": embed, "pos": pos, "blocks": blocks,
                     "lnf": ln()},
            "head": mlp.init(head_sizes, generator, device)}


def width(params: AttnParams) -> int:
    return params["attn"]["embed"][0].shape[1]


def window(params: AttnParams) -> int:
    """T_max: the longest context the positional table supports."""
    return params["attn"]["pos"].shape[0]


def _ln(x: torch.Tensor, gb) -> torch.Tensor:
    g, b = gb
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _site(backend: str):
    """site name -> does the "bf16" backend run it in bf16 (read from
    ``BF16_SITES`` at call time)."""
    return lambda name: backend == "bf16" and name in BF16_SITES


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, carried in float32: a bf16 operand of a product
    taken in float32 (its cotangent is rounded the same way, as the JAX
    package's cast to bf16 and back)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot(a: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ w, on bf16 operands with a float32 output when ``bf16``."""
    return mlp.bf16_dot(a, w) if bf16 else a @ w


def _ff(x: torch.Tensor, blk, activation: str,
        bf16: bool = False) -> torch.Tensor:
    w1, b1 = blk["ff1"]
    w2, b2 = blk["ff2"]
    return _dot(mlp._ACTIVATIONS[activation](_dot(x, w1, bf16) + b1), w2,
                bf16) + b2


def _embed(attn, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    we, be = attn["embed"]
    return _dot(x, we, bf16) + be


def _qkv(blk, u: torch.Tensor, bf16: bool = False):
    """(q, k, v), each [..., H, hd], from the block input ``u`` [..., d]."""
    w = blk["wqkv"]
    qkv = _dot(u, w.reshape(w.shape[0], -1), bf16).reshape(
        u.shape[:-1] + w.shape[1:]) + blk["bqkv"]
    return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


def episode_ids(reset_after: torch.Tensor) -> torch.Tensor:
    """[T, ...] int32 episode index per step: the exclusive cumulative
    count of done flags (the final step of an episode still belongs to
    it)."""
    d = reset_after.to(torch.int32)
    return (torch.cumsum(d, dim=0) - d).to(torch.int32)


def causal_episode_mask(reset_after: torch.Tensor) -> torch.Tensor:
    """[T_q, T_k, ...] bool: query t may attend key s (s <= t, same
    episode)."""
    ep = episode_ids(reset_after)
    T = ep.shape[0]
    pos = torch.arange(T, device=ep.device)
    causal = (pos[None, :] <= pos[:, None]).reshape(
        (T, T) + (1,) * (ep.dim() - 1))
    return causal & (ep[None] == ep[:, None])


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, bf16_av: bool = False) -> torch.Tensor:
    """Masked multi-head attention on [T, ..., H, hd] tensors with a
    [T_q, T_k, ...] mask; returns [T_q, ..., H, hd].  Scores and softmax
    are float32; ``bf16_av`` rounds the weights to bf16 for the P.V
    product (the caller rounds v), as the JAX package's ``w.astype(v.dtype)``
    on a bf16 v."""
    hd = q.shape[-1]
    scores = torch.einsum("t...hk,s...hk->ts...h", q, k) / math.sqrt(hd)
    scores = torch.where(mask[..., None], scores, NEG_INF)
    w = torch.softmax(scores, dim=1)
    if bf16_av:
        w = _round_bf16(w)
    return torch.einsum("ts...h,s...hk->t...hk", w, v)


def apply_seq(params: AttnParams, xs: torch.Tensor,
              reset_after: torch.Tensor, activation: str,
              with_cache: bool = False, backend: str = "jnp"):
    """Head outputs [T, ..., out] for a whole window [T, ..., in], every
    step in parallel.  ``with_cache=True`` also returns the per-layer keys
    and values (lists of [T, ..., H, hd]) for :func:`decode_next`.
    ``backend="pallas"`` at T >= FLASH_MIN_T runs the attention core
    through K7; ``backend="bf16"`` runs the ``BF16_SITES`` products in
    bf16, and its core through K7's bf16 variant at T >= FLASH_MIN_T when
    both "scores" and "av" are sites (``ppoc_tpu/models/attn.py:245-288``).
    """
    if backend not in ("jnp", "pallas", "bf16"):
        raise NotImplementedError(
            f"attention backend {backend!r} is not ported yet (ROADMAP.md)")
    attn = params["attn"]
    T = xs.shape[0]
    t_max = attn["pos"].shape[0]
    if T > t_max:
        raise ValueError(
            f"window length {T} exceeds the positional table ({t_max}); "
            f"init the trunk with t_max >= the rollout length")
    site = _site(backend)
    bf16_sc, bf16_av = site("scores"), site("av")
    pos = attn["pos"][:T].reshape((T,) + (1,) * (xs.dim() - 2) + (-1,))
    h = _embed(attn, xs, site("embed")) + pos
    if (backend == "pallas" or (bf16_sc and bf16_av)) and T >= FLASH_MIN_T:
        from ppoc_tpu_torch.ops import cuda_attn

        ep = episode_ids(reset_after)
        dt = torch.bfloat16 if backend == "bf16" else None

        def mha(q, k, v):
            return cuda_attn.flash_mha(q, k, v, ep, dt)
    else:
        mask = causal_episode_mask(reset_after)

        def mha(q, k, v):
            if bf16_sc:
                q, k = _round_bf16(q), _round_bf16(k)
            if bf16_av:
                v = _round_bf16(v)
            return _mha(q, k, v, mask, bf16_av)
    ks, vs = [], []
    for blk in attn["blocks"]:
        q, k, v = _qkv(blk, _ln(h, blk["ln1"]), site("qkv"))
        if with_cache:
            ks.append(k)
            vs.append(v)
        o = mha(q, k, v)
        h = h + _dot(o.reshape(o.shape[:-2] + (-1,)), blk["wo"],
                     site("out")) + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation, site("ff"))
    out = mlp.apply(params["head"], _ln(h, attn["lnf"]), activation,
                    "bf16" if site("head") else "jnp")
    return (out, ks, vs) if with_cache else out


def decode_next(params: AttnParams, x_next: torch.Tensor,
                pos_idx: torch.Tensor, ks: List[torch.Tensor],
                vs: List[torch.Tensor], mask: torch.Tensor,
                activation: str, backend: str = "jnp") -> torch.Tensor:
    """One-step decode for all T slots at once: next-token t ([T, ..., in]
    at position ``pos_idx[t]``) attends the context keys ``mask[t]`` allows
    (the per-layer ``ks``/``vs`` of ``apply_seq(with_cache=True)``) plus
    itself.  V(s'_t) for the GAE bootstrap in one pass.  A window of more
    than 2 * 128 slots runs 128 queries at a time, so the [T_q, T_k, ...]
    score planes stay small (the JAX package's ``lax.map`` chunks).
    ``backend="bf16"`` runs the embed, qkv, out, ff and head products of
    ``BF16_SITES`` in bf16; the scores and P.V stay float32."""
    T = x_next.shape[0]
    if T <= 2 * _DECODE_CHUNK:
        return _decode_next(params, x_next, pos_idx, ks, vs, mask,
                            activation, backend)
    return torch.cat([
        _decode_next(params, x_next[c:c + _DECODE_CHUNK],
                     pos_idx[c:c + _DECODE_CHUNK], ks, vs,
                     mask[c:c + _DECODE_CHUNK], activation, backend)
        for c in range(0, T, _DECODE_CHUNK)])


def _decode_next(params, x_next, pos_idx, ks, vs, mask, activation,
                 backend="jnp"):
    # each site gated by BF16_SITES, as apply_seq gates it: the JAX
    # package's _decode_next (models/attn.py:440-461) rounds all five
    # whenever the backend is "bf16", which parts from its own apply_seq
    # under a bisected set
    site = _site(backend)
    attn = params["attn"]
    h = _embed(attn, x_next, site("embed")) + attn["pos"][pos_idx].reshape(
        (x_next.shape[0],) + (1,) * (x_next.dim() - 2) + (-1,))
    scale = 1.0 / math.sqrt(attn["blocks"][0]["wqkv"].shape[-1])
    for blk, k_ctx, v_ctx in zip(attn["blocks"], ks, vs):
        q, k_self, v_self = _qkv(blk, _ln(h, blk["ln1"]), site("qkv"))
        s_ctx = torch.einsum("t...hk,s...hk->ts...h", q, k_ctx) * scale
        s_ctx = torch.where(mask[..., None], s_ctx, NEG_INF)
        s_self = (q * k_self).sum(dim=-1)[:, None] * scale
        w = torch.softmax(torch.cat([s_ctx, s_self], dim=1), dim=1)
        o = (torch.einsum("ts...h,s...hk->t...hk", w[:, :-1], v_ctx)
             + w[:, -1][..., None] * v_self)
        h = h + _dot(o.reshape(o.shape[:-2] + (-1,)), blk["wo"],
                     site("out")) + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation, site("ff"))
    return mlp.apply(params["head"], _ln(h, attn["lnf"]), activation,
                     "bf16" if site("head") else "jnp")


# --------------------------------------------------------------------------
# sequential decode (rollout)
# --------------------------------------------------------------------------

def initial_cache(params: AttnParams, batch_shape: Tuple[int, ...]) -> Dict:
    """Fresh KV cache for a window: per-layer keys and values
    [L, T_max, *batch, H, hd], per-lane episode starts, and the window step
    ``t`` (a Python int: the decode loop runs on the host)."""
    attn = params["attn"]
    n_heads, hd = attn["blocks"][0]["wqkv"].shape[-2:]
    dev = attn["pos"].device
    kv_shape = (len(attn["blocks"]), window(params), *batch_shape, n_heads,
                hd)
    return {"k": torch.zeros(kv_shape, device=dev),
            "v": torch.zeros(kv_shape, device=dev),
            "start": torch.zeros(batch_shape, dtype=torch.int32, device=dev),
            "t": 0}


def step(params: AttnParams, cache: Dict, x: torch.Tensor,
         activation: str) -> Tuple[Dict, torch.Tensor]:
    """One decode step: (cache, head output [..., out]).  The token is
    written into the cache at the window step, and attends every cached
    position in [start_lane, t] -- the set :func:`apply_seq`'s mask grants,
    so a replay recomputes the same outputs.  Steps past the positional
    window clamp to its last slot.  Unlike the JAX package's functional
    update, the keys and values are written into ``cache`` in place (a
    copy of the whole cache per step would cost more than the step)."""
    attn = params["attn"]
    t_max = window(params)
    t = min(cache["t"], t_max - 1)
    h = _embed(attn, x) + attn["pos"][t]
    scale = 1.0 / math.sqrt(attn["blocks"][0]["wqkv"].shape[-1])
    s_pos = torch.arange(t_max, device=x.device).reshape(
        (t_max,) + (1,) * cache["start"].dim())
    valid = (s_pos >= cache["start"][None]) & (s_pos <= t)
    for i, blk in enumerate(attn["blocks"]):
        q, k_self, v_self = _qkv(blk, _ln(h, blk["ln1"]))
        cache["k"][i, t] = k_self
        cache["v"][i, t] = v_self
        scores = torch.einsum("s...hk,...hk->s...h", cache["k"][i], q) * scale
        scores = torch.where(valid[..., None], scores, NEG_INF)
        w = torch.softmax(scores, dim=0)
        o = torch.einsum("s...h,s...hk->...hk", w, cache["v"][i])
        h = h + o.reshape(o.shape[:-2] + (-1,)) @ blk["wo"] + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation)
    out = mlp.apply(params["head"], _ln(h, attn["lnf"]), activation, "jnp")
    cache["t"] += 1
    return cache, out


def reset_lanes(cache: Dict, done: torch.Tensor) -> Dict:
    """Move the episode start of every lane whose episode ended past the
    token just written (clamped to the window's last slot, as the write
    position is)."""
    start = min(cache["t"], cache["k"].shape[1] - 1)
    cache["start"] = torch.where(done, start, cache["start"]).to(torch.int32)
    return cache

"""Recurrent trunks: a GRU or LSTM cell on the observation and a dense MLP
head over the hidden state.

Counterpart of ``ppoc_tpu/models/gru.py``.  Parameters keep the JAX
package's tree, so the two packages exchange them leaf by leaf
(``utils/params.py``):

  {"cell": {"wx": [in, G*H], "wh": [H, G*H], "b": [G*H]},
   "head": mlp.Params}                                # [H, *hidden, out]

G = 3 for a GRU, gates (reset | update | candidate) along the G*H axis;
G = 4 for an LSTM, gates (input | forget | candidate | output).  The kind
is read off the shapes (:func:`cell_kind`), so every consumer (rollout,
update, checkpoint, serving) dispatches on them with no other metadata.

State: one flat carry per lane, h [.., H] for a GRU and concat(h, c)
[.., 2H] for an LSTM (:func:`state_size`); the head reads the first H
columns.  The cell is plain products on tensors (``x @ wx + b``, ``h @
wh``) and the JAX package's gates (:func:`cell_from_gates`); over a window
(:func:`states_seq`, :func:`apply_seq`) the input products of every step
are one product, then a Python loop over time steps the state and zeroes
it in a lane after a step that ended the lane's episode, and the head runs
once over the window's states.
No library sequence kernel (``nn.GRU``, cuDNN) runs: its fused sequence
cannot take the mask at episode boundaries.  The JAX package runs this
family on its "jnp" path only, so it has no kernel here either.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from . import mlp

GRUParams = Dict[str, object]


def is_rnn(params) -> bool:
    """Structural test: does this trunk tree hold a recurrent cell?"""
    return isinstance(params, dict) and "cell" in params


def init(obs_dim: int, rnn_hidden: int, head_sizes: Sequence[int],
         generator: torch.Generator, device: torch.device,
         cell: str = "gru") -> GRUParams:
    """Recurrent cell + MLP head (``head_sizes``: the head's full layer
    list, e.g. (H, 128, act)), with the JAX package's bounds: wx and wh
    U(+-sqrt(3) sqrt(2 / (fan_in + fan_out))) (gain 1), b U(+-1/sqrt(in)),
    an LSTM's forget-gate bias +1, the head ``mlp.init``.  Drawn from
    ``generator`` in the JAX order: wx, wh, b, then the head."""
    if cell not in ("gru", "lstm"):
        raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
    h = rnn_hidden
    g = 3 if cell == "gru" else 4

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * 2.0 - 1.0) * bound

    def unif(fan_in, fan_out, shape):
        return uniform(shape, math.sqrt(3.0) * math.sqrt(
            2.0 / (fan_in + fan_out)))

    wx = unif(obs_dim, g * h, (obs_dim, g * h))
    wh = unif(h, g * h, (h, g * h))
    b = uniform((g * h,), 1.0 / math.sqrt(obs_dim))
    if cell == "lstm":        # the forget gate is the second H-slice
        b[h:2 * h] += 1.0
    cell_p = {"wx": wx.to(device), "wh": wh.to(device), "b": b.to(device)}
    return {"cell": cell_p, "head": mlp.init(head_sizes, generator, device)}


def hidden_size(params: GRUParams) -> int:
    return params["cell"]["wh"].shape[0]


def cell_kind(params: GRUParams) -> str:
    """"gru" (3H gates) or "lstm" (4H gates), read off the weight shapes."""
    wh = params["cell"]["wh"]
    return "lstm" if wh.shape[1] == 4 * wh.shape[0] else "gru"


def state_size(params: GRUParams) -> int:
    """Width of the flat per-lane carry: H for a GRU, 2H (h ‖ c) for an
    LSTM."""
    h = hidden_size(params)
    return 2 * h if cell_kind(params) == "lstm" else h


def initial_state(params: GRUParams,
                  batch_shape: Tuple[int, ...]) -> torch.Tensor:
    wh = params["cell"]["wh"]
    return torch.zeros((*batch_shape, state_size(params)), dtype=wh.dtype,
                       device=wh.device)


def cell_step(params: GRUParams, s: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """One recurrent step: the new flat state given state ``s`` and input
    ``x`` (GRU: s is h [.., H]; LSTM: s is concat(h, c) [.., 2H])."""
    return cell_from_gates(params, s, input_gates(params, x))


def input_gates(params: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """The input's gate term ``x @ wx + b`` [..., G*H]: one product for
    every step of a window at once."""
    c = params["cell"]
    return x @ c["wx"] + c["b"]


def cell_from_gates(params: GRUParams, s: torch.Tensor,
                    gx: torch.Tensor) -> torch.Tensor:
    """:func:`cell_step` given the input's gate term ``gx``
    (:func:`input_gates`).  The JAX package's gates, with a few elementwise
    terms fused into one op each and each tensor split in one op (a step's
    host cost, and its backward's, is its op count):

      GRU   r, z = sigmoid(gx_rz + gh_rz);  n = tanh(addcmul(gx_n, r, gh_n))
            h' = lerp(n, h, z)            # (1 - z) n + z h
      LSTM  i, f, _, o = sigmoid(gates);  g = tanh(gates_g)
            c' = addcmul(f c, i, g);  h' = o tanh(c')
    """
    wh = params["cell"]["wh"]
    H = wh.shape[0]
    if wh.shape[1] == 4 * H:                      # LSTM: s is h ‖ c
        h, c = s.split(H, dim=-1)
        gates = gx + h @ wh
        i, f, _, o = torch.sigmoid(gates).split(H, dim=-1)
        c2 = torch.addcmul(f * c, i, torch.tanh(gates[..., 2 * H:3 * H]))
        return torch.cat([o * torch.tanh(c2), c2], dim=-1)
    gx_rz, gx_n = gx.split([2 * H, H], dim=-1)
    gh_rz, gh_n = (s @ wh).split([2 * H, H], dim=-1)
    r, z = torch.sigmoid(gx_rz + gh_rz).split(H, dim=-1)
    n = torch.tanh(torch.addcmul(gx_n, r, gh_n))
    return torch.lerp(n, s, z)


def head_apply(params: GRUParams, s: torch.Tensor,
               activation: str) -> torch.Tensor:
    """The head on the state's first H columns (an LSTM's cell half
    dropped): the plain MLP, as the JAX package's ``mlp.apply(..., "jnp")``
    (``ppoc_tpu/models/gru.py:132-134``)."""
    return mlp.apply(params["head"], s[..., :hidden_size(params)],
                     activation, "jnp")


def step(params: GRUParams, h: torch.Tensor, x: torch.Tensor,
         activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One trunk step: (new state, head output)."""
    h2 = cell_step(params, h, x)
    return h2, head_apply(params, h2, activation)


def keep_mask(done: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[..., 1]: 0 in lanes whose episode ended, else 1 (``like``'s
    dtype)."""
    return (~done)[..., None].to(like.dtype)


def states_seq(params: GRUParams, xs: torch.Tensor,
               reset_after: torch.Tensor,
               h0: torch.Tensor = None) -> torch.Tensor:
    """The states [T, ..., S] each step's cell produced over a window
    [T, ..., in], before the episode mask: the state feeding step t + 1 is
    state t zeroed where ``reset_after[t]`` (the episode ended AT step t).
    ``h0`` defaults to zeros (a window start).  The input products of every
    step are one product up front; autograd backpropagates through the
    loop."""
    gx = input_gates(params, xs)
    keep = keep_mask(reset_after, gx).unbind(0)
    h = initial_state(params, xs.shape[1:-1]) if h0 is None else h0
    hs = []
    for gx_t, keep_t in zip(gx.unbind(0), keep):
        h2 = cell_from_gates(params, h, gx_t)
        hs.append(h2)
        h = h2 * keep_t
    return torch.stack(hs)


def apply_seq(params: GRUParams, xs: torch.Tensor,
              reset_after: torch.Tensor, activation: str,
              h0: torch.Tensor = None) -> torch.Tensor:
    """Head outputs [T, ..., out] for a window [T, ..., in]: the head on
    every step's state (:func:`states_seq`), the JAX package's masked time
    scan (``ppoc_tpu/models/gru.py:144-173``) with the head taken once over
    the window."""
    return head_apply(params, states_seq(params, xs, reset_after, h0),
                      activation)

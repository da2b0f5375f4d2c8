"""Mixture-of-experts trunk on one device (counterpart of
``ppoc_tpu/models/moe.py``).

    gate    g = softmax(x @ Wr + br)               [..., E]
    experts h_e = MLP_e(x)                         [..., E, out]
    output  y = sum_e g_e * h_e                    [..., out]

with optional top-k gating (``moe_topk``): keep the k largest gate weights
per input, renormalise (over at least 1e-9), zero the rest.  Every expert
runs on every input, as one batched contraction per layer (``torch.einsum``
over the expert axis; the JAX package's ``jnp.einsum``, which no Pallas
kernel computes).  With ``bf16`` each contraction takes bf16 operands with
a float32 output, the "bf16" backend's product (:func:`expert_forward`).

Parameters, the JAX package's stacked layout:

    {"router":  (Wr [d_in, E], br [E]),
     "experts": [(W0 [E, d_in, h], b0 [E, h]), (W1 [E, h, h], b1 [E, h]),
                 ...]}

The router is a reference-init linear layer (gain 1); each expert an MLP
with the reference init (``models/mlp.init``), drawn in turn from the
caller's generator after the router.  Expert parallelism (``ep_axis``) is
not ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ppoc_tpu_torch.models import mlp

MoEParams = Dict[str, Any]


def is_moe(params) -> bool:
    """Structural test: does this trunk tree hold a mixture of experts?"""
    return isinstance(params, dict) and "experts" in params


def aux_setup(cfg, params, backend: str) -> Tuple[float, int]:
    """(load-balance coefficient, router top-k) for one update phase: (0.0,
    0) for a dense trunk or moe_aux_coeff 0, else the top-k the backend
    string carries, so the aux loss sees the forward's gating."""
    coeff = cfg.moe_aux_coeff if is_moe(params) else 0.0
    topk = mlp._parse_moe_backend(backend)[0] if coeff else 0
    return coeff, topk


def init(sizes: Sequence[int], n_experts: int, generator: torch.Generator,
         device) -> MoEParams:
    """Router plus ``n_experts`` stacked expert MLPs over the layer sizes
    ``sizes`` (e.g. [obs, 128, 128, act])."""
    d_in = sizes[0]
    bound_w = math.sqrt(3.0) * math.sqrt(2.0 / (d_in + n_experts))
    bound_b = 1.0 / math.sqrt(d_in)
    w = torch.rand((d_in, n_experts), generator=generator)
    b = torch.rand((n_experts,), generator=generator)
    router = ((w * 2.0 - 1.0).mul_(bound_w).to(device),
              (b * 2.0 - 1.0).mul_(bound_b).to(device))
    each = [mlp.init(sizes, generator, device) for _ in range(n_experts)]
    experts = [(torch.stack([e[layer][0] for e in each]),
                torch.stack([e[layer][1] for e in each]))
               for layer in range(len(each[0]))]
    return {"router": router, "experts": experts}


def n_experts(params: MoEParams) -> int:
    return params["experts"][0][0].shape[0]


def _topk_mask(p: torch.Tensor, k: int) -> torch.Tensor:
    """1 at each row's ``k`` largest entries, 0 elsewhere."""
    idx = torch.topk(p, k, dim=-1).indices
    return torch.zeros_like(p).scatter_(-1, idx, 1.0)


def gate_weights(params: MoEParams, x: torch.Tensor,
                 topk: int = 0) -> torch.Tensor:
    """Softmax gate over the experts, top-k masked and renormalised when
    0 < topk < E.  Returns [..., E]."""
    wr, br = params["router"]
    g = torch.softmax(x @ wr + br, dim=-1)
    if 0 < topk < g.shape[-1]:
        g = g * _topk_mask(g.detach(), topk)
        g = g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-9)
    return g


def load_balance_loss(params: MoEParams, x: torch.Tensor,
                      topk: int = 0) -> torch.Tensor:
    """Switch-style load balance, E * sum_e f_e * P_e: ``f_e`` the share of
    inputs routed to expert e (its top-k set; argmax for dense gating),
    ``P_e`` the mean router probability.  1.0 under perfect balance; the
    gradient flows through ``P_e`` only (``f_e`` is detached, the JAX
    package's stop_gradient)."""
    wr, br = params["router"]
    p = torch.softmax(x @ wr + br, dim=-1)
    e = p.shape[-1]
    k = topk if 0 < topk < e else 1
    f = _topk_mask(p.detach(), k).reshape(-1, e).mean(dim=0) / k
    return e * torch.sum(f.detach() * p.reshape(-1, e).mean(dim=0))


class _Bf16Bmm(torch.autograd.Function):
    """a [E, N, i] @ w [E, i, o] per expert on bf16 operands with a
    float32 output: ``mlp._Bf16Dot`` batched over the experts (on CUDA one
    bf16 tensor-core ``bmm`` with float32 output; on the CPU the bf16
    values multiplied in float32), its backward the float32 cotangent
    times the other bf16 operand in float32, rounded to bf16."""

    @staticmethod
    def forward(ctx, a, w):
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(ab, wb)
        if ab.is_cuda:
            return torch.bmm(ab, wb, out_dtype=torch.float32)
        return torch.bmm(ab.float(), wb.float())

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, wb.float().transpose(1, 2)).to(
                torch.bfloat16).float()
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(ab.float().transpose(1, 2), g).to(
                torch.bfloat16).float()
        return ga, gw


def expert_forward(experts, x: torch.Tensor, activation: str,
                   bf16: bool = False) -> torch.Tensor:
    """Every expert on the full batch: [..., d_in] -> [..., E, out].
    ``bf16``: each layer's contraction on bf16 operands with a float32
    output (the JAX package's ``einsum(..., preferred_element_type=
    float32)``): the first layer one ``mlp.bf16_dot`` of x against the
    experts' weights side by side, the rest one batched product over the
    experts (:class:`_Bf16Bmm`); the bias and activation in float32."""
    act = mlp._ACTIVATIONS[activation]
    w0, b0 = experts[0]
    e, d_in, width = w0.shape
    if not bf16:
        h = torch.einsum("...i,eio->...eo", x, w0) + b0
        for w, b in experts[1:]:
            h = torch.einsum("...ei,eio->...eo", act(h), w) + b
        return h
    lead = x.shape[:-1]
    h = mlp.bf16_dot(x.reshape(-1, d_in),
                     w0.permute(1, 0, 2).reshape(d_in, e * width))
    h = h.reshape(-1, e, width) + b0
    for w, b in experts[1:]:
        h = _Bf16Bmm.apply(act(h).transpose(0, 1), w).transpose(0, 1) + b
    return h.reshape(*lead, e, h.shape[-1])


def apply(params: MoEParams, x: torch.Tensor, activation: str = "relu",
          ep_axis: Optional[str] = None, topk: int = 0,
          bf16: bool = False) -> torch.Tensor:
    """Mixture forward on a batch ``x`` [..., d_in] -> [..., out]."""
    if ep_axis is not None:
        raise NotImplementedError(
            f"expert parallelism (ep_axis {ep_axis!r}, parallel/ep.py) is "
            f"not ported to ppoc_tpu_torch yet (ROADMAP.md §1 item 16)")
    g = gate_weights(params, x, topk)
    h = expert_forward(params["experts"], x, activation, bf16)
    return torch.einsum("...e,...eo->...o", g, h)

"""Dense MLP: parameters, reference-exact initialisation, forward pass.

Counterpart of ``ppoc_tpu/models/mlp.py``.  Parameters are a list of
``(W [fan_in, fan_out], b [fan_out])`` tensor pairs, the JAX package's
layout, so the two packages exchange weights without transposes
(``utils/params.py``).

  * init, per layer: gain = sqrt(2) for hidden layers and 1 for the output
    layer; std = gain * sqrt(2 / (fan_in + fan_out));
    W ~ U(-sqrt(3) std, +sqrt(3) std) and b ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)).
  * forward: ``x @ W + b`` then the activation; the last layer is linear.

The "bf16" backend (``ppoc_tpu/models/mlp.py:110-121``) rounds each
layer's input and weights to bf16 and takes the product with a float32
output, then adds the float32 bias: :func:`bf16_dot`.  Master weights stay
float32.

A mixture-of-experts tree (``models/moe.py``) dispatches structurally in
:func:`apply`, ahead of the backend switch, with the gating options the
backend string carries (:func:`moe_backend`).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Params = List[Tuple[torch.Tensor, torch.Tensor]]

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "none": lambda x: x,
}


def init(sizes: Sequence[int], generator: torch.Generator,
         device: torch.device) -> Params:
    """Initialise weights with the reference scheme; ``sizes`` is the full
    layer-size list, e.g. [obs, 128, 128, act]."""
    params: Params = []
    n = len(sizes) - 1
    for i in range(n):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        gain = 1.0 if i == n - 1 else math.sqrt(2.0)
        bound_w = math.sqrt(3.0) * gain * math.sqrt(2.0 / (fan_in + fan_out))
        bound_b = 1.0 / math.sqrt(fan_in)
        w = torch.rand((fan_in, fan_out), generator=generator)
        b = torch.rand((fan_out,), generator=generator)
        params.append(((w * 2.0 - 1.0).mul_(bound_w).to(device),
                       (b * 2.0 - 1.0).mul_(bound_b).to(device)))
    return params


def dims(params: Params) -> List[int]:
    """Layer widths [d0, d1, ..., dL]."""
    return [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]


def flatten(params: Params) -> torch.Tensor:
    """One contiguous float32 vector: W0 (row-major), b0, W1, b1, ... --
    the layout the CUDA kernels take."""
    return torch.cat([t.reshape(-1) for w, b in params for t in (w, b)])


def unflatten(flat: torch.Tensor, widths: Sequence[int]) -> Params:
    """Views of ``flat`` as a list of (W, b) pairs; inverse of flatten."""
    out, off = [], 0
    for din, dout in zip(widths[:-1], widths[1:]):
        w = flat[off: off + din * dout].view(din, dout)
        off += din * dout
        out.append((w, flat[off: off + dout]))
        off += dout
    return out


class _Bf16Dot(torch.autograd.Function):
    """a @ w on bf16 operands with a float32 output, and the JAX package's
    VJP of ``jnp.dot(a.astype(bf16), w.astype(bf16),
    preferred_element_type=float32)``: the float32 cotangent times the
    other operand (bf16-valued) in float32, the result rounded to bf16 (the
    cotangent of a bf16 operand) and carried back in float32 (the cast's
    VJP).  On CUDA the forward is one bf16 tensor-core product with float32
    output; on the CPU, which has no such product, the bf16 values are
    multiplied in float32 (exact products, float32 sums)."""

    @staticmethod
    def forward(ctx, a, w):
        ab = a.reshape(-1, a.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(ab, wb)
        ctx.a_shape = a.shape
        if ab.is_cuda:
            out = torch.mm(ab, wb, out_dtype=torch.float32)
        else:
            out = ab.float() @ wb.float()
        return out.reshape(*a.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = (g @ wb.float().T).to(torch.bfloat16).float().reshape(
                ctx.a_shape)
        if ctx.needs_input_grad[1]:
            gw = (ab.float().T @ g).to(torch.bfloat16).float()
        return ga, gw


def bf16_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ w [k, n] with both rounded to bf16 and a float32 result
    (the "bf16" backend's product; see :class:`_Bf16Dot`)."""
    return _Bf16Dot.apply(a, w)


def moe_backend(base: str, topk: int) -> str:
    """Encode a mixture's gating options as a backend string:
    "moe:<topk>", with ":bf16" when ``base`` is "bf16"."""
    return f"moe:{topk}" + (":bf16" if base == "bf16" else "")


def _parse_moe_backend(backend: str):
    """-> (topk, bf16) for a mixture under any backend string; a plain one
    ("jnp", "pallas", "bf16") means dense gating."""
    parts = backend.split(":")
    if parts[0] == "moe":
        return int(parts[1]), len(parts) > 2 and parts[2] == "bf16"
    return 0, backend == "bf16"


def apply(params: Params, x: torch.Tensor, activation: str = "relu",
          backend: str = "jnp") -> torch.Tensor:
    """Forward pass on a batch ``x`` of shape [..., fan_in].

    A mixture-of-experts tree goes to ``moe.apply`` whatever the backend,
    with the top-k and bf16 options :func:`_parse_moe_backend` reads from
    it; no kernel of the port runs there.

    ``backend="pallas"`` runs the whole-MLP kernel K5
    (``ops/cuda_mlp.py``, the port of ``ops/pallas_mlp.py``): on a CUDA
    tensor its forward and backward kernels, on a CPU tensor their plain
    versions.  ``backend="bf16"`` takes each layer's product on bf16
    operands with a float32 output (:func:`bf16_dot`), the bias and the
    activation in float32, as the JAX package's "bf16" backend; no kernel
    of the port runs.  ``backend="jnp"`` is the plain PyTorch forward.
    """
    from ppoc_tpu_torch.models import moe

    if moe.is_moe(params):
        topk, bf16 = _parse_moe_backend(backend)
        return moe.apply(params, x, activation, topk=topk, bf16=bf16)
    if backend == "pallas":
        from ppoc_tpu_torch.ops import cuda_mlp

        return cuda_mlp.mlp_forward(params, x, activation)
    if backend not in ("jnp", "bf16"):
        raise NotImplementedError(f"MLP backend {backend!r} is not ported")
    dot = bf16_dot if backend == "bf16" else torch.matmul
    act = _ACTIVATIONS[activation]
    h = x
    for i, (w, b) in enumerate(params):
        h = dot(h, w) + b
        if i < len(params) - 1:
            h = act(h)
    return h

"""Dense MLP: parameters, reference-exact initialisation, forward pass.

Counterpart of ``ppoc_tpu/models/mlp.py``.  Parameters are a list of
``(W [fan_in, fan_out], b [fan_out])`` tensor pairs, the JAX package's
layout, so the two packages exchange weights without transposes
(``utils/params.py``).

  * init, per layer: gain = sqrt(2) for hidden layers and 1 for the output
    layer; std = gain * sqrt(2 / (fan_in + fan_out));
    W ~ U(-sqrt(3) std, +sqrt(3) std) and b ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)).
  * forward: ``x @ W + b`` then the activation; the last layer is linear.
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


def apply(params: Params, x: torch.Tensor, activation: str = "relu",
          backend: str = "jnp") -> torch.Tensor:
    """Forward pass on a batch ``x`` of shape [..., fan_in].

    ``backend="pallas"`` runs the whole-MLP kernel K5
    (``ops/cuda_mlp.py``, the port of ``ops/pallas_mlp.py``): on a CUDA
    tensor its forward and backward kernels, on a CPU tensor their plain
    versions.  ``backend="jnp"`` is the plain PyTorch forward below.
    """
    if backend == "pallas":
        from ppoc_tpu_torch.ops import cuda_mlp

        return cuda_mlp.mlp_forward(params, x, activation)
    act = _ACTIVATIONS[activation]
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = act(h)
    return h

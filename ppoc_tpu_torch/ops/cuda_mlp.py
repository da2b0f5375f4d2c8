"""K5: the whole-MLP forward and backward (``csrc/mlp.cu``) and their plain
versions.

Counterpart of ``ppoc_tpu/ops/pallas_mlp.py`` ``mlp_forward``, a custom VJP:
the forward runs every layer (``x @ W + b``, the activation fused, the last
layer linear) and saves each hidden post-activation; the backward computes
dW/db of every layer and dX, taking the activation derivative from the
saved post-activation.  :class:`MLPForward` binds the two halves as a
``torch.autograd.Function``; on a CUDA tensor each half launches its
kernel, on a CPU tensor it runs its plain version.  The backward skips dX
when autograd does not need it (``ctx.needs_input_grad``).

Each half has two variants (``_build.VARIANTS``): the weights in one
block's shared memory, or, for nets larger than that (the reacher regime's
2x256), in global memory, staged a slice at a time.  The launch picks the
first that fits, by size; the launch counts are kept per variant.

K3/K4's plain versions (``cuda_update.py``) are built from the same plain
forward and backward (:func:`forward_layers`, :func:`backward_layers`).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import _build

fwd_launches = _build.LaunchCount("mlp_forward")
bwd_launches = _build.LaunchCount("mlp_backward")
fwd_global_launches = _build.LaunchCount("mlp_forward_global")
bwd_global_launches = _build.LaunchCount("mlp_backward_global")

_MAX_LAYERS = 8   # csrc/common.cuh MAX_LAYERS


# --- plain versions -------------------------------------------------------

def act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(h)
    if activation == "tanh":
        return torch.tanh(h)
    if activation == "none":
        return h
    raise ValueError(f"unknown activation {activation!r}")


def act_grad(h_out: torch.Tensor, activation: str) -> torch.Tensor:
    """Activation derivative from the post-activation value
    (``pallas_mlp._act_grad_from_out``)."""
    if activation == "relu":
        return (h_out > 0).to(h_out.dtype)
    if activation == "tanh":
        return 1.0 - h_out * h_out
    return torch.ones_like(h_out)


def forward_layers(x, W: Sequence[torch.Tensor], B: Sequence[torch.Tensor],
                   activation: str) -> List[torch.Tensor]:
    """Post-activations of every layer (the last one linear)."""
    hs, h = [], x
    for l, (w, b) in enumerate(zip(W, B)):
        h = h @ w + b
        if l < len(W) - 1:
            h = act(h, activation)
        hs.append(h)
    return hs


def backward_layers(x, hs, g, W, activation: str, need_dx: bool = False):
    """(flat [dW0, db0, dW1, db1, ...], dX or None) from the output
    cotangent ``g`` and the post-activations ``hs`` of :func:`forward_layers`
    (only the hidden ones are read)."""
    grads = [None] * (2 * len(W))
    dx = None
    for l in range(len(W) - 1, -1, -1):
        a_in = x if l == 0 else hs[l - 1]
        grads[2 * l] = a_in.T @ g
        grads[2 * l + 1] = g.sum(dim=0)
        if l > 0:
            g = (g @ W[l].T) * act_grad(hs[l - 1], activation)
        elif need_dx:
            dx = g @ W[0].T
    return grads, dx


def mlp_forward_plain(params, x: torch.Tensor, activation: str):
    """Plain version of K5's forward on x [B, d0]; returns (out [B, dL],
    [hidden post-activations])."""
    hs = forward_layers(x, [w for w, _ in params], [b for _, b in params],
                        activation)
    return hs[-1], hs[:-1]


def mlp_backward_plain(params, x: torch.Tensor, hiddens, g: torch.Tensor,
                       activation: str, need_dx: bool = True):
    """Plain version of K5's backward; returns ([(dW, db), ...], dX or
    None)."""
    flat, dx = backward_layers(x, list(hiddens) + [None], g,
                               [w for w, _ in params], activation, need_dx)
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)], dx


# --- the kernels ----------------------------------------------------------

class _MlpArgs(ctypes.Structure):
    """Mirror of `struct MlpArgs` in csrc/mlp.cu."""
    _fields_ = [
        ("params", ctypes.c_void_p), ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("hidden", ctypes.c_void_p * _MAX_LAYERS),
        ("g", ctypes.c_void_p), ("dx", ctypes.c_void_p),
        ("partial", ctypes.c_void_p), ("grads", ctypes.c_void_p),
        ("dims", ctypes.POINTER(ctypes.c_int)),
        ("n_layers", ctypes.c_int), ("activation", ctypes.c_int),
        ("B", ctypes.c_int), ("variant", ctypes.c_int),
    ]


def _declare() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_mlp_declared", False):
        lib.ppoc_mlp_args_size.restype = ctypes.c_int
        if lib.ppoc_mlp_args_size() != ctypes.sizeof(_MlpArgs):
            raise RuntimeError("MlpArgs layout differs between csrc/mlp.cu "
                               "and cuda_mlp.py")
        args = [ctypes.POINTER(_MlpArgs)]
        lib.ppoc_mlp_sizes.argtypes = args + [ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_long)]
        lib.ppoc_mlp_sizes.restype = ctypes.c_int
        for fn in (lib.ppoc_mlp_forward, lib.ppoc_mlp_backward):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._mlp_declared = True
    return lib


_TILE, _TILE_L, _SLICE = 64, 32, 32   # csrc/mlp.cu TILE, TILE_L, SLICE


def variant_bytes(widths: Sequence[int]) -> List[int]:
    """Shared memory K5 needs on the net ``widths`` in each variant
    (``_build.VARIANTS``), in bytes: the larger of the forward's and the
    backward's (the launch picks a variant both fit), which is the
    backward's three row tiles, plus the padded weights or one staged weight
    slice.  The same as csrc/mlp.cu ``smem_bytes`` (a card test holds the
    two together); the batch does not enter."""
    dmax = max(widths)
    padded = sum(a * (b + 1) + b for a, b in zip(widths[:-1], widths[1:]))
    return [4 * (padded + 3 * _TILE * dmax),
            4 * (3 * _TILE_L * dmax + _SLICE * (dmax + 1))]


def _args(params, x: torch.Tensor, hiddens, activation: str,
          variant=None):
    """Argument block, the chosen variant's sizes and the host arrays it
    points to.  The variant is the first whose forward and backward both
    fit in shared memory, unless ``variant`` names one."""
    dev = x.device
    widths = mlp.dims(params)
    if not 1 <= len(widths) - 1 <= _MAX_LAYERS:
        raise ValueError(f"K5 takes 1-{_MAX_LAYERS} layers, got {widths}")
    if activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    flat = mlp.flatten(params)
    _build.require(x, "x", (x.shape[0], widths[0]), device=dev)
    _build.require(flat, "params", device=dev)
    if x.shape[0] < 1:
        raise ValueError("K5 takes a batch of at least one row")
    for h, d in zip(hiddens, widths[1:-1]):
        _build.require(h, "hidden activations", (x.shape[0], d), device=dev)
    dims = (ctypes.c_int * len(widths))(*widths)
    args = _MlpArgs(params=flat.data_ptr(), x=x.data_ptr(), dims=dims,
                    n_layers=len(widths) - 1,
                    activation=_build.ACTIVATIONS[activation],
                    B=x.shape[0])
    for i, h in enumerate(hiddens):
        args.hidden[i] = h.data_ptr()
    lib = _declare()
    sizes = [(ctypes.c_long * 4)() for _ in _build.VARIANTS]
    for v, out in enumerate(sizes):
        if not lib.ppoc_mlp_sizes(ctypes.byref(args), v, out):
            raise ValueError(f"K5 refuses widths {widths} at batch "
                             f"{x.shape[0]}")
    args.variant = _build.pick_variant(
        [max(n[0], n[1]) for n in sizes], _build.smem_optin(dev), variant,
        f"K5 for widths {widths}")
    return lib, args, sizes[args.variant], widths, (flat, dims)


def mlp_forward_kernel(params, x: torch.Tensor, activation: str,
                       variant=None):
    """Launch K5's forward; same arguments and results as
    mlp_forward_plain (``variant``: see :func:`_args`)."""
    widths = mlp.dims(params)
    f32 = dict(dtype=torch.float32, device=x.device)
    hiddens = [torch.empty(x.shape[0], d, **f32) for d in widths[1:-1]]
    lib, args, _, _, keep = _args(params, x, hiddens, activation, variant)
    out = torch.empty(x.shape[0], widths[-1], **f32)
    args.out = out.data_ptr()
    _build.check(lib, lib.ppoc_mlp_forward(ctypes.byref(args),
                                           _build.stream_of(x.device)),
                 "K5 forward")
    del keep
    (fwd_global_launches if args.variant else fwd_launches).n += 1
    return out, hiddens


def mlp_backward_kernel(params, x: torch.Tensor, hiddens, g: torch.Tensor,
                        activation: str, need_dx: bool = True, variant=None):
    """Launch K5's backward (the tile kernel and the fixed-order sum of its
    partials); same arguments and results as mlp_backward_plain
    (``variant``: see :func:`_args`)."""
    lib, args, sizes, widths, keep = _args(params, x, hiddens, activation,
                                           variant)
    dev = x.device
    _build.require(g, "output cotangent", (x.shape[0], widths[-1]),
                   device=dev)
    partial = torch.empty(sizes[2], sizes[3], dtype=torch.float32,
                          device=dev)
    grads = torch.empty(sizes[3], dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    args.g, args.dx = g.data_ptr(), _build.ptr(dx)
    args.partial, args.grads = partial.data_ptr(), grads.data_ptr()
    _build.check(lib, lib.ppoc_mlp_backward(ctypes.byref(args),
                                            _build.stream_of(dev)),
                 "K5 backward")
    del keep
    (bwd_global_launches if args.variant else bwd_launches).n += 1
    return mlp.unflatten(grads, widths), dx


class MLPForward(torch.autograd.Function):
    """K5 as an autograd function on a 2-D batch: ``apply(activation, x,
    W0, b0, W1, b1, ...)``; its backward is K5's backward kernel (the plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, activation: str, x: torch.Tensor, *leaves):
        params = _pairs(leaves)
        run = mlp_forward_kernel if x.is_cuda else mlp_forward_plain
        out, hiddens = run(params, x, activation)
        ctx.activation = activation
        ctx.save_for_backward(x, *leaves, *hiddens)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, *rest = ctx.saved_tensors
        n = 2 * ((len(rest) + 1) // 3)        # 2L leaves, L - 1 hiddens
        params, hiddens = _pairs(rest[:n]), rest[n:]
        need_dx = ctx.needs_input_grad[1]
        run = mlp_backward_kernel if g.is_cuda else mlp_backward_plain
        grads, dx = run(params, x, hiddens, g.contiguous(), ctx.activation,
                        need_dx)
        return (None, dx, *(t for pair in grads for t in pair))


def _pairs(leaves) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


def mlp_forward(params, x: torch.Tensor, activation: str = "relu"
                ) -> torch.Tensor:
    """K5 on a batch ``x`` of shape [..., d0] (any leading dims): hidden
    layers use ``activation``, the last layer is linear -- the semantics of
    ``pallas_mlp.mlp_forward``.  Differentiable in the params and ``x``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    leaves = [t.contiguous() for pair in params for t in pair]
    out = MLPForward.apply(activation, x2, *leaves)
    return out.reshape(*lead, out.shape[-1])

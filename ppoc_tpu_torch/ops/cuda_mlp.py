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

The kernels run their products on the tensor cores, float32-accurate
(3xTF32: each operand split into two tf32 values, three ``mma.sync`` a
k-step; :func:`tf32_dot` emulates the split for the CPU tests).  Each half
has two variants (``_build.VARIANTS``): the weights in one block's shared
memory, or, for nets larger than that (the reacher regime's 2x256), in
global memory, staged a slice at a time.  The launch picks the first that
fits, by size, and a row tile by the batch (:func:`tile_for`); the launch
counts are kept per variant, the last launch's plan in :data:`last_launch`.

K3/K4's plain versions (``cuda_update.py``) are built from the same plain
forward and backward (:func:`forward_layers`, :func:`backward_layers`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` as ``cvt.rna.tf32.f32`` rounds it: to a 10-bit
    mantissa, to nearest with ties away from zero (the low 13 bits
    cleared)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_dot(a: torch.Tensor, b: torch.Tensor, terms: int = 3
             ) -> torch.Tensor:
    """``a @ b`` (float32 operands) from the tf32 split K5's products take,
    with the sums in float64: each operand x as big = tf32_round(x) and
    small = tf32_round(x - big); ``terms`` 3 sums a_small b_big + a_big
    b_small + a_big b_big (3xTF32), 1 sums a_big b_big alone (one-term
    TF32).  A product of two tf32 values is exact in float64, so this
    shows what the split keeps and drops, apart from the sums' rounding.
    Used only by the checks of the split."""
    ab, bb = tf32_round(a), tf32_round(b)
    out = ab.double() @ bb.double()
    if terms == 3:
        a_s, b_s = tf32_round(a - ab), tf32_round(b - bb)
        out = a_s.double() @ bb.double() + ab.double() @ b_s.double() + out
    elif terms != 1:
        raise ValueError(f"terms is 3 or 1, got {terms}")
    return out


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
        ("tile", ctypes.c_int), ("grid", ctypes.c_int),
        ("cluster", ctypes.c_int),
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
        lib.ppoc_mlp_resident.argtypes = args + [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
        lib.ppoc_mlp_resident.restype = ctypes.c_int
        for fn in (lib.ppoc_mlp_forward, lib.ppoc_mlp_backward):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._mlp_declared = True
    return lib


# csrc/mlp.cu: row tiles (multiples of the mma's 16 rows), the k rows of a
# staged weight slice and a dX slice's row stride, the dW stage (8 warps'
# 32 x 32 tiles; twice that in variant 1) and the most blocks a backward
# cluster sums
TILES = tuple(range(16, 129, 16))
_KS, _XS_LD, _STAGE, CLUSTER = 32, 40, 8 * 32 * 32, 16


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(widths: Sequence[int], variant: int, backward: bool,
               tile: int = TILES[0]) -> int:
    """Dynamic shared memory of K5's forward or backward on the net
    ``widths`` in ``variant`` (index into ``_build.VARIANTS``) at ``tile``
    rows: two activation tiles (rows of the widest layer, 8 mod 16
    floats), plus in variant 0 every weight in the layout the fragments
    read (rows padded to 8, the forward's W rows 4 mod 8 floats with the
    biases, the backward's 8 mod 16) and the backward's dW stage and db
    column sums, in variant 1 a double buffer of weight slices (the
    backward's holds the stage and sums between its dX slices).  The same
    as csrc/mlp.cu ``smem_bytes`` (a card test holds the two together at
    every tile)."""
    dmax = max(widths)
    floats = 2 * tile * (_pad(dmax, 16) + 8)
    pairs = list(zip(widths[:-1], widths[1:]))
    if not backward:
        if variant == 0:
            floats += sum(_pad(a, 8) * (_pad(b, 8) + 4) + _pad(b, 8)
                          for a, b in pairs)
        else:
            floats += 2 * _KS * (_pad(dmax, 8) + 4)
    elif variant == 0:
        floats += sum(_pad(a, 8) * (_pad(b + 8, 16) - 8) for a, b in pairs)
        floats += _STAGE + _pad(dmax, 8)
    else:
        floats += max(2 * _pad(dmax, 8) * _XS_LD,
                      2 * _STAGE + _pad(dmax, 8))
    return 4 * floats


def variant_bytes(widths: Sequence[int]) -> List[int]:
    """Shared memory K5 needs on the net ``widths`` in each variant
    (``_build.VARIANTS``), in bytes: the larger of the forward's and the
    backward's (the launch picks a variant both fit) at the smallest row
    tile, which a launch can always take (:func:`smem_bytes`); the batch
    does not enter."""
    return [max(smem_bytes(widths, v, False), smem_bytes(widths, v, True))
            for v in range(len(_build.VARIANTS))]


def cluster_for(n_tiles: int) -> int:
    """Blocks a cluster of K5's backward: the smallest power of two that
    covers ``n_tiles``, at most :data:`CLUSTER`."""
    c = 1
    while c < min(CLUSTER, n_tiles):
        c *= 2
    return c


def tile_for(rows: int, resident: Dict[int, int]) -> int:
    """The row tile of a launch over ``rows`` rows, given ``resident``:
    each tile whose shared memory fits a block -> the blocks of it the card
    holds at once.  The smallest tile whose grid fits in one wave, else the
    largest (its blocks then loop over tiles)."""
    for tile in sorted(resident):
        if -(-rows // tile) <= resident[tile]:
            return tile
    return max(resident)


# the last launch of each direction: {"variant", "tile", "blocks",
# "cluster", "resident"}
last_launch: Dict[str, dict] = {}
_plans: Dict[tuple, dict] = {}


def _plan(lib, args, widths, rows: int, dev, variant, backward: bool,
          tile=None):
    """The variant (the first whose forward and backward both fit in shared
    memory at the smallest tile, unless ``variant`` names one), the row
    tile (:func:`tile_for` over the tiles that fit, unless ``tile`` forces
    one of them), the grid and the backward's cluster of a launch; cached
    by shape."""
    key = (dev.index, tuple(widths), rows, variant, backward, tile)
    if key in _plans:
        return _plans[key]
    optin = _build.smem_optin(dev)
    sizes = (ctypes.c_long * 4)()
    small = []
    for v in range(len(_build.VARIANTS)):
        args.tile = TILES[0]
        if not lib.ppoc_mlp_sizes(ctypes.byref(args), v, sizes):
            raise ValueError(f"K5 refuses widths {widths} at batch {rows}")
        small.append(max(sizes[0], sizes[1]))
    v = _build.pick_variant(small, optin, variant, f"K5 for widths {widths}")
    resident, clusters, out = {}, {}, (ctypes.c_long * 1)()
    for t in TILES:
        args.tile = t
        lib.ppoc_mlp_sizes(ctypes.byref(args), v, sizes)
        if sizes[int(backward)] > optin:
            break
        args.cluster = clusters[t] = (cluster_for(-(-rows // t)) if backward
                                      else 1)
        _build.check(lib, lib.ppoc_mlp_resident(ctypes.byref(args), v,
                                                int(backward), out),
                     "K5 occupancy query")
        if out[0] >= clusters[t]:
            resident[t] = out[0]
    what = f"K5's {('forward', 'backward')[backward]} on widths {widths}"
    if tile is not None and tile not in resident:
        raise ValueError(f"{what} takes no {tile}-row tile on this card "
                         f"(it takes {sorted(resident)})")
    if not resident:
        raise ValueError(f"{what} fits no block of the card")
    tile = tile_for(rows, resident) if tile is None else tile
    n_tiles, c = -(-rows // tile), clusters[tile]
    grid = (min(-(-n_tiles // c), resident[tile] // c) * c if backward
            else min(n_tiles, resident[tile]))
    _plans[key] = plan = dict(variant=v, tile=tile, blocks=grid, cluster=c,
                              resident=resident[tile],
                              n_params=int(sizes[3]))
    return plan


def launch_plan(widths: Sequence[int], rows: int, backward: bool,
                variant=None, tile=None, device=None) -> dict:
    """The plan (:func:`_plan`) of a K5 launch over ``rows`` rows of the
    net ``widths`` on ``device`` (default: CUDA device 0), without
    launching: {"variant", "tile", "blocks", "cluster", "resident",
    "n_params"}."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    dims = (ctypes.c_int * len(widths))(*widths)
    args = _MlpArgs(dims=dims, n_layers=len(widths) - 1, B=rows)
    return _plan(_declare(), args, list(widths), rows, dev, variant,
                 backward, tile)


def _args(params, x: torch.Tensor, hiddens, activation: str, variant,
          backward: bool, tile=None):
    """Argument block, its launch plan (:func:`_plan`) and the host arrays
    it points to."""
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
    plan = _plan(lib, args, widths, x.shape[0], dev, variant, backward,
                 tile)
    args.variant, args.tile = plan["variant"], plan["tile"]
    args.grid, args.cluster = plan["blocks"], plan["cluster"]
    return lib, args, plan, widths, (flat, dims)


def mlp_forward_kernel(params, x: torch.Tensor, activation: str,
                       variant=None, tile=None):
    """Launch K5's forward; same arguments and results as
    mlp_forward_plain (``variant``: "smem" or "global", and ``tile``, rows
    a block's tile, force a choice of :func:`_plan`: tests and timing)."""
    widths = mlp.dims(params)
    f32 = dict(dtype=torch.float32, device=x.device)
    hiddens = [torch.empty(x.shape[0], d, **f32) for d in widths[1:-1]]
    lib, args, plan, _, keep = _args(params, x, hiddens, activation, variant,
                                     False, tile)
    out = torch.empty(x.shape[0], widths[-1], **f32)
    args.out = out.data_ptr()
    _build.check(lib, lib.ppoc_mlp_forward(ctypes.byref(args),
                                           _build.stream_of(x.device)),
                 "K5 forward")
    del keep
    (fwd_global_launches if args.variant else fwd_launches).n += 1
    last_launch["forward"] = plan
    return out, hiddens


def mlp_backward_kernel(params, x: torch.Tensor, hiddens, g: torch.Tensor,
                        activation: str, need_dx: bool = True, variant=None,
                        tile=None):
    """Launch K5's backward (the tile kernel, whose clusters sum their
    dW/db partials into one row a cluster, and the fixed-order sum of those
    rows); same arguments and results as mlp_backward_plain (``variant``,
    ``tile``: see :func:`mlp_forward_kernel`)."""
    lib, args, plan, widths, keep = _args(params, x, hiddens, activation,
                                          variant, True, tile)
    dev = x.device
    _build.require(g, "output cotangent", (x.shape[0], widths[-1]),
                   device=dev)
    partial = torch.empty(plan["blocks"] // plan["cluster"],
                          plan["n_params"], dtype=torch.float32, device=dev)
    grads = torch.empty(plan["n_params"], dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    args.g, args.dx = g.data_ptr(), _build.ptr(dx)
    args.partial, args.grads = partial.data_ptr(), grads.data_ptr()
    _build.check(lib, lib.ppoc_mlp_backward(ctypes.byref(args),
                                            _build.stream_of(dev)),
                 "K5 backward")
    del keep
    (bwd_global_launches if args.variant else bwd_launches).n += 1
    last_launch["backward"] = plan
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

"""Interop with the reference ppo.c's binary checkpoint format.

Counterpart of ``ppoc_tpu/utils/ref_interop.py``: reads and writes the
byte layout of the C/CUDA reference's ``save_ppo`` / ``load_ppo``: 5 f32
hyperparameters, 3 i32 buffer dims, the Gaussian policy (f32[action]
log_std and the mean net), the V net (i32 node count, i32 output size,
per hidden layer a NUL-terminated activation name with an i32 length
prefix, then per layer i32 input/output sizes, row-major [out, in] weights
and biases), and the three Adam states (i32 size, i32 timestep, f32
beta1/beta2, i32 tensor count, then flat f32 m and v in (W0, b0, W1, b1,
...) order).

The reference stores W as [out, in] (out = x @ W.T + b); the port, like
the JAX package, stores [in, out].  The transpose is applied in both
directions, including inside the flat Adam moments.  Only Gaussian
policies on dense trunks exist in the reference, so discrete policies and
other trunks are refused.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, List, NamedTuple, Tuple

import numpy as np

_KNOWN_ACTIVATIONS = ("relu", "tanh", "none")


class RefNet(NamedTuple):
    params: List[Tuple[np.ndarray, np.ndarray]]  # [(W [in,out], b)]
    activations: List[str]                       # per layer incl. final


class RefAdam(NamedTuple):
    m: Any            # like the owning params
    v: Any
    t: int
    beta1: float
    beta2: float


class RefCheckpoint(NamedTuple):
    lam: float
    clip_eps: float
    ent_coeff: float
    lr_policy: float
    lr_v: float
    state_size: int
    action_size: int
    capacity: int     # the reference's steps_per_fit buffer size
    log_std: np.ndarray
    policy_net: RefNet
    v_net: RefNet
    adam_policy: RefAdam
    adam_v: RefAdam
    adam_log_std: RefAdam


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError(
            f"truncated reference checkpoint (wanted {size} bytes)")
    out = struct.unpack("<" + fmt, data)
    return out[0] if len(out) == 1 else out


def _read_f32(f: BinaryIO, n: int) -> np.ndarray:
    data = f.read(4 * n)
    if len(data) != 4 * n:
        raise ValueError(
            f"truncated reference checkpoint (wanted {4 * n} floats)")
    return np.frombuffer(data, "<f4", n).copy()


def _read_net(f: BinaryIO) -> RefNet:
    num_layers = _read(f, "i")          # node count
    _read(f, "i")                       # output size
    if not (2 <= num_layers <= 64):
        raise ValueError(
            f"implausible reference net num_layers={num_layers}")
    acts = []
    for _ in range(num_layers - 1):
        length = _read(f, "i")          # strlen + 1
        raw = f.read(length)
        if len(raw) != length:
            raise ValueError("truncated activation string")
        name = raw.split(b"\0", 1)[0].decode("ascii", "replace")
        # the reference maps an unknown name to the identity
        acts.append(name if name in _KNOWN_ACTIVATIONS else "none")
    params = []
    for _ in range(num_layers - 1):
        fan_in, fan_out = _read(f, "ii")
        w = _read_f32(f, fan_in * fan_out).reshape(fan_out, fan_in)
        b = _read_f32(f, fan_out)
        params.append((np.ascontiguousarray(w.T), b))
    return RefNet(params=params, activations=acts)


def _split_flat_like(flat: np.ndarray, params) -> Any:
    """A reference flat Adam vector ((W0, b0, W1, b1, ...) with row-major
    [out, in] W blocks) as a tree like ``params`` ([(W [in,out], b), ...]
    or one array for log_std)."""
    if isinstance(params, np.ndarray):
        if flat.size != params.size:
            raise ValueError(
                f"Adam state size {flat.size} != params size {params.size}")
        return flat.reshape(params.shape)
    out, off = [], 0
    for w, b in params:
        fan_in, fan_out = w.shape
        wm = flat[off: off + w.size].reshape(fan_out, fan_in).T
        off += w.size
        bm = flat[off: off + b.size]
        off += b.size
        out.append((np.ascontiguousarray(wm), bm.copy()))
    if off != flat.size:
        raise ValueError(f"Adam state size {flat.size} != params size {off}")
    return out


def _flatten_like(tree) -> np.ndarray:
    """Inverse of :func:`_split_flat_like`."""
    if isinstance(tree, np.ndarray):
        return np.asarray(tree, "<f4").reshape(-1)
    blocks = []
    for w, b in tree:
        blocks.append(np.asarray(w, "<f4").T.reshape(-1))   # [out,in]
        blocks.append(np.asarray(b, "<f4").reshape(-1))
    return np.concatenate(blocks) if blocks else np.zeros((0,), "<f4")


def _read_adam(f: BinaryIO, params) -> RefAdam:
    size, t = _read(f, "ii")
    beta1, beta2 = _read(f, "ff")
    _read(f, "i")                       # tensor count
    m = _read_f32(f, size)
    v = _read_f32(f, size)
    return RefAdam(m=_split_flat_like(m, params),
                   v=_split_flat_like(v, params),
                   t=int(t), beta1=float(beta1), beta2=float(beta2))


def read_reference(path: str) -> RefCheckpoint:
    """Parse a reference ``save_ppo`` file into numpy trees (the port's W
    layout)."""
    with open(path, "rb") as f:
        lam, clip_eps, ent_coeff, lr_policy, lr_v = _read(f, "fffff")
        state_size, action_size, capacity = _read(f, "iii")
        log_std = _read_f32(f, action_size)
        policy_net = _read_net(f)
        v_net = _read_net(f)
        adam_policy = _read_adam(f, policy_net.params)
        adam_v = _read_adam(f, v_net.params)
        adam_log_std = _read_adam(f, log_std)
        trailing = f.read(1)
    if trailing:
        raise ValueError(f"{path}: trailing bytes after reference checkpoint")
    return RefCheckpoint(
        lam=float(lam), clip_eps=float(clip_eps), ent_coeff=float(ent_coeff),
        lr_policy=float(lr_policy), lr_v=float(lr_v),
        state_size=int(state_size), action_size=int(action_size),
        capacity=int(capacity), log_std=log_std,
        policy_net=policy_net, v_net=v_net,
        adam_policy=adam_policy, adam_v=adam_v, adam_log_std=adam_log_std)


def _write_net(f: BinaryIO, net: RefNet) -> None:
    f.write(struct.pack("<ii", len(net.params) + 1,
                        net.params[-1][0].shape[1]))
    for name in net.activations:
        raw = name.encode("ascii") + b"\0"
        f.write(struct.pack("<i", len(raw)))
        f.write(raw)
    for w, b in net.params:
        fan_in, fan_out = w.shape
        f.write(struct.pack("<ii", fan_in, fan_out))
        f.write(np.asarray(w, "<f4").T.tobytes())      # [out,in] row-major
        f.write(np.asarray(b, "<f4").tobytes())


def _write_adam(f: BinaryIO, a: RefAdam) -> None:
    m = _flatten_like(a.m)
    v = _flatten_like(a.v)
    n_tensors = 1 if isinstance(a.m, np.ndarray) else 2 * len(a.m)
    f.write(struct.pack("<iiffi", m.size, a.t, a.beta1, a.beta2, n_tensors))
    f.write(m.tobytes())
    f.write(v.tobytes())


def write_reference(path: str, ck: RefCheckpoint) -> None:
    """Write a file byte-compatible with the reference's ``load_ppo``."""
    with open(path, "wb") as f:
        f.write(struct.pack("<fffff", ck.lam, ck.clip_eps, ck.ent_coeff,
                            ck.lr_policy, ck.lr_v))
        f.write(struct.pack("<iii", ck.state_size, ck.action_size,
                            ck.capacity))
        f.write(np.asarray(ck.log_std, "<f4").tobytes())
        _write_net(f, ck.policy_net)
        _write_net(f, ck.v_net)
        _write_adam(f, ck.adam_policy)
        _write_adam(f, ck.adam_v)
        _write_adam(f, ck.adam_log_std)


# --------------------------------------------------------------------------
# Trainer-level conversions
# --------------------------------------------------------------------------

def _net_activation(net: RefNet) -> str:
    """The single hidden-activation name a PPOConfig carries."""
    hidden = net.activations[:-1]
    if net.activations and net.activations[-1] != "none":
        raise ValueError(
            f"reference net has non-linear output activation "
            f"{net.activations[-1]!r}; not representable here")
    if hidden and len(set(hidden)) != 1:
        raise ValueError(
            f"reference net mixes hidden activations {hidden}; "
            f"PPOConfig.activation is uniform")
    return hidden[0] if hidden else "none"


def load_trainer(path: str, env: str, device=None, **overrides):
    """A :class:`~ppoc_tpu_torch.algo.trainer.Trainer` from a reference
    ``ppo_model.bin``: hyperparameters, net shapes, weights, log_std and
    all three Adam (m, v, t) states come from the file.  The file names no
    env, only (state, action) dims, so the caller names the env and the
    dims are checked against it; the rollout schedule is the port's
    (``overrides``).  ``device`` as ``Trainer``'s: CUDA device 0 unless
    given."""
    from ppoc_tpu_torch import envs as envs_mod
    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.algo.trainer import Trainer
    from ppoc_tpu_torch.config import PPOConfig
    from ppoc_tpu_torch.ops.adam import AdamState
    from ppoc_tpu_torch.utils import params

    ck = read_reference(path)
    hidden = tuple(int(w.shape[1]) for w, _ in ck.policy_net.params[:-1])
    cfg = PPOConfig(
        env=env, hidden=hidden, activation=_net_activation(ck.policy_net),
        lam=ck.lam, clip_eps=ck.clip_eps, ent_coeff=ck.ent_coeff,
        lr_policy=ck.lr_policy, lr_v=ck.lr_v,
        adam_beta1=ck.adam_policy.beta1, adam_beta2=ck.adam_policy.beta2,
    ).replace(**overrides)
    spec = envs_mod.make(env).spec
    if spec.discrete:
        raise ValueError(
            f"env {env!r} is discrete; reference checkpoints are Gaussian")
    if (spec.obs_dim, spec.action_dim) != (ck.state_size, ck.action_size):
        raise ValueError(
            f"env {env!r} dims ({spec.obs_dim}, {spec.action_dim}) != "
            f"checkpoint dims ({ck.state_size}, {ck.action_size})")

    def adam(a: RefAdam) -> AdamState:
        return AdamState(m=a.m, v=a.v, t=a.t)

    tr = Trainer(cfg, device)
    tr.state = params.train_state_from_numpy(ppo.TrainState(
        policy_params={"mlp": ck.policy_net.params, "log_std": ck.log_std},
        v_params=ck.v_net.params,
        opt_policy=adam(ck.adam_policy), opt_v=adam(ck.adam_v),
        opt_log_std=adam(ck.adam_log_std)), tr.device)
    return tr


def export_trainer(trainer, path: str) -> None:
    """Write the trainer's state as a reference-``load_ppo``-compatible
    file (inverse of :func:`load_trainer`)."""
    from ppoc_tpu_torch.utils import params

    cfg = trainer.cfg
    spec = trainer.env.spec
    state = params.train_state_to_numpy(trainer.state)
    if spec.discrete or "log_std" not in state.policy_params:
        raise ValueError(
            "reference checkpoints only represent Gaussian policies")
    pol = state.policy_params["mlp"]
    if not isinstance(pol, list):
        raise ValueError(
            "reference checkpoints only represent dense MLP trunks; an "
            "attention (or mixture-of-experts) trunk has no "
            "load_ppo-compatible layout")
    acts = [cfg.activation] * (len(pol) - 1) + ["none"]

    def ref_adam(opt) -> RefAdam:
        return RefAdam(m=opt.m, v=opt.v, t=int(opt.t),
                       beta1=cfg.adam_beta1, beta2=cfg.adam_beta2)

    write_reference(path, RefCheckpoint(
        lam=cfg.lam, clip_eps=cfg.clip_eps, ent_coeff=cfg.ent_coeff,
        lr_policy=cfg.lr_policy, lr_v=cfg.lr_v,
        state_size=spec.obs_dim, action_size=spec.action_dim,
        capacity=cfg.steps_per_fit, log_std=state.policy_params["log_std"],
        policy_net=RefNet(params=pol, activations=acts),
        v_net=RefNet(params=state.v_params, activations=acts),
        adam_policy=ref_adam(state.opt_policy),
        adam_v=ref_adam(state.opt_v),
        adam_log_std=ref_adam(state.opt_log_std)))

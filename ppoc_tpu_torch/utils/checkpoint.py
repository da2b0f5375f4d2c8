"""Binary checkpointing of the full training state.

Counterpart of ``ppoc_tpu/utils/checkpoint.py``, writing and reading the
same bytes: the ``"PPOC"`` magic, the version, the full config as JSON
(with run metadata under its reserved ``"_meta"`` key), the key slot, the
five scalar hyperparameters, the dims, log_std, the policy and value
trunks, and the three Adam states (m, v and the timestep), each flattened
in the JAX package's leaf order (dict keys sorted, lists and tuples in
order: a mixture's ``experts`` before its ``router``).  Dense trunks take
the byte-identical version 3; the others version 4 with a kind tag: 1 a
mixture of experts, 2 a GRU and 3 an LSTM (the cell, then the head), 4 an
attention encoder, 5 an attention encoder with the auxiliary value head
(kind 4 and then the aux MLP).  Version-2 files (no config) load through
the template path.

The file is written in the CRC blob container (int64 payload length, the
payload, the payload's crc32), the JAX package's native format, here in
pure Python with ``zlib``; ``load`` reads both the container and the plain
file.

**The draw stream.**  The key slot holds the JAX package's PRNG words,
which a ``torch.Generator`` cannot continue.  The port writes an empty key
slot and stores its CPU generator's ``get_state()`` (base64) under
``_meta["torch_generator"]``, which the JAX package's loader passes
through as metadata.  A file written by the JAX package therefore loads
into the port with its params and all three Adam states, not its draw
stream: ``Trainer.load`` and ``Trainer.from_checkpoint`` say so with a
:class:`DrawStreamWarning` and keep drawing from the trainer's own seed.

Reading a file gives numpy arrays (``Checkpoint.state`` is a
``TrainState`` of them, Adam timesteps as ints); ``utils/params.
train_state_from_numpy`` turns them into the port's tensors.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import struct
import warnings
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ppoc_tpu_torch.models.attn import is_attn
from ppoc_tpu_torch.models.gru import cell_kind, is_rnn
from ppoc_tpu_torch.models.moe import is_moe
from ppoc_tpu_torch.ops.adam import AdamState, tree_leaves, tree_unflatten

MAGIC = b"PPOC"
VERSION = 3       # plain dense-MLP trunks
MOE_VERSION = 4   # kind-tagged trunks (the JAX package's name for it)
GENERATOR_KEY = "torch_generator"   # the port's draw stream, under _meta


class DrawStreamWarning(UserWarning):
    """A checkpoint without the port's generator state was loaded into a
    trainer: params and Adam states are restored, the draw stream is not."""


class Checkpoint(NamedTuple):
    """Everything a checkpoint file holds.  ``cfg`` is None for version-2
    files; ``key`` holds the JAX package's PRNG words (uint32) when a JAX
    trainer wrote the file, ``generator`` the port's generator state."""
    hyperparams: Dict[str, float]
    dims: Dict[str, Any]
    state: Any                        # algo.ppo.TrainState of numpy arrays
    cfg: Optional[Any]                # ppoc_tpu_torch.config.PPOConfig
    key: Optional[np.ndarray]         # the JAX trainer's key words
    meta: Optional[Dict[str, Any]] = None  # run metadata (epochs_done, ...)
    generator: Optional[torch.Tensor] = None  # torch.Generator.get_state()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _w(f, fmt, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _r(f, fmt):
    size = struct.calcsize("<" + fmt)
    out = struct.unpack("<" + fmt, f.read(size))
    return out if len(out) > 1 else out[0]


def _write_arr(f, a):
    a = np.ascontiguousarray(_np(a), dtype=np.float32)
    _w(f, "i", a.size)
    f.write(a.tobytes())


def _read_arr(f, shape=None) -> np.ndarray:
    n = _r(f, "i")
    a = np.frombuffer(f.read(4 * n), dtype=np.float32).copy()
    return a.reshape(shape) if shape is not None else a


def _write_mlp(f, layers):
    _w(f, "i", len(layers))
    for w, b in layers:
        _w(f, "ii", w.shape[0], w.shape[1])
        _write_arr(f, w)
        _write_arr(f, b)


def _read_mlp(f) -> List[Tuple[np.ndarray, np.ndarray]]:
    n = _r(f, "i")
    layers = []
    for _ in range(n):
        fan_in, fan_out = _r(f, "ii")
        layers.append((_read_arr(f, (fan_in, fan_out)),
                       _read_arr(f, (fan_out,))))
    return layers


def _write_trunk(f, trunk):
    """Version-4 kind-tagged trunk: 0 = dense MLP, 1 = mixture of experts
    (router layer, then the stacked [E, fan_in, fan_out] expert layers;
    ``models/moe.py``), 2 / 3 = GRU / LSTM (d_in and G*H, wx, wh, b, then
    the dense head; ``models/gru.py``), 4 = causal-attention encoder
    (embed, pos, blocks, final LayerNorm, dense head; ``models/attn.py``),
    5 = kind 4 and then the aux value head's MLP, in the JAX package's
    field order (``ppoc_tpu/utils/checkpoint.py:100-145``)."""
    if is_moe(trunk):
        _w(f, "i", 1)
        wr, br = trunk["router"]
        _w(f, "ii", *np.shape(wr))
        _write_arr(f, wr)
        _write_arr(f, br)
        _w(f, "i", len(trunk["experts"]))
        for w, b in trunk["experts"]:
            _w(f, "iii", *np.shape(w))
            _write_arr(f, w)
            _write_arr(f, b)
        return
    if is_rnn(trunk):
        _w(f, "i", 3 if cell_kind(trunk) == "lstm" else 2)
        cell = trunk["cell"]
        _w(f, "ii", *np.shape(cell["wx"]))
        for name in ("wx", "wh", "b"):
            _write_arr(f, cell[name])
        _write_mlp(f, trunk["head"])
        return
    if not is_attn(trunk):
        _w(f, "i", 0)
        _write_mlp(f, trunk)
        return
    _w(f, "i", 5 if "aux_head" in trunk else 4)
    a = trunk["attn"]
    we, be = a["embed"]
    n_heads, _ = a["blocks"][0]["wqkv"].shape[-2:]
    ff = a["blocks"][0]["ff1"][0].shape[1]
    _w(f, "iiiiii", we.shape[0], we.shape[1], a["pos"].shape[0], n_heads,
       len(a["blocks"]), ff)
    for arr in (we, be, a["pos"]):
        _write_arr(f, arr)
    for blk in a["blocks"]:
        for arr in (blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"],
                    *blk["ln1"], *blk["ln2"], *blk["ff1"], *blk["ff2"]):
            _write_arr(f, arr)
    _write_arr(f, a["lnf"][0])
    _write_arr(f, a["lnf"][1])
    _write_mlp(f, trunk["head"])
    if "aux_head" in trunk:
        _write_mlp(f, trunk["aux_head"])


def _read_trunk(f):
    kind = _r(f, "i")
    if kind == 0:
        return _read_mlp(f)
    if kind in (2, 3):
        d_in, hg = _r(f, "ii")
        wx = _read_arr(f, (d_in, hg))
        wh = _read_arr(f, (hg // (4 if kind == 3 else 3), hg))
        b = _read_arr(f, (hg,))
        return {"cell": {"wx": wx, "wh": wh, "b": b}, "head": _read_mlp(f)}
    if kind == 1:
        d_in, e = _r(f, "ii")
        router = (_read_arr(f, (d_in, e)), _read_arr(f, (e,)))
        experts = []
        for _ in range(_r(f, "i")):
            ne, fan_in, fan_out = _r(f, "iii")
            experts.append((_read_arr(f, (ne, fan_in, fan_out)),
                            _read_arr(f, (ne, fan_out))))
        return {"router": router, "experts": experts}
    if kind not in (4, 5):
        raise ValueError(f"unknown trunk kind {kind}")
    d_in, d, t_max, n_heads, n_layers, ff = _r(f, "iiiiii")
    hd = d // n_heads
    we = _read_arr(f, (d_in, d))
    be = _read_arr(f, (d,))
    pos = _read_arr(f, (t_max, d))
    blocks = []
    for _ in range(n_layers):
        blk = {"wqkv": _read_arr(f, (d, 3, n_heads, hd)),
               "bqkv": _read_arr(f, (3, n_heads, hd)),
               "wo": _read_arr(f, (d, d)), "bo": _read_arr(f, (d,))}
        for name, shapes in (("ln1", ((d,), (d,))), ("ln2", ((d,), (d,))),
                             ("ff1", ((d, ff), (ff,))),
                             ("ff2", ((ff, d), (d,)))):
            blk[name] = tuple(_read_arr(f, s) for s in shapes)
        blocks.append(blk)
    lnf = (_read_arr(f, (d,)), _read_arr(f, (d,)))
    trunk = {"attn": {"embed": (we, be), "pos": pos, "blocks": blocks,
                      "lnf": lnf}, "head": _read_mlp(f)}
    if kind == 5:
        trunk["aux_head"] = _read_mlp(f)
    return trunk


def _flat_adam(state, params) -> Tuple[np.ndarray, np.ndarray, int]:
    """An Adam state's moments flattened in the JAX package's leaf order
    (``jax.tree.leaves``: for an MLP W0, b0, W1, b1, ...; for an attention
    trunk ``attn`` before ``head``, each dict's keys sorted), and its
    timestep."""
    def flat(tree):
        parts = [_np(x).ravel() for x in tree_leaves(tree)]
        return np.concatenate(parts or [np.zeros(0, np.float32)])

    return (flat(state.m).astype(np.float32),
            flat(state.v).astype(np.float32), int(state.t))


def _unflat_adam(m: np.ndarray, v: np.ndarray, t: int, params):
    ms, vs, off = [], [], 0
    for leaf in tree_leaves(params):
        shape = np.shape(leaf)
        n = int(np.prod(shape))
        ms.append(m[off: off + n].reshape(shape))
        vs.append(v[off: off + n].reshape(shape))
        off += n
    if off != m.size:
        raise ValueError(
            f"Adam state size mismatch: checkpoint has {m.size} elements, "
            f"the parameter tree needs {off}")
    return AdamState(m=tree_unflatten(params, ms), v=tree_unflatten(params, vs),
                     t=int(t))


def _save_stream(f, cfg, spec, state, generator=None,
                 meta: Optional[Dict[str, Any]] = None) -> None:
    """The checkpoint payload: version 4 when a trunk is a mixture of
    experts, a GRU/LSTM or an attention encoder, else version 3.
    ``state`` holds tensors or numpy arrays;
    ``generator`` is a ``torch.Generator`` whose state rides under
    ``_meta``, or None (then the stream equals the JAX package's
    ``_save_stream`` with no key)."""
    tagged = any(is_attn(t) or is_moe(t) or is_rnn(t)
                 for t in (state.policy_params["mlp"], state.v_params))
    f.write(MAGIC)
    _w(f, "i", MOE_VERSION if tagged else VERSION)
    d = dataclasses.asdict(cfg)
    meta = dict(meta or {})
    if generator is not None:
        meta[GENERATOR_KEY] = base64.b64encode(
            generator.get_state().numpy().tobytes()).decode("ascii")
    if meta:
        d["_meta"] = meta
    blob = json.dumps(d).encode("utf-8")
    _w(f, "i", len(blob))
    f.write(blob)
    _w(f, "i", 0)                       # the key slot: JAX PRNG words only
    # hyperparams, dims, discrete flag (the reference's field order)
    _w(f, "fffff", cfg.lam, cfg.clip_eps, cfg.ent_coeff, cfg.lr_policy,
       cfg.lr_v)
    _w(f, "iii", spec.obs_dim, spec.action_dim, cfg.steps_per_fit)
    _w(f, "i", 1 if spec.discrete else 0)
    log_std = state.policy_params.get("log_std", np.zeros(0, np.float32))
    _write_arr(f, log_std)
    if tagged:
        _write_trunk(f, state.policy_params["mlp"])
        _write_trunk(f, state.v_params)
    else:
        _write_mlp(f, state.policy_params["mlp"])
        _write_mlp(f, state.v_params)
    # three Adam states: policy, V, log_std
    for st, ps in ((state.opt_policy, state.policy_params["mlp"]),
                   (state.opt_v, state.v_params),
                   (state.opt_log_std, log_std)):
        m, v, t = _flat_adam(st, ps)
        _w(f, "ii", m.size, t)
        _write_arr(f, m)
        _write_arr(f, v)


def blob(payload: bytes) -> bytes:
    """The CRC blob container around ``payload``: int64 length, payload,
    crc32 (the JAX package's ``native.write_blob``)."""
    return (struct.pack("<q", len(payload)) + payload
            + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))


def save(path: str, cfg, spec, state, generator=None,
         keep_sidecars: tuple = (),
         meta: Optional[Dict[str, Any]] = None) -> None:
    """Write cfg (full config JSON), the env dims, the TrainState and the
    generator's state to ``path`` in the CRC blob container.

    Stale normalisation sidecars (``<path>.obsnorm.npz`` /
    ``.retnorm.npz``, the host trainer's running statistics) are removed
    after the write, so a re-save at the same path by a trainer without
    them never leaves foreign statistics for serving to apply.  A trainer
    that owns them names their suffixes in ``keep_sidecars`` and re-writes
    them itself right after this call (``envs/host.HostTrainer.save``), as
    ``ppoc_tpu/utils/checkpoint.py:253-298``: deleting those here would
    open a window with a valid checkpoint and no statistics."""
    buf = io.BytesIO()
    _save_stream(buf, cfg, spec, state, generator, meta=meta)
    with open(path, "wb") as f:
        f.write(blob(buf.getvalue()))
    for sidecar in (".obsnorm.npz", ".retnorm.npz"):
        if sidecar not in keep_sidecars and os.path.exists(path + sidecar):
            os.remove(path + sidecar)


def _read_blob(path: str) -> bytes:
    """The payload of a CRC blob container, its crc32 checked."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12:
        raise ValueError(f"{path}: too short for a blob container")
    (n,) = struct.unpack("<q", raw[:8])
    if n < 0 or len(raw) < 8 + n + 4:
        raise ValueError(f"{path}: truncated blob container")
    payload = raw[8: 8 + n]
    (crc,) = struct.unpack("<I", raw[8 + n: 12 + n])
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise IOError(f"{path}: CRC mismatch")
    return payload


def adapt_to_template(state, template):
    """Attention positional-table GROWTH before template validation: a
    trunk whose ``pos`` table is shorter than the live template's (same
    width) gets zero rows appended, and so do its Adam moments (the
    window-extension load, ``Trainer.from_checkpoint(..., rollout_len=
    longer)``).  Growth only, by the ``pos`` key, per trunk.  Growth past
    the one-row decode slot warns, naming each trunk that grew with its
    old and new row counts (the JAX package reports one "from" count
    derived from the policy template and the larger pad)."""
    def pad_rows(trunk, tpl) -> int:
        if not (is_attn(trunk) and is_attn(tpl)):
            return 0
        pos, tp = trunk["attn"]["pos"], tpl["attn"]["pos"]
        if pos.shape[-1] == tp.shape[-1] and pos.shape[0] < tp.shape[0]:
            return tp.shape[0] - pos.shape[0]
        return 0

    def grow(tree, n_pad):
        if not n_pad:
            return tree
        a = dict(tree["attn"])
        a["pos"] = np.pad(_np(a["pos"]), ((0, n_pad), (0, 0)))
        return dict(tree, attn=a)

    n_pol = pad_rows(state.policy_params["mlp"],
                     template.policy_params["mlp"])
    n_v = pad_rows(state.v_params, template.v_params)
    if max(n_pol, n_v) > 1:
        grown = [f"the {name} trunk's from {trunk['attn']['pos'].shape[0]} "
                 f"to {trunk['attn']['pos'].shape[0] + n} rows"
                 for name, trunk, n in (
                     ("policy", state.policy_params["mlp"], n_pol),
                     ("value", state.v_params, n_v)) if n]
        warnings.warn(
            f"growing the attention positional table: {'; '.join(grown)} "
            f"(zero-initialized, untrained positions) -- expected for a "
            f"window-extension curriculum load, a mistake otherwise",
            UserWarning, stacklevel=2)
    if not (n_pol or n_v):
        return state
    pol = dict(state.policy_params, mlp=grow(state.policy_params["mlp"],
                                             n_pol))
    return state._replace(
        policy_params=pol, v_params=grow(state.v_params, n_v),
        opt_policy=state.opt_policy._replace(
            m=grow(state.opt_policy.m, n_pol),
            v=grow(state.opt_policy.v, n_pol)),
        opt_v=state.opt_v._replace(m=grow(state.opt_v.m, n_v),
                                   v=grow(state.opt_v.v, n_v)))


def _check_template(state, template) -> None:
    """Structure and shape validation against a live state, so a
    mismatched checkpoint fails at load time with a clear message."""
    ls, ts = tree_leaves(state), tree_leaves(template)
    if len(ls) != len(ts):
        raise ValueError(
            f"checkpoint structure mismatch: {len(ls)} leaves vs "
            f"{len(ts)} in the live training state")
    for a, b in zip(ls, ts):
        if np.shape(a) != tuple(np.shape(b)):
            raise ValueError(
                f"checkpoint shape mismatch: {np.shape(a)} vs live "
                f"{tuple(np.shape(b))} -- was it saved with a different "
                f"hidden/env configuration?")


def load(path: str, template=None) -> Checkpoint:
    """Load a checkpoint, in the CRC blob container or the plain file
    (which starts with the magic).  ``template`` (a live TrainState)
    enables shape validation."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head == MAGIC:
        with open(path, "rb") as fh:
            return _load_stream(fh, template)
    return _load_stream(io.BytesIO(_read_blob(path)), template)


def _load_stream(f, template=None) -> Checkpoint:
    from ppoc_tpu_torch.algo.ppo import TrainState
    from ppoc_tpu_torch.config import PPOConfig

    magic = f.read(4)
    if magic != MAGIC:
        raise ValueError(f"not a ppoc_tpu checkpoint: bad magic {magic!r}")
    version = _r(f, "i")
    if version not in (2, VERSION, MOE_VERSION):
        raise ValueError(f"unsupported checkpoint version {version}")
    cfg = key = generator = None
    meta: Dict[str, Any] = {}
    if version >= 3:
        d = json.loads(f.read(_r(f, "i")).decode("utf-8"))
        for tup_field in ("hidden", "obs_loc", "obs_scale"):
            if tup_field in d:
                d[tup_field] = tuple(d[tup_field])
        meta = d.pop("_meta", {})
        cfg = PPOConfig(**d)
        nk = _r(f, "i")
        if nk:
            key = np.frombuffer(f.read(4 * nk), dtype=np.uint32).copy()
        if GENERATOR_KEY in meta:
            raw = base64.b64decode(meta.pop(GENERATOR_KEY))
            generator = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    lam, clip_eps, ent_coeff, lr_policy, lr_v = _r(f, "fffff")
    obs_dim, action_dim, capacity = _r(f, "iii")
    discrete = bool(_r(f, "i"))
    log_std = _read_arr(f)
    if version >= MOE_VERSION:
        mu, vnet = _read_trunk(f), _read_trunk(f)
    else:
        mu, vnet = _read_mlp(f), _read_mlp(f)
    policy_params: Dict[str, Any] = {"mlp": mu}
    if not discrete:
        policy_params["log_std"] = log_std
    adams = []
    for ps in (mu, vnet, log_std):
        _, t = _r(f, "ii")
        m = _read_arr(f)
        v = _read_arr(f)
        adams.append(_unflat_adam(m, v, t, ps))
    state = TrainState(policy_params=policy_params, v_params=vnet,
                       opt_policy=adams[0], opt_v=adams[1],
                       opt_log_std=adams[2])
    hp = dict(lam=lam, clip_eps=clip_eps, ent_coeff=ent_coeff,
              lr_policy=lr_policy, lr_v=lr_v)
    dims = dict(obs_dim=obs_dim, action_dim=action_dim, capacity=capacity,
                discrete=discrete)
    if template is not None:
        _check_template(state, template)
    return Checkpoint(hp, dims, state, cfg, key, meta, generator)

"""Port parity for checkpoints: ppoc_tpu_torch/utils/checkpoint.py and the
Trainer's save / load / from_checkpoint, held to ppoc_tpu/utils/checkpoint.py.

JAX-side states are built from a numpy seed (weights, moments, timesteps),
not trained, and saved with the JAX package's own writer; files move both
ways between the packages leaf for leaf, and the port's stream and CRC
container are the JAX package's bytes.  Mirrors tests/test_resume.py,
test_utils.py (template mismatch, the container without the native
library), test_attn.py (the pos-table shims, the attention round trip) and
test_errors.py (bad magic).
"""
import dataclasses
import io
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu import PPOConfig as JConfig, envs as jenvs, native
from ppoc_tpu.algo import ppo as jppo
from ppoc_tpu.ops.adam import AdamState as JAdam
from ppoc_tpu.utils import checkpoint as jck
from ppoc_tpu_torch import PPOConfig, envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.ops import adam as adam_ops
from ppoc_tpu_torch.ops.adam import AdamState
from ppoc_tpu_torch.utils import checkpoint, params as conv

torch.set_num_threads(1)

# the trunk kinds the port runs, at tiny widths (file kinds 0, 2, 3, 4 and
# 5; kind 1, the mixture, is test_moe_trunk_kind_loads')
KINDS = {
    "dense_gaussian": dict(env="pendulum", hidden=(8, 8)),
    "dense_categorical": dict(env="cartpole", hidden=(8, 8)),
    "attn_gaussian": dict(env="recall", hidden=(8,), attn_dim=8,
                          attn_layers=1, attn_heads=2),
    "attn_categorical": dict(env="cartpole", hidden=(8,), attn_dim=8,
                             attn_layers=2, attn_heads=2),
    "gru": dict(env="recall", hidden=(8,), rnn_hidden=4),
    "lstm": dict(env="cartpole_po", hidden=(8,), rnn_hidden=4,
                 rnn_cell="lstm"),
    "attn_aux": dict(env="recall", hidden=(8,), attn_dim=8, attn_layers=1,
                     attn_heads=2, aux_value_coeff=0.5),
}
BASE = dict(n_envs=8, rollout_len=6, minibatch_size=24, fits_per_epoch=1,
            eval_envs=8, eval_len=6, kernel_backend="jnp", seed=5)

# the resume config of tests/test_resume.py, on the port's kernels
CFG = PPOConfig(env="simple", n_envs=8, rollout_len=15, minibatch_size=16,
                fits_per_epoch=2, n_epochs=2, eval_envs=16, eval_len=15,
                hidden=(16, 16), kernel_backend="pallas", seed=3,
                lr_policy=2.5e-4, clip_eps=0.15)


def kind_config(kind: str) -> PPOConfig:
    return PPOConfig(**dict(BASE, **KINDS[kind]))


def jax_config(cfg) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def random_state(cfg, seed: int):
    """A TrainState of numpy arrays shaped as the port's for ``cfg``: every
    weight and first moment standard normal, second moments |normal|, Adam
    timesteps random, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    ts = conv.train_state_to_numpy(ppo.init_train_state(
        cfg, envs.make(cfg.env), torch.Generator().manual_seed(0), "cpu"))

    def fill(tree, positive=False):
        leaves = adam_ops.tree_leaves(tree)
        new = [rng.standard_normal(np.shape(x)).astype(np.float32)
               for x in leaves]
        return adam_ops.tree_unflatten(
            tree, [np.abs(x) if positive else x for x in new])

    def adam(st):
        return AdamState(m=fill(st.m), v=fill(st.v, True),
                         t=int(rng.integers(1, 10_000)))

    return ppo.TrainState(
        policy_params=fill(ts.policy_params), v_params=fill(ts.v_params),
        opt_policy=adam(ts.opt_policy), opt_v=adam(ts.opt_v),
        opt_log_std=adam(ts.opt_log_std))


def jax_state(ns):
    """The same numbers as the JAX package's TrainState."""
    def tree(t):
        return jax.tree.map(jnp.asarray, t)

    def adam(st):
        return JAdam(m=tree(st.m), v=tree(st.v),
                     t=jnp.asarray(st.t, jnp.int32))

    return jppo.TrainState(
        policy_params=tree(ns.policy_params), v_params=tree(ns.v_params),
        opt_policy=adam(ns.opt_policy), opt_v=adam(ns.opt_v),
        opt_log_std=adam(ns.opt_log_std))


def write_jax_file(path: str, kind: str, container: str, seed: int = 0):
    """A file the JAX package writes for ``kind``'s random state, with a
    PRNG key; ``container`` "plain" or "blob" (its native CRC container).
    Returns (port config, numpy state)."""
    cfg = kind_config(kind)
    ns = random_state(cfg, seed)
    spec = jenvs.make(cfg.env).spec
    args = (jax_config(cfg), spec, jax_state(ns), jax.random.PRNGKey(7))
    if container == "blob":
        if not native.available():
            pytest.skip("the JAX package writes its CRC container through "
                        "its native library, which is not built here")
        jck.save(path, *args, meta={"epochs_done": 4})
    else:
        buf = io.BytesIO()
        jck._save_stream(buf, *args, meta={"epochs_done": 4})
        with open(path, "wb") as f:
            f.write(buf.getvalue())
    return cfg, ns


def assert_leaves_equal(a, b):
    la, lb = adam_ops.tree_leaves(a), adam_ops.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- JAX -> port ------------------------------------------------------------

@pytest.mark.parametrize("container", ["plain", "blob"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_file_loads_bitwise(tmp_path, kind, container):
    """Every leaf of the port's load equals the JAX package's load of the
    same file, in both containers; config, dims, metadata and key too."""
    p = str(tmp_path / "j.bin")
    cfg, ns = write_jax_file(p, kind, container)
    with open(p, "rb") as f:
        assert (f.read(4) == checkpoint.MAGIC) == (container == "plain")
    ck, jk = checkpoint.load(p), jck.load(p)
    assert_leaves_equal(ck.state, jax.device_get(jk.state))
    assert_leaves_equal(ck.state, ns)
    assert ck.cfg == cfg
    assert dataclasses.asdict(ck.cfg) == dataclasses.asdict(jk.cfg)
    assert ck.dims == jk.dims and ck.hyperparams == jk.hyperparams
    assert ck.meta == jk.meta == {"epochs_done": 4}
    np.testing.assert_array_equal(ck.key, jck._key_data(jk.key))
    assert ck.generator is None
    # into a Trainer, on the saved "jnp" backend and on the port's kernels
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for kw in ({}, {"kernel_backend": "pallas"}):
            tr = Trainer.from_checkpoint(p, device="cpu", **kw)
            assert_leaves_equal(tr.state, ns)


def test_jnp_backend_is_refused_naming_the_override(tmp_path):
    """A "jnp" file now runs on "jnp" (the port's backend without
    kernels) with no override, and on the kernels with one."""
    p = str(tmp_path / "j.bin")
    write_jax_file(p, "dense_gaussian", "plain")
    with pytest.warns(checkpoint.DrawStreamWarning):
        tr = Trainer.from_checkpoint(p, device="cpu")
    assert tr.backend == "jnp"
    with pytest.warns(checkpoint.DrawStreamWarning):
        tr = Trainer.from_checkpoint(p, device="cpu",
                                     kernel_backend="pallas")
    assert tr.backend == "pallas"


def test_jax_file_keeps_params_and_adam_not_the_draw_stream(tmp_path):
    """A JAX-written file restores params and all three Adam states; its
    key words cannot continue a torch.Generator, and the load says so."""
    p = str(tmp_path / "j.bin")
    cfg, ns = write_jax_file(p, "dense_gaussian", "plain")
    tr = Trainer(cfg.replace(kernel_backend="pallas"), "cpu")
    before = tr.generator.get_state()
    with pytest.warns(checkpoint.DrawStreamWarning, match="draw stream"):
        tr.load(p)
    assert_leaves_equal(tr.state, ns)
    assert torch.equal(tr.generator.get_state(), before)


def _jax_file_of(p, cfg):
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make(cfg.env).spec,
                     jax_state(random_state(cfg.replace(zero1=False), 1)))
    with open(p, "wb") as f:
        f.write(buf.getvalue())


def test_refused_config_is_refused_by_name(tmp_path):
    """A config field the port does not run (zero1, ROADMAP.md §1 item 16)
    is refused by name and item."""
    p = str(tmp_path / "j.bin")
    _jax_file_of(p, kind_config("dense_gaussian").replace(zero1=True))
    with pytest.raises(NotImplementedError, match="zero1.*item 16"):
        Trainer.from_checkpoint(p, device="cpu", kernel_backend="pallas")


def test_stabiliser_config_loads(tmp_path):
    """A JAX file whose config carries the stabilisers (refused before
    they were ported) rebuilds a Trainer with them, every leaf equal."""
    p = str(tmp_path / "j.bin")
    cfg = kind_config("dense_gaussian").replace(max_grad_norm=0.5,
                                                target_kl=0.02)
    _jax_file_of(p, cfg)
    with pytest.warns(checkpoint.DrawStreamWarning):
        tr = Trainer.from_checkpoint(p, device="cpu")
    assert (tr.cfg.max_grad_norm, tr.cfg.target_kl) == (0.5, 0.02)
    assert_leaves_equal(tr.state, random_state(cfg, 1))


# --- port -> JAX --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense_gaussian", "attn_categorical",
                                  "lstm", "attn_aux"])
def test_port_file_loads_in_jax(tmp_path, kind):
    """The JAX package's load (and, dense, its Trainer.from_checkpoint)
    reads the port's file: every leaf equal, epochs_done read."""
    cfg = kind_config(kind).replace(kernel_backend="pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tr = Trainer(cfg, "cpu")
        tr.train(n_epochs=1, log=False, initial_eval=False,
                 checkpoint_path=str(tmp_path / "p.bin"))
    p = str(tmp_path / "p.bin")
    jk = jck.load(p)
    assert_leaves_equal(conv.train_state_to_numpy(tr.state),
                        jax.device_get(jk.state))
    assert jk.meta["epochs_done"] == 1
    assert dataclasses.asdict(jk.cfg) == dataclasses.asdict(cfg)
    assert jk.key is None
    if kind.startswith("dense"):
        from ppoc_tpu.algo.trainer import Trainer as JTrainer

        jt = JTrainer.from_checkpoint(p, kernel_backend="jnp")
        assert_leaves_equal(conv.train_state_to_numpy(tr.state),
                            jax.device_get(jt.state))


# --- bytes --------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_stream_bytes_equal_jax(kind):
    """Same state, config and _meta, no key and no generator: the port's
    payload is the JAX package's, byte for byte (version 3 dense, version 4
    kind 4 attention, 5 with the aux head, 2 GRU and 3 LSTM, whose Adam
    moments go in jax.tree.leaves order)."""
    cfg = kind_config(kind)
    ns = random_state(cfg, 2)
    ours, theirs = io.BytesIO(), io.BytesIO()
    tstate = conv.train_state_from_numpy(ns, "cpu")
    checkpoint._save_stream(ours, cfg, envs.make(cfg.env).spec, tstate,
                            meta={"epochs_done": 9})
    jck._save_stream(theirs, jax_config(cfg), jenvs.make(cfg.env).spec,
                     jax_state(ns), meta={"epochs_done": 9})
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue()[4:8] == struct.pack(
        "<i", 3 if kind.startswith("dense") else 4)


@pytest.mark.parametrize("kind", ["dense_gaussian", "dense_categorical"])
def test_jax_forced_v4_dense_loads(tmp_path, kind):
    """A dense state the JAX package writes as version 4 (kind-0 tagged
    trunks) loads into the port with every leaf as written."""
    cfg = kind_config(kind)
    ns = random_state(cfg, 6)
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make(cfg.env).spec,
                     jax_state(ns), version=4)
    p = tmp_path / "v4.bin"
    p.write_bytes(buf.getvalue())
    ck = checkpoint.load(str(p))
    assert buf.getvalue()[4:8] == struct.pack("<i", 4)
    assert ck.cfg == cfg
    assert_leaves_equal(ns, ck.state)


def test_container_bytes_equal_native(tmp_path):
    if not native.available():
        pytest.skip("the JAX package's native library is not built here")
    cfg = kind_config("dense_gaussian")
    ns = random_state(cfg, 3)
    p, q = str(tmp_path / "port.bin"), str(tmp_path / "native.bin")
    checkpoint.save(p, cfg, envs.make(cfg.env).spec, ns,
                    meta={"epochs_done": 1})
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make(cfg.env).spec,
                     jax_state(ns), meta={"epochs_done": 1})
    native.write_blob(q, buf.getvalue())
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()
    assert native.read_blob(p) == buf.getvalue()


# --- resume inside the port (tests/test_resume.py) ------------------------------

def test_from_checkpoint_reconstructs_everything(tmp_path):
    p = str(tmp_path / "ck.bin")
    tr = Trainer(CFG, "cpu")
    tr.train(n_epochs=1, log=False)
    tr.save(p)
    tr2 = Trainer.from_checkpoint(p, device="cpu")
    assert tr2.cfg == CFG
    assert tr2.env.spec.name == tr.env.spec.name
    assert_leaves_equal(tr.state, tr2.state)   # params + all 3 Adam m/v/t
    assert torch.equal(tr.generator.get_state(), tr2.generator.get_state())


def test_resume_is_bit_exact(tmp_path):
    """Two epochs with a checkpoint after the first (train's
    checkpoint_path); resuming from the file reproduces the uninterrupted
    run's final state bit for bit."""
    p = str(tmp_path / "ck.bin")
    tr = Trainer(CFG, "cpu")
    tr.train(n_epochs=1, log=False, checkpoint_path=p)
    assert checkpoint.load(p).meta == {"epochs_done": 1}
    tr.train(n_epochs=1, log=False, initial_eval=False)
    res = Trainer.from_checkpoint(p, device="cpu")
    res.train(n_epochs=1, log=False, initial_eval=False)
    assert_leaves_equal(tr.state, res.state)


def test_load_restores_generator_position(tmp_path):
    """Plain .load() on a matching trainer also restores the draw stream,
    so load-then-train equals save-then-train."""
    p = str(tmp_path / "ck.bin")
    tr = Trainer(CFG, "cpu")
    tr.train(n_epochs=1, log=False)
    tr.save(p)
    tr.train(n_epochs=1, log=False, initial_eval=False)
    tr2 = Trainer(CFG.replace(seed=11), "cpu")
    tr2.load(p)
    tr2.train(n_epochs=1, log=False, initial_eval=False)
    assert_leaves_equal(tr.state, tr2.state)


def test_train_checkpoint_every_and_epoch_offset(tmp_path):
    p = str(tmp_path / "ck.bin")
    seen = []
    tr = Trainer(CFG, "cpu")
    hist = tr.train(n_epochs=3, log=False, checkpoint_path=p,
                    checkpoint_every=2, epoch_offset=5,
                    on_epoch_end=lambda i, row: seen.append(i) or i == 1)
    assert len(hist) == 2 and seen == [0, 1]       # stopped by the hook
    assert checkpoint.load(p).meta == {"epochs_done": 7}


def test_from_checkpoint_override_validation(tmp_path):
    p = str(tmp_path / "ck.bin")
    Trainer(CFG, "cpu").save(p)
    assert Trainer.from_checkpoint(p, device="cpu", seed=99).cfg.seed == 99
    with pytest.raises(ValueError, match="shape mismatch"):
        Trainer.from_checkpoint(p, device="cpu", hidden=(32, 32))


@pytest.mark.parametrize("kind", ["dense_gaussian", "dense_categorical"])
def test_v2_loads_through_template_only(tmp_path, kind):
    """A version-2 file (no config) the JAX package writes loads only
    through the template path; from_checkpoint refuses it by name."""
    cfg = kind_config(kind)
    ns = random_state(cfg, 4)
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make(cfg.env).spec,
                     jax_state(ns), version=2)
    p = tmp_path / "v2.bin"
    p.write_bytes(buf.getvalue())
    template = conv.train_state_from_numpy(random_state(cfg, 5), "cpu")
    ck = checkpoint.load(str(p), template=template)
    assert ck.cfg is None and ck.key is None and ck.generator is None
    assert_leaves_equal(ns, ck.state)
    with pytest.raises(ValueError, match="version-2"):
        Trainer.from_checkpoint(str(p), device="cpu")


def test_save_removes_stale_sidecars(tmp_path):
    p = str(tmp_path / "m.bin")
    for sfx in (".obsnorm.npz", ".retnorm.npz"):
        open(p + sfx, "wb").write(b"x")
    tr = Trainer(CFG, "cpu")
    checkpoint.save(p, CFG, tr.env.spec, tr.state)
    assert not (tmp_path / "m.bin.obsnorm.npz").exists()
    assert not (tmp_path / "m.bin.retnorm.npz").exists()
    assert checkpoint.load(p).cfg == CFG


# --- error paths (tests/test_utils.py, tests/test_errors.py) -------------------

def test_checkpoint_bad_magic(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(checkpoint.blob(b"XXXX" + b"\x00" * 64))
    with pytest.raises(ValueError, match="bad magic"):
        checkpoint.load(str(p))
    p.write_bytes(b"XXXX" + b"\x00" * 64)      # not a container either
    with pytest.raises((ValueError, IOError)):
        checkpoint.load(str(p))


def test_container_crc_mismatch_and_truncation(tmp_path):
    p = str(tmp_path / "m.bin")
    tr = Trainer(CFG, "cpu")
    tr.save(p)
    raw = bytearray(open(p, "rb").read())
    raw[40] ^= 0x01
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC mismatch"):
        checkpoint.load(p)
    open(p, "wb").write(bytes(raw[:-9]))
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.load(p)


def test_checkpoint_template_mismatch_raises(tmp_path):
    p = str(tmp_path / "m.bin")
    Trainer(CFG, "cpu").save(p)
    big = Trainer(CFG.replace(hidden=(32, 32)), "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        big.load(p)


def _refused_trunk(kind: int, rng):
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if kind == 1:       # mixture of experts: router + stacked experts
        return {"router": (a(3, 4), a(4)),
                "experts": [(a(4, 3, 8), a(4, 8)), (a(4, 8, 1), a(4, 1))]}
    if kind in (2, 3):  # GRU (3H gates) / LSTM (4H)
        g = 3 if kind == 2 else 4
        return {"cell": {"wx": a(3, g * 8), "wh": a(8, g * 8),
                         "b": a(g * 8)}, "head": [(a(8, 1), a(1))]}
    trunk = random_state(kind_config("attn_gaussian"), 4).policy_params["mlp"]
    return dict(trunk, aux_head=[(a(8, 1), a(1))])


def _jax_trunk_file(tmp_path, kind):
    """A version-4 file the JAX package writes with a kind-``kind`` policy
    trunk; returns (path, numpy state)."""
    rng = np.random.default_rng(kind)
    cfg = kind_config("dense_gaussian")
    ns = random_state(cfg, 0)
    trunk = _refused_trunk(kind, rng)
    zeros = jax.tree.map(lambda x: np.zeros_like(x), trunk)
    ns = ns._replace(policy_params=dict(ns.policy_params, mlp=trunk),
                     opt_policy=AdamState(m=zeros, v=zeros, t=1))
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make("pendulum").spec,
                     jax_state(ns))
    p = tmp_path / "k.bin"
    p.write_bytes(buf.getvalue())
    return str(p), ns


def test_moe_trunk_kind_loads(tmp_path):
    """Kind 1, a mixture of experts (refused before it was ported), loads
    leaf for leaf, and the port writes it back byte for byte."""
    p, ns = _jax_trunk_file(tmp_path, 1)
    ck = checkpoint.load(p)
    assert_leaves_equal(ck.state, ns)
    buf = io.BytesIO()
    checkpoint._save_stream(buf, ck.cfg, envs.make("pendulum").spec,
                            ck.state)
    with open(p, "rb") as f:
        assert buf.getvalue() == f.read()


@pytest.mark.parametrize("kind", [2, 3, 5])
def test_sequence_trunk_kinds_load(tmp_path, kind):
    """Kinds 2 (GRU), 3 (LSTM) and 5 (attention with the aux value head),
    refused before they were ported, load leaf for leaf from a JAX file
    whose config does not describe them (the trunk's shapes alone decide
    the cell), and the port writes them back byte for byte."""
    p, ns = _jax_trunk_file(tmp_path, kind)
    ck = checkpoint.load(p)
    assert_leaves_equal(ck.state, ns)
    buf = io.BytesIO()
    checkpoint._save_stream(buf, ck.cfg, envs.make("pendulum").spec,
                            ck.state)
    with open(p, "rb") as f:
        assert buf.getvalue() == f.read()


# --- attention trunks (tests/test_attn.py) --------------------------------------

ATTN = PPOConfig(env="recall", n_envs=8, rollout_len=6, minibatch_size=24,
                 fits_per_epoch=1, eval_envs=8, eval_len=6, hidden=(8,),
                 attn_dim=8, attn_layers=1, attn_heads=2, seed=1,
                 kernel_backend="pallas")


def test_attention_roundtrip_and_from_checkpoint(tmp_path):
    tr = Trainer(ATTN, "cpu")
    tr.train(n_epochs=1, log=False, initial_eval=False)
    p = str(tmp_path / "attn.bin")
    tr.save(p)
    tr2 = Trainer.from_checkpoint(p, device="cpu")
    assert tr2.cfg.attn_dim == 8
    assert_leaves_equal(tr.state, tr2.state)
    assert tr2.state.opt_policy.t == tr.state.opt_policy.t > 0


def _strip_pos(ns, n_pol: int, n_v: int):
    """An older layout: the policy's and the value's positional tables
    (and their Adam moments) n rows shorter."""
    def strip(tree, n):
        if not n:
            return tree
        a = dict(tree["attn"])
        a["pos"] = a["pos"][:-n]
        return dict(tree, attn=a)

    pol = dict(ns.policy_params, mlp=strip(ns.policy_params["mlp"], n_pol))
    return ns._replace(
        policy_params=pol, v_params=strip(ns.v_params, n_v),
        opt_policy=ns.opt_policy._replace(m=strip(ns.opt_policy.m, n_pol),
                                          v=strip(ns.opt_policy.v, n_pol)),
        opt_v=ns.opt_v._replace(m=strip(ns.opt_v.m, n_v),
                                v=strip(ns.opt_v.v, n_v)))


def test_old_checkpoint_pos_table_migrates(tmp_path):
    """A file with one positional row fewer (before the V(s') decode slot)
    loads through adapt_to_template: a zero row and zero moments, no
    warning."""
    tr = Trainer(ATTN, "cpu")
    ns = conv.train_state_to_numpy(tr.state)
    old = _strip_pos(ns, 1, 1)
    p = str(tmp_path / "old.bin")
    checkpoint.save(p, ATTN, tr.env.spec, old, generator=tr.generator)
    tr2 = Trainer(ATTN, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr2.load(p)
    pos = tr2.state.policy_params["mlp"]["attn"]["pos"]
    assert torch.equal(pos[:-1], torch.from_numpy(
        ns.policy_params["mlp"]["attn"]["pos"][:-1]))
    assert torch.all(pos[-1] == 0)
    assert torch.all(tr2.state.opt_v.m["attn"]["pos"][-1] == 0)


def test_window_growth_on_load(tmp_path):
    """from_checkpoint with a longer window pads the pos tables and their
    Adam moments with zero rows, by key, and warns with the row counts."""
    tr1 = Trainer(ATTN, "cpu")
    tr1.train_epoch()
    p = str(tmp_path / "small.bin")
    tr1.save(p)
    with pytest.warns(UserWarning, match="from 7 to 25 rows"):
        tr2 = Trainer.from_checkpoint(p, device="cpu", rollout_len=24,
                                      eval_len=24, minibatch_size=96)
    old = tr1.state.policy_params["mlp"]["attn"]["pos"]
    new = tr2.state.policy_params["mlp"]["attn"]["pos"]
    assert new.shape[0] == 25 and torch.equal(new[:7], old)
    assert torch.all(new[7:] == 0)
    m_pos = tr2.state.opt_policy.m["attn"]["pos"]
    assert m_pos.shape == new.shape and torch.all(m_pos[7:] == 0)
    assert np.isfinite(float(tr2.train_epoch().value_loss))


def test_pos_growth_warning_names_each_trunk(tmp_path):
    """Different policy and value pads: the port reports each trunk's own
    from/to counts, where the JAX package derives one "from" count from
    the policy template and the larger pad (wrong for the policy here)."""
    big = ATTN.replace(rollout_len=24, eval_len=24, minibatch_size=96)
    template = Trainer(big, "cpu").state
    ns = _strip_pos(conv.train_state_to_numpy(template), 12, 18)
    with pytest.warns(UserWarning) as rec:
        grown = checkpoint.adapt_to_template(ns, template)
    msg = str(rec[0].message)
    assert "policy trunk's from 13 to 25 rows" in msg
    assert "value trunk's from 7 to 25 rows" in msg
    checkpoint._check_template(grown, template)
    with pytest.warns(UserWarning) as jrec:
        jck.adapt_to_template(jax_state(ns), jax_state(
            conv.train_state_to_numpy(template)))
    jmsg = str(jrec[0].message)    # 25 - max(12, 18): the value's count
    assert "from 7 to 25 rows" in jmsg and "from 13" not in jmsg

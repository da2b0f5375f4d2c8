"""Port parity for the reference ppo.c format: ppoc_tpu_torch/utils/
ref_interop.py against ppoc_tpu/utils/ref_interop.py.

For the same RefCheckpoint the port's write_reference bytes are the JAX
package's; a file packed field by field as the C writer emits it parses
and re-writes exactly (tests/test_ref_interop.py); a port trainer exports
and re-imports leaf for leaf, through the API and the CLI.
"""
import struct

import numpy as np
import pytest
import torch

from ppoc_tpu.utils import ref_interop as jri
from ppoc_tpu_torch import PPOConfig, cli
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.utils import params as conv, ref_interop as ri
from test_torch_checkpoint import assert_leaves_equal

torch.set_num_threads(1)


def _trained(seed=0, env="pendulum"):
    cfg = PPOConfig(env=env, hidden=(8, 8), n_envs=8, rollout_len=16,
                    minibatch_size=32, fits_per_epoch=1, n_epochs=1,
                    eval_envs=8, eval_len=200, seed=seed,
                    kernel_backend="pallas")
    tr = Trainer(cfg, "cpu")
    tr.train(log=False, initial_eval=False)   # nonzero Adam m/v/t
    return tr


def _random_ref(seed: int) -> "ri.RefCheckpoint":
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def net():
        params = [(a(3, 8), a(8)), (a(8, 8), a(8)), (a(8, 1), a(1))]
        return ri.RefNet(params=params, activations=["tanh", "tanh", "none"])

    def adam(like):
        if isinstance(like, np.ndarray):
            m, v = a(*like.shape), a(*like.shape)
        else:
            m = [(a(*w.shape), a(*b.shape)) for w, b in like]
            v = [(a(*w.shape), a(*b.shape)) for w, b in like]
        return ri.RefAdam(m=m, v=v, t=int(rng.integers(1, 999)), beta1=0.9,
                          beta2=0.999)

    pol, vnet, log_std = net(), net(), a(1)
    return ri.RefCheckpoint(
        lam=0.95, clip_eps=0.2, ent_coeff=0.01, lr_policy=3e-4, lr_v=1e-3,
        state_size=3, action_size=1, capacity=3000, log_std=log_std,
        policy_net=pol, v_net=vnet, adam_policy=adam(pol.params),
        adam_v=adam(vnet.params), adam_log_std=adam(log_std))


def test_write_reference_bytes_equal_jax(tmp_path):
    ck = _random_ref(0)
    p, q = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    ri.write_reference(p, ck)
    jri.write_reference(q, jri.RefCheckpoint(*ck))
    data = open(p, "rb").read()
    assert data == open(q, "rb").read()
    back, jback = ri.read_reference(p), jri.read_reference(q)
    for x, y in zip(back, jback):
        if isinstance(x, (int, float)):
            assert x == y


def test_reference_byte_layout_hand_packed(tmp_path):
    """A file packed field by field as the C writer emits it for a 2->2->1
    net, independent of either writer."""
    W0 = np.array([[1., 2.], [3., 4.]], "<f4")       # [out=2, in=2]
    b0 = np.array([0.5, -0.5], "<f4")
    W1 = np.array([[5., 6.]], "<f4")                 # [out=1, in=2]
    b1 = np.array([0.25], "<f4")

    def net_bytes():
        out = struct.pack("<ii", 3, 1)               # node count, output
        for name in (b"relu\0", b"none\0"):
            out += struct.pack("<i", len(name)) + name
        out += struct.pack("<ii", 2, 2) + W0.tobytes() + b0.tobytes()
        out += struct.pack("<ii", 2, 1) + W1.tobytes() + b1.tobytes()
        return out

    def adam_bytes(size, t, ntensors):
        m = np.arange(size, dtype="<f4")
        v = np.arange(size, dtype="<f4") * 10
        return (struct.pack("<iiffi", size, t, 0.9, 0.999, ntensors)
                + m.tobytes() + v.tobytes())

    nbytes = net_bytes()
    nsz = 2 * 2 + 2 + 2 * 1 + 1                      # 9 params per net
    blob = (struct.pack("<fffff", 0.95, 0.2, 0.0, 3e-4, 3e-4)
            + struct.pack("<iii", 2, 1, 3000)
            + np.array([0.1], "<f4").tobytes()       # log_std
            + nbytes + nbytes
            + adam_bytes(nsz, 7, 4) + adam_bytes(nsz, 7, 4)
            + adam_bytes(1, 7, 1))
    path = str(tmp_path / "hand.bin")
    open(path, "wb").write(blob)

    ck = ri.read_reference(path)
    assert (ck.state_size, ck.action_size, ck.capacity) == (2, 1, 3000)
    np.testing.assert_array_equal(ck.policy_net.params[0][0], W0.T)
    np.testing.assert_array_equal(ck.policy_net.params[1][0], W1.T)
    np.testing.assert_array_equal(ck.policy_net.params[0][1], b0)
    assert ck.policy_net.activations == ["relu", "none"]
    # Adam flat order: W0 block (row-major [out,in]), b0, W1, b1
    m = ck.adam_policy.m
    np.testing.assert_array_equal(
        m[0][0], np.arange(4, dtype="<f4").reshape(2, 2).T)
    np.testing.assert_array_equal(m[0][1], [4.0, 5.0])
    np.testing.assert_array_equal(m[1][0], np.array([[6.0], [7.0]], "<f4"))
    np.testing.assert_array_equal(m[1][1], [8.0])
    assert ck.adam_policy.t == 7
    np.testing.assert_array_equal(ck.adam_log_std.m, [0.0])
    path2 = str(tmp_path / "hand2.bin")
    ri.write_reference(path2, ck)
    assert open(path2, "rb").read() == blob


def test_export_import_roundtrip(tmp_path):
    tr = _trained()
    path = str(tmp_path / "ref.bin")
    ri.export_trainer(tr, path)
    ck = ri.read_reference(path)
    assert (ck.state_size, ck.action_size) == (3, 1)
    assert ck.capacity == tr.cfg.steps_per_fit
    assert ck.adam_policy.t == tr.state.opt_policy.t > 0
    # the JAX package reads the port's export the same way
    jck = jri.read_reference(path)
    for (w0, b0), (w1, b1) in zip(ck.policy_net.params,
                                  jck.policy_net.params):
        np.testing.assert_array_equal(w0, w1)
        np.testing.assert_array_equal(b0, b1)
    tr2 = ri.load_trainer(path, "pendulum", device="cpu", n_envs=8,
                          rollout_len=16, minibatch_size=32,
                          fits_per_epoch=1, eval_envs=8, eval_len=200,
                          kernel_backend="pallas")
    assert tr2.cfg.hidden == (8, 8) and tr2.cfg.activation == "relu"
    assert_leaves_equal(tr.state, tr2.state)       # W, log_std, 3 Adams
    assert np.isfinite(tr2.evaluate().R)
    path2 = str(tmp_path / "ref2.bin")
    ri.write_reference(path2, ck)
    assert open(path, "rb").read() == open(path2, "rb").read()


def test_cli_import_export(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PPOC_PLATFORM", "cpu")
    ref = str(tmp_path / "cli_ref.bin")
    base = ["--env", "pendulum", "--hidden", "8", "8", "--n-envs", "8",
            "--rollout-len", "16", "--minibatch-size", "32",
            "--fits-per-epoch", "1", "--eval-envs", "8", "--eval-len", "200",
            "--kernel-backend", "pallas"]
    assert cli.main(base + ["--n-epochs", "1", "--export-ref", ref]) == 0
    assert ri.read_reference(ref).adam_policy.t > 0
    assert cli.main(base + ["--import-ref", ref, "--eval-only"]) == 0
    assert "R:" in capsys.readouterr().out
    tr = ri.load_trainer(ref, "pendulum", device="cpu", n_envs=8,
                         rollout_len=16, minibatch_size=32, eval_envs=8,
                         eval_len=200, ent_coeff=0.5)
    assert tr.cfg.ent_coeff == 0.5


def test_interop_error_paths(tmp_path):
    tr = _trained()
    path = str(tmp_path / "ref.bin")
    ri.export_trainer(tr, path)
    with pytest.raises(ValueError, match="dims"):
        ri.load_trainer(path, "mountain_car", device="cpu", n_envs=8,
                        rollout_len=16, minibatch_size=32, eval_len=999)
    with pytest.raises(ValueError, match="discrete"):
        ri.load_trainer(path, "cartpole", device="cpu", n_envs=8,
                        rollout_len=16, minibatch_size=32, eval_len=500)
    with pytest.raises(NotImplementedError, match="tp_size"):
        ri.load_trainer(path, "pendulum", device="cpu", tp_size=2)
    cfg = PPOConfig(env="cartpole", hidden=(8, 8), n_envs=8, rollout_len=16,
                    minibatch_size=32, fits_per_epoch=1, eval_len=500)
    with pytest.raises(ValueError, match="Gaussian"):
        ri.export_trainer(Trainer(cfg, "cpu"), str(tmp_path / "d.bin"))
    acfg = PPOConfig(env="recall", n_envs=8, rollout_len=6,
                     minibatch_size=24, eval_len=6, hidden=(8,), attn_dim=8,
                     attn_layers=1, attn_heads=2)
    with pytest.raises(ValueError, match="dense MLP trunks"):
        ri.export_trainer(Trainer(acfg, "cpu"), str(tmp_path / "a.bin"))
    data = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.bin")
    open(trunc, "wb").write(data[:-8])
    with pytest.raises(ValueError, match="truncated|trailing|size"):
        ri.read_reference(trunc)
    open(trunc, "wb").write(data + b"\0")
    with pytest.raises(ValueError, match="trailing"):
        ri.read_reference(trunc)


def test_load_trainer_state_round_trips_through_numpy(tmp_path):
    """The imported TrainState goes through utils/params, the one
    converter: back to numpy it is the file's trees."""
    tr = _trained(seed=1)
    path = str(tmp_path / "ref.bin")
    ri.export_trainer(tr, path)
    ck = ri.read_reference(path)
    ns = conv.train_state_to_numpy(ri.load_trainer(
        path, "pendulum", device="cpu", n_envs=8, rollout_len=16,
        minibatch_size=32, eval_len=200).state)
    np.testing.assert_array_equal(ns.opt_log_std.v, ck.adam_log_std.v)
    for (w, b), (w2, b2) in zip(ns.opt_v.m, ck.adam_v.m):
        np.testing.assert_array_equal(w, w2)
        np.testing.assert_array_equal(b, b2)

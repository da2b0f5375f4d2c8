"""Port parity for serving: ppoc_tpu_torch/serve.py against ppoc_tpu/serve.py.

A checkpoint the JAX package writes (random weights from a numpy seed)
serves the same deterministic actions from both packages: dense and
attention, Gaussian and categorical.  The port's feedforward policy acts
through K5's forward (its plain version here, on the CPU); JAX's through
"jnp".  Tolerance: max |diff| within 1e-6 of the largest |action| (two
float32 forwards summing in different orders), class ids equal.
Stochastic serving draws from a torch.Generator, not JAX's draws: held to
seeded reproducibility, shapes and its mean within 5 sigma / sqrt(n).
Then the HTTP server, feedforward and attention sessions (the failed-step
retry and LRU eviction included), mirroring tests/test_serve_http.py.
"""
import json
import math
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ppoc_tpu import serve as jserve
from ppoc_tpu_torch import PPOConfig, serve
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.utils import checkpoint
from test_torch_checkpoint import write_jax_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6


def _jax_file(tmp_path, kind: str, seed: int = 0) -> str:
    p = str(tmp_path / f"{kind}.bin")
    write_jax_file(p, kind, "plain", seed)
    return p


def _close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    if ours.dtype == np.int32:
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert np.abs(ours - theirs).max() <= REL * np.abs(theirs).max()


@pytest.mark.parametrize("kind", ["dense_gaussian", "dense_categorical"])
def test_feedforward_serves_jax_actions(tmp_path, kind):
    """The North star's third condition: a checkpoint written by the JAX
    package loads into the port and gives the same actions."""
    p = _jax_file(tmp_path, kind)
    act, jact = serve.load_policy(p, device="cpu"), jserve.load_policy(p)
    assert act.recurrent is False and act.cfg.env == jact.cfg.env
    assert (act.spec.obs_dim, act.spec.action_dim, act.spec.discrete) == (
        jact.spec.obs_dim, jact.spec.action_dim, jact.spec.discrete)
    obs = np.random.default_rng(1).normal(
        size=(64, act.spec.obs_dim)).astype(np.float32)
    _close(act(obs).numpy(), jact(obs))
    _close(act(obs[0]).numpy(), jact(obs[0]))           # one vector
    _close(act(torch.from_numpy(obs)).numpy(), jact(obs))


@pytest.mark.parametrize("kind", ["attn_gaussian", "attn_categorical"])
def test_attention_serves_jax_actions(tmp_path, kind):
    """Session-style acting through the KV cache, three steps with lanes
    reset between them, against the JAX package's load_attention_policy."""
    p = _jax_file(tmp_path, kind)
    act = serve.load_attention_policy(p, device="cpu")
    jact = jserve.load_attention_policy(p)
    assert act.window == jact.window and act.recurrent
    with pytest.raises(ValueError, match="load_attention_policy"):
        serve.load_policy(p, device="cpu")
    rng = np.random.default_rng(2)
    s, js = act.initial_state(8), jact.initial_state(8)
    for t in range(3):
        obs = rng.normal(size=(8, act.spec.obs_dim)).astype(np.float32)
        a, s = act(obs, s)
        ja, js = jact(obs, js)
        _close(a.numpy(), ja)
        done = rng.random(8) < 0.4
        s = act.reset_lanes(s, torch.from_numpy(done))
        js = jact.reset_lanes(js, done)
    assert s["t"] == int(js["t"]) == 3


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_recurrent_serves_jax_actions(tmp_path, kind):
    """A GRU (Gaussian, recall) and an LSTM (categorical, cartpole_po)
    policy step by step against the JAX package's load_recurrent_policy,
    each step from the JAX package's state: actions as above, the next
    state rtol 1e-5 / atol 1e-6; one vector with one state row; and
    load_policy points to the recurrent loader in both packages."""
    p = _jax_file(tmp_path, kind)
    act = serve.load_recurrent_policy(p, device="cpu")
    jact = jserve.load_recurrent_policy(p)
    width = 8 if kind == "lstm" else 4
    assert act.recurrent and act.state_size == width
    for load in (lambda: serve.load_policy(p, device="cpu"),
                 lambda: jserve.load_policy(p)):
        with pytest.raises(ValueError, match="load_recurrent_policy"):
            load()
    rng = np.random.default_rng(4)
    jh = jact.initial_state(8)
    assert act.initial_state(8).shape == (8, width) == np.shape(jh)
    for t in range(6):
        obs = rng.normal(size=(8, act.spec.obs_dim)).astype(np.float32)
        a, h = act(obs, np.asarray(jh))
        ja, jh = jact(obs, jh)
        _close(a.numpy(), ja)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6)
        jh = np.where(rng.random((8, 1)) < 0.3, 0.0, np.asarray(jh))
    a1, h1 = act(obs[0], act.initial_state())
    ja1, jh1 = jact(obs[0], jact.initial_state())
    assert h1.shape == (width,)
    _close(a1.numpy(), ja1)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_http_recurrent_takes_back_its_own_state(tmp_path, kind):
    """The recurrent HTTP protocol: /spec says recurrent with rnn_hidden;
    a request without "h" starts from zeros and the reply's "h" is the
    state, H wide for a GRU and 2H (h ‖ c) for an LSTM; posting it back
    continues the episode as load_recurrent_policy does.  The JAX
    package's server checks "h" against [B, rnn_hidden] and so refuses an
    LSTM's own state (400) -- the fault this server does not copy -- while
    it takes a GRU's."""
    p = _jax_file(tmp_path, kind)
    width = 8 if kind == "lstm" else 4
    obs = np.random.default_rng(5).normal(size=(3, 2)).astype(np.float32)
    act = serve.load_recurrent_policy(p, device="cpu")
    a1, h1 = act(obs, act.initial_state(3))
    a2, h2 = act(obs, h1)
    server, thread, base = _serve(p)
    try:
        spec = _get(base + "/spec")
        assert spec["recurrent"] is True and spec["rnn_hidden"] == 4
        out = _post(base + "/act", {"obs": obs.tolist()})
        assert np.shape(out["h"]) == (3, width)
        _close(np.asarray(out["action"], a1.numpy().dtype), a1.numpy())
        out2 = _post(base + "/act", {"obs": obs.tolist(), "h": out["h"]})
        _close(np.asarray(out2["action"], a2.numpy().dtype), a2.numpy())
        np.testing.assert_allclose(np.asarray(out2["h"], np.float32),
                                   h2.numpy(), rtol=1e-6, atol=1e-7)
        one = _post(base + "/act", {"obs": obs[0].tolist(),
                                    "h": out["h"][0]})
        assert np.shape(one["h"]) == (width,)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/act", {"obs": obs.tolist(),
                                  "h": np.zeros((3, width + 1)).tolist()})
        assert e.value.code == 400
    finally:
        _stop(server, thread)
    jserver = jserve.make_server(p, port=0)
    jthread = threading.Thread(target=jserver.serve_forever, daemon=True)
    jthread.start()
    jbase = "http://%s:%d" % jserver.server_address[:2]
    try:
        jout = _post(jbase + "/act", {"obs": obs.tolist()})
        assert np.shape(jout["h"]) == (3, width)
        if kind == "gru":
            _post(jbase + "/act", {"obs": obs.tolist(), "h": jout["h"]})
        else:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(jbase + "/act", {"obs": obs.tolist(), "h": jout["h"]})
            assert e.value.code == 400
            assert "h must be [3, 4]" in json.loads(e.value.read())["error"]
    finally:
        _stop(jserver, jthread)


def test_affine_obs_normalisation_matches_jax(tmp_path):
    """obs_loc / obs_scale in the file's config are applied before acting,
    as the JAX package applies them."""
    import dataclasses
    import io

    from ppoc_tpu import envs as jenvs
    from ppoc_tpu.utils import checkpoint as jck
    from test_torch_checkpoint import jax_config, jax_state, random_state

    cfg = PPOConfig(env="pendulum", hidden=(8, 8), obs_loc=(0.5, -0.2, 1.0),
                    obs_scale=(2.0, 0.5, 3.0), kernel_backend="jnp")
    buf = io.BytesIO()
    jck._save_stream(buf, jax_config(cfg), jenvs.make("pendulum").spec,
                     jax_state(random_state(cfg.replace(obs_loc=(),
                                                        obs_scale=()), 3)))
    p = tmp_path / "norm.bin"
    p.write_bytes(buf.getvalue())
    obs = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    act = serve.load_policy(str(p), device="cpu")
    _close(act(obs).numpy(), jserve.load_policy(str(p))(obs))
    assert torch.equal(act(torch.from_numpy(obs)), act(obs))
    assert dataclasses.asdict(act.cfg)["obs_loc"] == (0.5, -0.2, 1.0)


def test_stochastic_gaussian_serving(tmp_path):
    p = _jax_file(tmp_path, "dense_gaussian")
    mean = serve.load_policy(p, device="cpu")
    n = 4096
    obs = np.tile(np.random.default_rng(4).normal(size=(1, 3)),
                  (n, 1)).astype(np.float32)
    a1 = serve.load_policy(p, deterministic=False, seed=3, device="cpu")(obs)
    a2 = serve.load_policy(p, deterministic=False, seed=3, device="cpu")(obs)
    a3 = serve.load_policy(p, deterministic=False, seed=4, device="cpu")(obs)
    assert a1.shape == (n, 1) and a1.dtype == torch.float32
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    sigma = math.exp(float(checkpoint.load(p).state.policy_params[
        "log_std"][0]))
    mu = float(mean(obs[0])[0])
    assert abs(float(a1.mean()) - mu) < 5 * sigma / math.sqrt(n)
    assert abs(float(a1.std()) / sigma - 1) < 0.1


def test_stochastic_categorical_serving(tmp_path):
    p = _jax_file(tmp_path, "dense_categorical")
    n = 4096
    obs = np.tile(np.random.default_rng(5).normal(size=(1, 4)),
                  (n, 1)).astype(np.float32)
    a = serve.load_policy(p, deterministic=False, seed=1, device="cpu")(obs)
    b = serve.load_policy(p, deterministic=False, seed=1, device="cpu")(obs)
    assert a.shape == (n, 1) and a.dtype == torch.int32 and torch.equal(a, b)
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.utils import params

    ck = checkpoint.load(p)
    logits = mlp.apply(params.trunk_from_numpy(
        ck.state.policy_params["mlp"], "cpu"), torch.from_numpy(obs[:1]))
    prob = torch.softmax(logits[0], -1).numpy()
    freq = np.bincount(a.numpy().ravel(), minlength=2) / n
    assert np.all(np.abs(freq - prob)
                  < 5 * np.sqrt(prob * (1 - prob) / n) + 1e-9)


def test_unported_serving_paths_are_refused(tmp_path):
    p = _jax_file(tmp_path, "dense_gaussian")
    open(p + ".obsnorm.npz", "wb").write(b"x")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 13"):
        serve.load_policy(p, device="cpu")


def test_serving_runs_on_the_card_by_default(tmp_path):
    p = _jax_file(tmp_path, "dense_gaussian")
    if torch.cuda.is_available():
        assert serve.load_policy(p)(np.zeros(3, np.float32)).is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            serve.load_policy(p)


def test_resolve_spec_prefers_file_dims_on_mismatch():
    cfg = PPOConfig(env="pendulum")  # registry: obs 3 / act 1
    with pytest.warns(UserWarning, match="do not match"):
        spec = serve._resolve_spec(cfg, {"obs_dim": 24, "action_dim": 4,
                                         "discrete": False})
    assert spec.obs_dim == 24 and spec.action_dim == 4
    spec2 = serve._resolve_spec(cfg, {"obs_dim": 3, "action_dim": 1,
                                      "discrete": False})
    assert spec2.horizon == 200


# --- HTTP (tests/test_serve_http.py) -----------------------------------------

def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode())


def _serve(path, **kw):
    server = serve.make_server(path, port=0, device="cpu", **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    return server, thread, f"http://{host}:{port}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_feedforward(tmp_path):
    p = _jax_file(tmp_path, "dense_gaussian")
    server, thread, base = _serve(p)
    try:
        assert _get(base + "/spec") == {
            "env": "pendulum", "obs_dim": 3, "action_dim": 1,
            "discrete": False, "recurrent": False, "rnn_hidden": 0,
            "deterministic": True}
        obs = np.random.default_rng(6).normal(size=(5, 3)).astype(np.float32)
        out = _post(base + "/act", {"obs": obs.tolist()})
        want = serve.load_policy(p, device="cpu")(obs).numpy()
        np.testing.assert_array_equal(np.asarray(out["action"], np.float32),
                                      want)
        out1 = _post(base + "/act", {"obs": obs[0].tolist()})
        assert np.asarray(out1["action"]).shape == (1,)
        assert out1 == _post(base + "/act", {"obs": obs[0].tolist()})
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/act", {"obs": [[0.0, 1.0]]})     # wrong width
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nope")
        assert e.value.code == 404
    finally:
        _stop(server, thread)


def test_http_attention_sessions(tmp_path, monkeypatch):
    """The KV cache lives server-side per session: advanced by /act, lanes
    reset by 'done', freed by 'close', least recently used evicted; a
    step that fails midway keeps the session, and its retry acts as a
    clean step would."""
    p = _jax_file(tmp_path, "attn_categorical")    # two attention blocks
    server, thread, url = _serve(p)
    try:
        spec = _get(url + "/spec")
        assert spec["attention"] and spec["protocol"] == "session"
        assert spec["window"] == 7 and spec["discrete"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/act", {"obs": [[0.0] * 4]})
        assert ei.value.code == 400
        assert "session" in json.loads(ei.value.read().decode())["error"]

        rng = np.random.default_rng(7)
        steps = [rng.normal(size=(2, 4)).astype(np.float32).tolist()
                 for _ in range(3)]
        r1 = _post(url + "/act", {"obs": steps[0], "session": "s1"})
        assert r1["t"] == 1 and np.asarray(r1["action"]).shape == (2, 1)
        r2 = _post(url + "/act", {"obs": steps[1], "session": "s1",
                                  "done": [True, False]})
        assert r2["t"] == 2
        with pytest.raises(urllib.error.HTTPError) as ei:   # batch size
            _post(url + "/act", {"obs": steps[2][:1], "session": "s1"})
        assert ei.value.code == 400

        # fail the third step inside the second block's feed-forward, after
        # both blocks wrote the token's keys and values into the cache
        calls, real_ff = [0], attn._ff

        def failing_ff(*a, **kw):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected device failure")
            return real_ff(*a, **kw)

        monkeypatch.setattr(attn, "_ff", failing_ff)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/act", {"obs": steps[2], "session": "s1"})
        assert ei.value.code == 500
        r3 = _post(url + "/act", {"obs": steps[2], "session": "s1"})
        monkeypatch.setattr(attn, "_ff", real_ff)
        assert r3["t"] == 3
        # the same three steps on a fresh session, none failing
        _post(url + "/act", {"obs": steps[0], "session": "s2"})
        _post(url + "/act", {"obs": steps[1], "session": "s2",
                             "done": [True, False]})
        assert _post(url + "/act", {"obs": steps[2], "session": "s2"}) == \
            dict(r3, session="s2")

        assert _post(url + "/act", {"session": "s1", "close": True})[
            "closed"]
        assert _post(url + "/act", {"obs": steps[0], "session": "s1"})[
            "t"] == 1

        monkeypatch.setattr(serve, "MAX_SESSIONS", 2)   # s2, s1 live
        _post(url + "/act", {"obs": steps[0], "session": "s3"})
        assert not _post(url + "/act", {"session": "s2", "close": True})[
            "closed"]                                   # the LRU went
        assert _post(url + "/act", {"session": "s1", "close": True})[
            "closed"]
    finally:
        _stop(server, thread)


def test_serve_main_subprocess(tmp_path):
    """``python -m ppoc_tpu_torch.serve`` on the CPU (PPOC_PLATFORM=cpu)
    prints its address and answers /spec."""
    p = _jax_file(tmp_path, "dense_categorical")
    env = dict(os.environ, PYTHONPATH=REPO, PPOC_PLATFORM="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppoc_tpu_torch.serve", p, "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), proc.stderr.read()
        spec = _get(line.split(" on ")[1].split()[0] + "/spec")
        assert spec["env"] == "cartpole" and spec["discrete"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode is not None

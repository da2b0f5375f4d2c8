"""Policy serving: rebuild a trained policy from a checkpoint and act.

Counterpart of ``ppoc_tpu/serve.py``:

    act = ppoc_tpu_torch.serve.load_policy("model.bin")
    action = act(obs)                  # [B, obs_dim] -> [B, act_dim]

On the card a feedforward policy acts through the whole-MLP kernel K5's
forward (``mlp.apply(..., "pallas")``); on the CPU (``device="cpu"``) the
same call runs K5's plain version.  The file's kernel_backend is ignored,
as the JAX package ignores it (it serves through "jnp", the same
function).  A mixture-of-experts policy acts through the plain mixture
with the file's gating top-k (``mlp.moe_backend("jnp", cfg.moe_topk)``,
as ``ppoc_tpu/serve.py:88-89``).  ``deterministic=True`` (the default) serves the Gaussian mean
or the categorical argmax; ``False`` samples the stochastic policy, with
noise drawn from a ``torch.Generator`` seeded by ``seed`` (not the JAX
package's draws).  Sequence checkpoints serve statefully, with no kernel,
as in the JAX package: a GRU/LSTM policy through one cell step a call,
the caller holding the state (``load_recurrent_policy``), an attention
policy through the KV-cache decode step (``load_attention_policy``; an
auxiliary value head in the file is never read).  Files from either
package load (``utils/checkpoint.py``).

A policy trained behind the host actor's running normalisation
(``envs/wrappers.RunningObsNorm``) sees its observations normalised with
the statistics, clip and eps of the ``.obsnorm.npz`` sidecar beside the
file, as ``ppoc_tpu/serve.py:93-115``; the config-carried affine
normalisation (``obs_loc`` / ``obs_scale``) likewise, and a file with both
is refused as ambiguous.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch


def _resolve_spec(cfg, dims):
    """EnvSpec for a checkpoint: the registry entry named by cfg.env when
    its dims match the file's, else a spec built from the file's own dims
    (the file is the ground truth)."""
    from ppoc_tpu_torch import envs
    from ppoc_tpu_torch.envs.core import EnvSpec

    try:
        spec = envs.make(cfg.env).spec
        if (spec.obs_dim == dims["obs_dim"]
                and spec.action_dim == dims["action_dim"]
                and spec.discrete == dims["discrete"]):
            return spec
        warnings.warn(
            f"checkpoint dims {dims} do not match env {cfg.env!r} "
            f"({spec.obs_dim}/{spec.action_dim}); serving with the file's "
            f"dims", stacklevel=3)
    except KeyError:
        pass  # env ids of the host bridge have no registry entry
    return EnvSpec(name=cfg.env, obs_dim=dims["obs_dim"],
                   action_dim=dims["action_dim"], horizon=0, gamma=0.99,
                   discrete=dims["discrete"])


def _affine_norm(cfg, dev):
    """obs -> (obs - loc) / scale from the config, on ``dev``, or None: a
    policy trained on normalised observations sees normalised ones here
    too."""
    if not getattr(cfg, "obs_loc", ()):
        return None
    loc = torch.tensor(cfg.obs_loc, dtype=torch.float32, device=dev)
    scale = torch.tensor(cfg.obs_scale, dtype=torch.float32, device=dev)
    return lambda x: (x - loc) / scale


def _load(path: str, ck, device):
    """(its policy params as tensors on the device, spec, normaliser) for
    ``ck``, the version-3/4 checkpoint read from ``path``."""
    from ppoc_tpu_torch.algo.trainer import resolve_device
    from ppoc_tpu_torch.utils import params

    if ck.cfg is None:
        raise ValueError(
            f"{path}: version-2 checkpoint has no embedded config; re-save "
            f"it with this version (Trainer.save) first")
    dev = resolve_device(device)
    norm = _affine_norm(ck.cfg, dev)
    sidecar = path + ".obsnorm.npz"
    if os.path.exists(sidecar):
        if norm is not None:
            raise ValueError(
                f"{path} carries BOTH config obs_loc/obs_scale and an "
                f".obsnorm.npz sidecar; ambiguous normalization")
        norm = _sidecar_norm(sidecar, dev)
    pol = params.policy_from_numpy(ck.state.policy_params, dev)
    return pol, _resolve_spec(ck.cfg, ck.dims), norm


def _sidecar_norm(sidecar: str, dev):
    """obs -> the training-time running normalisation from an
    ``.obsnorm.npz`` sidecar (``envs/wrappers.RunningStats``, with the
    sidecar's clip and eps, else the wrapper's defaults), in float64 on the
    host as the wrapper computes it, the result float32 on ``dev``
    (``ppoc_tpu/serve.py:93-115``)."""
    from ppoc_tpu_torch.envs.wrappers import RunningStats

    saved = np.load(sidecar)
    stats = RunningStats(int(np.asarray(saved["mean"]).shape[0]))
    stats.load_state_dict(saved)
    clip = float(saved["clip"]) if "clip" in saved else 10.0
    eps = float(saved["eps"]) if "eps" in saved else 1e-8

    def norm(x):
        z = stats.normalize(x.detach().cpu().numpy(), clip=clip, eps=eps)
        return torch.as_tensor(z).to(dev)

    return norm


def _obs_tensor(obs, norm, dev):
    """(obs as float32 [B, obs_dim] on ``dev``, normalised when the config
    says so, and whether it was one vector); numpy, lists and tensors are
    taken."""
    if not isinstance(obs, torch.Tensor):
        obs = np.asarray(obs, np.float32)
    obs = torch.as_tensor(obs, dtype=torch.float32, device=dev)
    if norm is not None:
        obs = norm(obs)
    single = obs.dim() == 1
    return (obs[None] if single else obs), single


def load_policy(path: str, deterministic: bool = True, seed: int = 0,
                device=None) -> Callable:
    """Load a checkpoint of a feedforward policy and return ``act(obs) ->
    action``.  ``obs`` is [B, obs_dim] (numpy or a tensor; a single
    [obs_dim] vector is also taken); a discrete policy returns int32 class
    ids [B, 1], a continuous one [B, act_dim], as tensors on ``device``
    (CUDA device 0 unless given; without CUDA that raises)."""
    from ppoc_tpu_torch.utils import checkpoint

    return _policy_actor(path, checkpoint.load(path), deterministic, seed,
                         device)


def _policy_actor(path, ck, deterministic, seed, device):
    from ppoc_tpu_torch.models import (attn, gru, mlp, moe,
                                       policy as policy_mod)
    from ppoc_tpu_torch.ops.adam import tree_leaves

    params, spec, norm = _load(path, ck, device)
    if gru.is_rnn(params["mlp"]):
        raise ValueError(
            f"{path} holds a recurrent (GRU/LSTM) policy, which needs a "
            f"hidden state between steps; use serve.load_recurrent_policy "
            f"instead")
    if attn.is_attn(params["mlp"]):
        raise ValueError(
            f"{path} holds an attention policy, which needs a KV cache "
            f"between steps; use serve.load_attention_policy instead")
    cfg = ck.cfg
    dev = tree_leaves(params["mlp"])[0].device
    backend = (mlp.moe_backend("jnp", cfg.moe_topk)
               if moe.is_moe(params["mlp"]) else "pallas")
    default_gen = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def act(obs, generator: Optional[torch.Generator] = None):
        x, single = _obs_tensor(obs, norm, dev)
        out = mlp.apply(params["mlp"], x, cfg.activation, backend)
        if deterministic:       # the mean, or the first of tied maxima
            a = (out.argmax(-1, keepdim=True).to(torch.int32)
                 if spec.discrete else out)
        else:
            noise = policy_mod.draw_noise(
                out.shape, spec.discrete,
                default_gen if generator is None else generator).to(dev)
            a, _ = policy_mod.act_from_out(out, spec.discrete,
                                           params.get("log_std"), False,
                                           noise)
        return a[0] if single else a

    act.recurrent = False
    act.cfg = cfg
    act.spec = spec
    return act


def load_recurrent_policy(path: str, deterministic: bool = True,
                          seed: int = 0, device=None):
    """Load a GRU/LSTM-trunk checkpoint and return a stateful actor whose
    state the caller holds:

        act = ppoc_tpu_torch.serve.load_recurrent_policy("model.bin")
        h = act.initial_state(batch_size)      # zeros: an episode start
        action, h = act(obs, h)                # [B, obs] -> ([B, act], h')

    ``h`` is [B, gru.state_size] (``act.state_size``): H wide for a GRU,
    2H (h ‖ c) for an LSTM; zero a lane's row at its episode start.  One
    cell step and the head a call, on ``device`` (CUDA device 0 unless
    given), with no kernel (``ppoc_tpu/serve.py:175-229``).  A single
    [obs_dim] observation takes a single [S] state."""
    from ppoc_tpu_torch.utils import checkpoint

    return _recurrent_actor(path, checkpoint.load(path), deterministic,
                            seed, device)


def _recurrent_actor(path, ck, deterministic, seed, device):
    from ppoc_tpu_torch.models import gru, policy as policy_mod

    params, spec, norm = _load(path, ck, device)
    if not gru.is_rnn(params["mlp"]):
        raise ValueError(
            f"{path} holds a non-recurrent policy; use serve.load_policy "
            f"or serve.load_attention_policy")
    cfg = ck.cfg
    dev = params["mlp"]["cell"]["wh"].device
    default_gen = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def act(obs, h, generator: Optional[torch.Generator] = None):
        x, single = _obs_tensor(obs, norm, dev)
        if not isinstance(h, torch.Tensor):
            h = np.array(h, np.float32)
        h = torch.as_tensor(h, dtype=torch.float32, device=dev)
        if h.dim() == 1:
            h = h[None]
        noise = None
        if not deterministic:
            noise = policy_mod.draw_noise(
                (x.shape[0], spec.action_dim), spec.discrete,
                default_gen if generator is None else generator).to(dev)
        h2, out = gru.step(params["mlp"], h, x, cfg.activation)
        a, _ = policy_mod.act_from_out(out, spec.discrete,
                                       params.get("log_std"), deterministic,
                                       noise)
        return (a[0], h2[0]) if single else (a, h2)

    act.initial_state = lambda batch_size=None: gru.initial_state(
        params["mlp"], () if batch_size is None else (batch_size,))
    act.state_size = gru.state_size(params["mlp"])
    act.recurrent = True
    act.cfg = cfg
    act.spec = spec
    return act


def load_attention_policy(path: str, deterministic: bool = True,
                          seed: int = 0, device=None):
    """Load an attention-trunk checkpoint and return a stateful actor whose
    per-episode state is the decode KV cache:

        act = ppoc_tpu_torch.serve.load_attention_policy("model.bin")
        s = act.initial_state(batch_size)
        action, s = act(obs, s)               # [B, obs] -> ([B, act], cache)
        s = act.reset_lanes(s, done)          # at episode ends

    The caller owns the cache (``models/attn.py``), which a step updates
    in place: it writes the token's keys and values at the window step
    and advances ``cache["t"]`` last, so a step that fails midway leaves
    the step count where it was and a retry rewrites the same slot before
    reading it.  Episodes longer than the window clamp to its last
    position."""
    from ppoc_tpu_torch.utils import checkpoint

    return _attention_actor(path, checkpoint.load(path), deterministic,
                            seed, device)


def _attention_actor(path, ck, deterministic, seed, device):
    from ppoc_tpu_torch.models import attn, policy as policy_mod

    params, spec, norm = _load(path, ck, device)
    if not attn.is_attn(params["mlp"]):
        raise ValueError(
            f"{path} holds a non-attention policy; use serve.load_policy")
    cfg = ck.cfg
    dev = params["mlp"]["attn"]["pos"].device
    default_gen = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def act(obs, cache, generator: Optional[torch.Generator] = None):
        x, single = _obs_tensor(obs, norm, dev)
        noise = None
        if not deterministic:
            noise = policy_mod.draw_noise(
                (x.shape[0], spec.action_dim), spec.discrete,
                default_gen if generator is None else generator).to(dev)
        cache, out = attn.step(params["mlp"], cache, x, cfg.activation)
        a, _ = policy_mod.act_from_out(out, spec.discrete,
                                       params.get("log_std"), deterministic,
                                       noise)
        return (a[0] if single else a), cache

    act.initial_state = lambda batch_size=None: attn.initial_cache(
        params["mlp"], (1,) if batch_size is None else (batch_size,))
    act.reset_lanes = attn.reset_lanes
    act.window = attn.window(params["mlp"])
    act.recurrent = True
    act.cfg = cfg
    act.spec = spec
    return act


# --------------------------------------------------------------------------
# HTTP inference server
# --------------------------------------------------------------------------

MAX_SESSIONS = 64


def make_server(path: str, host: str = "127.0.0.1", port: int = 8000,
                deterministic: bool = True, seed: int = 0, device=None):
    """An HTTP policy server over a checkpoint (stdlib only, threaded).

    Endpoints (JSON):
      GET  /spec  -> {env, obs_dim, action_dim, discrete, recurrent,
                      rnn_hidden, deterministic} (+ attention, protocol,
                      window for an attention policy)
      POST /act   -> body {"obs": [[...]] | [...], "h": [[...]]?},
                     reply {"action": ..., "h": ...?}

    A GRU/LSTM policy's state travels with the request: "h" is [B, S]
    (one row per obs; S = H for a GRU, 2H for an LSTM, whose state is h ‖
    c), omitted or null at an episode start (zeros), and the reply's "h"
    is the next call's.  The JAX package's server checks "h" against
    [B, rnn_hidden], and so refuses an LSTM's own state; this one checks
    it against the state's width.

    Attention checkpoints serve statefully, the KV cache kept per session:
      POST /act {"obs": ..., "session": "my-id", "done": [bools]?}
    creates the session's cache on first use (its batch size fixed by that
    call), advances it each call, and moves finished lanes' episode starts
    when "done" is given; {"session": "my-id", "close": true} frees it.
    At most ``MAX_SESSIONS`` live sessions, the least recently used
    evicted.  A step that fails keeps the session (the client can retry
    the step).

    Device calls are serialised with a lock.  Returns the HTTPServer: call
    serve_forever() or run it in a thread.
    """
    import http.server
    import json
    import threading

    from ppoc_tpu_torch.models import attn, gru
    from ppoc_tpu_torch.utils import checkpoint

    ck = checkpoint.load(path)
    trunk = ck.state.policy_params["mlp"]
    attention, recurrent = attn.is_attn(trunk), gru.is_rnn(trunk)
    actor = (_attention_actor if attention else
             _recurrent_actor if recurrent else _policy_actor)
    act = actor(path, ck, deterministic, seed, device)
    spec = act.spec
    rnn_hidden = int(act.cfg.rnn_hidden) if recurrent else 0
    width = act.state_size if recurrent else 0
    lock = threading.Lock()
    sessions = {}  # attention: session id -> KV cache (insertion = LRU)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code, obj):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/spec":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            info = {"env": spec.name, "obs_dim": spec.obs_dim,
                    "action_dim": spec.action_dim,
                    "discrete": spec.discrete, "recurrent": recurrent,
                    "rnn_hidden": rnn_hidden, "deterministic": deterministic}
            if attention:
                info.update(attention=True, protocol="session",
                            window=int(act.window))
            self._reply(200, info)

        def do_POST(self):
            if self.path != "/act":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n).decode("utf-8"))
                if attention and req.get("close"):
                    sid = req.get("session")
                    with lock:
                        existed = sessions.pop(sid, None) is not None
                    return self._reply(200, {"session": sid,
                                             "closed": existed})
                obs = np.asarray(req["obs"], np.float32)
                single = obs.ndim == 1
                if single:
                    obs = obs[None]
                if obs.ndim != 2 or obs.shape[1] != spec.obs_dim:
                    raise ValueError(
                        f"obs must be [B, {spec.obs_dim}], got {obs.shape}")
                if attention:
                    return self._act_attention(req, obs, single)
                if recurrent:
                    return self._act_recurrent(req, obs, single)
                with lock:
                    a = act(obs).cpu().numpy()
                out = a.tolist()
                self._reply(200, {"action": out[0] if single else out})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # device/runtime failure: a 500 body a
                # non-Python client can read, not a dropped socket
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _act_recurrent(self, req, obs, single):
            h = req.get("h")
            if h is None:
                h = act.initial_state(obs.shape[0])
            else:
                h = np.asarray(h, np.float32)
                if single and h.ndim == 1:
                    h = h[None]
                if h.shape != (obs.shape[0], width):
                    raise ValueError(
                        f"h must be [{obs.shape[0]}, {width}] (one row per "
                        f"obs, the state's width), got {h.shape}")
            with lock:
                a, h2 = act(obs, h)
                a, h2 = a.cpu().numpy(), h2.cpu().numpy()
            out = {"action": a.tolist(), "h": h2.tolist()}
            if single:
                out = {k: v[0] for k, v in out.items()}
            self._reply(200, out)

        def _act_attention(self, req, obs, single):
            sid = req.get("session")
            if not isinstance(sid, str) or not sid:
                raise ValueError(
                    "attention serving is stateful: pass a non-empty "
                    "'session' string; the server keeps that session's "
                    "KV cache")
            done = req.get("done")
            if done is not None:
                done = np.asarray(done, bool)
                if done.shape != (obs.shape[0],):
                    raise ValueError(
                        f"done must be [{obs.shape[0]}] bools (one per "
                        f"obs row), got {done.shape}")
            with lock:
                cache = sessions.pop(sid, None)  # pop: re-insert = LRU bump
                if cache is None:
                    while len(sessions) >= MAX_SESSIONS:
                        sessions.pop(next(iter(sessions)))
                    cache = act.initial_state(obs.shape[0])
                elif cache["start"].shape[0] != obs.shape[0]:
                    sessions[sid] = cache
                    raise ValueError(
                        f"session {sid!r} was created with batch size "
                        f"{cache['start'].shape[0]}, got {obs.shape[0]} "
                        f"obs rows; close it or use a new session")
                # the session goes back in whatever happens: a step that
                # fails midway has not advanced cache["t"] (attn.step
                # advances it last), so the client can retry the step
                try:
                    a, cache = act(obs, cache)
                    if done is not None:
                        cache = act.reset_lanes(cache, torch.as_tensor(
                            done, device=cache["start"].device))
                finally:
                    sessions[sid] = cache
                a = a.cpu().numpy()
            out = {"action": a.tolist(), "session": sid, "t": cache["t"]}
            if single:
                out["action"] = out["action"][0]
            self._reply(200, out)

    return http.server.ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    """``python -m ppoc_tpu_torch.serve model.bin [--port P]
    [--stochastic]``.  Serves on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins
    the CPU, as it pins the JAX package's platform."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="ppoc_tpu_torch.serve",
        description="serve a trained policy checkpoint over HTTP")
    ap.add_argument("checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--stochastic", action="store_true",
                    help="sample the policy instead of serving its mode")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ppoc_tpu_torch.cli import platform_device

    server = make_server(args.checkpoint, args.host, args.port,
                         deterministic=not args.stochastic, seed=args.seed,
                         device=platform_device(ap))
    host, port = server.server_address[:2]
    print(f"serving {args.checkpoint} on http://{host}:{port} "
          f"(GET /spec, POST /act)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

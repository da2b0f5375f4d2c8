"""Host-environment protocol and trainer: any env stepped on the host feeds
the learner on the card (counterpart of ``ppoc_tpu/envs/host.py``).

A host-protocol venv has

    venv.spec                  -> EnvSpec
    venv.n_envs                -> int
    venv.reset() -> obs        [n, obs_dim] numpy
    venv.step(a) -> (obs_after, next_obs, reward, terminated, truncated)

where ``next_obs`` is the true successor (the GAE bootstrap's source) and
``obs_after`` the observation after the per-env autoreset, which the policy
acts on next (the reference's collect_trajectories, src/ppo.cu:54-79).
Implementations: :class:`NativeHostVecEnv` below (the C++ engine of
``ppoc_tpu_torch/native``, the reference's native CPU envs, src/env.c, run
vectorised) and ``envs/gym_bridge.GymVecEnv`` (any Gymnasium env).

Two actors collect a window:

* the device actor (:func:`collect_host`): one batched policy forward a
  step on the trainer's device (K5 under "pallas"), the action noise drawn
  from the trainer's ``torch.Generator``, one round trip a step;
* the host actor (:class:`HostPolicy`, :func:`collect_host_np`): a numpy
  mirror of the policy, its weights copied to the host once a fit, the
  noise from a numpy generator seeded from words of the trainer's
  generator; no device traffic until the window ends.

Either way the trajectory crosses to the device once a window, as
``ppo.Transition`` tensors, and the learner is ``ppo.update_step`` on it:
two value forwards for V(s) and V(s') (K5), K2, then K3 and K4 (K6 for a
categorical policy) under the fused gate.  :class:`HostTrainer` runs the
loop; with ``overlap=True`` the host actor collects window i+1 with the
pre-update weights while the card fits window i.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.envs.core import Env, EnvSpec
from ppoc_tpu_torch.models import mlp, policy as policy_mod


class NativeHostVecEnv:
    """Host-protocol adapter over the C++ engine
    (``native.NativeVecEnv``) with a per-env autoreset; its spec is the
    port's registry env of the same name (gamma, horizon)."""

    def __init__(self, name: str, n_envs: int, seed: int = 0):
        from ppoc_tpu_torch import native
        from ppoc_tpu_torch.envs.core import make

        self._nat = native.NativeVecEnv(name, n_envs)
        self._resetter = native.NativeVecEnv(name, n_envs)
        self.n_envs = n_envs
        self._seed = seed
        self._episode = 0
        self.spec: EnvSpec = make(name).spec

    def reset(self) -> np.ndarray:
        self._episode += 1
        return self._nat.reset(seed=self._seed + 7919 * self._episode)

    def step(self, actions: np.ndarray):
        a = np.ascontiguousarray(actions, np.float32).reshape(self.n_envs, -1)
        next_obs, reward, term, trunc = self._nat.step(a)
        done = term | trunc
        obs_after = next_obs.copy()
        if done.any():
            # the finished instances restart from a freshly seeded batch
            # (the engine's reset is vectorised and cheap)
            idx = np.nonzero(done)[0]
            self._episode += 1
            fresh = self._resetter.reset(seed=self._seed + 7919 * self._episode)
            self._nat.states[idx] = self._resetter.states[idx]
            self._nat.steps[idx] = 0
            obs_after[idx] = fresh[idx]
        return obs_after, next_obs, reward, term, trunc

    def close(self):
        pass


_ACTIVATIONS = {"relu": lambda x: np.maximum(x, 0.0), "tanh": np.tanh,
                "none": lambda x: x}


class HostPolicy:
    """Numpy mirror of the policy for host-side rollouts: the reference's
    CPU actor (src/policy.cu:76-89), weights copied from the device once
    (``.cpu()``) when it is built.  Dense and mixture-of-experts trunks
    (top-k gating with ``moe_topk``), Gaussian or categorical heads, in
    float32 numpy; ``ppoc_tpu/envs/host.py:78-190`` line for line, so the
    same weights and numpy generator give the JAX package's bits.  The
    stored log-probs are what the learner takes as the "old" ones."""

    def __init__(self, policy_params, activation: str, discrete: bool,
                 moe_topk: int = 0):
        trunk = policy_params["mlp"]
        if isinstance(trunk, dict) and "experts" in trunk:
            self.router = tuple(_host(a) for a in trunk["router"])
            self.experts = [(_host(w), _host(b)) for w, b in trunk["experts"]]
            self.layers = None
            self.moe_topk = moe_topk
        else:
            self.layers = [(_host(w), _host(b)) for w, b in trunk]
        self.log_std = None if discrete else _host(policy_params["log_std"])
        self.discrete = discrete
        if activation not in _ACTIVATIONS:
            raise KeyError(f"unknown activation {activation!r}")
        self.act = _ACTIVATIONS[activation]

    def forward(self, obs: np.ndarray) -> np.ndarray:
        h = np.asarray(obs, np.float32)
        if self.layers is None:
            return self._forward_moe(h)
        n = len(self.layers)
        for i, (w, b) in enumerate(self.layers):
            h = h @ w + b
            if i < n - 1:
                h = self.act(h)
        return h

    def _forward_moe(self, x: np.ndarray) -> np.ndarray:
        """The mixture (``models/moe.apply``): softmax gate, top-k masked
        and renormalised when 0 < moe_topk < E, every expert on every
        row."""
        wr, br = self.router
        logits = x @ wr + br
        logits = logits - logits.max(axis=-1, keepdims=True)
        g = np.exp(logits)
        g /= g.sum(axis=-1, keepdims=True)
        e = g.shape[-1]
        if 0 < self.moe_topk < e:
            idx = np.argsort(-g, axis=-1)[..., : self.moe_topk]
            mask = np.zeros_like(g)
            np.put_along_axis(mask, idx, 1.0, axis=-1)
            g = g * mask
            g /= np.maximum(g.sum(axis=-1, keepdims=True), 1e-9)
        w0, b0 = self.experts[0]
        h = np.einsum("bi,eio->beo", x, w0) + b0
        for layer in range(1, len(self.experts)):
            h = self.act(h)
            w, b = self.experts[layer]
            h = np.einsum("beo,eoh->beh", h, w) + b
        return np.einsum("be,beo->bo", g, h).astype(np.float32)

    def sample(self, obs: np.ndarray, rng: np.random.Generator,
               deterministic: bool = False):
        """(action, log_prob) for a batch of observations.
        ``deterministic`` takes the Gaussian mean or the categorical argmax
        (the log-probs are still those of the returned action under the
        stochastic policy); otherwise Gaussian noise or Gumbel-max draws
        from ``rng``."""
        out = self.forward(obs)
        if self.discrete:
            logits, logp_all = _log_softmax(out)
            if deterministic:
                a = np.argmax(logits, axis=-1)
            else:
                g = rng.gumbel(size=logits.shape).astype(np.float32)
                a = np.argmax(logits + g, axis=-1)
            lp = np.take_along_axis(logp_all, a[:, None], axis=-1)[:, 0]
            return a[:, None].astype(np.int32), lp.astype(np.float32)
        if deterministic:
            k = out.shape[-1]
            lp = (-0.5 * k * np.log(2.0 * np.pi)
                  - np.sum(self.log_std, axis=-1)) * np.ones(out.shape[0])
            return out.astype(np.float32), lp.astype(np.float32)
        eps = rng.standard_normal(out.shape).astype(np.float32)
        action = (out + eps * np.exp(self.log_std)).astype(np.float32)
        return action, self._gaussian_log_prob(out, action)

    def _gaussian_log_prob(self, mu: np.ndarray, action: np.ndarray):
        k = action.shape[-1]
        z = (action - mu) * np.exp(-self.log_std)
        lp = (-0.5 * k * np.log(2.0 * np.pi)
              - np.sum(self.log_std + 0.5 * np.square(z), axis=-1))
        return lp.astype(np.float32)

    def log_prob(self, obs: np.ndarray, action: np.ndarray) -> np.ndarray:
        """The log-probs :meth:`sample` stores for ``action`` drawn at
        ``obs`` (stochastically), by the same arithmetic, so bit for bit:
        a stored window's log-probs against the weights it claims."""
        out = self.forward(obs)
        if self.discrete:
            _, logp_all = _log_softmax(out)
            a = np.asarray(action).reshape(-1).astype(np.int64)
            return np.take_along_axis(logp_all, a[:, None],
                                      axis=-1)[:, 0].astype(np.float32)
        return self._gaussian_log_prob(out, np.asarray(action, np.float32))


def _log_softmax(out: np.ndarray):
    """(max-shifted logits, log-softmax) of a categorical head's output."""
    logits = out - out.max(axis=-1, keepdims=True)
    return logits, logits - np.log(np.sum(np.exp(logits), axis=-1,
                                          keepdims=True))


def _host(x) -> np.ndarray:
    """A weight as a float32 numpy array (a tensor copied with .cpu())."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _transition(rows, force_truncate: bool, device) -> ppo.Transition:
    """Stack a window's host rows [(obs, action, log_prob, next_obs,
    reward, terminated, truncated)] into one Transition on ``device`` (the
    window's one crossing); with ``force_truncate`` the last step is marked
    truncated unless it terminated (src/ppo.cu:70-74)."""
    stack = [np.stack(x) for x in zip(*rows)]
    if force_truncate:
        stack[6][-1] |= ~stack[5][-1]
    return ppo.Transition(*(torch.as_tensor(x).to(device) for x in stack))


def collect_host_np(cfg: PPOConfig, venv, policy: HostPolicy,
                    rng: np.random.Generator, length: int,
                    obs0: Optional[np.ndarray] = None,
                    force_truncate: bool = True,
                    deterministic: bool = False, device="cpu"
                    ) -> Tuple[ppo.Transition, np.ndarray]:
    """All-host rollout: numpy policy and host venv, no device traffic
    until the trajectory crosses to ``device`` once at the end.  Same
    contract as :func:`collect_host`; returns (trajectory, last
    observation)."""
    obs = venv.reset() if obs0 is None else obs0
    rows = []
    for _ in range(length):
        action, log_prob = policy.sample(obs, rng, deterministic)
        obs_after, next_obs, reward, term, trunc = venv.step(action)
        rows.append((obs, action, log_prob, next_obs, reward, term, trunc))
        obs = obs_after
    return _transition(rows, force_truncate, device), obs


@torch.no_grad()
def collect_host(cfg: PPOConfig, venv, policy_params,
                 generator: torch.Generator, length: int,
                 backend: Optional[str] = None,
                 obs0: Optional[np.ndarray] = None,
                 force_truncate: bool = True, device=None
                 ) -> Tuple[ppo.Transition, np.ndarray]:
    """Host rollout with the device actor: per step one batched policy
    forward of ``policy_params`` on their device (``mlp.apply`` on
    ``backend``, default cfg's, so K5 under "pallas") and the action from
    noise drawn from ``generator`` (``policy.draw_noise``), then the host
    venv steps the actions (collect_trajectories, src/ppo.cu:54-79, with
    n_envs instances in lockstep).  ``obs0=None`` resets the venv at entry;
    the previous call's last observation continues its episodes
    (reset_per_fit=False).  Returns (trajectory on ``device``, default the
    params', last observation)."""
    from ppoc_tpu_torch.ops.adam import tree_leaves

    backend = ppo.backend_of(cfg) if backend is None else backend
    dev = tree_leaves(policy_params["mlp"])[0].device
    discrete = venv.spec.discrete
    log_std = policy_params.get("log_std")
    obs = venv.reset() if obs0 is None else obs0
    rows = []
    for _ in range(length):
        out = mlp.apply(policy_params["mlp"],
                        torch.as_tensor(obs, dtype=torch.float32).to(dev),
                        cfg.activation, backend)
        noise = policy_mod.draw_noise(tuple(out.shape), discrete,
                                      generator).to(dev)
        action, logp = policy_mod.act_from_out(out, discrete, log_std,
                                               False, noise)
        action, logp = action.cpu().numpy(), logp.cpu().numpy()
        obs_after, next_obs, reward, term, trunc = venv.step(action)
        rows.append((obs, action, logp, next_obs, reward, term, trunc))
        obs = obs_after
    return _transition(rows, force_truncate,
                       dev if device is None else device), obs


def seeded_rng(generator: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from two 32-bit words drawn from
    ``generator`` (the JAX package seeds it from a key's two words)."""
    words = torch.randint(0, 2 ** 32, (2,), generator=generator,
                          dtype=torch.int64)
    return np.random.default_rng([int(w) for w in words])


def _on(traj: ppo.Transition, device) -> ppo.Transition:
    return ppo.Transition(*(x.to(device) for x in traj))


class HostTrainer:
    """Trainer over host-protocol envs: an actor on the host, the learner on
    the card.  The subset of ``algo/trainer.Trainer`` the JAX package's
    ``HostTrainer`` has: train / train_fit / train_epoch / evaluate / save
    / load.

    ``backend=None`` takes cfg.kernel_backend (``ppo.backend_of``: "auto"
    and "pallas" are the kernels on the card); an explicit ``backend``
    wins, as in the JAX signature.  The JAX package defaults its host
    trainer to "jnp", so there ``--kernel-backend pallas`` with a gym env
    runs no kernel (ROADMAP.md §3, F5): the port does not copy that.  The
    learner runs under the chosen backend, while ``save`` embeds cfg as
    given.  ``device=None`` means CUDA device 0 (it raises without CUDA:
    pass ``device="cpu"``).  The trainer owns one ``torch.Generator``
    seeded from cfg.seed: the device actor's noise, the host actor's numpy
    seeds and every fit's row-id streams come from it."""

    def __init__(self, cfg: PPOConfig, venv, eval_venv,
                 backend: Optional[str] = None, actor: str = "device",
                 overlap: bool = False, device=None):
        from ppoc_tpu_torch.algo.trainer import (check_kernel_fit,
                                                 resolve_device)
        from ppoc_tpu_torch.ops import _build

        if venv.n_envs != cfg.n_envs:
            raise ValueError(
                f"venv has {venv.n_envs} envs but cfg.n_envs is {cfg.n_envs} "
                f"— the minibatch schedule (cfg.num_minibatches) is derived "
                f"from cfg.n_envs * rollout_len")
        if eval_venv.n_envs != cfg.eval_envs:
            raise ValueError(
                f"eval_venv has {eval_venv.n_envs} envs but cfg.eval_envs "
                f"is {cfg.eval_envs}")
        if cfg.num_minibatches < 1:
            raise ValueError(
                f"minibatch_size ({cfg.minibatch_size}) exceeds steps_per_fit "
                f"({cfg.steps_per_fit}): zero minibatches, nothing would "
                f"train")
        if actor not in ("device", "host"):
            raise ValueError(
                f"actor must be 'device' or 'host', got {actor!r}")
        if overlap and actor != "host":
            raise ValueError(
                "overlap=True requires actor='host': the device actor's "
                "per-step sampling would serialize against the in-flight "
                "update it is meant to hide")
        if cfg.zero1:
            raise ValueError(
                "zero1 is not supported on the host bridge: its learner "
                "runs single-device (no mesh to shard optimizer state over)")
        if getattr(cfg, "obs_loc", ()):
            raise ValueError(
                "obs_loc/obs_scale apply to on-device envs "
                "(envs.make_for); host-bridge envs use the running "
                "normalization wrappers (obs_norm=True)")
        if cfg.rnn_hidden > 0 or cfg.attn_dim > 0:
            raise ValueError(
                "rnn_hidden/attn_dim > 0 (sequence trunks) is not supported "
                "on the host bridge: the host actor and the learner's row "
                "minibatching are stateless; use an on-device env "
                "(e.g. 'pendulum_po', 'recall') for sequence training")
        self.cfg = cfg
        self.venv = venv
        self.eval_venv = eval_venv
        self.device = resolve_device(device)
        # a spec-only Env for the learner (it never resets or steps)
        self.env = Env(spec=venv.spec, reset=None, step=None)
        # the learner's config: cfg under the chosen backend (a mixture
        # keeps its top-k in the string, ppo.backend_of, so the actor's
        # gating and the learner's agree)
        self._learn_cfg = (cfg if backend is None
                           else cfg.replace(kernel_backend=backend))
        self.backend = ppo.backend_of(self._learn_cfg)
        if self.device.type == "cuda":
            check_kernel_fit(self._learn_cfg, self.env,
                             _build.smem_optin(self.device), rollout=False)
        self.actor = actor
        self.overlap = overlap
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.state = ppo.init_train_state(cfg, self.env, self.generator,
                                          self.device)
        self._obs = None       # the carried observation, reset_per_fit=False
        self._pending = None   # overlap: the next window, collected already

    def host_policy(self) -> HostPolicy:
        """The current policy's numpy mirror (one copy from the device)."""
        return HostPolicy(self.state.policy_params, self.cfg.activation,
                          self.env.spec.discrete, moe_topk=self.cfg.moe_topk)

    def _collect(self, policy: Optional[HostPolicy] = None, device=None):
        """One training window from self.venv with the current weights (the
        host actor: ``policy``, or a mirror of the current weights),
        threading the carried observation for reset_per_fit=False.  The
        trajectory lands on ``device`` (default the trainer's)."""
        obs0 = None if self.cfg.reset_per_fit else self._obs
        device = self.device if device is None else device
        if self.actor == "host":
            traj, last = collect_host_np(
                self.cfg, self.venv, policy or self.host_policy(),
                seeded_rng(self.generator), self.cfg.rollout_len, obs0=obs0,
                device=device)
        else:
            traj, last = collect_host(
                self.cfg, self.venv, self.state.policy_params,
                self.generator, self.cfg.rollout_len, self.backend,
                obs0=obs0, device=device)
        if not self.cfg.reset_per_fit:
            self._obs = last
        return traj

    def _update(self, traj: ppo.Transition):
        """The learner on one window: the fit's row-id streams, then
        ``ppo.update_step`` under the learner's backend.  Returns (state',
        metrics) without a host sync: on the card it only queues work."""
        draws = ppo.draw_streams(self._learn_cfg, self.generator, self.device)
        return ppo.update_step(self._learn_cfg, self.env, self.state, traj,
                               draws, None)

    def train_fit(self) -> ppo.FitMetrics:
        traj = self._collect()
        self.state, metrics = self._update(traj)
        return metrics

    def _train_fit_overlapped(self) -> ppo.FitMetrics:
        """Actor/learner overlap: queue the update of window i on the card,
        then collect window i+1 on the host while it runs, with the
        pre-update (one-fit-stale) weights.  Their host copy is taken
        before the update's launch, which therefore never waits behind it,
        and nothing in ``ppo.update_step`` syncs the host (the Adam
        timestep is a Python int; the metrics stay tensors).  Each window
        is one Adam phase stale against the params it updates; the ratio
        reads the stored log-probs, so the objective stays well formed."""
        if self._pending is None:     # prime: the first window, serially
            self._pending = self._collect(device="cpu")
        traj = _on(self._pending, self.device)
        policy = self.host_policy()   # the pre-update weights, on the host
        new_state, metrics = self._update(traj)
        self._pending = self._collect(policy, device="cpu")
        self.state = new_state
        return metrics

    def train_epoch(self) -> ppo.FitMetrics:
        """fits_per_epoch fits; their metrics meaned, as the Trainer's."""
        fit = self._train_fit_overlapped if self.overlap else self.train_fit
        ms = [fit() for _ in range(self.cfg.fits_per_epoch)]
        return ppo.FitMetrics(*(torch.stack(x).mean() for x in zip(*ms)))

    def evaluate(self, deterministic: bool = False) -> ppo.EvalMetrics:
        """cfg.eval_len steps on eval_venv with the genuine done flags:
        the stochastic policy by default (the device actor's, or the host
        actor's with actor="host"); ``deterministic=True`` serves the
        Gaussian mean or the categorical argmax through :class:`HostPolicy`.
        Returns Python floats."""
        if self.actor == "host" or deterministic:
            traj, _ = collect_host_np(
                self.cfg, self.eval_venv, self.host_policy(),
                seeded_rng(self.generator), self.cfg.eval_len,
                force_truncate=False, deterministic=deterministic)
        else:
            traj, _ = collect_host(
                self.cfg, self.eval_venv, self.state.policy_params,
                self.generator, self.cfg.eval_len, self.backend,
                force_truncate=False, device="cpu")
        if self.cfg.eval_estimator == "reference":
            m = ppo.eval_metrics_reference(traj, self.env.spec.gamma)
        else:
            m = ppo.eval_metrics_from_traj(traj, self.env.spec.gamma)
        return ppo.EvalMetrics(*(float(x) for x in m))

    def train(self, n_epochs: Optional[int] = None, log: bool = True,
              stop_at_R: Optional[float] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              initial_eval: bool = False,
              eval_deterministic: bool = False,
              on_epoch_end=None,
              epoch_offset: int = 0) -> List[Dict[str, Any]]:
        """The epoch loop, with ``Trainer.train``'s signature: periodic
        checkpoints (a resumed host run restores the optimisation state
        and the generator, then starts from fresh env resets: host envs
        are not serialisable), ``stop_at_R``, ``eval_deterministic`` and
        ``on_epoch_end(i, row)`` (a truthy return stops).  ``initial_eval``
        defaults False: a host evaluation is a whole eval_len rollout of
        real env steps."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        history: List[Dict[str, Any]] = []
        if initial_eval:
            m0 = self.evaluate(deterministic=eval_deterministic)
            if log:
                print(f"J: {m0.J:f} R: {m0.R:f} Episodes: {int(m0.episodes)}",
                      flush=True)
        for i in range(n_epochs):
            tic = time.perf_counter()
            fit = ppo.FitMetrics(*(float(x) for x in self.train_epoch()))
            toc = time.perf_counter()
            ev = self.evaluate(deterministic=eval_deterministic)
            row = {"epoch": i, "entropy": fit.entropy, "time_s": toc - tic,
                   "J": ev.J, "R": ev.R, "episodes": int(ev.episodes),
                   "value_loss": fit.value_loss,
                   "policy_loss": fit.policy_loss,
                   "mean_reward": fit.mean_reward}
            history.append(row)
            if log:
                print(f"Epoch: {i} Entropy: {row['entropy']:f} "
                      f"Time {row['time_s']:f}s J: {row['J']:f} "
                      f"R: {row['R']:f} Episodes: {row['episodes']}",
                      flush=True)
            if (checkpoint_path is not None and checkpoint_every > 0
                    and (i + 1) % checkpoint_every == 0):
                self.save(checkpoint_path,
                          meta={"epochs_done": epoch_offset + i + 1})
            if stop_at_R is not None and ev.R >= stop_at_R:
                break
            if on_epoch_end is not None and on_epoch_end(i, row):
                break
        return history

    def save(self, path: str, meta: Optional[Dict[str, Any]] = None) -> None:
        """The checkpoint (config, state, generator), then the venv's
        normalisation sidecars: ``<path>.obsnorm.npz`` with the owning
        RunningObsNorm's clip and eps, ``<path>.retnorm.npz``.  The
        checkpoint's save keeps the sidecars this trainer re-writes
        (atomically) and removes any other."""
        from ppoc_tpu_torch.envs.wrappers import RunningObsNorm
        from ppoc_tpu_torch.utils import checkpoint

        stats = getattr(self.venv, "stats", None)
        rstats = getattr(self.venv, "ret_stats", None)
        keep = tuple(s for s, present in ((".obsnorm.npz", stats is not None),
                                          (".retnorm.npz", rstats is not None))
                     if present)
        checkpoint.save(path, self.cfg, self.env.spec, self.state,
                        generator=self.generator, keep_sidecars=keep,
                        meta=meta)
        if stats is not None:
            # clip and eps live on the RunningObsNorm that owns the stats
            # (a RunningRewardNorm outside it passes them through)
            owner = self.venv
            while owner is not None and not isinstance(owner, RunningObsNorm):
                owner = getattr(owner, "venv", None)
            owner = owner if owner is not None else self.venv
            stats.save(path + ".obsnorm.npz",
                       clip=np.float64(getattr(owner, "clip", 10.0)),
                       eps=np.float64(getattr(owner, "eps", 1e-8)))
        if rstats is not None:
            rstats.save(path + ".retnorm.npz")

    def load(self, path: str) -> None:
        """Restore params, the three Adam states and, from a file the port
        wrote, the generator's position; then the obs statistics (into the
        eval venv's too where it holds its own) and the return statistics
        from their sidecars.  A pending overlap window, collected by the
        pre-load policy, is dropped."""
        from ppoc_tpu_torch.algo.trainer import restore
        from ppoc_tpu_torch.utils import checkpoint

        restore(self, checkpoint.load(path), path)
        self._pending = None
        stats = getattr(self.venv, "stats", None)
        sidecar = path + ".obsnorm.npz"
        if os.path.exists(sidecar):
            if stats is None:
                warnings.warn(
                    f"{path} was trained with running obs normalization "
                    f"({sidecar} exists) but this trainer's venv is not "
                    f"norm-wrapped (obs_norm=False?) — the restored policy "
                    f"would see RAW observations and misbehave")
            else:
                loaded = np.load(sidecar)
                stats.load_state_dict(loaded)
                estats = getattr(self.eval_venv, "stats", None)
                if estats is not None and estats is not stats:
                    estats.load_state_dict(loaded)
        elif stats is not None:
            warnings.warn(
                f"{path} has no obs-norm sidecar but this trainer's venv is "
                f"norm-wrapped — the checkpoint was trained on raw "
                f"observations; statistics start from scratch")
        rstats = getattr(self.venv, "ret_stats", None)
        if rstats is not None and os.path.exists(path + ".retnorm.npz"):
            rstats.load_state_dict(np.load(path + ".retnorm.npz"))

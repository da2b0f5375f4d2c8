"""Sequence-trunk PPO: the KV-cache decode rollout and the
sequence-minibatch update phases (attention trunks).

Counterpart of ``ppoc_tpu/algo/recurrent.py``, attention branches only; a
GRU/LSTM trunk (``cfg.rnn_hidden``) is not ported yet and raises.  Log-probs
and values depend on episode history, so the update replays whole
sequences: a minibatch is ``seqs`` env COLUMNS of the [T, E] window
(``seq_minibatch_plan``), reshuffled every epoch with the tail dropped,
and every loss runs the trunk's parallel pass (``attn.apply_seq``) over
the window -- through the flash kernel K7 once T >= attn.FLASH_MIN_T, its
bf16 variant under the "bf16" backend.

The rollout is a host loop over ``attn.step`` (one decode step per env
step, the KV cache carried; float32 under every backend, as in the JAX
package, so stored log-probs are float32), with its randomness drawn up
front into a
:class:`SeqDraws`; V(s) and V(s') come from one parallel pass plus a
one-step decode of every next observation (:func:`compute_values_rnn`).
The phases run the generic minibatch steps of ``algo/ppo.py``
(``value_steps``, ``policy_steps``), so the stabilisers apply here as
there; the aux value head (cfg.aux_value_coeff) is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs.core import Env, vector_autoreset_step
from ppoc_tpu_torch.models import attn, policy as policy_mod


def _require_attn(trunk) -> None:
    if not attn.is_attn(trunk):
        raise NotImplementedError(
            "GRU/LSTM trunks (rnn_hidden) are not ported yet (ROADMAP.md); "
            "the port's sequence trunk is attention (attn_dim)")


def seq_minibatch_plan(n_envs: int, rollout_len: int,
                       mb_size: int) -> Tuple[int, int]:
    """-> (sequences per minibatch, minibatches per epoch): the closest plan
    to ``mb_size`` transitions in whole env sequences, floor(mb_size /
    rollout_len) of them (at least 1), the tail of the env axis dropped."""
    seqs = max(1, min(n_envs, mb_size // rollout_len))
    return seqs, n_envs // seqs


def _gather_seqs(arrs, idx: torch.Tensor):
    """Gather env columns (axis 1) of [T, E, ...] planes."""
    return tuple(a.index_select(1, idx) for a in arrs)


# --------------------------------------------------------------------------
# rollout
# --------------------------------------------------------------------------

# all the randomness one sequence-trunk rollout consumes: the env loop's
SeqDraws = ppo.LoopDraws


def draw_seq(env: Env, generator: torch.Generator, n_envs: int, length: int,
             device, deterministic: bool = False) -> SeqDraws:
    """Draw a sequence rollout's start and reset states and, unless
    ``deterministic``, its action noise from ``generator``."""
    return ppo.draw_loop(env, generator, n_envs, length, device,
                         noise=not deterministic)


def initial_seq_state(cfg: PPOConfig, policy_params, n_envs: int):
    """Fresh trunk sequence state for a rollout window: the KV cache."""
    trunk = policy_params["mlp"]
    _require_attn(trunk)
    return attn.initial_cache(trunk, (n_envs,))


def rollout_step_fn(cfg: PPOConfig, env: Env, policy_params,
                    deterministic: bool = False):
    """The per-step body of :func:`rollout_rnn`: ``(carry, draws_t) ->
    (carry, transition)`` with carry (env state, obs, cache) and draws_t
    (fresh state, fresh obs, noise or None)."""
    trunk = policy_params["mlp"]
    _require_attn(trunk)
    discrete = env.spec.discrete

    def step_fn(carry, draws_t):
        state, obs, cache = carry
        fresh_state, fresh_obs, noise = draws_t
        cache, out = attn.step(trunk, cache, obs, cfg.activation)
        action, logp = policy_mod.act_from_out(
            out, discrete, policy_params.get("log_std"), deterministic,
            noise)
        state, obs2, next_obs, reward, term, trunc = vector_autoreset_step(
            env, state, action, fresh=(fresh_state, fresh_obs))
        cache = attn.reset_lanes(cache, term | trunc)
        tr = ppo.Transition(obs, action, logp, next_obs, reward, term, trunc)
        return (state, obs2, cache), tr

    return step_fn


@torch.no_grad()
def rollout_rnn(cfg: PPOConfig, env: Env, policy_params, draws: SeqDraws,
                force_truncate: bool = True, deterministic: bool = False):
    """Collect [T, E] transitions with a sequence-trunk policy, T and E from
    ``draws``; returns (Transition, final (env state, obs, cache)).  The
    window starts from an empty cache in every lane."""
    state, obs = draws.carry
    fstate, fobs = draws.fresh
    step_fn = rollout_step_fn(cfg, env, policy_params, deterministic)
    carry = (state, obs, initial_seq_state(cfg, policy_params,
                                           obs.shape[0]))
    steps = []
    for t in range(fobs.shape[0]):
        noise = None if deterministic else draws.noise[t]
        carry, tr = step_fn(carry, (type(fstate)(*(f[t] for f in fstate)),
                                    fobs[t], noise))
        steps.append(tr)
    traj = ppo.Transition(*(torch.stack(col) for col in zip(*steps)))
    if force_truncate:
        traj = force_truncate_traj(traj)
    return traj, carry


# the window's last row truncated unless it terminated, as for MLP trunks
force_truncate_traj = ppo._force_truncate_last


# --------------------------------------------------------------------------
# values / log-probs over stored windows
# --------------------------------------------------------------------------

@torch.no_grad()
def compute_values_rnn(cfg: PPOConfig, v_params, traj, backend: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V(s_t), V(s'_t)) planes [T, E] for GAE: one parallel pass with the
    keys and values kept, then a one-step decode of all T next
    observations at once (V(s'_t) attends obs_<=t of the same episode and
    next_obs_t, at position t + 1), both on ``backend`` ("pallas" or
    "bf16")."""
    _require_attn(v_params)
    done = traj.terminated | traj.truncated
    values, ks, vs = attn.apply_seq(v_params, traj.obs, done,
                                    cfg.activation, with_cache=True,
                                    backend=backend)
    T = traj.obs.shape[0]
    pos_idx = torch.clamp(torch.arange(T, device=traj.obs.device) + 1,
                          max=attn.window(v_params) - 1)
    nv = attn.decode_next(v_params, traj.next_obs, pos_idx, ks, vs,
                          attn.causal_episode_mask(done), cfg.activation,
                          backend)
    return values[..., 0], nv[..., 0]


def policy_log_probs_rnn(cfg: PPOConfig, policy_params, obs, action, done,
                         discrete: bool, backend: str):
    """(log-probs [T, B], mean entropy) of the stored actions under the
    current policy, replayed over the window with the episode mask -- the
    decode's attention sets, so at epoch 0 the ratios are 1 to float
    noise."""
    out = attn.apply_seq(policy_params["mlp"], obs, done, cfg.activation,
                         backend=backend)
    if discrete:
        logp_all = torch.log_softmax(out, dim=-1)
        logp = torch.take_along_dim(logp_all, action.long(), dim=-1)[..., 0]
        ent = torch.mean(-torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        return logp, ent
    logp = policy_mod.gaussian_log_prob_from_mean(
        out, policy_params["log_std"], action)
    return logp, policy_mod.gaussian_entropy(policy_params)


# --------------------------------------------------------------------------
# update phases (sequence minibatches)
# --------------------------------------------------------------------------

def draw_columns(cfg: PPOConfig, generator: torch.Generator, n_epochs: int,
                 device) -> torch.Tensor:
    """[n_epochs, n_mb, seqs] env-column ids: per epoch a fresh permutation
    of the env axis sliced into minibatches, tail dropped (the JAX
    package's ``buffer.epoch_scan`` over env columns)."""
    seqs, n_mb = seq_minibatch_plan(cfg.n_envs, cfg.rollout_len,
                                    cfg.minibatch_size)
    return torch.stack([
        buffer.permutation_minibatches(generator, cfg.n_envs, n_mb, seqs)
        for _ in range(n_epochs)]).to(device)


def _check_phase_options(cfg: PPOConfig) -> None:
    if cfg.aux_value_coeff:
        raise NotImplementedError(
            "the aux value head (aux_value_coeff) is not ported to the "
            "sequence phases yet (ROADMAP.md §1 item 8)")


def value_phase_rnn(cfg: PPOConfig, ts, traj, target: torch.Tensor,
                    idx: torch.Tensor, backend: str,
                    v_old: Optional[torch.Tensor] = None):
    """n_epochs_value passes over the env-column stream ``idx``
    [n_epochs, n_mb, seqs]: ``ppo.value_steps`` on the trunk's parallel
    pass against ``target`` (K7's backward at T >= FLASH_MIN_T on the
    card), clipped against ``v_old`` [T, E] (the rollout-time values) with
    cfg.clip_value.  Returns (ts', mean minibatch loss)."""
    _check_phase_options(cfg)
    done = traj.terminated | traj.truncated

    def batch(cols):
        o, d, t = _gather_seqs((traj.obs, done, target), cols)
        vo = None if v_old is None else _gather_seqs((v_old,), cols)[0]
        return o, t, vo, d

    return ppo.value_steps(
        cfg, ts, (batch(c) for c in idx.reshape(-1, idx.shape[-1])),
        lambda p, b: attn.apply_seq(p, b[0], b[3], cfg.activation,
                                    backend=backend)[..., 0],
        idx.shape[1], backend)


def policy_phase_rnn(cfg: PPOConfig, env: Env, ts, traj, adv: torch.Tensor,
                     idx: torch.Tensor, backend: str):
    """n_epochs_policy passes of the clipped surrogate over the env-column
    stream ``idx``: ``ppo.policy_steps`` on the replayed log-probs and
    entropy.  Returns (ts', mean loss, mean entropy)."""
    _check_phase_options(cfg)
    discrete = env.spec.discrete
    done = traj.terminated | traj.truncated
    batches = (_gather_seqs((traj.obs, traj.action, traj.log_prob, adv,
                             done), cols)
               for cols in idx.reshape(-1, idx.shape[-1]))
    return ppo.policy_steps(
        cfg, ts, batches,
        lambda p, b: policy_log_probs_rnn(cfg, p, b[0], b[1], b[4],
                                          discrete, backend),
        idx.shape[1], backend, discrete)

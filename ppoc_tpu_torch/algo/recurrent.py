"""Sequence-trunk PPO: the rollouts that carry a trunk's sequence state
and the sequence-minibatch update phases, for attention and GRU/LSTM
trunks.

Counterpart of ``ppoc_tpu/algo/recurrent.py`` (one device).  Log-probs and
values depend on episode history, so the update replays whole sequences:
a minibatch is ``seqs`` env COLUMNS of the [T, E] window
(``seq_minibatch_plan``), reshuffled every epoch with the tail dropped,
and every loss runs the trunk over the window (:func:`_seq_apply`): an
attention trunk's parallel pass (``attn.apply_seq``, through the flash
kernel K7 once T >= attn.FLASH_MIN_T, its bf16 variant under "bf16"), or a
GRU/LSTM trunk's masked time loop (``gru.apply_seq``; backpropagation
through time over the window, no kernel).

The rollout is a host loop (one trunk step per env step, the sequence
state carried: the attention KV cache, whose finished lanes move their
episode start, or the GRU/LSTM state, zeroed in finished lanes; float32
under every backend, as in the JAX package, so stored log-probs are
float32), with its randomness drawn up front into a :class:`SeqDraws`.
The hidden feeding step t is h_t; the cell takes (h_t, obs_t) to h_{t+1}
and the step's head output, so a replay from h_0 = 0 recomputes the
stored log-probs.  V(s) and V(s') come from one parallel pass plus a
one-step decode of every next observation (attention), or one time loop
that also steps each next observation from the state after s_t
(GRU/LSTM; :func:`compute_values_rnn`).  The phases run the generic
minibatch steps of ``algo/ppo.py`` (``value_steps``, ``policy_steps``), so
the stabilisers apply here as there; with cfg.aux_value_coeff > 0 an
attention policy trunk's aux head regresses the value targets in the
policy phase (:func:`policy_phase_rnn`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs.core import Env, vector_autoreset_step
from ppoc_tpu_torch.models import attn, gru, mlp, policy as policy_mod


def _seq_apply(trunk, xs, reset_after, activation, backend: str):
    """Whole-window head outputs for either sequence family: the attention
    trunk's parallel pass on ``backend`` (K7 at T >= attn.FLASH_MIN_T), or
    the GRU/LSTM masked time loop, which ignores the backend
    (``ppoc_tpu/algo/recurrent.py:45-62``)."""
    if attn.is_attn(trunk):
        return attn.apply_seq(trunk, xs, reset_after, activation,
                              backend=backend)
    return gru.apply_seq(trunk, xs, reset_after, activation)


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
    """Fresh trunk sequence state for a rollout window: the attention KV
    cache, or the GRU/LSTM zero state."""
    trunk = policy_params["mlp"]
    if attn.is_attn(trunk):
        return attn.initial_cache(trunk, (n_envs,))
    return gru.initial_state(trunk, (n_envs,))


def rollout_step_fn(cfg: PPOConfig, env: Env, policy_params,
                    deterministic: bool = False):
    """The per-step body of :func:`rollout_rnn`: ``(carry, draws_t) ->
    (carry, transition)`` with carry (env state, obs, sequence state) and
    draws_t (fresh state, fresh obs, noise or None).  Lanes whose episode
    ended start the next step afresh: the KV cache's episode start moves
    past the token just written, the GRU/LSTM state is zeroed
    (``ppoc_tpu/algo/recurrent.py:134-176``)."""
    trunk = policy_params["mlp"]
    discrete = env.spec.discrete
    if attn.is_attn(trunk):
        def trunk_step(s, x):
            return attn.step(trunk, s, x, cfg.activation)

        on_done = attn.reset_lanes
    else:
        def trunk_step(s, x):
            return gru.step(trunk, s, x, cfg.activation)

        def on_done(s, done):
            return s * gru.keep_mask(done, s)

    def step_fn(carry, draws_t):
        state, obs, s = carry
        fresh_state, fresh_obs, noise = draws_t
        s, out = trunk_step(s, obs)
        action, logp = policy_mod.act_from_out(
            out, discrete, policy_params.get("log_std"), deterministic,
            noise)
        state, obs2, next_obs, reward, term, trunc = vector_autoreset_step(
            env, state, action, fresh=(fresh_state, fresh_obs))
        s = on_done(s, term | trunc)
        tr = ppo.Transition(obs, action, logp, next_obs, reward, term, trunc)
        return (state, obs2, s), tr

    return step_fn


@torch.no_grad()
def rollout_rnn(cfg: PPOConfig, env: Env, policy_params, draws: SeqDraws,
                force_truncate: bool = True, deterministic: bool = False):
    """Collect [T, E] transitions with a sequence-trunk policy, T and E from
    ``draws``; returns (Transition, final (env state, obs, sequence
    state)).  The window starts from an empty cache or a zero state in
    every lane."""
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
    """(V(s_t), V(s'_t)) planes [T, E] for GAE.  Attention: one parallel
    pass with the keys and values kept, then a one-step decode of all T
    next observations at once (V(s'_t) attends obs_<=t of the same episode
    and next_obs_t, at position t + 1), both on ``backend``.  GRU/LSTM:
    one time loop in which V(s'_t) is the head on the cell stepped from
    the state reached AFTER s_t, the history the critic would have at
    t + 1, and the episode mask applies after both
    (``ppoc_tpu/algo/recurrent.py:206-222``)."""
    done = traj.terminated | traj.truncated
    if gru.is_rnn(v_params):
        gxo = gru.input_gates(v_params, traj.obs)
        gxn = gru.input_gates(v_params, traj.next_obs)
        keep = gru.keep_mask(done, gxo)
        h = gru.initial_state(v_params, traj.obs.shape[1:-1])
        hs, hns = [], []
        for t in range(traj.obs.shape[0]):
            h2 = gru.cell_from_gates(v_params, h, gxo[t])
            hs.append(h2)
            hns.append(gru.cell_from_gates(v_params, h2, gxn[t]))
            h = h2 * keep[t]
        return tuple(gru.head_apply(v_params, torch.stack(x),
                                    cfg.activation)[..., 0]
                     for x in (hs, hns))
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
                         discrete: bool, backend: str,
                         return_hidden: bool = False):
    """(log-probs [T, B], mean entropy) of the stored actions under the
    current policy, replayed over the window with the episode mask -- the
    decode's attention sets, or the rollout's recurrence from a zero state,
    so at epoch 0 the ratios are 1 to float noise.  ``return_hidden=True``
    (attention) appends the final-LN hidden plane, the aux value head's
    input."""
    trunk = policy_params["mlp"]
    hidden = None
    if return_hidden:
        out, hidden = attn.apply_seq(trunk, obs, done, cfg.activation,
                                     backend=backend, return_hidden=True)
    else:
        out = _seq_apply(trunk, obs, done, cfg.activation, backend)
    if discrete:
        logp_all = torch.log_softmax(out, dim=-1)
        logp = torch.take_along_dim(logp_all, action.long(), dim=-1)[..., 0]
        ent = torch.mean(-torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    else:
        logp = policy_mod.gaussian_log_prob_from_mean(
            out, policy_params["log_std"], action)
        ent = policy_mod.gaussian_entropy(policy_params)
    return (logp, ent, hidden) if return_hidden else (logp, ent)


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


def value_phase_rnn(cfg: PPOConfig, ts, traj, target: torch.Tensor,
                    idx: torch.Tensor, backend: str,
                    v_old: Optional[torch.Tensor] = None):
    """n_epochs_value passes over the env-column stream ``idx``
    [n_epochs, n_mb, seqs]: ``ppo.value_steps`` on the trunk's window pass
    against ``target`` (K7's backward at T >= FLASH_MIN_T on the card for
    attention; backpropagation through time for a GRU/LSTM), clipped
    against ``v_old`` [T, E] (the rollout-time values) with
    cfg.clip_value.  Returns (ts', mean minibatch loss)."""
    done = traj.terminated | traj.truncated

    def batch(cols):
        o, d, t = _gather_seqs((traj.obs, done, target), cols)
        vo = None if v_old is None else _gather_seqs((v_old,), cols)[0]
        return o, t, vo, d

    return ppo.value_steps(
        cfg, ts, (batch(c) for c in idx.reshape(-1, idx.shape[-1])),
        lambda p, b: _seq_apply(p, b[0], b[3], cfg.activation,
                                backend)[..., 0],
        idx.shape[1], backend)


def policy_phase_rnn(cfg: PPOConfig, env: Env, ts, traj, adv: torch.Tensor,
                     idx: torch.Tensor, backend: str,
                     target: Optional[torch.Tensor] = None):
    """n_epochs_policy passes of the clipped surrogate over the env-column
    stream ``idx``: ``ppo.policy_steps`` on the replayed log-probs and
    entropy.  ``target`` (the fit's value targets [T, E]) engages the
    PPG-style auxiliary value loss when cfg.aux_value_coeff > 0 and the
    policy trunk carries an ``aux_head``: cfg.aux_value_coeff times the
    mean squared error of the aux head on the final-LN hidden plane
    against the targets, added to each minibatch's loss, so its gradient
    reaches the trunk (``ppoc_tpu/algo/recurrent.py:350-367``).  Returns
    (ts', mean loss, mean entropy)."""
    discrete = env.spec.discrete
    done = traj.terminated | traj.truncated
    use_aux = (cfg.aux_value_coeff > 0.0 and target is not None
               and "aux_head" in ts.policy_params["mlp"])
    cols = (traj.obs, traj.action, traj.log_prob, adv, done)
    if use_aux:
        cols = cols + (target,)
    batches = (_gather_seqs(cols, c) for c in idx.reshape(-1, idx.shape[-1]))

    def log_probs(p, b):
        if not use_aux:
            return policy_log_probs_rnn(cfg, p, b[0], b[1], b[4], discrete,
                                        backend)
        logp, ent, hid = policy_log_probs_rnn(cfg, p, b[0], b[1], b[4],
                                              discrete, backend,
                                              return_hidden=True)
        vhat = mlp.apply(p["mlp"]["aux_head"], hid, cfg.activation,
                         "jnp")[..., 0]
        return logp, ent, cfg.aux_value_coeff * torch.mean(
            torch.square(vhat - b[5]))

    return ppo.policy_steps(cfg, ts, batches, log_probs, idx.shape[1],
                            backend, discrete)

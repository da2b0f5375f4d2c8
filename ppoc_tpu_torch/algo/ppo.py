"""PPO: rollout collection, GAE, and the clipped-surrogate update.

Counterpart of ``ppoc_tpu/algo/ppo.py`` for the single-device MLP path.  A
fit collects ``n_envs x rollout_len`` transitions, computes GAE with
whole-buffer advantage normalisation, then runs ``n_epochs_value`` value
epochs and ``n_epochs_policy`` policy epochs of shuffled minibatch Adam
steps.  Semantics kept from the reference, as in the JAX package: envs
reset at every collection window; the window's last step is force-marked
truncated so GAE never bootstraps across it; value targets are V + A taken
before normalisation; every epoch reshuffles and drops the tail; three
Adam states (policy net, value net, log_std).

The port runs the JAX package's fused path (kernel_backend "pallas" or
"auto"): one rollout kernel (K1, with V(s) and V(s') in-kernel), one GAE +
normalise kernel (K2), one kernel per update phase (K3, K4).  On CPU
tensors each runs its plain version.  The JAX package's generic "jnp"
path (env loop, doubling-scan GAE, autograd phases) is not ported.

The JAX package compiles a fit into one program; here a fit is four kernel
launches plus a few small PyTorch ops, driven eagerly from the host.

Randomness is explicit: a fit's draws (:class:`FitDraws`) are the rollout's
two seed words and the value/policy row-id streams, drawn up front from
the trainer's ``torch.Generator`` -- or handed in, so tests can feed both
packages the same randomness.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs.core import Env, vector_reset
from ppoc_tpu_torch.models import mlp, policy as policy_mod
from ppoc_tpu_torch.ops import (adam, cuda_gae, cuda_rollout, cuda_update,
                                gae as gae_ops)


class Transition(NamedTuple):
    obs: torch.Tensor         # [T, E, obs_dim]
    action: torch.Tensor      # [T, E, act_dim]
    log_prob: torch.Tensor    # [T, E]
    next_obs: torch.Tensor    # [T, E, obs_dim]  true successor (pre-reset)
    reward: torch.Tensor      # [T, E]
    terminated: torch.Tensor  # [T, E] bool
    truncated: torch.Tensor   # [T, E] bool


class TrainState(NamedTuple):
    policy_params: Dict[str, Any]
    v_params: Any
    opt_policy: adam.AdamState    # over policy_params["mlp"]
    opt_v: adam.AdamState         # over v_params
    opt_log_std: adam.AdamState   # over policy_params["log_std"]


class FitMetrics(NamedTuple):
    value_loss: torch.Tensor
    policy_loss: torch.Tensor
    entropy: torch.Tensor
    mean_reward: torch.Tensor


class FitDraws(NamedTuple):
    """All the randomness one fit consumes."""
    seed: Tuple[int, int]       # the rollout's two 32-bit seed words
    value_idx: torch.Tensor     # [n_epochs_value, n_mb, mb] row ids
    policy_idx: torch.Tensor    # [n_epochs_policy, n_mb, mb] row ids


class EvalMetrics(NamedTuple):
    J: Any          # mean discounted episode return
    R: Any          # mean undiscounted episode return
    episodes: Any   # completed-episode count


def _hyper(cfg: PPOConfig, lr: float) -> cuda_update.Hyper:
    return cuda_update.Hyper.of(lr, cfg.adam_beta1, cfg.adam_beta2,
                                cfg.adam_eps)


def draw_fit(cfg: PPOConfig, generator: torch.Generator,
             device: torch.device) -> FitDraws:
    """Draw one fit's seed words and row-id streams from ``generator``."""
    seed = cuda_rollout.seed_words(generator)

    def stream(n_epochs):
        return torch.stack([
            buffer.permutation_minibatches(generator, cfg.steps_per_fit,
                                           cfg.num_minibatches,
                                           cfg.minibatch_size)
            for _ in range(n_epochs)]).to(device)

    return FitDraws(seed, stream(cfg.n_epochs_value),
                    stream(cfg.n_epochs_policy))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_train_state(cfg: PPOConfig, env: Env, generator: torch.Generator,
                     device: torch.device) -> TrainState:
    """Policy (Gaussian MLP + log_std), value net with the same trunk and a
    scalar head, and three fresh Adam states."""
    spec = env.spec
    policy_params = policy_mod.init_gaussian(
        spec.obs_dim, spec.action_dim, cfg.hidden, cfg.init_std, generator,
        device)
    v_params = mlp.init((spec.obs_dim, *cfg.hidden, 1), generator, device)
    return TrainState(
        policy_params=policy_params,
        v_params=v_params,
        opt_policy=adam.init(policy_params["mlp"]),
        opt_v=adam.init(v_params),
        opt_log_std=adam.init(policy_params["log_std"]),
    )


# --------------------------------------------------------------------------
# rollout
# --------------------------------------------------------------------------

def _force_truncate_last(traj: Transition) -> Transition:
    """Mark the window's last step truncated unless it terminated, so GAE
    never bootstraps across the window end (the carried env state still
    continues the episode when reset_per_fit=False)."""
    truncated = traj.truncated.clone()
    truncated[-1] = traj.truncated[-1] | ~traj.terminated[-1]
    return traj._replace(truncated=truncated)


def rollout(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any], seed,
            n_envs: int, length: int, env_carry=None,
            force_truncate: bool = True, v_params=None):
    """Collect [length, n_envs] transitions with one K1 launch; returns
    (traj, final carry), and with ``v_params`` a third element, the
    (V(s), V(s')) planes the kernel computed.  ``seed`` is K1's two 32-bit
    seed words; ``env_carry=None`` resets every env at entry."""
    out = cuda_rollout.rollout_fused(
        env.spec.name, policy_params, seed, n_envs, length, cfg.activation,
        env_carry, gamma=env.spec.gamma, v_params=v_params)
    if force_truncate:
        out = (_force_truncate_last(out[0]),) + tuple(out[1:])
    return out


# --------------------------------------------------------------------------
# advantages
# --------------------------------------------------------------------------

def compute_advantages(cfg: PPOConfig, env: Env, traj: Transition,
                       values_pair):
    """GAE + whole-buffer normalisation (one K2 launch) on the rollout
    kernel's (V(s), V(s')) planes; returns (advantages, targets), both
    [T, E]."""
    values, next_values = values_pair
    return cuda_gae.gae_norm_fused(
        traj.reward, values, next_values, traj.terminated, traj.truncated,
        env.spec.gamma, cfg.lam, normalize=cfg.norm_adv_global)


# --------------------------------------------------------------------------
# update phases
# --------------------------------------------------------------------------

def value_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                idx: torch.Tensor):
    """Fit V over the row-id stream ``idx`` [n_epochs, n_mb, mb] with one
    K3 launch on the pre-gathered rows; returns (ts', mean minibatch
    loss)."""
    n_epochs, n_mb, mb = idx.shape
    obs_seq, tgt_seq = buffer.gather_mb((buf.obs, buf.target), idx)
    v2, opt2, loss = cuda_update.value_phase(
        obs_seq, tgt_seq, ts.v_params, ts.opt_v, n_epochs * n_mb, mb,
        cfg.activation, _hyper(cfg, cfg.lr_v))
    return ts._replace(v_params=v2, opt_v=opt2), loss


def policy_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                 idx: torch.Tensor):
    """Clipped-surrogate passes over the row-id stream ``idx`` with one K4
    launch; returns (ts', mean loss, mean entropy)."""
    n_epochs, n_mb, mb = idx.shape
    pol = ts.policy_params
    o, a, lp, ad = buffer.gather_mb(
        (buf.obs, buf.action, buf.log_prob, buf.advantage), idx)
    params2, ls2, opt_p2, opt_ls2, loss, ent = cuda_update.policy_phase(
        o, a, lp, ad, pol["mlp"], pol["log_std"], ts.opt_policy,
        ts.opt_log_std, n_epochs * n_mb, mb, cfg.activation,
        _hyper(cfg, cfg.lr_policy), cfg.clip_eps, cfg.ent_coeff)
    return ts._replace(policy_params={"mlp": params2, "log_std": ls2},
                       opt_policy=opt_p2, opt_log_std=opt_ls2), loss, ent


# --------------------------------------------------------------------------
# fit step / epoch / train-until
# --------------------------------------------------------------------------

def update_step(cfg: PPOConfig, env: Env, ts: TrainState, traj: Transition,
                draws: FitDraws, values_pair):
    """Learner half of a fit: GAE + normalisation, then the value and
    policy phases on an already-collected trajectory."""
    adv, target = compute_advantages(cfg, env, traj, values_pair)
    buf = buffer.from_rollout(traj, adv, target)
    ts, v_loss = value_phase(cfg, ts, buf, draws.value_idx)
    ts, p_loss, ent = policy_phase(cfg, ts, buf, draws.policy_idx)
    return ts, FitMetrics(v_loss, p_loss, ent, traj.reward.mean())


def fit_step(cfg: PPOConfig, env: Env, ts: TrainState, draws: FitDraws,
             n_envs: Optional[int] = None, env_carry=None,
             return_env_carry: bool = False):
    """One fit: collect steps_per_fit transitions, GAE, value + policy
    epochs.  ``env_carry``/``return_env_carry`` thread persistent env state
    across fits (cfg.reset_per_fit=False)."""
    n_envs = cfg.n_envs if n_envs is None else n_envs
    traj, env_carry, vpair = rollout(
        cfg, env, ts.policy_params, draws.seed, n_envs, cfg.rollout_len,
        env_carry, v_params=ts.v_params)
    ts, metrics = update_step(cfg, env, ts, traj, draws, vpair)
    return (ts, env_carry, metrics) if return_env_carry else (ts, metrics)


def train_epoch(cfg: PPOConfig, env: Env, ts: TrainState,
                generator: torch.Generator):
    """fits_per_epoch sequential fits; returns (ts', metrics meaned over the
    fits).  With cfg.reset_per_fit=False envs reset once at epoch entry and
    persist across the fits."""
    device = ts.policy_params["log_std"].device
    carry = None
    if not cfg.reset_per_fit:
        carry = vector_reset(env, generator, cfg.n_envs, device)
    metrics = []
    for _ in range(cfg.fits_per_epoch):
        draws = draw_fit(cfg, generator, device)
        if cfg.reset_per_fit:
            ts, m = fit_step(cfg, env, ts, draws)
        else:
            ts, carry, m = fit_step(cfg, env, ts, draws, env_carry=carry,
                                    return_env_carry=True)
        metrics.append(m)
    return ts, FitMetrics(*(torch.stack(x).mean() for x in zip(*metrics)))


def train_until(cfg: PPOConfig, env: Env, ts: TrainState,
                generator: torch.Generator, target_R: float,
                max_epochs: int, eval_envs: Optional[int] = None):
    """Train epochs until the stochastic-eval mean return reaches
    ``target_R`` or ``max_epochs`` ran; returns (ts, epochs_run, final_R).
    A host loop: one device sync per epoch, to read R."""
    n, R = 0, -math.inf
    while R < target_R and n < max_epochs:
        ts, _ = train_epoch(cfg, env, ts, generator)
        ev = evaluate(cfg, env, ts.policy_params,
                      cuda_rollout.seed_words(generator), eval_envs)
        n, R = n + 1, float(ev.R)
    return ts, n, R


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def _eval_metrics(sum_j, sum_r, n_eps) -> EvalMetrics:
    """Means over completed episodes; 0 episodes give -inf, not 0 (a 0
    would read as solved on negative-return envs)."""
    none = n_eps == 0
    denom = torch.clamp(n_eps, min=1.0)
    neg_inf = torch.full_like(sum_j, -math.inf)
    return EvalMetrics(J=torch.where(none, neg_inf, sum_j / denom),
                       R=torch.where(none, neg_inf, sum_r / denom),
                       episodes=n_eps)


def eval_metrics_from_traj(traj: Transition, gamma: float) -> EvalMetrics:
    """Episode metrics from a trajectory with GENUINE done flags, counting
    only the episodes that complete inside the window."""
    done = traj.terminated | traj.truncated
    j_t = gae_ops.discounted_episode_returns(traj.reward, done, gamma)
    r_t = gae_ops.discounted_episode_returns(traj.reward, done, 1.0)
    starts = torch.cat([torch.ones_like(done[:1]), done[:-1]], dim=0)
    # a step's segment completes iff some done exists at s >= t (per env)
    completed = torch.flip(torch.cumsum(torch.flip(done.float(), [0]), 0),
                           [0]) > 0
    mask = (starts & completed).float()
    return _eval_metrics((j_t * mask).sum(), (r_t * mask).sum(),
                         done.float().sum())


def evaluate(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any], seed,
             n_envs: Optional[int] = None) -> EvalMetrics:
    """Stochastic-policy evaluation over cfg.eval_len steps: one K1 launch
    that sums the completed episodes' returns inside the kernel."""
    n_envs = cfg.eval_envs if n_envs is None else n_envs
    _, _, (sum_r, sum_j, n_eps) = cuda_rollout.rollout_fused(
        env.spec.name, policy_params, seed, n_envs, cfg.eval_len,
        cfg.activation, None, gamma=env.spec.gamma, return_metrics=True)
    return _eval_metrics(sum_j, sum_r, n_eps)

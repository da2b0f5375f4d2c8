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

The port runs the JAX package's "pallas" backend (kernel_backend "pallas"
or "auto"): one rollout kernel (K1, with V(s) and V(s') in-kernel), one
GAE + normalise kernel (K2), then per update phase either one whole-phase
kernel (K3, K4) or, above the fused gate (minibatches over 2048 rows), the
generic per-minibatch phase whose forward and backward are the whole-MLP
kernel K5.  The mean policy evaluates through the env loop, one K5 forward
per step.  On CPU tensors each kernel runs its plain version.  The JAX
package's "jnp" backend (stochastic env-loop training rollout,
doubling-scan GAE with Welford) is not ported.

The JAX package compiles a fit into one program; here a fit is a few kernel
launches plus small PyTorch ops, driven eagerly from the host.

Randomness is explicit: a fit's draws (:class:`FitDraws`) are the rollout's
two seed words and the value/policy row-id (or block-id) streams, and an
env-loop evaluation's (:class:`LoopDraws`) its start and reset states,
drawn up front from the trainer's ``torch.Generator`` -- or handed in, so
tests can feed both packages the same randomness.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs.core import Env, vector_autoreset_step, vector_reset
from ppoc_tpu_torch.models import mlp, policy as policy_mod
from ppoc_tpu_torch.ops import (adam, cuda_gae, cuda_rollout, cuda_update,
                                gae as gae_ops, losses)

# The port's one backend: every MLP call outside K1/K3/K4 goes through K5.
BACKEND = "pallas"


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
    value_idx: torch.Tensor     # [n_epochs_value, n_mb, mb] row ids, or
                                # [.., mb / shuffle_block] block ids
    policy_idx: torch.Tensor    # [n_epochs_policy, n_mb, ...] likewise


class EvalMetrics(NamedTuple):
    J: Any          # mean discounted episode return
    R: Any          # mean undiscounted episode return
    episodes: Any   # completed-episode count


def _hyper(cfg: PPOConfig, lr: float) -> cuda_update.Hyper:
    return cuda_update.Hyper.of(lr, cfg.adam_beta1, cfg.adam_beta2,
                                cfg.adam_eps)


def draw_fit(cfg: PPOConfig, generator: torch.Generator,
             device: torch.device) -> FitDraws:
    """Draw one fit's seed words and row-id (block-id, with
    cfg.shuffle_block) streams from ``generator``."""
    seed = cuda_rollout.seed_words(generator)
    args = (cfg.steps_per_fit, cfg.num_minibatches, cfg.minibatch_size)

    def epoch():
        if cfg.shuffle_block:
            return buffer.block_permutation_minibatches(
                generator, *args, cfg.shuffle_block)
        return buffer.permutation_minibatches(generator, *args)

    def stream(n_epochs):
        return torch.stack([epoch() for _ in range(n_epochs)]).to(device)

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


class LoopDraws(NamedTuple):
    """All the randomness one mean-policy env-loop rollout consumes."""
    carry: Any   # (state, obs) the window starts from
    fresh: Any   # (state, obs) with leading dims [T, E]: what an env that
                 # finishes step t resets to


def draw_loop(env: Env, generator: torch.Generator, n_envs: int, length: int,
              device) -> LoopDraws:
    """Draw an env-loop rollout's start and reset states from
    ``generator``."""
    carry = vector_reset(env, generator, n_envs, device)
    state, obs = vector_reset(env, generator, length * n_envs, device)

    def lead(x):
        return x.reshape((length, n_envs) + x.shape[1:])

    return LoopDraws(carry, (type(state)(*map(lead, state)), lead(obs)))


@torch.no_grad()
def rollout_env_loop(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any],
                     draws: LoopDraws) -> Transition:
    """The JAX package's env-loop rollout of the mean policy
    (``ppoc_tpu/algo/ppo.py:387-424`` with ``deterministic=True``), for
    evaluation: per step, the policy's mode through K5, then
    ``vector_autoreset_step`` with the drawn reset states.  Returns the
    trajectory [T, E, ...] with its genuine done flags.  A stochastic
    rollout is K1 (:func:`rollout`) on this backend, as in the JAX
    package."""
    state, obs = draws.carry
    fstate, fobs = draws.fresh
    steps = []
    for t in range(fobs.shape[0]):
        action, logp = policy_mod.mode(policy_params, obs, cfg.activation,
                                       BACKEND)
        fresh = (type(fstate)(*(f[t] for f in fstate)), fobs[t])
        state, obs2, next_obs, reward, term, trunc = vector_autoreset_step(
            env, state, action, fresh=fresh)
        steps.append((obs, action, logp, next_obs, reward, term, trunc))
        obs = obs2
    return Transition(*(torch.stack(col) for col in zip(*steps)))


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

# The JAX package runs its fused phases only for minibatches of at most this
# many rows (`_MAX_TILE`, ppoc_tpu/ops/pallas_update.py:59) and the generic
# per-minibatch phases above it.  The port keeps the reference's choice of
# path; the value has not been re-derived on the H100 (ROADMAP.md).
MAX_FUSED_MB = 2048


def _stab_value_ok(cfg: PPOConfig) -> bool:
    return (cfg.max_grad_norm == 0.0 and not cfg.lr_anneal
            and cfg.clip_value == 0.0)


def _stab_policy_ok(cfg: PPOConfig) -> bool:
    return (cfg.max_grad_norm == 0.0 and not cfg.lr_anneal
            and cfg.target_kl == 0.0 and not cfg.ent_anneal)


def _fused(cfg: PPOConfig, stab_ok: bool) -> bool:
    """The JAX package's gate for a whole-phase kernel (K3/K4):
    ``ppoc_tpu/algo/ppo.py:598-604`` and ``:698-704``.  Its other two
    conditions (per-shard minibatch size and count equal to cfg's) hold
    here always: the port has no sharding and draws its streams from
    cfg."""
    return stab_ok and cfg.minibatch_size <= MAX_FUSED_MB


def _requiring_grad(tree):
    """Detached copies of a parameter tree's tensors that require grad."""
    return adam.tree_map(lambda t: t.detach().requires_grad_(), tree)


def _adam_step(cfg: PPOConfig, params, grads, opt, lr: float):
    return adam.update(params, adam.tree_unflatten(params, list(grads)), opt,
                       lr, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps)


def _minibatches(idx: torch.Tensor):
    """The stream's minibatches in order: epoch-major, then minibatch."""
    return idx.reshape(-1, idx.shape[-1])


def value_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                idx: torch.Tensor):
    """Fit V over the id stream ``idx`` [n_epochs, n_mb, ...]; returns
    (ts', mean minibatch loss).

    Under the fused gate, one K3 launch on the pre-gathered rows.  Above
    it, the JAX package's scan branch (``ppoc_tpu/algo/ppo.py:631-667``) as
    a loop: per minibatch, gather, the MSE loss through K5,
    ``torch.autograd.grad`` (K5's backward) and one Adam step.  The
    stabilisers are not ported (the Trainer refuses them), so the JAX
    package's ``_prep_grads`` and lr schedule are the identity and lr_v
    here."""
    n_epochs, n_mb = idx.shape[:2]
    mb, blk = cfg.minibatch_size, cfg.shuffle_block
    cols = (buf.obs, buf.target)
    if _fused(cfg, _stab_value_ok(cfg)):
        obs_seq, tgt_seq = buffer.gather_mb(cols, idx, blk)
        v2, opt2, loss = cuda_update.value_phase(
            obs_seq, tgt_seq, ts.v_params, ts.opt_v, n_epochs * n_mb, mb,
            cfg.activation, _hyper(cfg, cfg.lr_v))
        return ts._replace(v_params=v2, opt_v=opt2), loss
    if not _stab_value_ok(cfg):
        raise NotImplementedError("the value-phase stabilisers are not "
                                  "ported yet (ROADMAP.md)")
    v_params, opt_v, mb_losses = ts.v_params, ts.opt_v, []
    for ids in _minibatches(idx):
        o, t = buffer.gather_mb(cols, ids, blk)
        params = _requiring_grad(v_params)
        v = mlp.apply(params, o, cfg.activation, BACKEND)[..., 0]
        loss = losses.value_loss(v, t)
        grads = torch.autograd.grad(loss, adam.tree_leaves(params))
        v_params, opt_v = _adam_step(cfg, v_params, grads, opt_v, cfg.lr_v)
        mb_losses.append(loss.detach())
    return (ts._replace(v_params=v_params, opt_v=opt_v),
            torch.stack(mb_losses).mean())


def policy_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                 idx: torch.Tensor):
    """Clipped-surrogate passes over the id stream ``idx``; returns (ts',
    mean loss, mean entropy).

    Under the fused gate, one K4 launch.  Above it, the JAX package's scan
    branch (``ppoc_tpu/algo/ppo.py:726-780``): per minibatch, the Gaussian
    log-prob through K5, ``clipped_surrogate_loss - ent_coeff * entropy``,
    ``torch.autograd.grad`` and one Adam step for the mean net and one for
    log_std, each with its own state.  Without the stabilisers the entropy
    coefficient is the constant cfg.ent_coeff."""
    n_epochs, n_mb = idx.shape[:2]
    mb, blk = cfg.minibatch_size, cfg.shuffle_block
    cols = (buf.obs, buf.action, buf.log_prob, buf.advantage)
    pol = ts.policy_params
    if _fused(cfg, _stab_policy_ok(cfg)):
        o, a, lp, ad = buffer.gather_mb(cols, idx, blk)
        params2, ls2, opt_p2, opt_ls2, loss, ent = cuda_update.policy_phase(
            o, a, lp, ad, pol["mlp"], pol["log_std"], ts.opt_policy,
            ts.opt_log_std, n_epochs * n_mb, mb, cfg.activation,
            _hyper(cfg, cfg.lr_policy), cfg.clip_eps, cfg.ent_coeff)
        return ts._replace(policy_params={"mlp": params2, "log_std": ls2},
                           opt_policy=opt_p2, opt_log_std=opt_ls2), loss, ent
    if not _stab_policy_ok(cfg):
        raise NotImplementedError("the policy-phase stabilisers are not "
                                  "ported yet (ROADMAP.md)")
    opt_p, opt_ls = ts.opt_policy, ts.opt_log_std
    mb_losses, ents = [], []
    for ids in _minibatches(idx):
        o, a, lp, ad = buffer.gather_mb(cols, ids, blk)
        params = {"mlp": _requiring_grad(pol["mlp"]),
                  "log_std": pol["log_std"].detach().requires_grad_()}
        logp = policy_mod.log_prob(params, o, a, cfg.activation, BACKEND)
        ent = policy_mod.entropy(params)
        loss = (losses.clipped_surrogate_loss(logp, lp, ad, cfg.clip_eps)
                - cfg.ent_coeff * ent)
        grads = torch.autograd.grad(
            loss, adam.tree_leaves(params["mlp"]) + [params["log_std"]])
        mlp2, opt_p = _adam_step(cfg, pol["mlp"], grads[:-1], opt_p,
                                 cfg.lr_policy)
        ls2, opt_ls = _adam_step(cfg, pol["log_std"], grads[-1:], opt_ls,
                                 cfg.lr_policy)
        pol = {"mlp": mlp2, "log_std": ls2}
        mb_losses.append(loss.detach())
        ents.append(ent.detach())
    return (ts._replace(policy_params=pol, opt_policy=opt_p,
                        opt_log_std=opt_ls),
            torch.stack(mb_losses).mean(), torch.stack(ents).mean())


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
    device = ts.policy_params["log_std"].device
    n, R = 0, -math.inf
    while R < target_R and n < max_epochs:
        ts, _ = train_epoch(cfg, env, ts, generator)
        ev = evaluate(cfg, env, ts.policy_params,
                      draw_eval(cfg, env, generator, device, n_envs=eval_envs))
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


def eval_metrics_reference(traj: Transition, gamma: float) -> EvalMetrics:
    """The reference's own eval estimator per env stream, pooled over the
    streams (``ppoc_tpu/algo/ppo.py:1086-1138``, which documents its
    quirks): per stream the backward walk seeds episode_J with r[T-1] and
    for i = T-2..0 takes episode_J = r[i] + gamma * episode_J before it
    checks done[i]; n_episodes starts at 1 and counts every interior done;
    the oldest segment's J is never summed.  J = sum_J / n, R = sum(r) /
    n."""
    T = traj.reward.shape[0]
    done = traj.terminated | traj.truncated
    ep_j = traj.reward[T - 1].float()
    sum_j = torch.zeros_like(ep_j)
    for i in range(T - 2, -1, -1):
        ep_j = traj.reward[i] + gamma * ep_j        # before the done check
        sum_j = sum_j + torch.where(done[i], ep_j, torch.zeros_like(ep_j))
        ep_j = torch.where(done[i], torch.zeros_like(ep_j), ep_j)
    n_total = (1.0 + done[: T - 1].float().sum(dim=0)).sum()
    return EvalMetrics(J=sum_j.sum() / n_total,
                       R=traj.reward.sum(dim=0).sum() / n_total,
                       episodes=n_total)


def draw_eval(cfg: PPOConfig, env: Env, generator: torch.Generator, device,
              deterministic: bool = False, n_envs: Optional[int] = None):
    """Draw what one evaluation consumes: the env loop's
    :class:`LoopDraws` for the mean policy, else K1's two seed words."""
    n_envs = cfg.eval_envs if n_envs is None else n_envs
    if deterministic:
        return draw_loop(env, generator, n_envs, cfg.eval_len, device)
    return cuda_rollout.seed_words(generator)


def evaluate(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any], draws,
             n_envs: Optional[int] = None,
             deterministic: bool = False) -> EvalMetrics:
    """Evaluation over cfg.eval_len steps, with ``draws`` from
    :func:`draw_eval`, as ``ppoc_tpu/algo/ppo.py:1141-1194`` chooses:

    * the stochastic policy is K1 (``draws``: its two seed words).  With
      the completed-episode estimator the kernel sums the returns itself;
      with cfg.eval_estimator "reference" the estimator reads K1's
      trajectory;
    * ``deterministic=True`` (the mean policy) runs the env loop, one K5
      forward per step (``draws``: a :class:`LoopDraws`, which also fixes
      the env count)."""
    n_envs = cfg.eval_envs if n_envs is None else n_envs
    reference = cfg.eval_estimator == "reference"
    if deterministic:
        traj = rollout_env_loop(cfg, env, policy_params, draws)
    elif reference:
        traj, _ = rollout(cfg, env, policy_params, draws, n_envs,
                          cfg.eval_len, force_truncate=False)
    else:
        _, _, (sum_r, sum_j, n_eps) = cuda_rollout.rollout_fused(
            env.spec.name, policy_params, draws, n_envs, cfg.eval_len,
            cfg.activation, None, gamma=env.spec.gamma, return_metrics=True)
        return _eval_metrics(sum_j, sum_r, n_eps)
    if reference:
        return eval_metrics_reference(traj, env.spec.gamma)
    return eval_metrics_from_traj(traj, env.spec.gamma)

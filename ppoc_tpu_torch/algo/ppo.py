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
kernel (K3; K4 for a Gaussian policy, K6 for a categorical one) or, above
the fused gate (minibatches over 2048 rows), the generic per-minibatch
phase whose forward and backward are the whole-MLP kernel K5.  A discrete
env (cartpole, acrobot) takes the same path with a categorical policy: K1
samples its int32 class ids by Gumbel-max.  The mean policy evaluates
through the env loop, one K5 forward per step.  On CPU tensors each kernel
runs its plain version.

The "bf16" backend (kernel_backend "bf16") is the JAX package's: K1 rolls
out without the V planes (its fused value forwards are gated to "pallas",
``ppoc_tpu/algo/ppo.py:363``), so V(s) and V(s') are two whole-buffer
forwards with bf16 products, then K2; no whole-phase kernel runs at any
minibatch size, so both phases are generic, and every MLP product there
and in the mean-policy evaluation is bf16 with float32 output
(``models/mlp.bf16_dot``).

The "jnp" backend launches no kernel: every product is plain PyTorch, the
training rollout is the stochastic env loop (:func:`rollout_env_loop`, one
policy forward a step on noise drawn up front), the advantages the
doubling-scan GAE with Welford moments (:func:`_seq_advantages`).  The
env loop also serves, on any backend, a mixture-of-experts trunk
(cfg.n_experts > 1, ``models/moe.py``; :func:`backend_of` names it
"moe:<topk>[:bf16]", as the JAX Trainer does) and an env no rollout lane
knows (an ``#affine`` one, ``envs/wrappers.affine_obs``); a mixture's
products are library calls, its GAE K2 only under "moe:<k>:bf16".

The stabilisers (max_grad_norm, clip_value, target_kl, lr_anneal,
ent_anneal) are the JAX package's, in the generic phases only: the fused
gate refuses them, as there (:func:`_stab_value_ok`,
:func:`_stab_policy_ok`).

An attention trunk (cfg.attn_dim > 0) takes the sequence path of
``algo/recurrent.py``, as the JAX package does: the rollout is a host loop
of KV-cache decode steps, V(s) and V(s') come from one parallel pass plus a
one-step decode, the advantages from the doubling-scan GAE and the
Welford moments (the JAX "jnp" GAE the sequence branch runs there), and
both phases fit on minibatches of whole env columns; every parallel pass of
a window of at least 1024 steps runs its attention core through the flash
kernel K7 (``ops/cuda_attn.py``), its bf16 variant under "bf16".  A
GRU/LSTM trunk (cfg.rnn_hidden > 0, ``models/gru.py``) takes the same
sequence path on "jnp" whatever the config's backend, as the JAX Trainer
forces it: its rollout steps the cell, V(s) and V(s') come from one time
loop, and no kernel launches.

The JAX package compiles a fit into one program; here a fit is a few kernel
launches plus small PyTorch ops, driven eagerly from the host.

Randomness is explicit: a fit's draws (:class:`FitDraws`) are the rollout's
two seed words and the value/policy row-id (or block-id) streams (for a
sequence trunk: its :class:`recurrent.SeqDraws` and the env-column
streams), and an env-loop rollout's (:class:`LoopDraws`) its start and
reset states and, unless it is the mean policy's, its action noise,
drawn up front from the trainer's ``torch.Generator`` -- or handed in, so
tests can feed both packages the same randomness.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ppoc_tpu_torch import envs
from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.data import buffer
from ppoc_tpu_torch.envs.core import Env, vector_autoreset_step, vector_reset
from ppoc_tpu_torch.models import attn, gru, mlp, moe, policy as policy_mod
from ppoc_tpu_torch.ops import (_build, adam, cuda_gae, cuda_mlp,
                                cuda_rollout, cuda_update, gae as gae_ops,
                                losses, resolve_backend, welford)


def backend_of(cfg: PPOConfig) -> str:
    """The backend cfg.kernel_backend selects: "pallas" (every MLP call
    outside K1/K3/K4/K6 through K5), "bf16" (bf16 products) or "jnp" (no
    kernel).  A mixture-of-experts config (cfg.n_experts > 1) gets its
    gating in the string, "moe:<topk>", with ":bf16" under "bf16": the
    JAX Trainer's rewrite (``ppoc_tpu/algo/trainer.py:170-178``), so no
    dense-MLP kernel takes a mixture.  A GRU/LSTM trunk (cfg.rnn_hidden >
    0) runs "jnp" whatever cfg.kernel_backend says, as the JAX Trainer
    forces it (``ppoc_tpu/algo/trainer.py:149-159``)."""
    backend = resolve_backend(cfg.kernel_backend)
    if cfg.rnn_hidden > 0:
        return "jnp"
    if cfg.n_experts > 1 and cfg.attn_dim == 0:
        return mlp.moe_backend(backend, cfg.moe_topk)
    return backend


def is_seq(trunk) -> bool:
    """Is ``trunk`` a sequence trunk (attention or GRU/LSTM), which rolls
    out and fits through ``algo/recurrent.py``?"""
    return attn.is_attn(trunk) or gru.is_rnn(trunk)


def uses_rollout_kernel(cfg: PPOConfig, env: Env) -> bool:
    """Does a stochastic rollout of cfg's MLP policy on ``env`` run K1?
    Under "pallas" or "bf16" for an env with a rollout lane, as
    ``ppoc_tpu/algo/ppo.py:352-359`` chooses; a mixture ("moe:*"), "jnp"
    (so a GRU/LSTM trunk) and an env without a lane (``pendulum#affine``,
    the ``_po`` envs) take the env loop or a sequence trunk's."""
    return (backend_of(cfg) in ("pallas", "bf16")
            and env.spec.name in cuda_rollout.SUPPORTED)


class Transition(NamedTuple):
    obs: torch.Tensor         # [T, E, obs_dim]
    action: torch.Tensor      # [T, E, act_dim] (int32 [T, E, 1] if discrete)
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
    opt_log_std: adam.AdamState   # over policy_params["log_std"] (empty
                                  # moments if discrete)


class FitMetrics(NamedTuple):
    value_loss: torch.Tensor
    policy_loss: torch.Tensor
    entropy: torch.Tensor
    mean_reward: torch.Tensor


class FitDraws(NamedTuple):
    """All the randomness one fit consumes."""
    seed: Optional[Tuple[int, int]]   # K1's two 32-bit seed words (None
                                      # where the rollout is a loop)
    value_idx: torch.Tensor     # [n_epochs_value, n_mb, mb] row ids, or
                                # [.., mb / shuffle_block] block ids, or
                                # [.., n_mb, seqs] env columns (sequence)
    policy_idx: torch.Tensor    # [n_epochs_policy, n_mb, ...] likewise
    seq: Any = None             # a loop rollout's LoopDraws: a sequence
                                # trunk's decode loop or the env loop


class EvalMetrics(NamedTuple):
    J: Any          # mean discounted episode return
    R: Any          # mean undiscounted episode return
    episodes: Any   # completed-episode count


def _hyper(cfg: PPOConfig, lr: float) -> cuda_update.Hyper:
    return cuda_update.Hyper.of(lr, cfg.adam_beta1, cfg.adam_beta2,
                                cfg.adam_eps)


def draw_fit(cfg: PPOConfig, generator: torch.Generator,
             device: torch.device, env: Optional[Env] = None) -> FitDraws:
    """Draw one fit's seed words and row-id (block-id, with
    cfg.shuffle_block) streams from ``generator``; for a sequence trunk
    (attention or GRU/LSTM) the rollout's :class:`LoopDraws` (from
    ``env``) and the env-column streams instead; where the rollout is the
    env loop (:func:`uses_rollout_kernel` false) its :class:`LoopDraws`
    with the action noise, then the row-id streams."""
    env = env if env is not None else envs.make_for(cfg)
    if cfg.attn_dim > 0 or cfg.rnn_hidden > 0:
        from ppoc_tpu_torch.algo import recurrent

        seq = recurrent.draw_seq(env, generator, cfg.n_envs, cfg.rollout_len,
                                 device)
        return FitDraws(None,
                        recurrent.draw_columns(cfg, generator,
                                               cfg.n_epochs_value, device),
                        recurrent.draw_columns(cfg, generator,
                                               cfg.n_epochs_policy, device),
                        seq)
    seed = loop = None
    if uses_rollout_kernel(cfg, env):
        seed = cuda_rollout.seed_words(generator)
    else:
        loop = draw_loop(env, generator, cfg.n_envs, cfg.rollout_len, device,
                         noise=True)
    args = (cfg.steps_per_fit, cfg.num_minibatches, cfg.minibatch_size)

    def epoch():
        if cfg.shuffle_block:
            return buffer.block_permutation_minibatches(
                generator, *args, cfg.shuffle_block)
        return buffer.permutation_minibatches(generator, *args)

    def stream(n_epochs):
        return torch.stack([epoch() for _ in range(n_epochs)]).to(device)

    return FitDraws(seed, stream(cfg.n_epochs_value),
                    stream(cfg.n_epochs_policy), loop)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_train_state(cfg: PPOConfig, env: Env, generator: torch.Generator,
                     device: torch.device) -> TrainState:
    """Policy (Gaussian MLP + log_std, or categorical MLP for a discrete
    env), value net with the same trunk and a scalar head, and three fresh
    Adam states; a categorical policy's log_std state has empty moments,
    as the JAX package's ``adam.init(jnp.zeros((0,)))``.  With
    cfg.n_experts > 1 both trunks are mixtures of that many experts
    (``models/moe.py``), policy first.

    With cfg.attn_dim > 0 both trunks are attention encoders
    (``models/attn.py``) with MLP heads, drawn policy first, then value,
    as the JAX package draws them; their positional tables cover
    max(rollout_len, eval_len) + 1 steps, so the next-token decode at a
    window's last row gets a position of its own.  With
    cfg.aux_value_coeff > 0 the policy trunk also carries ``aux_head``, a
    scalar MLP head [d, *hidden, 1] over the final-LN plane (the JAX
    package's PPG auxiliary value head, ``ppoc_tpu/algo/ppo.py:229-236``),
    drawn right after the policy trunk from the generator's next numbers
    (the JAX package draws it from a split of the key its policy trunk
    already consumed, ``ROADMAP.md`` §3).

    With cfg.rnn_hidden > 0 both trunks are GRU or LSTM cells
    (cfg.rnn_cell, ``models/gru.py``) with MLP heads [H, *hidden, out],
    drawn policy first, then value (``ppoc_tpu/algo/ppo.py:245-260``)."""
    spec = env.spec

    def log_std():
        return torch.full((spec.action_dim,), math.log(cfg.init_std),
                          dtype=torch.float32, device=device)

    if cfg.attn_dim > 0:
        t_max = max(cfg.rollout_len, cfg.eval_len) + 1
        ff = cfg.attn_ff or 4 * cfg.attn_dim

        def trunk(out_dim):
            return attn.init(spec.obs_dim, cfg.attn_dim, cfg.attn_layers,
                             cfg.attn_heads, ff, t_max,
                             (cfg.attn_dim, *cfg.hidden, out_dim),
                             generator, device)

        policy_params = {"mlp": trunk(spec.action_dim)}
        if cfg.aux_value_coeff > 0.0:
            policy_params["mlp"]["aux_head"] = mlp.init(
                (cfg.attn_dim, *cfg.hidden, 1), generator, device)
        if not spec.discrete:
            policy_params["log_std"] = log_std()
        v_params = trunk(1)
    elif cfg.rnn_hidden > 0:
        def trunk(out_dim):
            return gru.init(spec.obs_dim, cfg.rnn_hidden,
                            (cfg.rnn_hidden, *cfg.hidden, out_dim),
                            generator, device, cell=cfg.rnn_cell)

        policy_params = {"mlp": trunk(spec.action_dim)}
        if not spec.discrete:
            policy_params["log_std"] = log_std()
        v_params = trunk(1)
    elif cfg.n_experts > 1:
        policy_params = {"mlp": moe.init(
            (spec.obs_dim, *cfg.hidden, spec.action_dim), cfg.n_experts,
            generator, device)}
        if not spec.discrete:
            policy_params["log_std"] = log_std()
        v_params = moe.init((spec.obs_dim, *cfg.hidden, 1), cfg.n_experts,
                            generator, device)
    else:
        policy_params = policy_mod.init(
            spec.obs_dim, spec.action_dim, cfg.hidden, cfg.init_std,
            spec.discrete, generator, device)
        v_params = mlp.init((spec.obs_dim, *cfg.hidden, 1), generator,
                            device)
    log_std = policy_params.get(
        "log_std", torch.zeros((0,), dtype=torch.float32, device=device))
    return TrainState(
        policy_params=policy_params,
        v_params=v_params,
        opt_policy=adam.init(policy_params["mlp"]),
        opt_v=adam.init(v_params),
        opt_log_std=adam.init(log_std),
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
    (V(s), V(s')) planes the kernel computed -- None under the "bf16"
    backend, whose K1 launch takes no value net (the JAX package's).
    ``seed`` is K1's two 32-bit seed words; ``env_carry=None`` resets
    every env at entry.

    Where :func:`uses_rollout_kernel` says no (a mixture, "jnp", an env
    without a lane) the stochastic env loop runs instead
    (:func:`rollout_env_loop`; ``seed``: its :class:`LoopDraws` with the
    action noise, which fix the shape), and a sequence trunk the loop of
    ``recurrent.rollout_rnn`` (``seed``: its :class:`LoopDraws`), always
    from a fresh window; the third element is then None."""
    if is_seq(policy_params["mlp"]):
        from ppoc_tpu_torch.algo import recurrent

        if env_carry is not None:
            raise ValueError("sequence-trunk rollouts always start from a "
                             "fresh window; reset_per_fit=False is not "
                             "supported with attn_dim > 0 or "
                             "rnn_hidden > 0")
        traj, carry = recurrent.rollout_rnn(cfg, env, policy_params, seed,
                                            force_truncate)
        return (traj, carry) + (() if v_params is None else (None,))
    if not uses_rollout_kernel(cfg, env):
        traj, carry = _env_loop(cfg, env, policy_params, seed, env_carry)
        if force_truncate:
            traj = _force_truncate_last(traj)
        return (traj, carry) + (() if v_params is None else (None,))
    fused_v = v_params is not None and backend_of(cfg) == "pallas"
    out = cuda_rollout.rollout_fused(
        env.spec.name, policy_params, seed, n_envs, length, cfg.activation,
        env_carry, gamma=env.spec.gamma,
        v_params=v_params if fused_v else None)
    if v_params is not None and not fused_v:
        out = out + (None,)
    if force_truncate:
        out = (_force_truncate_last(out[0]),) + tuple(out[1:])
    return out


class LoopDraws(NamedTuple):
    """All the randomness one loop rollout consumes (the env loop here, a
    sequence trunk's decode loop in ``algo/recurrent.py``)."""
    carry: Any   # (state, obs) the window starts from
    fresh: Any   # (state, obs) with leading dims [T, E]: what an env that
                 # finishes step t resets to
    noise: Optional[torch.Tensor] = None  # [T, E, A] standard normals
                 # (Gaussian) or [T, E, K] Gumbel draws (categorical);
                 # None for the mean policy


def draw_loop(env: Env, generator: torch.Generator, n_envs: int, length: int,
              device, noise: bool = False) -> LoopDraws:
    """Draw a loop rollout's start and reset states and, with ``noise``,
    its action noise (``policy.draw_noise``) from ``generator``."""
    carry = vector_reset(env, generator, n_envs, device)
    state, obs = vector_reset(env, generator, length * n_envs, device)

    def lead(x):
        return x.reshape((length, n_envs) + x.shape[1:])

    eps = None
    if noise:
        eps = policy_mod.draw_noise((length, n_envs, env.spec.action_dim),
                                    env.spec.discrete, generator).to(device)
    return LoopDraws(carry, (type(state)(*map(lead, state)), lead(obs)), eps)


@torch.no_grad()
def _env_loop(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any],
              draws: LoopDraws, env_carry=None):
    """(trajectory, final (state, obs)) of the env loop, from ``env_carry``
    or, when None, from the drawn start states."""
    state, obs = draws.carry if env_carry is None else env_carry
    fstate, fobs = draws.fresh
    steps, backend = [], backend_of(cfg)
    for t in range(fobs.shape[0]):
        out = mlp.apply(policy_params["mlp"], obs, cfg.activation, backend)
        action, logp = policy_mod.act_from_out(
            out, env.spec.discrete, policy_params.get("log_std"),
            draws.noise is None, None if draws.noise is None
            else draws.noise[t])
        fresh = (type(fstate)(*(f[t] for f in fstate)), fobs[t])
        state, obs2, next_obs, reward, term, trunc = vector_autoreset_step(
            env, state, action, fresh=fresh)
        steps.append((obs, action, logp, next_obs, reward, term, trunc))
        obs = obs2
    return (Transition(*(torch.stack(col) for col in zip(*steps))),
            (state, obs))


def rollout_env_loop(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any],
                     draws: LoopDraws) -> Transition:
    """The JAX package's env-loop rollout (``ppoc_tpu/algo/ppo.py:387-424``):
    per step one policy forward (K5 under "pallas", bf16 products under
    "bf16", plain PyTorch under "jnp", the mixture for a MoE trunk), the
    action from ``draws.noise`` (the mode where it is None: the mean
    policy), then ``vector_autoreset_step`` with the drawn reset states.
    Returns the trajectory [T, E, ...] with its genuine done flags."""
    return _env_loop(cfg, env, policy_params, draws)[0]


# --------------------------------------------------------------------------
# advantages
# --------------------------------------------------------------------------

@torch.no_grad()
def value_planes(cfg: PPOConfig, v_params, traj: Transition):
    """(V(s), V(s')) [T, E] as two whole-buffer forwards of ``v_params``
    on cfg's backend (``ppoc_tpu/algo/ppo.py:450-452``), where the rollout
    computed no planes."""
    return tuple(mlp.apply(v_params, o, cfg.activation, backend_of(cfg))[..., 0]
                 for o in (traj.obs, traj.next_obs))


def compute_advantages(cfg: PPOConfig, env: Env, traj: Transition,
                       values_pair, v_params=None):
    """GAE + whole-buffer normalisation on the rollout kernel's (V(s),
    V(s')) planes, or with ``values_pair`` None on :func:`value_planes`
    of ``v_params``; returns (advantages, targets), both [T, E].  One K2
    launch under "pallas", "bf16" and "moe:<k>:bf16"; the doubling-scan
    GAE and the Welford moments under "jnp" and "moe:<k>", as
    ``ppoc_tpu/algo/ppo.py:457-486`` gates it."""
    if values_pair is None:
        values_pair = value_planes(cfg, v_params, traj)
    backend = backend_of(cfg)
    if not (backend in ("pallas", "bf16")
            or (backend.startswith("moe:") and backend.endswith(":bf16"))):
        return _seq_advantages(cfg, env, traj, values_pair)
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
    """The JAX package's gate for a whole-phase kernel (K3, K4, K6):
    ``ppoc_tpu/algo/ppo.py:598-604`` and ``:698-704``, the "pallas"
    backend only.  Its other two conditions (per-shard minibatch size and
    count equal to cfg's) hold here always: the port has no sharding and
    draws its streams from cfg."""
    return (backend_of(cfg) == "pallas" and stab_ok
            and cfg.minibatch_size <= MAX_FUSED_MB)


class KernelFit(NamedTuple):
    """One kernel of a config's path on the card: the nets it takes, the
    shared memory it needs in each variant (``_build.VARIANTS``: the
    weights in shared memory, or past that in global memory; for K3, K4
    and K6 replicated in each block of a cluster, or sharded over it), and
    the first variant that fits (None: none does)."""
    kernel: str
    widths: Tuple[Tuple[int, ...], ...]
    nbytes: Tuple[int, ...]
    variant: Optional[str]


def kernel_fit(cfg: PPOConfig, optin: int,
               env: Optional[Env] = None) -> List[KernelFit]:
    """The kernels ``cfg``'s MLP path launches on the card, in path order,
    each with its shared-memory needs from the widths alone (the ops
    modules' ``variant_bytes``) and the variant that fits a block's
    ``optin`` bytes: K1 with the V planes (a fit's rollout, for an env
    with a lane; the evaluation's, with the metrics, needs less), K5 on
    the policy and the value net (the mean-policy evaluation, the env-loop
    rollout and the generic phases), then under the gate K3 and K4, or K6
    for a categorical policy (the three kinds of one pair of cluster
    kernels, so the same bytes).  Under the "bf16" backend only K1,
    without the V planes: the MLP products are library calls and no
    whole-phase kernel runs.  "jnp" (so a GRU/LSTM trunk) and a mixture
    ("moe:*") launch no kernel that takes the widths (K2 takes none), nor
    do K2 and K7 on an attention trunk: their lists are empty.  Needs no
    card."""
    backend = backend_of(cfg)
    if cfg.attn_dim > 0 or backend not in ("pallas", "bf16"):
        return []
    env = env if env is not None else envs.make_for(cfg)
    spec = env.spec
    pw = (spec.obs_dim, *cfg.hidden, spec.action_dim)
    vw = (spec.obs_dim, *cfg.hidden, 1)
    lane = uses_rollout_kernel(cfg, env)
    if backend == "bf16":
        plan = [(f"K1 (rollout, {spec.name} lane)", (pw,),
                 cuda_rollout.variant_bytes(pw))] if lane else []
    else:
        plan = ([(f"K1 (rollout, {spec.name} lane, with the V planes)",
                  (pw, vw), cuda_rollout.variant_bytes(pw, vw))]
                if lane else [])
        plan += [("K5 (whole-MLP forward and backward, policy net)", (pw,),
                  cuda_mlp.variant_bytes(pw)),
                 ("K5 (whole-MLP forward and backward, value net)", (vw,),
                  cuda_mlp.variant_bytes(vw))]
    if _fused(cfg, _stab_value_ok(cfg)):
        plan.append(("K3 (value phase)", (vw,),
                     cuda_update.variant_bytes(vw)))
    if _fused(cfg, _stab_policy_ok(cfg)):
        plan.append(("K6 (categorical policy phase)" if spec.discrete
                     else "K4 (policy phase)", (pw,),
                     cuda_update.variant_bytes(pw)))
    out = []
    for name, nets, nbytes in plan:
        fits = [0 <= n <= optin for n in nbytes]
        out.append(KernelFit(name, nets, tuple(nbytes),
                             _build.VARIANTS[fits.index(True)]
                             if any(fits) else None))
    return out


def _requiring_grad(tree):
    """Detached copies of a parameter tree's tensors that require grad."""
    return adam.tree_map(lambda t: t.detach().requires_grad_(), tree)


def _grads(loss: torch.Tensor, params):
    """d loss / d params as a tree shaped like ``params``."""
    leaves = adam.tree_leaves(params)
    return adam.tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))


def _adam_step(cfg: PPOConfig, params, grads, opt, lr):
    return adam.update(params, grads, opt, lr, cfg.adam_beta1,
                       cfg.adam_beta2, cfg.adam_eps)


def _minibatches(idx: torch.Tensor):
    """The stream's minibatches in order: epoch-major, then minibatch."""
    return idx.reshape(-1, idx.shape[-1])


# --- the stabilisers (``ppoc_tpu/algo/ppo.py:85-175``) -------------------------

def _prep_grads(cfg: PPOConfig, grads):
    """Clip the global norm of one step's whole gradient tree when
    cfg.max_grad_norm > 0 (a Gaussian policy's ``{"mlp", "log_std"}`` as
    one tree); shared by every phase, so the clip can never apply to one
    and not another."""
    if cfg.max_grad_norm > 0.0:
        return adam.clip_by_global_norm(grads, cfg.max_grad_norm)
    return grads


def _anneal_factor(cfg: PPOConfig, opt: adam.AdamState, n_mb: int,
                   epochs_per_fit: int) -> torch.Tensor:
    """The remaining share of the cfg.n_epochs schedule in ``opt``'s own
    Adam steps, max(0, 1 - t / total), as a 0-dim float32 CPU tensor: t
    and total in float32 and a tensor division, the JAX package's
    ``t.astype(f32) / f32(total)`` (a division by a Python scalar is a
    reciprocal product on CUDA).  On the CPU, so no step waits for a copy
    to the card; a CUDA op reads it as a scalar."""
    total = cfg.n_epochs * cfg.fits_per_epoch * epochs_per_fit * n_mb
    frac = (torch.tensor(float(opt.t), dtype=torch.float32)
            / torch.tensor(float(max(total, 1)), dtype=torch.float32))
    return torch.clamp(1.0 - frac, min=0.0)


def _lr(base: float, cfg: PPOConfig, opt: adam.AdamState, n_mb: int,
        epochs_per_fit: int):
    """The learning rate of ``opt``'s next step: ``base``, or with
    cfg.lr_anneal ``base`` times :func:`_anneal_factor` (a 0-dim float32
    tensor, which ``adam.update`` takes as is)."""
    if not cfg.lr_anneal:
        return base
    return base * _anneal_factor(cfg, opt, n_mb, epochs_per_fit)


def _ent_coeff(cfg: PPOConfig, opt_policy: adam.AdamState, n_mb: int):
    """The entropy coefficient: cfg.ent_coeff, or with cfg.ent_anneal
    annealed by the policy net's Adam steps over n_epochs_policy."""
    if not cfg.ent_anneal:
        return cfg.ent_coeff
    return cfg.ent_coeff * _anneal_factor(cfg, opt_policy, n_mb,
                                          cfg.n_epochs_policy)


def value_steps(cfg: PPOConfig, ts: TrainState, batches, values, n_mb: int,
                backend: str):
    """The generic value phase over ``batches`` (``ppoc_tpu/algo/ppo.py:
    631-667``), shared with the sequence phase: per minibatch ``(obs,
    target, v_old or None, extra)``, the predictions ``values(params,
    batch)``, the MSE (the clipped loss against v_old with
    cfg.clip_value), the mixture's load-balance term with
    cfg.moe_aux_coeff, the gradient (K5's or K7's backward on the card),
    :func:`_prep_grads` and one Adam step at :func:`_lr` of lr_v.
    Returns (ts', mean minibatch loss)."""
    aux_coeff, topk = moe.aux_setup(cfg, ts.v_params, backend)
    v_params, opt_v, mb_losses = ts.v_params, ts.opt_v, []
    for batch in batches:
        o, t, vo = batch[:3]
        params = _requiring_grad(v_params)
        v = values(params, batch)
        if cfg.clip_value > 0.0:
            loss = losses.clipped_value_loss(v, vo, t, cfg.clip_value)
        else:
            loss = losses.value_loss(v, t)
        if aux_coeff:
            loss = loss + aux_coeff * moe.load_balance_loss(params, o, topk)
        grads = _prep_grads(cfg, _grads(loss, params))
        v_params, opt_v = _adam_step(
            cfg, v_params, grads, opt_v,
            _lr(cfg.lr_v, cfg, opt_v, n_mb, cfg.n_epochs_value))
        mb_losses.append(loss.detach())
    return (ts._replace(v_params=v_params, opt_v=opt_v),
            torch.stack(mb_losses).mean())


def policy_steps(cfg: PPOConfig, ts: TrainState, batches, log_probs,
                 n_mb: int, backend: str, discrete: bool):
    """The generic policy phase over ``batches`` (``ppoc_tpu/algo/ppo.py:
    726-780``), shared with the sequence phase: per minibatch ``(obs,
    action, old log-prob, advantage, extra)``, ``log_probs(params, batch)
    -> (log-probs, entropy)``, the clipped surrogate minus the
    (annealed) entropy coefficient times the entropy, plus the mixture's
    load-balance term; its gradient through :func:`_prep_grads` (the
    policy net and log_std as one tree) and one Adam step each for the
    net and, if Gaussian, log_std, each at :func:`_lr` of its own
    counter.

    cfg.target_kl: once a minibatch's approximate KL, mean(old - new
    log-prob) before its step, exceeds the target, every later step of the
    phase is frozen -- params and both Adam states (the JAX package's
    ``_freeze_where``) -- while the loss and entropy of every remaining
    minibatch still enter the reported means, computed without a gradient.
    A third element of ``log_probs``' result is a loss term added to the
    minibatch's loss (the sequence phase's auxiliary value loss).
    Returns (ts', mean loss, mean entropy)."""
    aux_coeff, topk = moe.aux_setup(cfg, ts.policy_params["mlp"], backend)
    pol, opt_p, opt_ls = ts.policy_params, ts.opt_policy, ts.opt_log_std
    stop, mb_losses, ents = False, [], []

    def loss_of(params, batch):
        o, _, lp, ad = batch[:4]
        logp, ent, *extra = log_probs(params, batch)
        loss = (losses.clipped_surrogate_loss(logp, lp, ad, cfg.clip_eps)
                - _ent_coeff(cfg, opt_p, n_mb) * ent)
        for term in extra:
            loss = loss + term
        if aux_coeff:
            loss = loss + aux_coeff * moe.load_balance_loss(
                params["mlp"], o, topk)
        return loss, ent, logp

    for batch in batches:
        if stop:
            with torch.no_grad():
                loss, ent, _ = loss_of(pol, batch)
        else:
            params = {k: _requiring_grad(v) for k, v in pol.items()}
            loss, ent, logp = loss_of(params, batch)
            grads = _prep_grads(cfg, _grads(loss, params))
            mlp2, opt_p2 = _adam_step(
                cfg, pol["mlp"], grads["mlp"], opt_p,
                _lr(cfg.lr_policy, cfg, opt_p, n_mb, cfg.n_epochs_policy))
            pol2 = {"mlp": mlp2}
            if not discrete:
                pol2["log_std"], opt_ls = _adam_step(
                    cfg, pol["log_std"], grads["log_std"], opt_ls,
                    _lr(cfg.lr_policy, cfg, opt_ls, n_mb,
                        cfg.n_epochs_policy))
            pol, opt_p = pol2, opt_p2
            if cfg.target_kl > 0.0:
                kl = torch.mean(batch[2] - logp.detach())
                stop = bool(kl > cfg.target_kl)
        mb_losses.append(loss.detach())
        ents.append(ent.detach())
    return (ts._replace(policy_params=pol, opt_policy=opt_p,
                        opt_log_std=opt_ls),
            torch.stack(mb_losses).mean(), torch.stack(ents).mean())


def value_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                idx: torch.Tensor):
    """Fit V over the id stream ``idx`` [n_epochs, n_mb, ...]; returns
    (ts', mean minibatch loss).

    Under the fused gate, one K3 launch on the pre-gathered rows.  Above
    it, under the "bf16" or "jnp" backend, for a mixture or with a value
    stabiliser at any size, :func:`value_steps` on the gathered
    minibatches, the predictions through K5 on "pallas" (bf16 products
    under "bf16", plain PyTorch under "jnp")."""
    n_epochs, n_mb = idx.shape[:2]
    mb, blk = cfg.minibatch_size, cfg.shuffle_block
    if _fused(cfg, _stab_value_ok(cfg)):
        obs_seq, tgt_seq = buffer.gather_mb((buf.obs, buf.target), idx, blk)
        v2, opt2, loss = cuda_update.value_phase(
            obs_seq, tgt_seq, ts.v_params, ts.opt_v, n_epochs * n_mb, mb,
            cfg.activation, _hyper(cfg, cfg.lr_v))
        return ts._replace(v_params=v2, opt_v=opt2), loss
    backend = backend_of(cfg)
    cols = (buf.obs, buf.target) + ((buf.v_old,) if cfg.clip_value > 0.0
                                    else ())
    batches = (tuple(buffer.gather_mb(cols, ids, blk)) + (None,) * (4 - len(cols))
               for ids in _minibatches(idx))
    return value_steps(
        cfg, ts, batches,
        lambda p, b: mlp.apply(p, b[0], cfg.activation, backend)[..., 0],
        n_mb, backend)


def policy_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                 idx: torch.Tensor, discrete: bool = False):
    """Clipped-surrogate passes over the id stream ``idx``; returns (ts',
    mean loss, mean entropy).

    Under the fused gate, one K4 launch, or one K6 launch for a categorical
    policy (``discrete``), as ``ppoc_tpu/algo/ppo.py:687-708`` chooses.
    Above it, under the "bf16" or "jnp" backend, for a mixture or with a
    policy stabiliser at any size, :func:`policy_steps` on the gathered
    minibatches, the log-prob and entropy through K5 on "pallas"."""
    n_epochs, n_mb = idx.shape[:2]
    mb, blk = cfg.minibatch_size, cfg.shuffle_block
    cols = (buf.obs, buf.action, buf.log_prob, buf.advantage)
    pol = ts.policy_params
    if _fused(cfg, _stab_policy_ok(cfg)):
        o, a, lp, ad = buffer.gather_mb(cols, idx, blk)
        if discrete:
            params2, opt_p2, loss, ent = cuda_update.policy_phase_categorical(
                o, a, lp, ad, pol["mlp"], ts.opt_policy, n_epochs * n_mb, mb,
                cfg.activation, _hyper(cfg, cfg.lr_policy), cfg.clip_eps,
                cfg.ent_coeff)
            return ts._replace(policy_params={"mlp": params2},
                               opt_policy=opt_p2), loss, ent
        params2, ls2, opt_p2, opt_ls2, loss, ent = cuda_update.policy_phase(
            o, a, lp, ad, pol["mlp"], pol["log_std"], ts.opt_policy,
            ts.opt_log_std, n_epochs * n_mb, mb, cfg.activation,
            _hyper(cfg, cfg.lr_policy), cfg.clip_eps, cfg.ent_coeff)
        return ts._replace(policy_params={"mlp": params2, "log_std": ls2},
                           opt_policy=opt_p2, opt_log_std=opt_ls2), loss, ent
    backend = backend_of(cfg)

    def log_probs(params, b):
        return (policy_mod.log_prob(params, b[0], b[1], cfg.activation,
                                    backend, discrete),
                policy_mod.entropy(params, b[0], cfg.activation, backend,
                                   discrete))

    batches = (tuple(buffer.gather_mb(cols, ids, blk))
               for ids in _minibatches(idx))
    return policy_steps(cfg, ts, batches, log_probs, n_mb, backend,
                        discrete)


def value_phase_fused(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                      idx: torch.Tensor, bf16: bool = False):
    """The whole value phase over the id stream ``idx`` as one kernel,
    whatever the minibatch size: ``ppoc_tpu/ops/pallas_update.py``
    ``value_phase_fused``.  Gathers the stream, then runs K3, or with
    ``bf16`` K3 bf16 (bf16 products, float32 master weights, moments and
    gradient sums: the kernel's over 128-row partials, its plain version's
    over row tiles of ``cuda_update.bf16_tile(mb)`` rows).
    No trainer path calls it, as in the JAX package (its gate,
    ``ppoc_tpu/algo/ppo.py:609-615``, never routes here).  Returns (ts',
    mean loss)."""
    n_steps = idx.shape[0] * idx.shape[1]
    mb = cfg.minibatch_size
    obs_seq, tgt_seq = buffer.gather_mb((buf.obs, buf.target), idx,
                                        cfg.shuffle_block)
    args = (obs_seq, tgt_seq, ts.v_params, ts.opt_v, n_steps, mb,
            cfg.activation, _hyper(cfg, cfg.lr_v))
    if bf16:
        v2, opt2, loss = cuda_update.value_phase_bf16(*args)
    else:
        v2, opt2, loss = cuda_update.value_phase(*args)
    return ts._replace(v_params=v2, opt_v=opt2), loss


def policy_phase_fused(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer,
                       idx: torch.Tensor, bf16: bool = False):
    """The whole Gaussian policy phase over ``idx`` as one kernel: K4, or
    with ``bf16`` K4 bf16 (``pallas_update.policy_phase_fused``; see
    :func:`value_phase_fused`).  The JAX package's categorical phase has no
    bf16 argument, so a categorical policy is refused here.  Returns (ts',
    mean loss, mean entropy)."""
    pol = ts.policy_params
    if "log_std" not in pol:
        raise ValueError("policy_phase_fused is the Gaussian policy phase; a "
                         "categorical policy takes "
                         "cuda_update.policy_phase_categorical (K6)")
    n_steps = idx.shape[0] * idx.shape[1]
    mb = cfg.minibatch_size
    o, a, lp, ad = buffer.gather_mb(
        (buf.obs, buf.action, buf.log_prob, buf.advantage), idx,
        cfg.shuffle_block)
    args = (o, a, lp, ad, pol["mlp"], pol["log_std"], ts.opt_policy,
            ts.opt_log_std, n_steps, mb, cfg.activation,
            _hyper(cfg, cfg.lr_policy), cfg.clip_eps, cfg.ent_coeff)
    if bf16:
        out = cuda_update.policy_phase_bf16(*args)
    else:
        out = cuda_update.policy_phase(*args)
    params2, ls2, opt_p2, opt_ls2, loss, ent = out
    return ts._replace(policy_params={"mlp": params2, "log_std": ls2},
                       opt_policy=opt_p2, opt_log_std=opt_ls2), loss, ent


# --------------------------------------------------------------------------
# fit step / epoch / train-until
# --------------------------------------------------------------------------

def _seq_advantages(cfg: PPOConfig, env: Env, traj: Transition,
                    values_pair):
    """GAE by the doubling scan, then the whole-buffer normalisation with
    Welford moments: the JAX package's "jnp" advantages, which its
    sequence branch and its "jnp" and "moe:<k>" backends take
    (``ppoc_tpu/algo/ppo.py:475-486``, ``:827-828``)."""
    values, next_values = values_pair
    adv, target = gae_ops.gae(traj.reward, values, next_values,
                              traj.terminated, traj.truncated,
                              env.spec.gamma, cfg.lam)
    if cfg.norm_adv_global:
        mean, var = welford.mean_var(adv)
        adv = gae_ops.normalize(adv, mean, torch.sqrt(var))
    return adv, target


def update_step(cfg: PPOConfig, env: Env, ts: TrainState, traj: Transition,
                draws: FitDraws, values_pair):
    """Learner half of a fit: GAE + normalisation, then the value and
    policy phases on an already-collected trajectory.  ``values_pair`` is
    K1's (V(s), V(s')) planes or None (then :func:`value_planes`); with
    cfg.clip_value its V(s) rides in the row buffer as V_old
    (``ppoc_tpu/algo/ppo.py:843-855``).  A sequence trunk (attention or
    GRU/LSTM) computes its value planes itself and ignores
    ``values_pair``; with cfg.aux_value_coeff > 0 its policy phase also
    fits the aux head to the value targets (``ppoc_tpu/algo/ppo.py:
    818-836``)."""
    if is_seq(ts.v_params):
        from ppoc_tpu_torch.algo import recurrent

        backend = backend_of(cfg)
        vpair = recurrent.compute_values_rnn(cfg, ts.v_params, traj, backend)
        adv, target = _seq_advantages(cfg, env, traj, vpair)
        ts, v_loss = recurrent.value_phase_rnn(
            cfg, ts, traj, target, draws.value_idx, backend,
            v_old=vpair[0] if cfg.clip_value > 0.0 else None)
        ts, p_loss, ent = recurrent.policy_phase_rnn(
            cfg, env, ts, traj, adv, draws.policy_idx, backend,
            target=target if cfg.aux_value_coeff > 0.0 else None)
        return ts, FitMetrics(v_loss, p_loss, ent, traj.reward.mean())
    if values_pair is None:
        values_pair = value_planes(cfg, ts.v_params, traj)
    adv, target = compute_advantages(cfg, env, traj, values_pair)
    buf = buffer.from_rollout(
        traj, adv, target,
        v_old=values_pair[0] if cfg.clip_value > 0.0 else None)
    ts, v_loss = value_phase(cfg, ts, buf, draws.value_idx)
    ts, p_loss, ent = policy_phase(cfg, ts, buf, draws.policy_idx,
                                   env.spec.discrete)
    return ts, FitMetrics(v_loss, p_loss, ent, traj.reward.mean())


def fit_step(cfg: PPOConfig, env: Env, ts: TrainState, draws: FitDraws,
             n_envs: Optional[int] = None, env_carry=None,
             return_env_carry: bool = False):
    """One fit: collect steps_per_fit transitions, GAE, value + policy
    epochs.  ``env_carry``/``return_env_carry`` thread persistent env state
    across fits (cfg.reset_per_fit=False)."""
    n_envs = cfg.n_envs if n_envs is None else n_envs
    traj, env_carry, vpair = rollout(
        cfg, env, ts.policy_params,
        draws.seed if draws.seq is None else draws.seq, n_envs,
        cfg.rollout_len, env_carry, v_params=ts.v_params)
    ts, metrics = update_step(cfg, env, ts, traj, draws, vpair)
    return (ts, env_carry, metrics) if return_env_carry else (ts, metrics)


def _device(ts: TrainState) -> torch.device:
    return adam.tree_leaves(ts.v_params)[0].device


def train_epoch(cfg: PPOConfig, env: Env, ts: TrainState,
                generator: torch.Generator):
    """fits_per_epoch sequential fits; returns (ts', metrics meaned over the
    fits).  With cfg.reset_per_fit=False envs reset once at epoch entry and
    persist across the fits."""
    device = _device(ts)
    carry = None
    if not cfg.reset_per_fit:
        carry = vector_reset(env, generator, cfg.n_envs, device)
    metrics = []
    for _ in range(cfg.fits_per_epoch):
        draws = draw_fit(cfg, generator, device, env)
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
    device = _device(ts)
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
    """Draw what one evaluation consumes: K1's two seed words for the
    stochastic policy where :func:`uses_rollout_kernel`, else the env
    loop's :class:`LoopDraws` (with the action noise unless
    ``deterministic``); for a sequence trunk its loop's."""
    n_envs = cfg.eval_envs if n_envs is None else n_envs
    if cfg.attn_dim > 0 or cfg.rnn_hidden > 0:
        from ppoc_tpu_torch.algo import recurrent

        return recurrent.draw_seq(env, generator, n_envs, cfg.eval_len,
                                  device, deterministic)
    if deterministic or not uses_rollout_kernel(cfg, env):
        return draw_loop(env, generator, n_envs, cfg.eval_len, device,
                         noise=not deterministic)
    return cuda_rollout.seed_words(generator)


def evaluate(cfg: PPOConfig, env: Env, policy_params: Dict[str, Any], draws,
             n_envs: Optional[int] = None,
             deterministic: bool = False) -> EvalMetrics:
    """Evaluation over cfg.eval_len steps, with ``draws`` from
    :func:`draw_eval`, as ``ppoc_tpu/algo/ppo.py:1141-1194`` chooses:

    * the stochastic policy is K1 (``draws``: its two seed words) where
      :func:`uses_rollout_kernel`.  With the completed-episode estimator
      the kernel sums the returns itself; with cfg.eval_estimator
      "reference" the estimator reads K1's trajectory;
    * ``deterministic=True`` (the mean policy), and the stochastic policy
      of a mixture, "jnp" or an env without a lane, run the env loop, one
      policy forward per step (``draws``: a :class:`LoopDraws`, which also
      fixes the env count);
    * a sequence trunk, either way, runs its loop (``recurrent.
      rollout_rnn``: the attention decode or the GRU/LSTM cell; ``draws``:
      a ``SeqDraws``), as ``ppoc_tpu/algo/ppo.py:1163-1193`` does; no
      kernel launches."""
    n_envs = cfg.eval_envs if n_envs is None else n_envs
    reference = cfg.eval_estimator == "reference"
    if is_seq(policy_params["mlp"]):
        from ppoc_tpu_torch.algo import recurrent

        traj, _ = recurrent.rollout_rnn(cfg, env, policy_params, draws,
                                        force_truncate=False,
                                        deterministic=deterministic)
    elif deterministic or not uses_rollout_kernel(cfg, env):
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

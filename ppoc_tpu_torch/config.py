"""Training configuration: the port's own copy of ``ppoc_tpu/config.py``.

The port imports nothing of the JAX package, so it keeps this copy of the
``PPOConfig`` dataclass (same fields, defaults and derived properties), the
``validate`` bank and the three presets.  ``tests/test_torch_config.py``
holds it to the JAX package's module: equal field names and defaults,
equal presets, and ``validate`` accepting and rejecting the same configs
with the same messages.  The field comments are kept short; the JAX
module documents each field at length.

Many fields select parts of the JAX package that the port has not ported
yet; ``algo/trainer.py`` ``check_ported`` refuses those settings.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # --- environment -----------------------------------------------------
    env: str = "pendulum"
    seed: int = 0

    # --- network ---------------------------------------------------------
    hidden: Tuple[int, ...] = (128, 128)
    activation: str = "relu"   # hidden-layer activation: relu | tanh | none
    init_std: float = 1.0      # initial policy std

    # --- PPO hyperparameters ---------------------------------------------
    lr_policy: float = 3e-4
    lr_v: float = 3e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    lam: float = 0.95          # GAE lambda
    clip_eps: float = 0.2
    ent_coeff: float = 0.0
    n_epochs_policy: int = 4
    n_epochs_value: int = 10
    minibatch_size: int = 64

    # --- stabilisers beyond the reference (all off by default) -------------
    max_grad_norm: float = 0.0
    target_kl: float = 0.0
    lr_anneal: bool = False
    clip_value: float = 0.0
    ent_anneal: bool = False

    # --- schedule: a fit collects n_envs x rollout_len transitions ---------
    n_envs: int = 15
    rollout_len: int = 200
    fits_per_epoch: int = 10
    n_epochs: int = 10

    # --- evaluation ---------------------------------------------------------
    eval_envs: int = 15
    eval_len: int = 200
    eval_estimator: str = "completed"   # "completed" | "reference"

    # --- execution -----------------------------------------------------------
    kernel_backend: str = "auto"   # "pallas" | "jnp" | "bf16" | "auto"
    mesh_axis: str = "dp"
    tp_size: int = 1
    pp_size: int = 1
    pp_microbatches: int = 0
    n_experts: int = 1
    moe_topk: int = 0
    ep_size: int = 1
    moe_aux_coeff: float = 0.0
    rnn_hidden: int = 0
    rnn_cell: str = "gru"
    attn_dim: int = 0
    attn_layers: int = 2
    attn_heads: int = 2
    attn_ff: int = 0
    sp_size: int = 1
    zero1: bool = False
    obs_loc: Tuple[float, ...] = ()
    obs_scale: Tuple[float, ...] = ()
    shuffle_block: int = 0     # >0: shuffle minibatches in blocks of rows
    transplant_patience: int = 0
    aux_value_coeff: float = 0.0
    fit_dispatch: str = "fused"
    rollout_chunk: int = 0
    fits_per_program: int = 0
    norm_adv_global: bool = True
    reset_per_fit: bool = True

    # ----------------------------------------------------------------------
    @property
    def steps_per_fit(self) -> int:
        return self.n_envs * self.rollout_len

    @property
    def steps_per_epoch(self) -> int:
        return self.steps_per_fit * self.fits_per_epoch

    @property
    def num_minibatches(self) -> int:
        # floor division: the tail (< minibatch_size rows) is dropped
        return self.steps_per_fit // self.minibatch_size

    def replace(self, **kw) -> "PPOConfig":
        return dataclasses.replace(self, **kw)


def _single_device_only(cfg: PPOConfig) -> bool:
    return (cfg.tp_size > 1 or cfg.pp_size > 1 or cfg.ep_size > 1
            or cfg.sp_size > 1 or cfg.zero1)


def validate(cfg: PPOConfig) -> PPOConfig:
    """The config-consistency checks of ``ppoc_tpu.config.validate``, with
    the same messages; returns ``cfg``."""
    if cfg.eval_estimator not in ("completed", "reference"):
        raise ValueError(
            f"eval_estimator must be 'completed' or 'reference', got "
            f"{cfg.eval_estimator!r}"
        )
    if cfg.num_minibatches < 1:
        raise ValueError(
            f"minibatch_size ({cfg.minibatch_size}) exceeds steps_per_fit "
            f"({cfg.steps_per_fit} = n_envs * rollout_len): zero "
            f"minibatches per epoch, nothing would train"
        )
    if cfg.shuffle_block:
        if cfg.shuffle_block < 0:
            raise ValueError(f"shuffle_block must be >= 0, got "
                             f"{cfg.shuffle_block}")
        if (cfg.minibatch_size % cfg.shuffle_block
                or cfg.steps_per_fit % cfg.shuffle_block):
            raise ValueError(
                f"shuffle_block ({cfg.shuffle_block}) must divide both "
                f"minibatch_size ({cfg.minibatch_size}) and steps_per_fit "
                f"({cfg.steps_per_fit})"
            )
        if cfg.rnn_hidden > 0 or cfg.attn_dim > 0:
            raise ValueError(
                "shuffle_block applies to row-minibatch trunks only: "
                "sequence trunks (rnn_hidden/attn_dim) already shuffle "
                "whole sequences"
            )
    if cfg.transplant_patience:
        if cfg.transplant_patience < 0:
            raise ValueError(f"transplant_patience must be >= 0, got "
                             f"{cfg.transplant_patience}")
        if cfg.rnn_hidden <= 0 and cfg.attn_dim <= 0:
            raise ValueError(
                "transplant_patience (critic->policy encoder transplant) "
                "requires a sequence trunk (rnn_hidden or attn_dim > 0): "
                "the policy and value encoders must share a shape"
            )
        if cfg.zero1:
            raise ValueError(
                "transplant_patience resets the policy Adam moments in "
                "the logical tree layout and cannot combine with zero1's "
                "packed optimizer state"
            )
    if cfg.aux_value_coeff:
        if cfg.aux_value_coeff < 0:
            raise ValueError(f"aux_value_coeff must be >= 0, got "
                             f"{cfg.aux_value_coeff}")
        if cfg.attn_dim <= 0:
            raise ValueError(
                "aux_value_coeff (PPG-style auxiliary value head on the "
                "policy trunk) requires the attention family (attn_dim > 0)"
            )
        if cfg.sp_size > 1:
            raise ValueError(
                "aux_value_coeff does not combine with sequence "
                "parallelism (sp_size > 1): the auxiliary head reads the "
                "whole-window hidden plane"
            )
    if cfg.fit_dispatch not in ("fused", "phased"):
        raise ValueError(
            f"fit_dispatch must be 'fused' or 'phased', got "
            f"{cfg.fit_dispatch!r}"
        )
    if cfg.fit_dispatch == "phased":
        if cfg.rnn_hidden <= 0 and cfg.attn_dim <= 0:
            raise ValueError(
                "fit_dispatch='phased' splits the SEQUENCE-trunk fit "
                "(rollout / values+GAE / phases); dense trunks use the "
                "fused fit (their programs are small)"
            )
        if not cfg.reset_per_fit:
            raise ValueError(
                "fit_dispatch='phased' requires reset_per_fit=True "
                "(sequence trunks always reset at window entry)"
            )
        if cfg.fits_per_program:
            raise ValueError(
                "fit_dispatch='phased' already dispatches per fit; do not "
                "combine with fits_per_program"
            )
        if _single_device_only(cfg):
            raise ValueError(
                "fit_dispatch='phased' supports single-device runs only"
            )
    if cfg.rollout_chunk:
        if cfg.rollout_chunk < 0:
            raise ValueError(f"rollout_chunk must be >= 0, got "
                             f"{cfg.rollout_chunk}")
        if cfg.fit_dispatch != "phased":
            raise ValueError(
                "rollout_chunk (segmented decode dispatch) requires "
                "fit_dispatch='phased'"
            )
        if cfg.rollout_len % cfg.rollout_chunk or \
                cfg.eval_len % cfg.rollout_chunk:
            raise ValueError(
                f"rollout_chunk ({cfg.rollout_chunk}) must divide both "
                f"rollout_len ({cfg.rollout_len}) and eval_len "
                f"({cfg.eval_len}): segments are equal-size compiled "
                f"programs"
            )
    if cfg.fits_per_program:
        if cfg.fits_per_program < 0:
            raise ValueError(f"fits_per_program must be >= 0, got "
                             f"{cfg.fits_per_program}")
        if cfg.fits_per_epoch % cfg.fits_per_program:
            raise ValueError(
                f"fits_per_program ({cfg.fits_per_program}) must divide "
                f"fits_per_epoch ({cfg.fits_per_epoch}): the epoch runs as "
                f"equal-size compiled chunks"
            )
        if _single_device_only(cfg):
            raise ValueError(
                "fits_per_program supports single-device runs only "
                "(the parallel modes wrap the fused epoch program); its "
                "target regime — extreme single-chip windows — doesn't "
                "overlap them"
            )
    if cfg.rnn_hidden > 0 or cfg.attn_dim > 0:
        kind = "rnn_hidden" if cfg.rnn_hidden > 0 else "attn_dim"
        if cfg.rnn_hidden > 0 and cfg.attn_dim > 0:
            raise ValueError(
                "rnn_hidden and attn_dim cannot both be set: pick ONE "
                "sequence family (recurrent or attention) per run"
            )
        if cfg.n_experts > 1 or cfg.tp_size > 1 or cfg.pp_size > 1 \
                or cfg.ep_size > 1:
            raise ValueError(
                f"{kind} > 0 (sequence trunks) cannot combine with "
                f"n_experts/tp_size/pp_size/ep_size; sequence training "
                f"shards over the data axis only"
            )
        if not cfg.reset_per_fit:
            raise ValueError(
                f"{kind} > 0 requires reset_per_fit=True: sequence "
                f"updates replay each window from an empty state, so "
                f"windows must start at episode starts"
            )
        if cfg.rnn_hidden > 0 and cfg.rnn_cell not in ("gru", "lstm"):
            raise ValueError(
                f"rnn_cell must be 'gru' or 'lstm', got {cfg.rnn_cell!r}"
            )
        if cfg.attn_dim > 0 and cfg.attn_dim % cfg.attn_heads:
            raise ValueError(
                f"attn_dim ({cfg.attn_dim}) must be divisible by "
                f"attn_heads ({cfg.attn_heads})"
            )
    if cfg.sp_size > 1:
        if cfg.attn_dim <= 0:
            raise ValueError(
                "sp_size > 1 (sequence parallelism) requires attn_dim > 0: "
                "only the attention family computes over the window in "
                "parallel (ring attention); GRU/LSTM scans and feedforward "
                "trunks have no time axis to shard"
            )
        if cfg.rollout_len % cfg.sp_size:
            raise ValueError(
                f"rollout_len ({cfg.rollout_len}) must be divisible by "
                f"sp_size ({cfg.sp_size}): the window shards into "
                f"contiguous equal time blocks"
            )
        if cfg.zero1:
            raise ValueError(
                "sp_size > 1 cannot combine with zero1: the sp update's "
                "gradient reduction spans the (dp, sp) mesh while ZeRO-1 "
                "shards optimizer state over dp alone"
            )
    if cfg.tp_size > 1 and cfg.pp_size > 1:
        raise ValueError(
            "tp_size and pp_size cannot both exceed 1: pick tensor OR "
            "pipeline sharding for the model axis"
        )
    if cfg.zero1 and (cfg.tp_size > 1 or cfg.pp_size > 1
                      or cfg.ep_size > 1):
        raise ValueError(
            "zero1 cannot combine with tp_size/pp_size/ep_size: those "
            "modes already shard optimizer state along the model axis"
        )
    if cfg.ep_size > 1:
        if cfg.tp_size > 1 or cfg.pp_size > 1:
            raise ValueError(
                "ep_size cannot combine with tp_size/pp_size: the model "
                "axis is experts OR tensor OR pipeline"
            )
        if cfg.n_experts <= 1:
            raise ValueError("ep_size > 1 requires n_experts > 1")
        if cfg.n_experts % cfg.ep_size:
            raise ValueError(
                f"n_experts ({cfg.n_experts}) must be divisible by "
                f"ep_size ({cfg.ep_size})"
            )
    if cfg.n_experts > 1 and (cfg.tp_size > 1 or cfg.pp_size > 1):
        raise ValueError(
            "n_experts > 1 (MoE trunks) cannot combine with "
            "tp_size/pp_size; shard experts with ep_size instead"
        )
    if cfg.pp_size > 1:
        n_layers = len(cfg.hidden) + 1
        if n_layers % cfg.pp_size:
            raise ValueError(
                f"{n_layers} MLP layers (hidden={cfg.hidden}) do not "
                f"partition into pp_size={cfg.pp_size} contiguous stages"
            )
    return cfg


# Presets ------------------------------------------------------------------

def reference_preset(env: str = "pendulum", seed: int = 0) -> PPOConfig:
    """The reference driver's step counts, minibatch schedule and
    hyperparameters."""
    return PPOConfig(env=env, seed=seed)


def tpu_preset(env: str = "pendulum", seed: int = 0) -> PPOConfig:
    """Throughput preset: 1024 envs x 200 steps, minibatch 8192 in
    block-shuffled blocks of 1024 rows, one fit per epoch.  The name is the
    JAX package's; the port runs it on the card."""
    return PPOConfig(
        env=env,
        seed=seed,
        n_envs=1024,
        rollout_len=200,
        minibatch_size=8192,
        fits_per_epoch=1,
        n_epochs_value=10,
        n_epochs_policy=4,
        eval_envs=256,
        eval_len=200,
        shuffle_block=1024,
    )


def tuned_preset(env: str = "pendulum", seed: int = 0) -> PPOConfig:
    """Solve-speed preset found by the JAX package's own sweep: lr 1e-3,
    clip 0.3, 5 value + 2 policy epochs."""
    return PPOConfig(
        env=env,
        seed=seed,
        n_envs=64,
        rollout_len=200,
        minibatch_size=256,
        fits_per_epoch=4,
        eval_envs=64,
        eval_len=200,
        kernel_backend="pallas",
        lr_policy=1e-3,
        lr_v=1e-3,
        clip_eps=0.3,
        n_epochs_value=5,
        n_epochs_policy=2,
    )


__all__ = ["PPOConfig", "reference_preset", "tpu_preset", "tuned_preset",
           "validate"]

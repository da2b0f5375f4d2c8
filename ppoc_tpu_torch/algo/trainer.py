"""Training driver: epoch loop, evaluation, the per-epoch metrics line.

Counterpart of ``ppoc_tpu/algo/trainer.py`` for one device.  The trainer
owns one ``torch.Generator`` (seeded from cfg.seed) in place of the JAX
package's key; every fit and evaluation draws its seed words and row-id
streams from it.  ``solve`` is a host loop over epochs plus evaluation
(``ppo.train_until``), where the JAX package compiles that loop into one
``while_loop``.  The trainer runs on CUDA device 0 unless it is given
another device (the CPU tests pass ``device="cpu"``).

``save`` / ``load`` / ``from_checkpoint`` read and write the JAX package's
checkpoint files (``utils/checkpoint.py``): params, all three Adam states
and, in a file the port wrote, the generator's state, so a resumed run
replays the remaining epochs bit for bit.

A sequence trunk's plateau rescue is the JAX package's: with
cfg.transplant_patience > 0, ``train`` copies the critic's encoder into
the policy (``transplant_value_trunk``) once eval R has failed to gain
0.05 over its best for that many epochs.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from ppoc_tpu_torch import envs
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.config import PPOConfig, validate
from ppoc_tpu_torch.ops import _build


class EvalWindowWarning(UserWarning):
    """cfg.eval_len < env horizon: evaluation counts only episodes that
    COMPLETE inside the window, so long episodes are censored."""


# PPOConfig fields whose non-default settings select parts of the JAX
# package that are not ported yet: the value that is supported, and the
# ROADMAP.md §1 item that ports them.  The relief valves (fit_dispatch,
# rollout_chunk, fits_per_program) are not here: the port runs every fit
# eagerly, so each is already what it asks for (``solve`` refuses them).
_NOT_PORTED = {
    "tp_size": (1, 16), "pp_size": (1, 16), "ep_size": (1, 16),
    "sp_size": (1, 16), "zero1": (False, 16),
}


def check_ported(cfg: PPOConfig) -> None:
    """Raise NotImplementedError for a config that needs an unported part,
    naming each field and its ROADMAP.md item."""
    bad = {k: (getattr(cfg, k), item) for k, (ok, item) in _NOT_PORTED.items()
           if getattr(cfg, k) != ok}
    if bad:
        raise NotImplementedError(
            "not ported to ppoc_tpu_torch yet: " + ", ".join(
                f"{k}={v!r} (ROADMAP.md §1 item {item})"
                for k, (v, item) in bad.items()))


def check_kernel_fit(cfg: PPOConfig, env, optin: int,
                     rollout: bool = True) -> None:
    """Raise NotImplementedError if a kernel of cfg's path takes its nets
    in neither variant within a block's ``optin`` bytes of shared memory
    (``ppo.kernel_fit``; ``rollout=False``: a host actor's learner, no
    K1), naming the first such kernel and its widths."""
    for k in ppo.kernel_fit(cfg, optin, env, rollout):
        if k.variant is None:
            raise NotImplementedError(
                f"{k.kernel} takes the nets {' and '.join(map(str, k.widths))}"
                f" in no variant: it needs {list(k.nbytes)} B of shared "
                f"memory (weights in shared memory, in global memory) and "
                f"one block holds at most {optin} B")


def resolve_device(device=None) -> torch.device:
    """``device=None`` means CUDA device 0; without CUDA that raises rather
    than run on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA device 0 by default, and CUDA is not "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def platform_device() -> torch.device:
    """The device ``PPOC_PLATFORM`` pins, for the CLI, serving and the
    examples (``examples_torch/``): "cpu" -> the CPU; unset, "cuda" or
    "gpu" -> CUDA device 0, which raises without CUDA rather than fall
    back to the CPU."""
    plat = os.environ.get("PPOC_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"PPOC_PLATFORM={plat!r}: the port runs on 'cpu' "
                         f"or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("the port runs on CUDA device 0, and CUDA is not "
                           "available; set PPOC_PLATFORM=cpu to run on the "
                           "CPU")
    return torch.device("cuda", 0)


def score(trainer, episodes: int = 100, deterministic: bool = True,
          max_rounds: int = 1000) -> Dict[str, float]:
    """Evaluation over at least ``episodes`` COMPLETED episodes: repeat
    ``trainer.evaluate`` rounds, weighting each round's mean J/R by its
    episode count (``ppoc_tpu/algo/trainer.py`` ``score``).  Returns {"J",
    "R", "episodes", "rounds"}."""
    tot_j = tot_r = tot_n = 0.0
    rounds = zero_rounds = 0
    while tot_n < episodes and rounds < max_rounds:
        m = trainer.evaluate(deterministic=deterministic)
        rounds += 1
        if m.episodes > 0:
            tot_j += m.J * m.episodes
            tot_r += m.R * m.episodes
            tot_n += m.episodes
        else:
            zero_rounds += 1
            # eval_len < horizon completes no episode, every round alike
            if zero_rounds >= 3 and tot_n == 0:
                break
    if tot_n == 0:
        raise RuntimeError(
            f"no episode completed in {rounds} evaluation rounds; is "
            f"eval_len >= the env horizon?")
    return {"J": tot_j / tot_n, "R": tot_r / tot_n,
            "episodes": int(tot_n), "rounds": rounds}


def restore(trainer, ck, path: str) -> None:
    """Put checkpoint ``ck`` (read from ``path``) into ``trainer`` (a
    Trainer or an ``envs/host.HostTrainer``): params and the three Adam
    states on its device, the file's shapes held to its own (an attention
    positional table may grow), and, from a file the port wrote, the
    generator's position."""
    from ppoc_tpu_torch.utils import checkpoint, params

    state = checkpoint.adapt_to_template(ck.state, trainer.state)
    checkpoint._check_template(state, trainer.state)
    trainer.state = params.train_state_from_numpy(state, trainer.device)
    if ck.generator is not None:
        trainer.generator.set_state(ck.generator)
    else:
        warnings.warn(
            f"{path} holds no torch generator state (the JAX package "
            f"writes its PRNG key words, which a torch.Generator cannot "
            f"continue): params and the three Adam states are restored, "
            f"the draw stream is not; this trainer keeps drawing from "
            f"its own generator (seed {trainer.cfg.seed})",
            checkpoint.DrawStreamWarning, stacklevel=4)


class Trainer:
    def __init__(self, cfg: PPOConfig, device=None):
        validate(cfg)
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.env = envs.make_for(cfg)
        # "pallas"/"auto", "bf16" or "jnp" (an attention trunk keeps it, a
        # GRU/LSTM trunk runs "jnp", as ppoc_tpu/algo/trainer.py:149-159
        # does); a mixture-of-experts config runs "moe:<topk>[:bf16]", the
        # JAX Trainer's rewrite (ppoc_tpu/algo/trainer.py:170-178, here
        # ppo.backend_of)
        self.backend = ppo.backend_of(cfg)
        if self.device.type == "cuda":
            check_kernel_fit(cfg, self.env, _build.smem_optin(self.device))
        self.generator = torch.Generator().manual_seed(cfg.seed)
        if cfg.eval_len < self.env.spec.horizon:
            warnings.warn(
                f"eval_len ({cfg.eval_len}) < env horizon "
                f"({self.env.spec.horizon}): evaluation counts only episodes "
                f"that COMPLETE within the window, so long episodes are "
                f"censored; set eval_len >= the horizon for unbiased R/J",
                EvalWindowWarning, stacklevel=2)
        self.state = ppo.init_train_state(cfg, self.env, self.generator,
                                          self.device)

    def evaluate(self, deterministic: bool = False) -> ppo.EvalMetrics:
        """Stochastic eval by default (one K1 launch);
        ``deterministic=True`` rolls out the policy mean, the mean-policy
        protocol, through the env loop.  A sequence trunk evaluates
        through its own loop (the attention decode, the GRU/LSTM cell)
        either way.  Returns Python floats."""
        draws = ppo.draw_eval(self.cfg, self.env, self.generator,
                              self.device, deterministic)
        m = ppo.evaluate(self.cfg, self.env, self.state.policy_params, draws,
                         deterministic=deterministic)
        return ppo.EvalMetrics(*(float(x) for x in m))

    def train_epoch(self) -> ppo.FitMetrics:
        self.state, metrics = ppo.train_epoch(self.cfg, self.env, self.state,
                                              self.generator)
        return metrics

    def train(self, n_epochs: Optional[int] = None, log: bool = True,
              stop_at_R: Optional[float] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              initial_eval: bool = True,
              eval_deterministic: bool = False,
              on_epoch_end=None,
              epoch_offset: int = 0) -> List[Dict[str, Any]]:
        """Full training run; returns per-epoch metric dicts.  ``stop_at_R``
        stops once the eval mean undiscounted return reaches it.
        ``eval_deterministic`` scores each epoch with the mean policy, and
        stop_at_R then gates on that R.

        ``checkpoint_path`` writes a checkpoint every ``checkpoint_every``
        epochs, right after the epoch's evaluation, with ``epochs_done``
        (``epoch_offset`` + epochs of this call) in its metadata; so
        ``Trainer.from_checkpoint(path).train(..., initial_eval=False)``
        replays the remaining epochs bit for bit (``initial_eval=False``
        skips the pre-training evaluation, whose draws the interrupted run
        already took).  ``on_epoch_end(i, row)`` is called after each
        epoch's metrics and checkpoint; a truthy return stops training (the
        CLI's preemption hook).  As ``ppoc_tpu/algo/trainer.py`` ``train``.

        With cfg.transplant_patience > 0 (a sequence trunk) an epoch whose
        R does not reach the best so far + 0.05 counts toward a plateau;
        after that many such epochs in a row :meth:`transplant_value_trunk`
        runs, once a run, and marks the epoch's row ``"transplanted":
        True`` (``ppoc_tpu/algo/trainer.py:879-931``).
        """
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        history: List[Dict[str, Any]] = []
        best_R, since_improve, transplanted = -float("inf"), 0, False
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
            row = {
                "epoch": i,
                "entropy": fit.entropy,
                "time_s": toc - tic,
                "J": ev.J,
                "R": ev.R,
                "episodes": int(ev.episodes),
                "value_loss": fit.value_loss,
                "policy_loss": fit.policy_loss,
                "mean_reward": fit.mean_reward,
            }
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
            if self.cfg.transplant_patience > 0 and not transplanted:
                if ev.R >= best_R + 0.05:
                    best_R, since_improve = ev.R, 0
                else:
                    since_improve += 1
                    if since_improve >= self.cfg.transplant_patience:
                        self.transplant_value_trunk()
                        transplanted = True
                        row["transplanted"] = True
                        if log:
                            print(f"Epoch: {i} plateau ({since_improve} "
                                  f"epochs < +0.05 R) — critic->policy "
                                  f"encoder transplant", flush=True)
            if on_epoch_end is not None and on_epoch_end(i, row):
                break
        return history

    def transplant_value_trunk(self) -> None:
        """Replace the policy trunk's encoder -- the attention encoder
        (``attn``) or the GRU/LSTM cell (``cell``) -- with a copy of the
        critic's, keeping the action head, the aux head and log_std, and
        start the policy net's Adam afresh over the new trunk (moments 0,
        t 0); the log_std Adam is kept (``ppoc_tpu/algo/trainer.py:
        933-966``).  The JAX package's measured rescue for a policy whose
        encoder cannot find the recall cue while the critic's has.  Raises
        ValueError on a dense trunk, which has no encoder to transplant."""
        from ppoc_tpu_torch.ops import adam

        ts = self.state
        old = ts.policy_params["mlp"]
        if not ppo.is_seq(old):
            raise ValueError(
                "transplant_value_trunk needs a sequence trunk (attention "
                "or GRU/LSTM): dense trunks have no shared encoder to "
                "transplant")
        part = "attn" if "attn" in old else "cell"
        trunk = dict(old)
        trunk[part] = adam.tree_map(torch.clone, ts.v_params[part])
        self.state = ts._replace(
            policy_params=dict(ts.policy_params, mlp=trunk),
            opt_policy=adam.init(trunk))

    def solve(self, target_R: float, max_epochs: int = 100) -> Dict[str, Any]:
        """Train until eval R >= target_R (or max_epochs); returns
        {"epochs": n, "R": R}.  Refuses a config that sets a relief valve,
        as the JAX package's ``solve`` does (``ppoc_tpu/algo/trainer.py:
        970-978``)."""
        if (self.cfg.fit_dispatch != "fused" or self.cfg.fits_per_program
                or self.cfg.rollout_chunk):
            raise ValueError(
                "solve() does not take the fit_dispatch/fits_per_program/"
                "rollout_chunk relief valves: the JAX package refuses them "
                "there, since its solve compiles the whole train-until loop "
                "as one program; use train(stop_at_R=...) with these "
                "settings")
        self.state, n, R = ppo.train_until(
            self.cfg, self.env, self.state, self.generator, target_R,
            max_epochs)
        return {"epochs": n, "R": R}

    def save(self, path: str, meta: Optional[Dict[str, Any]] = None) -> None:
        """Write the config, the TrainState and the generator's state
        (``utils/checkpoint.py``)."""
        from ppoc_tpu_torch.utils import checkpoint

        checkpoint.save(path, self.cfg, self.env.spec, self.state,
                        generator=self.generator, meta=meta)

    def load(self, path: str) -> None:
        """Restore params, the three Adam states and, from a file the port
        wrote, the generator's position; the file's shapes must match this
        trainer's (an attention positional table may grow)."""
        from ppoc_tpu_torch.utils import checkpoint

        self._restore(checkpoint.load(path), path)

    def _restore(self, ck, path: str) -> None:
        restore(self, ck, path)

    @classmethod
    def from_checkpoint(cls, path: str, device=None,
                        **overrides) -> "Trainer":
        """Rebuild a Trainer -- config, env, nets, the three Adam states
        and, from a file the port wrote, the generator's position -- from
        the checkpoint alone.  ``overrides`` replace config fields; the
        result is validated and refused where the port refuses it, as
        ``Trainer(cfg)`` does."""
        from ppoc_tpu_torch.utils import checkpoint

        ck = checkpoint.load(path)
        if ck.cfg is None:
            raise ValueError(
                f"{path}: version-2 checkpoint has no embedded config; "
                f"construct Trainer(cfg) with the original config and call "
                f".load(path) instead")
        cfg = ck.cfg.replace(**overrides) if overrides else ck.cfg
        tr = cls(cfg, device)
        tr._restore(ck, path)
        return tr

"""Host-environment bridge: train on any Gymnasium env (counterpart of
``ppoc_tpu/envs/gym_bridge.py``).

The reference embeds a Python interpreter in its C binary to step one
Gymnasium env a rollout step (src/gym_env.c, scripts/gym_env.py); here the
framework is Python, so the bridge runs the other way: a vectorised
Gymnasium actor on the host feeds the learner on the card
(``envs/host.HostTrainer``).  Env ids follow the reference's registry
(scripts/gym_env.py:11-17): id 0 is Pendulum-v1, id 1 BipedalWalker-v3;
any Gymnasium id string works.  ``gymnasium`` is imported when a bridge is
built, never when this module is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ppoc_tpu_torch.config import PPOConfig
from ppoc_tpu_torch.envs.core import EnvSpec

# the reference's env-id table (scripts/gym_env.py:11-17)
ENV_IDS = {0: "Pendulum-v1", 1: "BipedalWalker-v3"}


class _make_env_fn:
    """A picklable env factory (the async mode ships it to its worker
    processes)."""

    def __init__(self, env_id: str):
        self.env_id = env_id

    def __call__(self):
        import gymnasium

        return gymnasium.make(self.env_id)


def _gymnasium():
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            "the Gymnasium bridge needs the 'gymnasium' package; the "
            "PyTorch envs (ppoc_tpu_torch.envs.make) have no such "
            "dependency") from e
    return gymnasium


class GymVecEnv:
    """``n_envs`` Gymnasium instances with a per-env autoreset, stepped
    through ``gymnasium.vector`` (``vector_mode`` "sync": one process;
    "async": a worker process an env, for CPU-heavy physics such as
    Box2D).  ``step`` returns the true successor observation for the GAE
    bootstrap and the post-reset observation the policy acts on next (the
    SAME_STEP autoreset puts the final observation in
    ``info["final_obs"]``)."""

    def __init__(self, env_id, n_envs: int, seed: int = 0,
                 vector_mode: str = "sync"):
        gymnasium = _gymnasium()
        try:
            from gymnasium.vector import (AsyncVectorEnv, AutoresetMode,
                                          SyncVectorEnv)
        except ImportError as e:
            raise ImportError(
                f"the vectorized bridge needs gymnasium >= 1.1 "
                f"(AutoresetMode.SAME_STEP); installed version "
                f"{getattr(gymnasium, '__version__', '?')} lacks it — "
                f"upgrade with `pip install -U gymnasium`") from e

        if isinstance(env_id, int):
            env_id = ENV_IDS[env_id]
        self.name = env_id
        self.n_envs = n_envs
        self._seed = seed
        if vector_mode not in ("sync", "async"):
            raise ValueError(f"vector_mode must be 'sync' or 'async', got "
                             f"{vector_mode!r}")
        fns = [_make_env_fn(env_id) for _ in range(n_envs)]
        if vector_mode == "async":
            # workers start from a fresh interpreter: forking a process
            # that holds torch's threads is unsafe
            self.venv = AsyncVectorEnv(fns, context="spawn",
                                       autoreset_mode=AutoresetMode.SAME_STEP)
        else:
            self.venv = SyncVectorEnv(fns,
                                      autoreset_mode=AutoresetMode.SAME_STEP)
        obs_space = self.venv.single_observation_space
        act_space = self.venv.single_action_space
        discrete = hasattr(act_space, "n")
        horizon = gymnasium.spec(env_id).max_episode_steps or 1000
        if not discrete:
            # EnvSpec carries one scalar bound pair: refuse a Box whose
            # dimensions differ rather than mis-scale all but the first
            low = np.asarray(act_space.low, np.float32).reshape(-1)
            high = np.asarray(act_space.high, np.float32).reshape(-1)
            if not (np.all(low == low[0]) and np.all(high == high[0])):
                raise ValueError(
                    f"{env_id}: per-dimension action bounds differ "
                    f"(low={low.tolist()}, high={high.tolist()}); EnvSpec "
                    f"supports a single scalar bound pair — wrap the env "
                    f"with a RescaleAction transform first")
        self.spec = EnvSpec(
            name=f"gym:{env_id}",
            obs_dim=int(np.prod(obs_space.shape)),
            action_dim=(int(act_space.n) if discrete
                        else int(np.prod(act_space.shape))),
            horizon=int(horizon),
            gamma=0.99,   # the reference's fixed gamma (src/gym_env.c:102)
            discrete=discrete,
            action_low=(-1.0 if discrete
                        else float(getattr(act_space, "low", [-1.0])[0])),
            action_high=(1.0 if discrete
                         else float(getattr(act_space, "high", [1.0])[0])))
        self._episode = 0

    def reset(self) -> np.ndarray:
        self._episode += 1
        obs, _ = self.venv.reset(seed=self._seed + 1000 * self._episode)
        return np.asarray(obs, np.float32).reshape(self.n_envs, -1)

    def step(self, actions: np.ndarray):
        if self.spec.discrete:
            a = np.asarray(actions).reshape(self.n_envs, -1)[:, 0].astype(
                np.int64)
        else:
            a = np.asarray(actions, np.float32).reshape(
                self.n_envs, *self.venv.single_action_space.shape)
        obs, reward, term, trunc, info = self.venv.step(a)
        obs_after = np.asarray(obs, np.float32).reshape(self.n_envs, -1)
        next_obs = obs_after.copy()
        done = term | trunc
        if done.any():
            # the true (final) successor of a finished env, for the GAE
            # bootstrap; obs holds its fresh reset
            final = info.get("final_obs")
            for i in np.nonzero(done)[0]:
                next_obs[i] = np.asarray(final[i], np.float32).reshape(-1)
        return (obs_after, next_obs, np.asarray(reward, np.float32),
                np.asarray(term, bool), np.asarray(trunc, bool))

    def close(self):
        self.venv.close()


def collect_host(cfg, venv, policy_params, generator, length,
                 backend: Optional[str] = None):
    """A window from a Gymnasium venv with the device actor: the generic
    host-protocol collector, ``envs/host.collect_host``."""
    from ppoc_tpu_torch.envs.host import collect_host as _collect

    return _collect(cfg, venv, policy_params, generator, length, backend)


class GymTrainer:
    """``envs/host.HostTrainer`` over Gymnasium venvs (train and eval), with
    the reference's env-id table; ``obs_norm`` wraps both in one shared
    ``RunningObsNorm`` (the eval side reads it), ``reward_norm`` the
    training venv in ``RunningRewardNorm`` (evaluation reports raw
    rewards).  The config embedded in the checkpoint names the env trained
    (``gym:<id>``), which serving resolves its spec from."""

    def __new__(cls, cfg: PPOConfig, env_id, backend: Optional[str] = None,
                vector_mode: str = "sync", actor: str = "device",
                obs_norm: bool = False, obs_clip: float = 10.0,
                reward_norm: bool = False, overlap: bool = False,
                device=None):
        from ppoc_tpu_torch.envs.host import HostTrainer
        from ppoc_tpu_torch.envs.wrappers import (RunningObsNorm,
                                                  RunningRewardNorm)

        if cfg.env != f"gym:{env_id}":
            cfg = cfg.replace(env=f"gym:{env_id}")
        venv = GymVecEnv(env_id, cfg.n_envs, seed=cfg.seed,
                         vector_mode=vector_mode)
        eval_venv = GymVecEnv(env_id, cfg.eval_envs, seed=cfg.seed + 7777,
                              vector_mode=vector_mode)
        if obs_norm:
            venv = RunningObsNorm(venv, clip=obs_clip, update=True)
            eval_venv = RunningObsNorm(eval_venv, stats=venv.stats,
                                       clip=obs_clip, update=False)
        if reward_norm:
            venv = RunningRewardNorm(venv, gamma=venv.spec.gamma)
        return HostTrainer(cfg, venv, eval_venv, backend=backend, actor=actor,
                           overlap=overlap, device=device)

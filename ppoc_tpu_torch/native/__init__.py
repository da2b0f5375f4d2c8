"""The port's host env engine: ``ppoc_native.cpp`` built with g++ at
first use and bound with ctypes (counterpart of ``ppoc_tpu/native``).

The library lands in ``build/ppoc_tpu_torch/native/`` at the root of the
checkout, keyed by a hash of the source, the flags and the CPU that
``-march=native`` targets (a stamp file beside it), so a changed source,
or another machine, rebuilds and an unchanged one loads at once.  The
flags are the JAX package's (``-O3 -march=native``): the compiler's
instruction choice and its FMA contraction move float results, and the
port's engine is held to ``ppoc_tpu.native`` bit for bit.  A missing
compiler or a failed build raises with the compiler's output: nothing
falls back.  The engine stays out of ``csrc/``, whose sources nvcc takes.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "ppoc_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppoc_tpu_torch" \
    / "native"
LIB_NAME = "libppoc_native.so"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

ENV_IDS = {"simple": 0, "pendulum": 1, "cartpole": 2, "mountain_car": 3,
           "acrobot": 4, "reacher": 5, "recall": 6, "recall_long": 7,
           "recall_xl": 8, "recall_xxl": 9, "recall_4k": 10, "recall_8k": 11,
           "recall_16k": 12}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def source_hash() -> str:
    """The build's key: the source, the flags and what ``-march=native``
    means on this machine (g++'s resolved target options), so a library
    built for another CPU is never loaded."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    try:
        target = subprocess.run(["g++", "-march=native", "-Q",
                                 "--help=target"], capture_output=True,
                                text=True, timeout=60).stdout
    except OSError:
        target = ""        # no g++: build() raises with the reason
    h.update(target.encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its
    path.  Raises RuntimeError with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib
        tmp = BUILD_DIR / (LIB_NAME + f".tmp{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), "-lm"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build the host env "
                               f"engine ({' '.join(cmd)}): {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed (exit {proc.returncode}) building the host env "
                f"engine: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        stamp.write_text(digest)
    return lib


def load() -> ctypes.CDLL:
    """The engine's library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        for name in ("ppoc_env_state_dim", "ppoc_env_obs_dim",
                     "ppoc_env_action_dim", "ppoc_env_horizon"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.ppoc_env_reset.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_uint64, f32p, i32p, f32p]
        lib.ppoc_env_reset.restype = None
        lib.ppoc_env_step.argtypes = [ctypes.c_int, ctypes.c_int, f32p, i32p,
                                      f32p, f32p, f32p, u8p, u8p]
        lib.ppoc_env_step.restype = None
        _lib = lib
        return lib


class NativeVecEnv:
    """``n`` lockstep instances of an in-repo environment, stepped by the
    C++ engine (``ppoc_tpu/native/__init__.py:105-150``).  ``states`` [n,
    state_dim] float32 and ``steps`` [n] int32 are the engine's arrays,
    which callers may write (the host env's partial reset does)."""

    def __init__(self, name: str, n: int):
        if name not in ENV_IDS:
            raise KeyError(f"no native env '{name}'; have {sorted(ENV_IDS)}")
        self._lib = load()
        self.env_id = ENV_IDS[name]
        self.n = n
        self.state_dim = self._lib.ppoc_env_state_dim(self.env_id)
        self.obs_dim = self._lib.ppoc_env_obs_dim(self.env_id)
        self.action_dim = self._lib.ppoc_env_action_dim(self.env_id)
        self.horizon = self._lib.ppoc_env_horizon(self.env_id)
        self.states = np.zeros((n, self.state_dim), np.float32)
        self.steps = np.zeros((n,), np.int32)

    def reset(self, seed: int = 0) -> np.ndarray:
        obs = np.zeros((self.n, self.obs_dim), np.float32)
        self._lib.ppoc_env_reset(self.env_id, self.n, np.uint64(seed),
                                 self.states, self.steps, obs)
        return obs

    def set_state(self, states: np.ndarray,
                  steps: Optional[np.ndarray] = None) -> None:
        """Force the exact physics state (lockstep comparisons)."""
        self.states[:] = np.asarray(states, np.float32).reshape(
            self.n, self.state_dim)
        if steps is not None:
            self.steps[:] = np.asarray(steps, np.int32).reshape(self.n)

    def step(self, actions: np.ndarray):
        """(obs, reward, terminated, truncated) after one step of every
        instance; discrete actions are class ids passed as floats."""
        actions = np.ascontiguousarray(actions, np.float32).reshape(
            self.n, self.action_dim)
        obs = np.zeros((self.n, self.obs_dim), np.float32)
        reward = np.zeros((self.n,), np.float32)
        term = np.zeros((self.n,), np.uint8)
        trunc = np.zeros((self.n,), np.uint8)
        self._lib.ppoc_env_step(self.env_id, self.n, self.states, self.steps,
                                actions, obs, reward, term, trunc)
        return obs, reward, term.astype(bool), trunc.astype(bool)

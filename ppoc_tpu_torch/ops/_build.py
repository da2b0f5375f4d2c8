"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by nvcc, on first use, into one shared
library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/ppoc_tpu_torch/libppoc_kernels.so csrc/*.cu

No ``--use_fast_math``: the parity checks compare the kernels' logf, cosf,
sinf, expf and sqrtf with PyTorch's.  The library lands in ``build/`` at the
root of the checkout, keyed by a hash of the sources and flags (a stamp file
beside it), so a changed source rebuilds and an unchanged one loads at once.
The compiler's resource report (registers, spills, shared memory per
kernel) is kept in ``nvcc.log`` beside the library.  A missing nvcc or a
failed build raises: nothing falls back to the CPU or to a plain version.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppoc_tpu_torch"
LIB_NAME = "libppoc_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit PyTorch found."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME and (
            Path(cpp_extension.CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(cpp_extension.CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use")


def build() -> Dict[str, object]:
    """Compile the library unless an up-to-date one exists.  Returns
    {"path", "built", "seconds"}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    t0 = time.perf_counter()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one builder per checkout
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            return {"path": str(lib), "built": False,
                    "seconds": time.perf_counter() - t0}
        tmp = BUILD_DIR / (LIB_NAME + f".tmp{os.getpid()}")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "nvcc.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
        stamp.write_text(digest)
    return {"path": str(lib), "built": True,
            "seconds": time.perf_counter() - t0}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(build()["path"])
    lib.ppoc_error_string.argtypes = [ctypes.c_int]
    lib.ppoc_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{what} failed: {lib.ppoc_error_string(code).decode()} "
            f"(cudaError {code})")


# --- what the kernel wrappers share -------------------------------------

ACTIVATIONS = {"relu": 0, "tanh": 1, "none": 2}   # csrc/common.cuh Activation


class LaunchCount:
    """How many times a wrapper launched its kernel: a plain int that the
    wrapper bumps right after a successful launch, and nowhere else."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def ptr(t) -> Optional[int]:
    """Device address of a tensor for a c_void_p field (None -> null)."""
    return None if t is None else t.data_ptr()


def require(t, name: str, shape=None, dtype=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    (float32 by default), shape and device."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def stream_of(device) -> int:
    """The current PyTorch stream of ``device`` as a c_void_p value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def smem_optin(device) -> int:
    """Dynamic shared memory one block may opt in to on ``device``."""
    import torch

    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))

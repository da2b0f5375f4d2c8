"""ppoc_tpu_torch: the PyTorch/CUDA port of ppoc_tpu.

The JAX package ``ppoc_tpu`` stays the reference; this package mirrors its
module layout so each counterpart is easy to find.  Plain tensor code is
PyTorch, and every Pallas kernel on the ported path is a CUDA C++ kernel
for Hopper (``csrc/``), built with nvcc on first use.  Each kernel keeps a
plain PyTorch version beside it, which tensors on the CPU run.

One :class:`PPOConfig` (re-exported from ``ppoc_tpu.config``, a plain
dataclass) drives both packages.  Importing this package never imports jax.
"""
from ppoc_tpu_torch.config import PPOConfig, reference_preset, tpu_preset

__all__ = ["PPOConfig", "reference_preset", "tpu_preset", "Trainer"]


def __getattr__(name):  # lazy: keep `import ppoc_tpu_torch` light
    if name == "Trainer":
        from ppoc_tpu_torch.algo.trainer import Trainer
        return Trainer
    raise AttributeError(f"module 'ppoc_tpu_torch' has no attribute {name!r}")

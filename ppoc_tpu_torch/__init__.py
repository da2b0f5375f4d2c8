"""ppoc_tpu_torch: the PyTorch/CUDA port of ppoc_tpu.

The JAX package ``ppoc_tpu`` stays the reference; this package mirrors its
module layout so each counterpart is easy to find.  Plain tensor code is
PyTorch, and every Pallas kernel on the ported path is a CUDA C++ kernel
for Hopper (``csrc/``), built with nvcc on first use.  Each kernel keeps a
plain PyTorch version beside it, which tensors on the CPU run.

:class:`PPOConfig` is the port's own copy of the JAX package's dataclass
(``config.py``), held to it by the tests.  Importing this package imports
neither jax nor any module of ``ppoc_tpu``.
"""
from ppoc_tpu_torch.config import (PPOConfig, reference_preset, tpu_preset,
                                   tuned_preset)

__all__ = ["PPOConfig", "reference_preset", "tpu_preset", "tuned_preset",
           "Trainer"]


def __getattr__(name):  # lazy: keep `import ppoc_tpu_torch` light
    if name == "Trainer":
        from ppoc_tpu_torch.algo.trainer import Trainer
        return Trainer
    raise AttributeError(f"module 'ppoc_tpu_torch' has no attribute {name!r}")

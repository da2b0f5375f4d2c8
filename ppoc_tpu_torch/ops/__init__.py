"""Device ops: the hand-written CUDA kernels, optimizer, GAE, losses.

Each CUDA kernel (``cuda_*.py`` + ``csrc/*.cu``) keeps a plain PyTorch
version in the same module, as each Pallas kernel of the JAX package keeps
a jnp twin.  A kernel wrapper picks by the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version.
"""


def resolve_backend(kernel_backend: str) -> str:
    """Map the config's kernel_backend to a concrete backend name.

    ``"pallas"`` and ``"auto"`` both select the JAX package's "pallas"
    backend: the hand-written CUDA kernels for CUDA tensors and their plain
    PyTorch versions for CPU tensors.  ``"bf16"`` is the JAX package's
    bf16 backend: K1 and K2 as under "pallas", the dense MLP's products
    on bf16 operands with float32 output, and on an attention trunk the
    bf16 variant of the flash kernel K7.  ``"jnp"`` runs no kernel: plain
    PyTorch products, the stochastic env-loop training rollout and the
    doubling-scan GAE with Welford moments.
    """
    if kernel_backend in ("pallas", "auto"):
        return "pallas"
    if kernel_backend in ("bf16", "jnp"):
        return kernel_backend
    raise ValueError(
        f"unknown kernel_backend {kernel_backend!r}; expected 'pallas', "
        f"'auto', 'bf16' or 'jnp'")

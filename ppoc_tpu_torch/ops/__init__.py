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
    bf16 variant of the flash kernel K7.  The ``"jnp"`` backend
    (stochastic env-loop training rollout, doubling-scan GAE with Welford)
    is not ported yet.
    """
    if kernel_backend in ("pallas", "auto"):
        return "pallas"
    if kernel_backend == "bf16":
        return "bf16"
    raise NotImplementedError(
        f"kernel_backend {kernel_backend!r} is not ported yet; the port "
        f"supports 'pallas', 'auto' and 'bf16'")

"""Models: the dense MLP and the Gaussian policy."""
from . import mlp, policy  # noqa: F401

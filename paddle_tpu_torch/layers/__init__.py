"""Layers DSL (parity: python/paddle/fluid/layers/): the layers the
Fluid-API Transformer LM uses."""

from . import io, nn, tensor
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = sorted(set(io.__all__) | set(nn.__all__) | set(tensor.__all__))

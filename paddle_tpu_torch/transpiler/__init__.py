"""Program transpilers of the PyTorch port: the inference transpiler and
the memory-optimization analysis."""

from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .memory_optimization_transpiler import (  # noqa: F401
    memory_optimize, release_memory)

__all__ = ["InferenceTranspiler", "memory_optimize", "release_memory"]

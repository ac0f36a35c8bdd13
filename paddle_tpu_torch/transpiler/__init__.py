"""Program transpilers of the PyTorch port: the inference transpiler."""

from .inference_transpiler import InferenceTranspiler  # noqa: F401

__all__ = ["InferenceTranspiler"]

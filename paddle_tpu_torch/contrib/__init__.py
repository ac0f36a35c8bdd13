"""Contrib toolkit of the PyTorch port: mixed precision."""

from . import mixed_precision  # noqa: F401

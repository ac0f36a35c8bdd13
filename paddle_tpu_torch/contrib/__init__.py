"""Contrib toolkit of the PyTorch port: mixed precision and the int8
weight store (``quantize.QuantizeTranspiler.convert_to_int8``)."""

from . import mixed_precision, quantize  # noqa: F401

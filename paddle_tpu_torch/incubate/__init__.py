"""Incubating APIs (parity: the JAX package's ``incubate/``): the
fleet."""

from . import fleet  # noqa: F401

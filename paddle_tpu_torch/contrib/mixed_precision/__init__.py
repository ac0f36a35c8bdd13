"""Mixed-precision training (bf16 compute, loss scaling)."""

from .decorator import (AutoMixedPrecisionLists,  # noqa: F401
                        OptimizerWithMixedPrecision, decorate)

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists"]

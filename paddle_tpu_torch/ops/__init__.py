"""Op kernels and hand-written kernels of the PyTorch port, each kernel
beside its plain PyTorch version. Importing this package registers the
graph ops (``registry``) and builds nothing: a CUDA kernel is compiled
at its first use on a CUDA device (``ops/_build.py``)."""

from . import (compat_ops, elementwise, math, nn_ops,  # noqa: F401
               optimizer_ops, quant_ops)

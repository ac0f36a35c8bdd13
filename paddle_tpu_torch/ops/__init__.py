"""Op kernels and hand-written kernels of the PyTorch port, each kernel
beside its plain PyTorch version. Importing this package registers the
graph ops (``registry``) and builds nothing: a CUDA kernel is compiled
at its first use on a CUDA device (``ops/_build.py``)."""

from . import (activations, compat_ops, controlflow, conv,  # noqa: F401
               elementwise, fused_tail_ops, loss_ops, math, metric_ops,
               misc_ops, nn_ops, optimizer_ops, quant_ops, reduce, rnn_ops,
               sequence_ops, tensor_ops)

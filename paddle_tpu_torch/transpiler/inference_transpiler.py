"""Inference transpiler (parity: the JAX package's
``transpiler/inference_transpiler.py``): fold conv2d + batch_norm into
the conv weights and drop dropout ops, through the registered passes
``conv_bn_fold`` and ``dropout_remove`` (``ir.py``).

The fold is done in numpy on host copies of the scope's tensors, in the
JAX package's order (factor = gamma / sqrt(var + eps), then W * factor,
then beta - mean * factor), so the folded weights and biases are bitwise
the JAX package's; they go back into the scope on the device the
weight was on.
"""

import numpy as np
import torch

from ..core.scope import global_scope

__all__ = ["InferenceTranspiler"]


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        from .. import ir

        scope = scope or global_scope()
        ir.apply_passes(program, ["conv_bn_fold", "dropout_remove"], scope)
        return program


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _fold_bn_weights(conv_op, bn_op, scope, conv_bias_name):
    """W' = W * gamma/std per output channel. The per-channel shift
    beta - mean*gamma/std merges into the conv bias when there is one
    (`conv_bias_name`, which is rescaled too), else it becomes a new
    FoldedBias input the conv op adds to its output. False, with nothing
    changed, when a value is not in the scope."""
    w_name = conv_op.input_names("Filter")[0]
    names = [w_name] + [bn_op.input_names(s)[0]
                        for s in ("Scale", "Bias", "Mean", "Variance")]
    vals = [scope.get(n) for n in names]
    if any(v is None for v in vals):
        return False  # params not materialized yet (startup not run)
    b = None
    if conv_bias_name is not None:
        b = scope.get(conv_bias_name)
        if b is None:
            return False  # checked before any weight changes
    device = vals[0].device if isinstance(vals[0], torch.Tensor) else "cpu"
    w, gamma, beta, mean, var = [_host(v) for v in vals]
    eps = bn_op.attrs.get("epsilon", 1e-5)
    factor = gamma / np.sqrt(var + eps)
    scope.set(w_name, torch.from_numpy(
        w * factor.reshape((-1, 1, 1, 1)).astype(w.dtype)).to(device))
    shift = (beta - mean * factor).astype(w.dtype)
    if conv_bias_name is not None:
        scope.set(conv_bias_name, torch.from_numpy(
            _host(b) * factor.astype(w.dtype) + shift).to(device))
    else:
        block = conv_op.block
        bias_name = w_name + ".bn_folded_bias"
        bvar = block.create_var(name=bias_name, shape=(shift.shape[0],),
                                dtype=str(shift.dtype), persistable=True)
        scope.set(bias_name, torch.from_numpy(shift).to(device))
        conv_op.inputs["FoldedBias"] = [bvar]
    return True

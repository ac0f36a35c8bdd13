"""Broadcast elementwise ops with Fluid's `axis` convention (parity: the
JAX package's ``ops/elementwise.py``), the exact-erf gelu (its
``ops/activations.py:39``) and the reductions (its ``ops/reduce.py``)."""

import torch
import torch.nn.functional as F

from .registry import broadcast_to_axis, register


def _binary(name, fn):
    def impl(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        y = broadcast_to_axis(y, x.ndim, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}

    register(name)(impl)


_binary("elementwise_add", torch.add)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)


@register("gelu")
def _gelu(ctx, ins, attrs):
    return {"Out": [F.gelu(ins["X"][0])]}


def _reduce(name, fn):
    def impl(ctx, ins, attrs):
        x = ins["X"][0]
        keep_dim = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x.reshape(-1), 0)
            out = out.reshape((1,) * x.ndim if keep_dim else (1,))
        else:
            dim = attrs.get("dim", [0])
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            out = x
            for d in sorted((d % x.ndim for d in dims), reverse=True):
                out = fn(out, d, keepdim=keep_dim)
        # jnp keeps an integer input's dtype; torch widens it to int64
        return {"Out": [out.to(x.dtype)]}

    register(name)(impl)


_reduce("reduce_sum", torch.sum)
_reduce("reduce_prod", torch.prod)

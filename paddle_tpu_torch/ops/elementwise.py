"""Broadcast elementwise, compare and logical ops with Fluid's `axis`
convention (parity: the JAX package's ``ops/elementwise.py``) and the
reductions (its ``ops/reduce.py``: reduce_sum, reduce_mean, reduce_max,
reduce_min, reduce_prod and mean).

Mixed dtypes promote as jnp promotes them, by torch.promote_types of
the two operands' dtypes: torch's own rule would let a 0-d operand of
another float dtype keep the other's (a bf16 grad divided by an fp32
scalar stays bf16 in torch, and is fp32 in jnp).
"""

import torch

from .registry import broadcast_to_axis, register


def promote(x, y):
    """x and y in their jnp result dtype."""
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return x, y


def _binary(name, fn, differentiable=True, promoted=True):
    def impl(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        y = broadcast_to_axis(y, x.ndim, attrs.get("axis", -1))
        if promoted:
            x, y = promote(x, y)
        return {"Out": [fn(x, y)]}

    register(name, differentiable=differentiable)(impl)


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_pow", torch.pow)
_binary("elementwise_mod", torch.remainder, differentiable=False)
_binary("elementwise_floordiv", torch.floor_divide, differentiable=False)

_binary("equal", torch.eq, differentiable=False)
_binary("not_equal", torch.ne, differentiable=False)
_binary("less_than", torch.lt, differentiable=False)
_binary("less_equal", torch.le, differentiable=False)
_binary("greater_than", torch.gt, differentiable=False)
_binary("greater_equal", torch.ge, differentiable=False)


def _logical(name, fn, unary=False):
    def impl(ctx, ins, attrs):
        x = ins["X"][0]
        return {"Out": [fn(x) if unary else fn(x, ins["Y"][0])]}

    register(name, differentiable=False)(impl)


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, unary=True)


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


def _reduce_over(name, fn):
    """A reduction over all its dims at once (jnp's one pass), not dim
    after dim."""
    def impl(ctx, ins, attrs):
        x = ins["X"][0]
        keep_dim = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x.reshape(-1), dim=0)
            return {"Out": [out.reshape((1,) * x.ndim if keep_dim
                                        else (1,))]}
        dim = attrs.get("dim", [0])
        dims = tuple(d % x.ndim for d in (
            dim if isinstance(dim, (list, tuple)) else [dim]))
        return {"Out": [fn(x, dim=dims, keepdim=keep_dim)]}

    register(name)(impl)


_reduce_over("reduce_mean", torch.mean)
_reduce_over("reduce_max", torch.amax)
_reduce_over("reduce_min", torch.amin)


@register("mean")
def _mean(ctx, ins, attrs):
    """The mean of all elements, shape [1] (Fluid's mean_op)."""
    return {"Out": [torch.mean(ins["X"][0]).reshape((1,))]}

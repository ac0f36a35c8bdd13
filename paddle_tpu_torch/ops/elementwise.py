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

from .dp import refuse
from .registry import (DpRule, TpRule, broadcast_to_axis, dp_rule, get,
                       register, tp_rule)
from .tp import binary_plan, pointwise_plan


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


# ---------------------------------------------------------------------------
# data parallelism (registry.DpRule)
# ---------------------------------------------------------------------------


def _binary_plan(op, sharded, block):
    """Row-local when X is batch-sharded and Y is either batch-sharded
    and aligned with X's batch axis, or replicated and broadcast along
    it (its aligned dims leave X's axis 0 alone, or have size 1 there)."""
    xs, ys = sharded["X"][0], sharded["Y"][0]
    if ys and not xs:
        refuse(op, "Y is batch-sharded and X is replicated")
    x, y = op.inputs["X"][0], op.inputs["Y"][0]
    if x.shape is not None and y.shape is not None:
        axis = op.attrs.get("axis", -1)
        start = len(x.shape) - len(y.shape) if axis in (-1, None) else axis
        covers = start == 0 and len(y.shape) > 0
        if ys and not covers:
            refuse(op, "the batch-sharded Y is not aligned with X's "
                    "batch axis")
        if not ys and covers and y.shape[0] != 1:
            refuse(op, "the replicated Y %r spans X's batch axis"
                    % y.name)
    return {"Out": [True]}


_BINARY = ("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
           "equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor")


def _acc_dtype(dtype):
    """The dtype partial sums are carried in: fp32 for the low-precision
    floats, the input's own otherwise."""
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


def _reduced_dims(attrs, ndim):
    if attrs.get("reduce_all", False):
        return tuple(range(ndim))
    dim = attrs.get("dim", [0])
    return tuple(sorted(d % ndim for d in (
        dim if isinstance(dim, (list, tuple)) else [dim])))


def _batch_reduced(op, block):
    x = op.inputs["X"][0]
    if op.type == "mean":
        return True
    nd = len(x.shape) if x.shape is not None else 1
    return 0 in _reduced_dims(op.attrs, nd)


def _reduce_plan(op, sharded, block):
    return {"Out": [not _batch_reduced(op, block)]}


def _reduce_collectives(op, block, sharded, wanted, tp=(1, {})):
    """One all-reduce of the partial result, kept-dims shaped; a max or
    min whose X grad is wanted adds one of its tie counts in backward (a
    product's backward all-gathers, which is not an all-reduce)."""
    from ..framework import torch_dtype

    if not _batch_reduced(op, block):
        return 0, 0
    x = op.inputs["X"][0]
    dims = () if op.type == "mean" else _reduced_dims(op.attrs,
                                                      len(x.shape))
    n = 1
    size, marks = tp
    if op.type != "mean" and len(dims) < len(x.shape):
        for i, s in enumerate(x.shape):
            if i not in dims:
                n *= int(s) // (size if (marks.get("X") or [None])[0] == i
                                else 1)
    acc = _acc_dtype(torch_dtype(x.dtype))
    calls = 1
    if op.type in ("reduce_max", "reduce_min") \
            and (wanted.get("X") or [None])[0] is not None:
        calls = 2
    return calls, calls * n * torch.empty((), dtype=acc).element_size()


def _dp_reduce(kind, local):
    """A batch reduction: partial results over the local rows, one
    all-reduce over the data group, then the global value (a mean
    divides by the global count). A reduction that leaves the batch
    axis alone is row-local: the op's own kernel."""
    def impl(ctx, ins, attrs, sharded):
        from ..parallel.collective import reduce_chooser, reduce_replicated

        x = ins["X"][0]
        if kind == "mean_op":
            dims, keep_dim, reduce_all = tuple(range(x.ndim)), False, True
        else:
            dims = _reduced_dims(attrs, x.ndim)
            keep_dim = attrs.get("keep_dim", False)
            reduce_all = attrs.get("reduce_all", False)
            if 0 not in dims:
                return local(ctx, ins, attrs)
        acc = _acc_dtype(x.dtype)
        if kind in ("sum", "mean", "mean_op"):
            out = reduce_replicated(
                torch.sum(x, dim=dims, keepdim=True, dtype=acc), ctx.dp)
        elif kind == "prod":
            part = x.to(acc)
            for d in dims:
                part = torch.prod(part, d, keepdim=True).to(acc)
            out = reduce_replicated(part, ctx.dp, "prod")
        else:
            out = reduce_chooser(x, dims, acc, ctx.dp, kind)
        if kind in ("mean", "mean_op"):
            count = ctx.dp.world
            for d in dims:
                count *= x.shape[d]
            out = out / count
        if kind == "mean_op" or reduce_all:
            out = out.reshape((1,) * x.ndim if keep_dim else (1,))
        elif not keep_dim:
            out = out.reshape([s for i, s in enumerate(out.shape)
                               if i not in dims])
        return {"Out": [out.to(x.dtype)]}

    return impl


def _declare_dp():
    dp_rule(_BINARY, DpRule(plan=_binary_plan))
    dp_rule("logical_not")
    for name, kind in (("reduce_sum", "sum"), ("reduce_mean", "mean"),
                       ("reduce_prod", "prod"), ("reduce_max", "max"),
                       ("reduce_min", "min"), ("mean", "mean_op")):
        dp_rule(name, DpRule(plan=_reduce_plan,
                             impl=_dp_reduce(kind, get(name).impl),
                             collectives=_reduce_collectives))


_declare_dp()


# ---------------------------------------------------------------------------
# tensor parallelism (registry.TpRule)
# ---------------------------------------------------------------------------


def _reduce_tp_plan(top):
    """A sum or mean over the tp-sharded dim: the rank's part (over the
    batch too, under data parallelism), then a sum over the tp line (a
    mean's parts divided by the line's size: equal blocks). A reduction
    that leaves the sharded dim keeps its mark (shifted past the dims it
    drops)."""
    x = top.var("X")
    d = top.mark("X")
    if x.shape is None:
        return False
    nd = len(x.shape)
    dims = tuple(range(nd)) if top.op.type == "mean" \
        else _reduced_dims(top.op.attrs, nd)
    if d in dims:
        top.row = True
        top.reduce("Out")
        return True
    keep = top.op.attrs.get("keep_dim", False)
    top.outs["Out"] = [d if keep else d - sum(1 for i in dims if i < d)]
    return True


def _reduce_tp_impl(ctx, ins, attrs, inner, top):
    from ..parallel.collective import reduce_tp

    outs = inner(ctx, ins, attrs)
    if top.row:
        out = reduce_tp(outs["Out"][0], ctx.tp)
        if top.op.type != "reduce_sum":
            out = out / ctx.tp.world
        outs["Out"] = [out]
    return outs


def _declare_tp():
    tp_rule(_BINARY, TpRule(plan=binary_plan))
    tp_rule("logical_not", TpRule(plan=pointwise_plan()))
    tp_rule(["reduce_sum", "reduce_mean", "mean"],
            TpRule(plan=_reduce_tp_plan, impl=_reduce_tp_impl))


_declare_tp()

"""Core math and tensor-creation ops (parity: the JAX package's
``ops/math.py`` fill_constant :21, fill_any_like :48, uniform_random :60,
gaussian_random, shape :110, mul :223, scale :238, sum :245, cast :254)."""

import numpy as np
import torch

from ..framework import torch_dtype
from .registry import register, simple_op


@register("fill_constant", differentiable=False)
def _fill_constant(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register("fill_any_like", differentiable=False)
def _fill_any_like(ctx, ins, attrs):
    return {"Out": [torch.full_like(ins["X"][0], attrs.get("value", 0.0))]}


@register("uniform_random", differentiable=False, stateful=True)
def _uniform_random(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator(attrs))
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register("gaussian_random", differentiable=False, stateful=True)
def _gaussian_random(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator(attrs))
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@simple_op("shape", differentiable=False)
def _shape(ctx, x, **_):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


def _amp_dot(x, y, attrs):
    """AMP white-list product: fp32 (or mixed) operands are cast to bf16
    and multiplied in bf16 (fp32 accumulation), bf16 out — the JAX op's
    semantics. A plain product otherwise (mixed dtypes promote, as in
    jnp)."""
    floats = (torch.float32, torch.bfloat16)
    if (attrs.get("__amp_bf16__") and torch.float32 in (x.dtype, y.dtype)
            and x.dtype in floats and y.dtype in floats):
        return torch.matmul(x.to(torch.bfloat16), y.to(torch.bfloat16))
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.matmul(x, y)


@register("mul")
def _mul(ctx, ins, attrs):
    """Fluid `mul`: flatten x to 2-D at x_num_col_dims, y at
    y_num_col_dims, then one matrix product."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xn])), int(np.prod(xs[xn:])))
    y2 = y.reshape(int(np.prod(ys[:yn])), int(np.prod(ys[yn:])))
    return {"Out": [_amp_dot(x2, y2, attrs).reshape(xs[:xn] + ys[yn:])]}


@simple_op("scale")
def _scale(ctx, x, scale=1.0, bias=0.0, bias_after_scale=True, **_):
    # adding a zero bias changes no value: skip that pass
    if bias_after_scale:
        out = x * scale
        return out + bias if bias else out
    return (x + bias if bias else x) * scale


@register("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@simple_op("cast")
def _cast(ctx, x, out_dtype="float32", **_):
    return x.to(torch_dtype(out_dtype))

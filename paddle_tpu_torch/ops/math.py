"""Core math and tensor-creation ops (parity: the JAX package's
``ops/math.py`` fill_constant :21, fill_any_like :48, uniform_random :60,
gaussian_random, shape :110, fused_int8_matmul :193, mul :223, scale
:238, sum :245, cast :254)."""

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


def _int8_dot(x, y):
    """quant_rewrite-marked product of int8 operands, exact in int32 (the
    JAX op's ``preferred_element_type=int32``): an int32 product on the
    CPU; on a card, where there is none, a float64 one, exact while
    |acc| < 2^53. The per-channel dequantize is a separate
    `dequantize_linear` op."""
    if x.device.type == "cpu":
        return x.to(torch.int32) @ y.to(torch.int32)
    return (x.to(torch.float64) @ y.to(torch.float64)).to(torch.int32)


def _quant_int8(x, y, attrs):
    return (attrs.get("__quant_int8__") and not x.is_floating_point()
            and not y.is_floating_point())


def _flatten2(t, n):
    """`t` as the 2-D matrix Fluid's mul sees: dims before n are rows."""
    s = tuple(t.shape)
    return t.reshape(int(np.prod(s[:n])), int(np.prod(s[n:])))


@register("mul")
def _mul(ctx, ins, attrs):
    """Fluid `mul`: flatten x to 2-D at x_num_col_dims, y at
    y_num_col_dims, then one matrix product."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2, y2 = _flatten2(x, xn), _flatten2(y, yn)
    out = _int8_dot(x2, y2) if _quant_int8(x2, y2, attrs) \
        else _amp_dot(x2, y2, attrs)
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register("fused_int8_matmul", differentiable=False)
def _fused_int8_matmul(ctx, ins, attrs):
    """quant_rewrite's fused full-int8 dense layer (one op instead of the
    quantize -> int8 mul -> dequantize_linear chain): X fp32 activation,
    Y [K, N] int8 weight, Scale [N] combined per-output-channel
    dequantize vector, attr `act_scale` the activation quantize scale.
    Runs the kernel K4 (``ops/int8_matmul.py``); with x_num_col_dims set
    it has mul's semantics: the leading dims of X are the rows, handed to
    the kernel as a view (strided rows, as the lm_head's sliced input
    is), and Y is flattened at y_num_col_dims."""
    from .int8_matmul import int8_matmul

    x, y = ins["X"][0], ins["Y"][0]
    dq = ins["Scale"][0]
    act_scale = float(attrs["act_scale"])
    xn = attrs.get("x_num_col_dims")
    if xn is None:  # plain 2-D matmul
        return {"Out": [int8_matmul(x, y, dq, act_scale)]}
    yn = int(attrs.get("y_num_col_dims", 1))
    x2 = x if x.dim() == xn + 1 else _flatten2(x, xn)
    out = int8_matmul(x2, _flatten2(y, yn), dq, act_scale)
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


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

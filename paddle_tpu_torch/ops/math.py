"""Core math and tensor-creation ops (parity: the JAX package's
``ops/math.py`` fill_constant :21, fill_zeros_like :43, fill_any_like
:48, uniform_random :60, gaussian_random, assign_value :99, shape :110,
fused_int8_matmul :193, assign :91, matmul :175, mul :223, scale :238,
sum :245, cast :254, sign :259, clip :264, clip_by_norm :269,
squared_l2_norm :295)."""

import numpy as np
import torch

from ..framework import torch_dtype
from .dp import refuse, replicated_slots
from .registry import (DataParallelError, DpRule, TpRule, dp_rule, register,
                       simple_op, tp_rule, weak_scalar)
from .tp import pointwise_plan


@register("fill_constant", differentiable=False)
def _fill_constant(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register("fill_any_like", differentiable=False)
def _fill_any_like(ctx, ins, attrs):
    val = attrs.get("value", 0.0)
    if attrs.get("__loss_seed__"):
        # the backward seed: BuildStrategy.GradientScaleStrategy.One
        # scales it by the number of replicas (compiler.grad_seed_scale_of)
        val = val * getattr(ctx, "grad_seed_scale", 1.0)
    return {"Out": [torch.full_like(ins["X"][0], val)]}


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


@register("assign")
def _assign(ctx, ins, attrs):
    if ins.get("X"):
        return {"Out": [ins["X"][0]]}
    v = np.asarray(attrs["value"], dtype=attrs.get("dtype", "float32"))
    return {"Out": [torch.from_numpy(v).to(ctx.device)]}


@register("assign_value", differentiable=False)
def _assign_value(ctx, ins, attrs):
    """A constant held in the op's attrs (constant_fold's inline form):
    `values` a numpy array (bf16 values held as fp32), made on the
    device in `dtype` and `shape`."""
    vals = torch.from_numpy(np.array(attrs["values"]))
    return {"Out": [vals.to(ctx.device, torch_dtype(
        attrs.get("dtype", "float32"))).reshape(attrs["shape"])]}


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


@register("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    if _quant_int8(x, y, attrs):
        return {"Out": [_int8_dot(x, y)]}
    out = _amp_dot(x, y, attrs)
    alpha = attrs.get("alpha", 1.0)
    return {"Out": [out * alpha if alpha != 1.0 else out]}


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
    scale = weak_scalar(x, scale)
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


@simple_op("sign")
def _sign(ctx, x, **_):
    return torch.sign(x)


@simple_op("clip")
def _clip(ctx, x, min=None, max=None, **_):
    return torch.clamp(x, min, max)


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """x scaled to an L2 norm of at most max_norm: the norm in fp32, the
    scale rounded to x's dtype before the product (the JAX op's order)."""
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x.float() ** 2))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


@simple_op("squared_l2_norm")
def _squared_l2_norm(ctx, x, **_):
    return torch.sum(x * x).reshape((1,))


@register("fill_zeros_like", differentiable=False)
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


# ---------------------------------------------------------------------------
# data parallelism (registry.DpRule)
# ---------------------------------------------------------------------------


def _dp_shape(ctx, ins, attrs, sharded):
    """The global shape: the leading dim times the world size (a loss
    that divides by the token count divides by the global count)."""
    x = ins["Input"][0] if "Input" in ins else ins["X"][0]
    shape = (x.shape[0] * ctx.dp.world,) + tuple(x.shape[1:])
    return {"Out": [torch.tensor(shape, dtype=torch.int32,
                                 device=x.device)]}


def _replicated_out(op, sharded, block):
    return {slot: [False] * len(vs) for slot, vs in op.outputs.items()}


def _mul_plan(op, sharded, block):
    replicated_slots("Y")(op, sharded, block)
    return {"Out": [True]}


def _matmul_plan(op, sharded, block):
    """Row-local when X is batch-sharded and the product keeps its
    leading axis: X of rank 2 not transposed against a replicated Y, or
    a batched product (rank >= 3) against a batch-sharded Y of the same
    rank or a replicated Y broadcast over the batch."""
    x, y = op.inputs["X"][0], op.inputs["Y"][0]
    xs, ys = sharded["X"][0], sharded["Y"][0]
    if not xs:
        refuse(op, "Y is batch-sharded and X is replicated")
    xnd = len(x.shape) if x.shape is not None else None
    ynd = len(y.shape) if y.shape is not None else None
    if xnd == 2 and op.attrs.get("transpose_X", False):
        refuse(op, "transpose_X contracts the batch axis")
    if ys and (xnd is None or xnd < 3 or ynd != xnd):
        refuse(op, "a batch-sharded Y must be a batched operand of X's "
                "rank")
    if not ys and ynd is not None and ynd >= 3 and y.shape[0] != 1:
        refuse(op, "the replicated Y %r spans the batch axis" % y.name)
    return {"Out": [True]}


def _sum_plan(op, sharded, block):
    if not all(sharded["X"]):
        refuse(op, "it adds batch-sharded and replicated inputs")
    return {"Out": [True]}


def _declare_dp():
    dp_rule("shape", DpRule(plan=_replicated_out, impl=_dp_shape))
    dp_rule("mul", DpRule(plan=_mul_plan))
    dp_rule("matmul", DpRule(plan=_matmul_plan))
    dp_rule("fused_int8_matmul", DpRule(plan=_mul_plan))
    dp_rule("sum", DpRule(plan=_sum_plan))
    dp_rule(["scale", "cast", "sign", "clip", "assign", "fill_any_like",
             "fill_zeros_like"])


_declare_dp()


# ---------------------------------------------------------------------------
# tensor parallelism (registry.TpRule)
# ---------------------------------------------------------------------------


def _dense_plan(top, xk, yk, yo, out_nd):
    """A product contracting X's dim `xk` with Y's `yk` (Y's other dim
    `yo` gives the output's last): column-parallel (Y sharded on `yo`,
    X replicated and entering; the output's last dim sharded) or
    row-parallel (Y sharded on `yk`, X sharded on `xk` or narrowed to
    it; the partial products summed over the tp line)."""
    mx, my = top.mark("X"), top.mark("Y")
    if my == yo and mx is None:
        top.enter("X")
        top.outs["Out"] = [out_nd - 1]
        return True
    if my == yk and mx in (None, xk):
        if mx is None:
            top.enter("X", 0, xk)
        top.row = True
        top.reduce("Out")
        return True
    return False


def _mul_tp_plan(top):
    x, y = top.var("X"), top.var("Y")
    attrs = top.op.attrs
    xn = attrs.get("x_num_col_dims", 1)
    if x.shape is None or y.shape is None or len(y.shape) != 2 \
            or attrs.get("y_num_col_dims", 1) != 1 \
            or xn != len(x.shape) - 1:
        return False
    return _dense_plan(top, xn, 0, 1, xn + 1)


def _matmul_tp_plan(top):
    x, y = top.var("X"), top.var("Y")
    attrs = top.op.attrs
    if x.shape is None or y.shape is None or len(y.shape) != 2 \
            or len(x.shape) < 2 or attrs.get("transpose_X", False):
        return False
    ty = bool(attrs.get("transpose_Y", False))
    return _dense_plan(top, len(x.shape) - 1, 1 if ty else 0,
                       0 if ty else 1, len(x.shape))


def _reduced_impl(ctx, ins, attrs, inner, top):
    """The kernel, then a row-parallel product's sum over the tp line."""
    from ..parallel.collective import reduce_tp

    outs = inner(ctx, ins, attrs)
    if getattr(top, "row", False):
        outs["Out"] = [reduce_tp(outs["Out"][0], ctx.tp)]
    return outs


def _int8_tp_plan(top):
    raise DataParallelError(
        "op 'fused_int8_matmul' reads the tp-sharded var %r: the int8 "
        "kernel (K4) runs on replicated operands only; run the int8 "
        "program without tensor_parallel_degree" % next(
            top.var(s, i).name for s, ms in top.marks.items()
            for i, m in enumerate(ms) if m is not None))


def _sum_norm_plan(top):
    """The sum of squares of a sharded tensor: each rank's part, summed
    over the tp line."""
    top.row = True
    top.reduce("Out")
    return True


def _declare_tp():
    tp_rule("mul", TpRule(plan=_mul_tp_plan, impl=_reduced_impl))
    tp_rule("matmul", TpRule(plan=_matmul_tp_plan, impl=_reduced_impl))
    tp_rule("fused_int8_matmul", TpRule(plan=_int8_tp_plan))
    tp_rule("squared_l2_norm", TpRule(plan=_sum_norm_plan,
                                      impl=_reduced_impl))
    tp_rule("sum", TpRule(plan=pointwise_plan()))
    tp_rule(["scale", "cast", "sign", "clip", "assign", "fill_any_like",
             "fill_zeros_like"], TpRule(plan=pointwise_plan()))


_declare_tp()

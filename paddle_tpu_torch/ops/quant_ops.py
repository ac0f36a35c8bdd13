"""Quantize / dequantize ops (parity: the JAX package's
``ops/quant_ops.py`` quantize :111, dequantize :119, dequantize_linear
:132) and the loss-scaling state machine `update_loss_scaling` (:177).
The first three serve ``quant_rewrite``'s weight-only rewrite and its
unfused quantize -> int32 mul -> dequantize_linear chain; the last the
AMP decorators' dynamic loss scaling (``check_finite_and_unscale`` is
in ``optimizer_ops.py``)."""

import numpy as np
import torch

from ..framework import torch_dtype
from .registry import register


def quantize_int8(x, scale):
    """The int8 grid of the quantize op: round-half-even(x * scale),
    clipped to [-128, 127]. The scale is rounded to fp32 once, so the
    product is one fp32 multiply, as in the JAX op (its Python-float
    scale is weakly typed)."""
    s = float(np.float32(scale))
    return torch.clamp(torch.round(x * s), -128, 127).to(torch.int8)


@register("quantize", differentiable=False)
def _quantize(ctx, ins, attrs):
    return {"Output": [quantize_int8(ins["Input"][0],
                                     attrs.get("Scale", 1.0))]}


@register("dequantize", differentiable=False)
def _dequantize(ctx, ins, attrs):
    x = ins["Input"][0]
    out = x.to(torch.float32) / attrs.get("Scale", 1.0)
    od = attrs.get("out_dtype")
    if od is not None:
        out = out.to(torch_dtype(od))
    return {"Output": [out]}


@register("dequantize_linear", differentiable=False)
def _dequantize_linear(ctx, ins, attrs):
    """Output = float(Input) * Scale, Scale already shaped to broadcast
    onto Input (per output column for mul/matmul weights and
    accumulators, (C_out, 1, ..) for conv)."""
    out = ins["Input"][0].to(torch.float32) * ins["Scale"][0]
    od = attrs.get("out_dtype")
    if od is not None and str(od) != "float32":
        out = out.to(torch_dtype(od))
    return {"Output": [out]}


@register("update_loss_scaling", differentiable=False)
def _update_loss_scaling(ctx, ins, attrs):
    """The dynamic loss-scaling state machine (the JAX op, quant_ops.py
    :177): after `incr_every_n_steps` finite steps in a row the scale
    grows by `incr_ratio`; after `decr_every_n_nan_or_inf` overflowed
    steps in a row it shrinks by `decr_ratio`, never below 1. Computed
    on the device with torch.where: no host sync."""
    scale = ins["PrevLossScaling"][0].reshape(())
    good = ins["InGoodSteps"][0].reshape(()).to(torch.int32)
    bad = ins["InBadSteps"][0].reshape(()).to(torch.int32)
    found_inf = ins["FoundInfinite"][0].reshape(()).to(torch.bool)
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)

    zero = torch.zeros_like(good)
    good_n = torch.where(found_inf, zero, good + 1)
    bad_n = torch.where(found_inf, bad + 1, zero)
    grow = ~found_inf & (good_n >= incr_every)
    shrink = found_inf & (bad_n >= decr_every)
    new_scale = torch.where(
        grow, scale * incr_ratio,
        torch.where(shrink, torch.clamp(scale * decr_ratio, min=1.0),
                    scale))
    good_n = torch.where(grow, zero, good_n)
    bad_n = torch.where(shrink, zero, bad_n)
    return {"LossScaling": [new_scale.reshape(1)],
            "OutGoodSteps": [good_n.reshape(1)],
            "OutBadSteps": [bad_n.reshape(1)]}

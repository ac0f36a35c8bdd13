"""Quantize / dequantize ops (parity: the JAX package's
``ops/quant_ops.py`` quantize :111, dequantize :119, dequantize_linear
:132). They serve ``quant_rewrite``'s weight-only rewrite and its
unfused quantize -> int32 mul -> dequantize_linear chain."""

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

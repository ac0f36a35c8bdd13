"""The fused conv op of the inference passes (parity: the JAX package's
``ops/fused_tail_ops.py`` `_conv2d_fusion` :38, the one op of that file
the port registers): conv2d, then Bias, then ResidualData, then the
activation, then an optional split of the channels. The convolution is
the port's conv2d op, so an fp32 one takes its GEMM route
(``ops/conv.py`` `_Conv2dFp32`)."""

import torch
import torch.nn.functional as F

from .dp import replicated_slots, row_rule
from .registry import dp_rule, get, register

_ACTS = {
    "identity": lambda x: x,
    "": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0, 6),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's
}


def _act(name):
    key = (name or "identity").strip().lower()
    if key not in _ACTS:
        raise ValueError(
            "fused op activation %r is not supported (choose from %s)"
            % (name, sorted(k for k in _ACTS if k)))
    return _ACTS[key]


@register("conv2d_fusion")
def _conv2d_fusion(ctx, ins, attrs):
    """conv + bias + (residual add) + activation [+ channel split]."""
    out = get("conv2d").impl(ctx, {"Input": ins["Input"],
                                   "Filter": ins["Filter"]},
                             attrs)["Output"][0]
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1, 1, 1).to(out.dtype)
    if ins.get("ResidualData"):
        out = out + ins["ResidualData"][0].to(out.dtype)
    out = _act(attrs.get("activation", "relu"))(out)
    split = [int(s) for s in attrs.get("split_channels", []) or []]
    if split:
        pieces, start = [], 0
        for n in split:
            pieces.append(out[:, start:start + n])
            start += n
        return {"Output": [out], "Outputs": pieces}
    return {"Output": [out]}


dp_rule("conv2d_fusion", row_rule(replicated_slots("Filter", "Bias")))

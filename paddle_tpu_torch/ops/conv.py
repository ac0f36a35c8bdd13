"""Convolution and pooling ops (parity: the JAX package's ``ops/conv.py``
`_conv_nd` :17-32 (the forward, non-transposed branch), `_amp_bf16_pair`
:60-70, `_make_conv` :73-97 for conv2d and depthwise_conv2d, `_pool_nd`
:108-135 and pool2d :138).

The JAX package computes these with ``lax.conv_general_dilated`` and
``lax.reduce_window``: no Pallas kernel lies on this path. A bf16 (AMP)
convolution calls cuDNN through ``torch.nn.functional``. An fp32
convolution is a GEMM over the unfolded input, forward and backward
(`_Conv2dFp32`), on both devices: fp32 products summed in fp32, as the
JAX reference computes them. cuDNN's own fp32 convolution is less exact:
at a ResNet-50 shape on an H100 its weight grad lies 6.9e-5 of the
tensor's largest off float64, this route's 1.2e-6 (PERF.md §6).
The 3-D, transposed, adaptive and interpolation ops of that file are not
ported yet.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .dp import replicated_slots, row_rule
from .registry import TpRule, dp_rule, register, tp_rule


@contextlib.contextmanager
def full_fp32(x):
    """cuBLAS without TF32 while an fp32 CUDA product runs (the switch is
    process-wide and is read when cuBLAS is called, so it is set around
    each call and put back, never at import)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _pointwise(w, stride, padding):
    return tuple(w.shape[2:]) == (1, 1) and list(stride) == [1, 1] and \
        list(padding) == [0, 0]


def _columns(x, w, stride, padding, dilation):
    """x unfolded to [N, C * kh * kw, L], L the output's positions: one
    copy of a strided view of the padded x (F.unfold launches a kernel a
    sample); a 1x1 convolution of stride 1 reads x as it lies."""
    n, c = x.shape[:2]
    kh, kw = w.shape[2:]
    if _pointwise(w, stride, padding):
        return x.reshape(n, c, -1)
    if any(padding):
        x = F.pad(x, _torch_pads(padding))
    win = x.unfold(2, dilation[0] * (kh - 1) + 1, stride[0]).unfold(
        3, dilation[1] * (kw - 1) + 1, stride[1])
    win = win[..., ::dilation[0], ::dilation[1]]   # [N, C, OH, OW, kh, kw]
    return win.permute(0, 1, 4, 5, 2, 3).reshape(n, c * kh * kw, -1)


class _Conv2dFp32(torch.autograd.Function):
    """An fp32 convolution as GEMMs over `_columns`: the output is
    W[g] @ cols[n, g]; the weight grad is the sum over the batch of
    dY[n, g] @ cols[n, g]^T, the input grad W[g]^T @ dY[n, g] folded back
    onto x (F.fold, a gather: no atomics). Without groups each is one
    batched GEMM whose W is broadcast over the batch (stride 0). The
    columns are made again in the backward rather than kept."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        n, o = x.shape[0], w.shape[0]
        oh, ow = (_out_dim(x.shape[2 + i], w.shape[2 + i], stride[i],
                           padding[i], dilation[i]) for i in range(2))
        with full_fp32(x):
            cols = _columns(x, w, stride, padding, dilation)
            if groups == 1:
                out = torch.bmm(w.reshape(1, o, -1).expand(n, -1, -1), cols)
            else:
                out = torch.einsum(
                    "goc,ngcl->ngol", w.reshape(groups, o // groups, -1),
                    cols.reshape(n, groups, -1, cols.shape[-1]))
        return out.reshape(n, o, oh, ow)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        n, o = g.shape[:2]
        wm = w.reshape(groups, o // groups, -1)
        gx = gw = None
        with full_fp32(x):
            if ctx.needs_input_grad[1]:
                cols = _columns(x, w, stride, padding, dilation)
                if groups == 1:
                    gw = torch.bmm(g.reshape(n, o, -1),
                                   cols.transpose(1, 2)).sum(0)
                else:
                    gw = torch.einsum(
                        "ngol,ngcl->goc",
                        g.reshape(n, groups, o // groups, -1),
                        cols.reshape(n, groups, -1, cols.shape[-1]))
                gw = gw.reshape(w.shape)
                del cols
            if ctx.needs_input_grad[0]:
                if groups == 1:
                    dcols = torch.bmm(wm.transpose(1, 2).expand(n, -1, -1),
                                      g.reshape(n, o, -1))
                else:
                    dcols = torch.einsum(
                        "goc,ngol->ngcl", wm,
                        g.reshape(n, groups, o // groups, -1)).reshape(
                            n, -1, g.shape[2] * g.shape[3])
                if _pointwise(w, stride, padding):
                    gx = dcols.reshape(x.shape)
                else:
                    gx = F.fold(dcols, x.shape[2:], w.shape[2:], dilation,
                                padding, stride)
        return gx, gw, None, None, None, None


def _out_dim(size, k, stride, pad, dilation):
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _amp_bf16_pair(x, w, attrs):
    """AMP white-list marking: both operands in bf16 when the op is
    marked and both are fp32 or bf16 (the product accumulates in fp32 and
    comes out in bf16); the cast lies inside the op, so its grad does."""
    floats = (torch.float32, torch.bfloat16)
    if attrs.get("__amp_bf16__") and x.dtype in floats \
            and w.dtype in floats:
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    return x, w


def _make_conv(name):
    def impl(ctx, ins, attrs):
        x, w = _amp_bf16_pair(ins["Input"][0], ins["Filter"][0], attrs)
        # NCHW x with OIHW w, symmetric padding: `_conv_nd` for nd=2
        conf = (list(attrs.get("strides", [1, 1])),
                list(attrs.get("paddings", [0, 0])),
                list(attrs.get("dilations", [1, 1])),
                attrs.get("groups", 1) or 1)
        if attrs.get("__quant_int8__") and not x.is_floating_point() \
                and not w.is_floating_point():
            # quant_rewrite's int8 operands, exact in int32 (the JAX op's
            # preferred_element_type): a float64 product is exact while
            # |acc| < 2^53, and neither device has an int8 convolution
            out = F.conv2d(x.to(torch.float64), w.to(torch.float64), None,
                           *conf).to(torch.int32)
        elif x.dtype == torch.float32 and w.dtype == torch.float32:
            out = _Conv2dFp32.apply(x, w, *conf)
        else:
            out = F.conv2d(x, w, None, *conf)
        # a white-list output stays bf16; the batch_norm after it upcasts
        if ins.get("FoldedBias"):
            # the per-channel shift conv+bn folding leaves behind
            out = out + ins["FoldedBias"][0].reshape(1, -1, 1, 1)
        return {"Output": [out]}

    register(name)(impl)


_make_conv("conv2d")
_make_conv("depthwise_conv2d")


def _torch_pads(paddings):
    """F.pad's list for symmetric paddings of the trailing dims."""
    return [q for p in reversed(paddings) for q in (p, p)]


def pool2d(x, attrs):
    """`_pool_nd` for nd=2: max pads with -inf; avg divides by the count
    of real elements when `exclusive` and some padding is nonzero, else by
    the window's size. A bf16 average sums in fp32 and rounds once, both
    ways (the JAX op's CPU reduce_window sums bf16 in bf16, some ulps off
    the exact sum). `ceil_mode` is not read: the JAX op ignores it (its
    layer's declared shape honours it)."""
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", [1, 1]))
    paddings = list(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
        strides = ksize
        paddings = [0, 0]
    # cuDNN's pools take at most half a window of padding; past that the
    # padding is made explicitly
    wide = any(2 * p > k for p, k in zip(paddings, ksize))
    if ptype == "max":
        if wide:
            x = F.pad(x, _torch_pads(paddings), value=-float("inf"))
            paddings = [0, 0]
        return F.max_pool2d(x, ksize, strides, paddings)
    exclusive = attrs.get("exclusive", True) and any(p > 0 for p in paddings)
    xf = x.float()
    if not wide:
        out = F.avg_pool2d(xf, ksize, strides, paddings,
                           count_include_pad=not exclusive)
        return out.to(x.dtype)
    pads = _torch_pads(paddings)
    s = F.avg_pool2d(F.pad(xf, pads), ksize, strides, divisor_override=1)
    if not exclusive:
        return (s / float(np.prod(ksize))).to(x.dtype)
    ones = F.pad(torch.ones_like(xf[:1, :1]), pads)
    cnt = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    return (s / cnt).to(x.dtype)


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    return {"Out": [pool2d(ins["X"][0], attrs)]}


dp_rule(["conv2d", "depthwise_conv2d"],
        row_rule(replicated_slots("Filter", "FoldedBias")))
dp_rule("pool2d")


# ---------------------------------------------------------------------------
# tensor parallelism (registry.TpRule): channel blocks (NCHW dim 1)
# ---------------------------------------------------------------------------


def _conv_tp_plan(top):
    """The filter's out-channels sharded: the input enters, the output's
    channels sharded. Its in-channels sharded: the input sharded on its
    channels (or narrowed to them), the partial outputs summed over the
    tp line. Grouped convs and a folded bias stay replicated."""
    if (top.op.attrs.get("groups", 1) or 1) != 1 \
            or top.op.inputs.get("FoldedBias"):
        return False
    mx, mw = top.mark("Input"), top.mark("Filter")
    if mw == 0 and mx is None:
        top.enter("Input")
        top.outs["Output"] = [1]
        return True
    if mw == 1 and mx in (None, 1):
        if mx is None:
            top.enter("Input", 0, 1)
        top.row = True
        top.reduce("Output")
        return True
    return False


def _conv_tp_impl(ctx, ins, attrs, inner, top):
    from ..parallel.collective import reduce_tp

    outs = inner(ctx, ins, attrs)
    if top.row:
        outs["Output"] = [reduce_tp(outs["Output"][0], ctx.tp)]
    return outs


def _pool_tp_plan(top):
    if top.mark("X") != 1:
        return False
    top.outs["Out"] = [1]
    return True


tp_rule("conv2d", TpRule(plan=_conv_tp_plan, impl=_conv_tp_impl))
tp_rule("pool2d", TpRule(plan=_pool_tp_plan))

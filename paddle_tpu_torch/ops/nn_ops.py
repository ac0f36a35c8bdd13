"""Tensor and NN ops of the LM path (parity: the JAX package's
``ops/tensor_ops.py`` reshape2 :13 / transpose2 :96 / split :113 / slice
:148, concat :108, ``ops/nn_ops.py`` softmax :20 / dropout :33 / lookup_table :53 /
layer_norm :78 / batch_norm :106 / add_position_encoding :275, and
``ops/loss_ops.py`` softmax_with_cross_entropy :90)."""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .dp import axes_exclude_batch, refuse, replicated_slots, row_rule, rows
from .registry import (DataParallelError, DpRule, TpRule, dp_rule, register,
                       tp_rule, weak_scalar)
from .tp import GATHER, check_divides, pointwise_plan


@register("reshape2")
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    # Fluid reshape: 0 copies the input dim, -1 is inferred
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)],
            "XShape": [x.new_zeros((0,) + tuple(x.shape))]}


@register("transpose2")
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])],
            "XShape": [x.new_zeros((0,) + tuple(x.shape))]}


@register("split")
def _split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError("split: dim %d of size %d does not divide into %d"
                         % (axis, x.shape[axis], num))
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register("softmax")
def _softmax(ctx, ins, attrs):
    """Softmax in the input's dtype (jax.nn.softmax's)."""
    x = ins["X"][0]
    return {"Out": [torch.softmax(x, dim=attrs.get("axis", -1))]}


@register("dropout", stateful=True)
def _dropout(ctx, ins, attrs):
    """Keep each element with probability 1 - p, drawn from the op's own
    generator (``LoweringContext.generator``: a recompute segment's
    re-run draws the forward's mask). downgrade_in_infer: Out = X * Mask
    in training, X * (1 - p) at test; upscale_in_train: X / (1 - p) where
    kept in training, X at test. Mask is in X's dtype (ones at test)."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl_type = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = (x if impl_type == "upscale_in_train"
               else x * weak_scalar(x, 1.0 - p))
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    u = torch.rand(x.shape, generator=ctx.generator(attrs),
                   device=x.device)
    return _dropout_with(x, u, p, impl_type)


def _dropout_with(x, u, p, impl_type):
    """Dropout of x by the uniform draws u (x's shape)."""
    keep = u >= p
    mask = keep.to(x.dtype)
    if impl_type == "upscale_in_train":
        out = torch.where(keep, x / weak_scalar(x, 1.0 - p),
                          torch.zeros_like(x))
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}


@register("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        d = x.shape[ax]
        st = max(st + d, 0) if st < 0 else min(st, d)
        en = max(en + d, 0) if en < 0 else min(en, d)
        idx[ax] = slice(st, en)
    return {"Out": [x[tuple(idx)]]}


@register("lookup_table", nondiff_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim and ids.shape[-1] == 1:  # Fluid ids carry a trailing 1
        ids = ids.reshape(ids.shape[:-1])
    out = F.embedding(ids.long(), w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": [out]}


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """fp32 statistics, output in the input's dtype (the stream dtype)."""
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    feat = tuple(x.shape[begin:])
    scale = ins["Scale"][0].reshape(feat).float() if ins.get("Scale") \
        else None
    bias = ins["Bias"][0].reshape(feat).float() if ins.get("Bias") else None
    y, mean, rstd = torch.native_layer_norm(x.float(), feat, scale, bias,
                                            eps)
    # Variance as the JAX op returns it, re-derived from 1/sqrt(var+eps)
    var = rstd.detach().pow(-2) - eps
    return {"Y": [y.to(x.dtype)], "Mean": [mean.detach().reshape(-1)],
            "Variance": [var.reshape(-1)]}


@register("batch_norm", stateful=True)
def _batch_norm(ctx, ins, attrs):
    """The JAX op's formula in torch ops: batch statistics in fp32 over
    every axis but the channel's (var = E[x^2] - E[x]^2, biased), moving
    = in * momentum + batch * (1 - momentum), written outside autograd;
    with `is_test` or `use_global_stats` the moving statistics normalize
    and pass through unmoved. Y in x's dtype. MeanOut / VarianceOut are
    the moving statistics, SavedMean / SavedVariance the ones used. A
    float64 x, which the JAX package cannot run, keeps float64 statistics
    (the tests' rounding oracle)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    use_global = attrs.get("use_global_stats", False) \
        or attrs.get("is_test", False)
    ch_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    axes = [i for i in range(x.ndim) if i != ch_axis]
    bshape = [x.shape[ch_axis] if i == ch_axis else 1 for i in range(x.ndim)]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if use_global:
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        mean = xf.mean(axes)
        var = (xf * xf).mean(axes) - mean * mean
        with torch.no_grad():
            mean_out = mean_in * momentum + mean * (1.0 - momentum)
            var_out = var_in * momentum + var * (1.0 - momentum)
    y = (xf - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape) + eps)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [mean],
            "SavedVariance": [var]}


@functools.lru_cache(maxsize=8)
def _position_table(t, d, dtype, device):
    pos = np.arange(t)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    pe = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    # float64 -> float32 -> dtype, the rounding path of jnp.asarray
    return torch.from_numpy(pe.astype(np.float32)).to(device=device,
                                                      dtype=dtype)


@register("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, D]
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    pe = _position_table(x.shape[1], x.shape[2], x.dtype, x.device)
    # multiplying by 1 changes no value: skip those passes
    ax = x if alpha == 1 else alpha * x
    return {"Out": [ax + (pe if beta == 1 else beta * pe)]}


class _HardLabelCE(torch.autograd.Function):
    """Per-position CE over the last axis with the JAX op's lean backward
    (loss_ops.py `_hard_label_ce`): the residual is the logits
    themselves, the backward recomputes the softmax from them, and the
    logits' grad is formed in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, lab, ignore_index):
        ignored = (lab == ignore_index)[..., None]
        # an ignored label may lie outside the vocab (-100): pick class 0
        # for it, the mask zeroes its loss and its grad
        idx = torch.where(ignored, torch.zeros_like(lab[..., None]),
                          lab[..., None])
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, idx)
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
        ctx.save_for_backward(logits, idx, ignored)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, idx, ignored = ctx.saved_tensors
        xf = logits.to(torch.float32, copy=True)
        xf.sub_(torch.logsumexp(xf, dim=-1, keepdim=True)).exp_()
        d = xf.to(logits.dtype)
        del xf
        d.scatter_(-1, idx, d.gather(-1, idx) - 1)   # softmax - one_hot
        gv = torch.where(ignored, torch.zeros_like(g), g)
        d.mul_(gv.to(d.dtype))
        return d, None, None


@register("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("soft_label", False) or axis not in (-1, logits.ndim - 1):
        raise NotImplementedError(
            "softmax_with_cross_entropy: the PyTorch port has the hard-"
            "label, last-axis form only")
    lab = label
    if lab.ndim and lab.shape[-1] == 1:
        lab = lab.reshape(lab.shape[:-1])
    # the loss stays fp32 for bf16 logits (AMP black-list semantics)
    loss = _HardLabelCE.apply(logits, lab.long(),
                              attrs.get("ignore_index", -100))
    if not attrs.get("__need_softmax__", True):
        return {"Loss": [loss]}
    softmax = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    return {"Softmax": [softmax], "Loss": [loss]}


# ---------------------------------------------------------------------------
# data parallelism (registry.DpRule)
# ---------------------------------------------------------------------------


def _global_reshape(x, attrs, world):
    """The rank's rows of the global reshape: Fluid's shape applied to
    the global input shape, its leading dim then split over the ranks
    (the flattened order is the same, so rank r's block of input
    elements is rank r's block of output rows)."""
    gshape = (x.shape[0] * world,) + tuple(x.shape[1:])
    shape = [gshape[i] if s == 0 else int(s)
             for i, s in enumerate(attrs["shape"])]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = int(np.prod(gshape)) // known
    if not shape or shape[0] % world:
        raise DataParallelError(
            "reshape of a batch-sharded input: the global output's "
            "leading dim %s does not divide over %d ranks"
            % (shape[:1], world))
    return [shape[0] // world] + shape[1:]


def _dp_reshape2(ctx, ins, attrs, sharded):
    x = ins["X"][0]
    return {"Out": [x.reshape(_global_reshape(x, attrs, ctx.dp.world))],
            "XShape": [x.new_zeros((0,) + tuple(x.shape))]}


def _dp_dropout(ctx, ins, attrs, sharded):
    """The global batch's mask, drawn from the op's usual generator, then
    the rank's rows: world N gives world 1's masks."""
    x = ins["X"][0]
    if attrs.get("is_test", False):
        return _dropout(ctx, ins, attrs)
    u = torch.rand((x.shape[0] * ctx.dp.world,) + tuple(x.shape[1:]),
                   generator=ctx.generator(attrs), device=x.device)
    return _dropout_with(x, rows(u, ctx.dp), attrs.get("dropout_prob", 0.5),
                         attrs.get("dropout_implementation",
                                   "downgrade_in_infer"))


def _dp_batch_norm(ctx, ins, attrs, sharded):
    """Training statistics over the global batch: one all-reduce of
    [sum x, sum x^2, count] (fp32), then the JAX op's formula var =
    E[x^2] - E[x]^2 on the global moments. The replicated moments
    re-enter the sharded region, where they normalize the local rows,
    so their cotangent (each rank's rows' part) is summed in backward:
    one all-reduce more. With `is_test` or `use_global_stats` the op is
    row-local."""
    from ..parallel.collective import enter_sharded, reduce_replicated

    x = ins["X"][0]
    if attrs.get("use_global_stats", False) or attrs.get("is_test", False):
        return _batch_norm(ctx, ins, attrs)
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    ch_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    axes = [i for i in range(x.ndim) if i != ch_axis]
    bshape = [x.shape[ch_axis] if i == ch_axis else 1 for i in range(x.ndim)]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    local_n = xf.numel() // xf.shape[ch_axis]
    moments = torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                         xf.new_full((1,), float(local_n))])
    moments = enter_sharded(reduce_replicated(moments, ctx.dp, "sum"),
                            ctx.dp)
    c = xf.shape[ch_axis]
    count = moments[2 * c]
    mean = moments[:c] / count
    var = moments[c:2 * c] / count - mean * mean
    with torch.no_grad():
        mean_out = mean_in * momentum + mean * (1.0 - momentum)
        var_out = var_in * momentum + var * (1.0 - momentum)
    y = (xf - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape) + eps)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [mean],
            "SavedVariance": [var]}


def _batch_norm_plan(op, sharded, block):
    replicated_slots("Scale", "Bias", "Mean", "Variance")(op, sharded,
                                                          block)
    marks = {slot: [False] * len(vs) for slot, vs in op.outputs.items()}
    marks["Y"] = [True]
    return marks


def _batch_norm_collectives(op, block, sharded, wanted, tp=(1, {})):
    """The moments' all-reduce, and its cotangent's when X's grad is
    formed."""
    if op.attrs.get("use_global_stats", False) \
            or op.attrs.get("is_test", False):
        return 0, 0
    calls = 1 + (wanted.get("X", [None])[0] is not None)
    c = op.inputs["Scale"][0].shape[0]
    size, marks = tp
    if (marks.get("X") or [None])[0] == 1:  # the rank's channels
        c //= size
    return calls, calls * (2 * c + 1) * 4


def _declare_dp():
    dp_rule("reshape2", DpRule(impl=_dp_reshape2))
    dp_rule("transpose2", row_rule(_perm_keeps_batch))
    dp_rule("split", row_rule(axes_exclude_batch("axis", 0)))
    dp_rule("concat", row_rule(_all_sharded("X"),
                               axes_exclude_batch("axis", 0)))
    dp_rule("softmax", row_rule(axes_exclude_batch("axis", -1)))
    dp_rule("slice", row_rule(axes_exclude_batch("axes", [], "Input")))
    dp_rule("lookup_table", row_rule(replicated_slots("W")))
    dp_rule("layer_norm", row_rule(_norm_axis_keeps_batch,
                                   replicated_slots("Scale", "Bias")))
    dp_rule("add_position_encoding")
    dp_rule("softmax_with_cross_entropy",
            row_rule(axes_exclude_batch("axis", -1, "Logits")))
    dp_rule("dropout", DpRule(impl=_dp_dropout))
    dp_rule("batch_norm", DpRule(plan=_batch_norm_plan,
                                 impl=_dp_batch_norm,
                                 collectives=_batch_norm_collectives))


def _perm_keeps_batch(op, sharded, block):
    if list(op.attrs.get("axis", [0]))[:1] != [0]:
        refuse(op, "axis=%r moves the batch axis" % (op.attrs["axis"],))


def _norm_axis_keeps_batch(op, sharded, block):
    if op.attrs.get("begin_norm_axis", 1) < 1:
        refuse(op, "begin_norm_axis=0 normalizes over the batch axis")


def _all_sharded(slot):
    def check(op, sharded, block):
        if not all(sharded.get(slot, ())):
            refuse(op, "it mixes batch-sharded and replicated %s inputs"
                    % slot)
    return check


_declare_dp()


# ---------------------------------------------------------------------------
# tensor parallelism (registry.TpRule)
# ---------------------------------------------------------------------------


def _axis(top, slot, attr, default):
    v = top.var(slot)
    nd = len(v.shape) if v.shape is not None else None
    a = top.op.attrs.get(attr, default)
    return a % nd if nd is not None and a is not None else a


def _split_tp_plan(top):
    """A split off the sharded dim is local. A split on it would hand
    the rank the wrong pieces (rank 0 of a column-sharded [.., 3D] qkv
    holds q's columns and half of k's), so the input is gathered (the
    seam) and each piece cut to the rank's block, entering the region
    so its replicated cotangent is whole in backward."""
    d = top.mark("X")
    axis = _axis(top, "X", "axis", 0)
    outs = top.op.outputs["Out"]
    top.outs["Out"] = [d] * len(outs)
    if axis != d:
        return True
    top.actions["X"] = [GATHER]
    top.calls.append(("gather_tp", top.in_bytes("X", 0, d)))
    for i, v in enumerate(outs):
        check_divides(top, v.shape[d] if v.shape is not None else None,
                      "split piece %r" % v.name)
        if top.grad_wanted("X"):
            top.calls.append(("enter_tp_bwd", top.out_bytes("Out", i)))
    top.row = True
    return True


def _split_tp_impl(ctx, ins, attrs, inner, top):
    from ..parallel.collective import enter_tp, local_part

    outs = inner(ctx, ins, attrs)
    if top.row:
        d = top.outs["Out"][0]
        outs["Out"] = [local_part(enter_tp(t, ctx.tp), ctx.tp, d)
                       for t in outs["Out"]]
    return outs


def _softmax_tp_plan(top):
    if _axis(top, "X", "axis", -1) == top.mark("X"):
        return False
    return pointwise_plan()(top)


def _dropout_tp_plan(top):
    d = top.mark("X")
    top.outs = {slot: [d] * len(vs) for slot, vs in top.op.outputs.items()}
    return True


def _dropout_tp_impl(ctx, ins, attrs, inner, top):
    """The global tensor's mask (the global batch's rows under data
    parallelism), then the rank's block: any mesh gives one device's
    masks."""
    from ..parallel.collective import local_part

    x = ins["X"][0]
    if attrs.get("is_test", False):
        return _dropout(ctx, ins, attrs)
    d = top.mark("X")
    shape = list(x.shape)
    rows_sharded = top.batch["X"][0]
    if rows_sharded:
        shape[0] *= ctx.dp.world
    shape[d] *= ctx.tp.world
    u = torch.rand(shape, generator=ctx.generator(attrs), device=x.device)
    if rows_sharded:
        u = rows(u, ctx.dp)
    return _dropout_with(x, local_part(u, ctx.tp, d),
                         attrs.get("dropout_prob", 0.5),
                         attrs.get("dropout_implementation",
                                   "downgrade_in_infer"))


def _squeezed_ids(ids):
    return ids.reshape(ids.shape[:-1]) if ids.ndim and ids.shape[-1] == 1 \
        else ids


def _lookup_tp_plan(top):
    """Vocab-parallel (W's rows sharded: rank t holds rows [t·V/tp,
    (t+1)·V/tp)): ids outside the rank's rows look up zeros, the
    partial rows summed over the tp line; W's columns sharded: the
    output's last dim sharded."""
    mw = top.mark("W")
    out = top.op.outputs["Out"][0]
    if top.mark("Ids") is not None or out.shape is None:
        return False
    if mw == 0:
        top.row = True
        top.reduce("Out")
        return True
    if mw == 1:
        top.outs["Out"] = [len(out.shape) - 1]
        return True
    return False


def _lookup_tp_impl(ctx, ins, attrs, inner, top):
    from ..parallel.collective import reduce_tp

    if not top.row:
        return inner(ctx, ins, attrs)
    w, ids = ins["W"][0], ins["Ids"][0]
    v = w.shape[0]
    start = ctx.tp.rank * v
    sq = _squeezed_ids(ids)
    inside = (sq >= start) & (sq < start + v)
    local = torch.where(inside, sq - start, torch.zeros_like(sq))
    out = inner(ctx, {"W": [w], "Ids": [local]},
                dict(attrs, padding_idx=-1))["Out"][0]
    keep = inside
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        keep = keep & (sq != padding_idx)
    out = out * keep[..., None].to(out.dtype)
    return {"Out": [reduce_tp(out, ctx.tp)]}


def _vocab_ce(logits, lab, ignore_index, group):
    """Megatron's vocab-parallel cross-entropy over logits sharded on the
    last axis: the max over the tp line (a MAX all-reduce), then one SUM
    all-reduce of [sum exp(x - max), the label's logit] (the rank that
    owns the label gives it, the others 0), the loss in `_HardLabelCE`'s
    fp32. Returns (loss, logsumexp, the label's local column, owned,
    ignored)."""
    from ..parallel.collective import reduce_tp

    v = logits.shape[-1]
    start = group.rank * v
    ignored = (lab == ignore_index)[..., None]
    inside = ((lab >= start) & (lab < start + v))[..., None] & ~ignored
    idx = torch.where(inside, lab[..., None] - start,
                      torch.zeros_like(lab[..., None]))
    xf = logits.detach().float()
    m = reduce_tp(xf.amax(-1, keepdim=True), group, "max")
    parts = torch.cat([torch.exp(xf - m).sum(-1, keepdim=True),
                       torch.where(inside, xf.gather(-1, idx),
                                   torch.zeros_like(m))], -1)
    parts = reduce_tp(parts, group)
    lse = m + torch.log(parts[..., :1])
    loss = torch.where(ignored, torch.zeros_like(lse), lse - parts[..., 1:])
    return loss, lse, idx, inside, ignored


class _VocabParallelCE(torch.autograd.Function):
    """`_vocab_ce` with a local backward: (softmax - onehot) * g in the
    logits' dtype, the softmax recomputed from the logits and the global
    logsumexp, the onehot on the owning rank only."""

    @staticmethod
    def forward(ctx, logits, lab, ignore_index, group):
        loss, lse, idx, inside, ignored = _vocab_ce(logits, lab,
                                                    ignore_index, group)
        ctx.save_for_backward(logits, lse, idx, inside, ignored)
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        logits, lse, idx, inside, ignored = ctx.saved_tensors
        xf = logits.to(torch.float32, copy=True)
        xf.sub_(lse).exp_()
        d = xf.to(logits.dtype)
        del xf
        d.scatter_(-1, idx, d.gather(-1, idx) - inside.to(d.dtype))
        gv = torch.where(ignored, torch.zeros_like(g), g)
        d.mul_(gv.to(d.dtype))
        return d, None, None, None


def _ce_tp_plan(top):
    logits = top.var("Logits")
    if logits.shape is None or top.mark("Label") is not None \
            or top.mark("Logits") != len(logits.shape) - 1 \
            or top.op.attrs.get("soft_label", False) \
            or _axis(top, "Logits", "axis", -1) != len(logits.shape) - 1:
        return False
    top.outs["Softmax"] = [len(logits.shape) - 1]
    b = top.out_bytes("Loss", itemsize=4)  # the loss is fp32
    top.calls += [("reduce_tp", b), ("reduce_tp", 2 * b)]
    return True


def _ce_tp_impl(ctx, ins, attrs, inner, top):
    logits, label = ins["Logits"][0], ins["Label"][0]
    lab = _squeezed_ids(label).long()
    ignore_index = attrs.get("ignore_index", -100)
    if logits.requires_grad and torch.is_grad_enabled():
        loss, lse = _VocabParallelCE.apply(logits, lab, ignore_index, ctx.tp)
    else:
        loss, lse = _vocab_ce(logits, lab, ignore_index, ctx.tp)[:2]
    if not attrs.get("__need_softmax__", True):
        return {"Loss": [loss]}
    softmax = torch.exp(logits.detach().float() - lse).to(logits.dtype)
    return {"Softmax": [softmax], "Loss": [loss]}


def _batch_norm_tp_plan(top):
    """Channels sharded (NCHW dim 1) with their params: each rank's
    channels are its own, so the op (its data-parallel statistics too)
    runs on them as it is."""
    if top.op.attrs.get("data_layout", "NCHW") != "NCHW" \
            or top.mark("X") != 1 or any(
                top.mark(s) != 0 for s in ("Scale", "Bias", "Mean",
                                           "Variance")):
        return False
    top.outs = {slot: [1 if slot == "Y" else 0] * len(vs)
                for slot, vs in top.op.outputs.items()}
    return True


def _declare_tp():
    tp_rule("split", TpRule(plan=_split_tp_plan, impl=_split_tp_impl))
    tp_rule("softmax", TpRule(plan=_softmax_tp_plan))
    tp_rule("dropout", TpRule(plan=_dropout_tp_plan, impl=_dropout_tp_impl))
    tp_rule("lookup_table", TpRule(plan=_lookup_tp_plan,
                                   impl=_lookup_tp_impl))
    tp_rule("softmax_with_cross_entropy", TpRule(plan=_ce_tp_plan,
                                                 impl=_ce_tp_impl))
    tp_rule("batch_norm", TpRule(plan=_batch_norm_tp_plan))


_declare_tp()

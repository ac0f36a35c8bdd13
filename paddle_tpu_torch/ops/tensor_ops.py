"""Tensor manipulation ops (parity: the JAX package's
``ops/tensor_ops.py``): the shape ops reshape :25, squeeze2/squeeze
:35/:48, unsqueeze2/unsqueeze :61/:70, flatten2/flatten :79/:88,
transpose :103, stack/unstack :127/:132, expand :141, strided_slice :163,
pad :173, pad2d :181, pad_constant_like :198; the index ops gather :205,
gather_nd :211, scatter :217, one_hot :226, multiplex :234, reverse :242,
where :251, where_op_select :257, label_smooth :268, shard_index :278;
and the random ops sampling_id :290, uniform_random_batch_size_like :298
and gaussian_random_batch_size_like :310, which draw from the op's own
generator (``LoweringContext.generator``), so their values are not the
JAX package's. reshape2, transpose2, concat, split and slice are in
``nn_ops.py``, is_empty in ``controlflow.py``.

The ops of the ``*2`` forms return `XShape` as the JAX ops do: a
zero-size ``[0, *x.shape]`` tensor in x's dtype."""

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import torch_dtype
from .dp import axes_exclude_batch, refuse, replicated_slots, row_rule, rows
from .nn_ops import _reshape2
from .registry import DpRule, dp_rule, get, register


def _xshape(x):
    return x.new_zeros((0,) + tuple(x.shape))


def _squeezed(x, axes):
    if not axes:
        return x.squeeze()
    for ax in sorted((a % x.ndim for a in axes), reverse=True):
        x = x.squeeze(ax)
    return x


def _unsqueezed(x, axes):
    for ax in sorted(axes):
        x = x.unsqueeze(ax)
    return x


def _flattened(x, axis):
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


@register("reshape")
def _reshape(ctx, ins, attrs):
    return {"Out": _reshape2(ctx, ins, attrs)["Out"]}


@register("squeeze2")
def _squeeze2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_squeezed(x, attrs.get("axes", []))],
            "XShape": [_xshape(x)]}


@register("squeeze")
def _squeeze(ctx, ins, attrs):
    return {"Out": [_squeezed(ins["X"][0], attrs.get("axes", []))]}


@register("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_unsqueezed(x, attrs["axes"])], "XShape": [_xshape(x)]}


@register("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    return {"Out": [_unsqueezed(ins["X"][0], attrs["axes"])]}


@register("flatten2")
def _flatten2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_flattened(x, attrs.get("axis", 1))],
            "XShape": [_xshape(x)]}


@register("flatten")
def _flatten(ctx, ins, attrs):
    return {"Out": [_flattened(ins["X"][0], attrs.get("axis", 1))]}


@register("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register("expand")
def _expand(ctx, ins, attrs):
    """x tiled `expand_times` along each dim (jnp.tile's semantics)."""
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """x[start:end:stride] along each axis, with Python's slice rules (a
    negative stride walks backwards, which torch's slicing cannot: the
    elements are picked by index)."""
    x = ins["Input"][0]
    for ax, st, en, stride in zip(attrs["axes"], attrs["starts"],
                                  attrs["ends"], attrs["strides"]):
        idx = range(*slice(st, en, stride).indices(x.shape[ax]))
        x = x.index_select(ax, torch.tensor(list(idx), dtype=torch.long,
                                            device=x.device))
    return {"Out": [x]}


def _torch_pad(pad_width):
    """[(before, after)] a dim, first dim first -> F.pad's flat list,
    last dim first."""
    return [p for pair in reversed(pad_width) for p in pair]


@register("pad")
def _pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    width = [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    return {"Out": [F.pad(x, _torch_pad(width),
                          value=attrs.get("pad_value", 0.0))]}


@register("pad2d")
def _pad2d(ctx, ins, attrs):
    """paddings [top, bottom, left, right] over H and W; mode constant,
    reflect, or edge for any other mode (the JAX op's)."""
    x = ins["X"][0]
    p = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    flat = [p[2], p[3], p[0], p[1]]
    if mode == "constant":
        out = F.pad(x, flat, value=attrs.get("pad_value", 0.0))
    else:
        out = F.pad(x, flat, mode="reflect" if mode == "reflect"
                    else "replicate")
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    """y padded at the end of each dim to x's shape."""
    x, y = ins["X"][0], ins["Y"][0]
    width = [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)]
    return {"Out": [F.pad(y, _torch_pad(width),
                          value=attrs.get("pad_value", 0.0))]}


@register("gather", nondiff_inputs=("Index",))
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [x.index_select(0, idx.reshape(-1).long())]}


@register("gather_nd", nondiff_inputs=("Index",))
def _gather_nd(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0].long()
    return {"Out": [x[tuple(idx.movedim(-1, 0))]]}


@register("scatter", nondiff_inputs=("Ids",))
def _scatter(ctx, ins, attrs):
    """Rows `Ids` of x set to (overwrite) or summed with `Updates`."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = ids.reshape(-1).long()
    if attrs.get("overwrite", True):
        return {"Out": [x.index_put((ids,), upd)]}
    return {"Out": [x.index_add(0, ids, upd)]}


@register("one_hot", differentiable=False)
def _one_hot(ctx, ins, attrs):
    """float32 one-hot rows of `depth`; a trailing dim of 1 is dropped
    and an id outside [0, depth) gives a row of zeros, as in
    jax.nn.one_hot."""
    x = ins["X"][0]
    depth = int(attrs["depth"])
    flat = x.reshape(x.shape[:-1]) if x.ndim and x.shape[-1] == 1 else x
    classes = torch.arange(depth, device=x.device)
    return {"Out": [(flat[..., None] == classes).to(torch.float32)]}


@register("multiplex", nondiff_inputs=("Ids",))
def _multiplex(ctx, ins, attrs):
    """Row i of Out is row i of X[Ids[i]]."""
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)  # [n, batch, ...]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids, rows]]}


@register("reverse")
def _reverse(ctx, ins, attrs):
    out = ins["X"][0]
    for ax in attrs["axis"]:
        out = out.flip(ax)
    return {"Out": [out]}


@register("where", differentiable=False)
def _where(ctx, ins, attrs):
    """The coordinates of the true elements, [n, ndim] int64."""
    return {"Out": [torch.nonzero(ins["Condition"][0]).to(torch.int64)]}


@register("where_op_select")
def _where_select(ctx, ins, attrs):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register("label_smooth")
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register("shard_index", differentiable=False)
def _shard_index(ctx, ins, attrs):
    """An id of shard `shard_id` as its offset in the shard, any other id
    as `ignore_value`."""
    x = ins["X"][0]
    nshards = attrs["nshards"]
    shard_size = (attrs["index_num"] + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") \
        == attrs["shard_id"]
    return {"Out": [torch.where(
        in_shard, torch.remainder(x, shard_size),
        torch.full_like(x, attrs.get("ignore_value", -1)))]}


@register("sampling_id", differentiable=False, stateful=True)
def _sampling_id(ctx, ins, attrs):
    """One id a row of X drawn with probability proportional to the row
    (the JAX op's categorical over log(max(x, 1e-20)))."""
    x = ins["X"][0]
    probs = torch.clamp_min(x.float(), 1e-20).reshape(-1, x.shape[-1])
    ids = torch.multinomial(probs, 1, generator=ctx.generator(attrs))
    return {"Out": [ids.reshape(x.shape[:-1]).to(torch.int64)]}


def _batch_size_like_shape(ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return shape


@register("uniform_random_batch_size_like", differentiable=False,
          stateful=True)
def _uniform_random_bsl(ctx, ins, attrs):
    out = torch.empty(_batch_size_like_shape(ins, attrs),
                      dtype=torch.float32, device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator(attrs))
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register("gaussian_random_batch_size_like", differentiable=False,
          stateful=True)
def _gaussian_random_bsl(ctx, ins, attrs):
    out = torch.empty(_batch_size_like_shape(ins, attrs),
                      dtype=torch.float32, device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator(attrs))
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


# ---------------------------------------------------------------------------
# data parallelism (registry.DpRule)
# ---------------------------------------------------------------------------


def _dp_reshape(ctx, ins, attrs, sharded):
    from .nn_ops import _dp_reshape2

    return {"Out": _dp_reshape2(ctx, ins, attrs, sharded)["Out"]}


def _flatten_keeps_batch(op, sharded, block):
    if op.attrs.get("axis", 1) < 1:
        refuse(op, "axis=0 folds the batch axis into one row")


def _expand_keeps_batch(op, sharded, block):
    if list(op.attrs.get("expand_times", [1]))[:1] != [1]:
        refuse(op, "expand_times tiles the batch axis")


def _pad_keeps_batch(op, sharded, block):
    if list(op.attrs.get("paddings", [0, 0]))[:2] != [0, 0]:
        refuse(op, "paddings pad the batch axis")


def _dp_batch_size_like(local):
    """The global batch's draw from the op's usual generator, then the
    rank's rows (an output whose batch dim is not its leading one is
    the whole global draw)."""
    def impl(ctx, ins, attrs, sharded):
        if attrs.get("input_dim_idx", 0) != 0:
            return local(ctx, ins, attrs)
        x = ins["Input"][0]
        whole = x.new_empty((x.shape[0] * ctx.dp.world,)
                            + tuple(x.shape[1:]))
        out = local(ctx, {"Input": [whole]}, attrs)["Out"][0]
        if attrs.get("output_dim_idx", 0) == 0:
            out = rows(out, ctx.dp)
        return {"Out": [out]}
    return impl


def _batch_size_like_plan(op, sharded, block):
    batch_out = op.attrs.get("input_dim_idx", 0) == 0 \
        and op.attrs.get("output_dim_idx", 0) == 0
    return {"Out": [batch_out]}


def _declare_dp():
    dp_rule("reshape", DpRule(impl=_dp_reshape))
    for name in ("squeeze", "squeeze2"):
        dp_rule(name, row_rule(axes_exclude_batch("axes", None)))
    for name in ("unsqueeze", "unsqueeze2"):
        dp_rule(name, row_rule(axes_exclude_batch("axes", [],
                                                  rank_delta=1)))
    for name in ("flatten", "flatten2"):
        dp_rule(name, row_rule(_flatten_keeps_batch))
    dp_rule("transpose", get("transpose2").dp)
    dp_rule("stack", row_rule(_all_sharded_x,
                              axes_exclude_batch("axis", 0,
                                                 rank_delta=1)))
    dp_rule("unstack", row_rule(axes_exclude_batch("axis", 0)))
    dp_rule("expand", row_rule(_expand_keeps_batch))
    dp_rule("strided_slice", row_rule(axes_exclude_batch("axes", [],
                                                         "Input")))
    dp_rule("pad", row_rule(_pad_keeps_batch))
    dp_rule("pad2d")
    dp_rule("gather", row_rule(replicated_slots("X")))
    dp_rule("one_hot")
    dp_rule("label_smooth", row_rule(replicated_slots("PriorDist")))
    dp_rule("where_op_select", row_rule(_all_sharded_where))
    for name in ("uniform_random_batch_size_like",
                 "gaussian_random_batch_size_like"):
        dp_rule(name, DpRule(plan=_batch_size_like_plan,
                             impl=_dp_batch_size_like(get(name).impl)))


def _all_sharded_x(op, sharded, block):
    from .nn_ops import _all_sharded

    _all_sharded("X")(op, sharded, block)


def _all_sharded_where(op, sharded, block):
    if not all(m for ms in sharded.values() for m in ms):
        refuse(op, "it mixes batch-sharded and replicated operands")


_declare_dp()

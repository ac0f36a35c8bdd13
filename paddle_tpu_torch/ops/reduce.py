"""top_k (parity: the JAX package's ``ops/reduce.py`` top_k :68-73). The
reductions (reduce_sum and the rest) are in ``elementwise.py``."""

import torch

from .dp import refuse, row_rule
from .registry import dp_rule, register


@register("top_k", differentiable=False)
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first; equal values in
    index order, as ``lax.top_k`` returns them (a stable sort)."""
    x = ins["X"][0]
    k = int(attrs["k"])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


def _last_axis_not_batch(op, sharded, block):
    """top_k works over the last axis, which must not be the batch's."""
    shape = op.inputs["X"][0].shape
    if shape is not None and len(shape) == 1:
        refuse(op, "its input %r is 1-D, so its last axis is the batch "
                   "axis" % op.inputs["X"][0].name)


dp_rule("top_k", row_rule(_last_axis_not_batch))

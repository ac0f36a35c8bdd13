"""top_k (parity: the JAX package's ``ops/reduce.py`` top_k :68-73). The
reductions (reduce_sum and the rest) are in ``elementwise.py``."""

import torch

from .registry import register


@register("top_k", differentiable=False)
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first; equal values in
    index order, as ``lax.top_k`` returns them (a stable sort)."""
    x = ins["X"][0]
    k = int(attrs["k"])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}

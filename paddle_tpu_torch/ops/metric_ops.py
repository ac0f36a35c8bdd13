"""In-graph metric ops (parity: the JAX package's ``ops/metric_ops.py``
accuracy :9-24)."""

import torch

from .registry import register


@register("accuracy", differentiable=False)
def _accuracy(ctx, ins, attrs):
    """Top-k accuracy: a row is correct when its label is among its top-k
    Indices. Accuracy [1] float32, Correct and Total [1] int32."""
    indices = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1)
    correct = (indices == label).any(dim=1).float().sum().reshape(1)
    total = indices.shape[0]
    return {"Accuracy": [correct / float(total)],
            "Correct": [correct.to(torch.int32)],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=indices.device)]}

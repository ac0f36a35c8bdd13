"""Cross-entropy over probabilities (parity: the JAX package's
``ops/loss_ops.py`` `_take_label_prob` :16-21, cross_entropy :24-37 and
cross_entropy2 :40-45). The softmax form, softmax_with_cross_entropy, is
in ``nn_ops.py``."""

import torch

from .registry import register, weak_scalar

_EPS = 1e-12


def _take_label_prob(x, label):
    """x [N, C], int label [N, 1] -> the label's probability [N, 1].
    A label outside [0, C) (an ignore_index such as -100) picks class 0,
    where jnp's gather would fill: the caller masks that row."""
    lab = label.reshape(-1, 1).long()
    inside = (lab >= 0) & (lab < x.shape[-1])
    return x.gather(-1, torch.where(inside, lab, torch.zeros_like(lab)))


def _neg_log(p):
    return -torch.log(torch.clamp_min(p, weak_scalar(p, _EPS)))


@register("cross_entropy", nondiff_inputs=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """Y = -log(max(p[label], 1e-12)) [N, 1], 0 where label equals
    `ignore_index`; soft labels: -sum(label * log(max(x, 1e-12)))."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        logs = torch.log(torch.clamp_min(x, weak_scalar(x, _EPS)))
        return {"Y": [-torch.sum(label * logs, dim=-1, keepdim=True)]}
    loss = _neg_log(_take_label_prob(x, label))
    ignored = label.reshape(-1, 1) == attrs.get("ignore_index", -100)
    return {"Y": [torch.where(ignored, torch.zeros_like(loss), loss)]}


@register("cross_entropy2", nondiff_inputs=("Label",))
def _cross_entropy2(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    p = _take_label_prob(x, label)
    return {"Y": [_neg_log(p)], "MatchX": [p],
            "XShape": [x.new_zeros((0,) + tuple(x.shape))]}

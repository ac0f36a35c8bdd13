"""Cross-entropy over probabilities and the sigmoid and log losses (parity: the JAX package's
``ops/loss_ops.py`` `_take_label_prob` :16-21, cross_entropy :24-37 and
cross_entropy2 :40-45, sigmoid_cross_entropy_with_logits :135 and
log_loss :173). The softmax form, softmax_with_cross_entropy, is in
``nn_ops.py``."""

import torch

from .registry import dp_rule, register, weak_scalar

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


@register("sigmoid_cross_entropy_with_logits", nondiff_inputs=("Label",))
def _sigmoid_ce(ctx, ins, attrs):
    """max(x, 0) - x * label + softplus(-|x|) (the JAX op's formula,
    softplus as logaddexp(., 0) like jax.nn.softplus), 0 where the label
    is `ignore_index`; `normalize` scales by size / the count of the
    other labels (at least 1). At x = 0 the grads are jnp's: max's split
    evenly (torch.maximum's too), |x|'s +1 (torch.abs's would be 0, so
    -|x| is formed as where(x >= 0, -x, x))."""
    x, label = ins["X"][0], ins["Label"][0]
    ignore_index = attrs.get("ignore_index", -100)
    zero = torch.zeros_like(x)
    loss = torch.maximum(x, zero) - x * label \
        + torch.logaddexp(torch.where(x >= 0, -x, x), zero)
    ignored = label == ignore_index
    loss = torch.where(ignored, zero, loss)
    if attrs.get("normalize", False):
        n_valid = torch.clamp_min((~ignored).to(x.dtype).sum(), 1.0)
        loss = loss * (loss.numel() / n_valid)
    return {"Out": [loss]}


@register("log_loss", nondiff_inputs=("Labels",))
def _log_loss(ctx, ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps)
                     - (1.0 - label) * torch.log(1.0 - p + eps)]}


dp_rule(["cross_entropy", "cross_entropy2",
         "sigmoid_cross_entropy_with_logits", "log_loss"])

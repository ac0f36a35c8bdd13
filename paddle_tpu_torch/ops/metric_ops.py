"""In-graph metric ops (parity: the JAX package's ``ops/metric_ops.py``
accuracy :9-24)."""

import torch

from .dp import replicated_slots
from .registry import DpRule, dp_rule, register


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


@register("auc", differentiable=False)
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC over a threshold histogram: each score falls in
    bin clip(int(score * num_thresholds), 0, num_thresholds), the product
    in fp32 and truncated as the JAX op's astype(int32) truncates; the
    bins' positive and negative counts add to the persistable StatPos /
    StatNeg (integers held in fp32, so exact in any order), written back
    through StatPosOut / StatNegOut as batch_norm writes its moving
    statistics. AUC: the trapezoid area under the curve swept from the
    highest bin down, over tot_pos * tot_neg (0 while either is 0)."""
    predict = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = stat_pos.shape[0] - 1
    # the positive class's probability: column 1 of [N, 2], else the score
    score = predict[:, 1] if predict.ndim == 2 and predict.shape[1] >= 2 \
        else predict.reshape(-1)
    bins = torch.clamp((score.float() * num_thresholds).to(torch.int32),
                       0, num_thresholds).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, bins, is_pos)
    stat_neg = stat_neg.index_add(0, bins, 1.0 - is_pos)
    tp = torch.cumsum(stat_pos.flip(0), 0)
    fp = torch.cumsum(stat_neg.flip(0), 0)
    zero = tp.new_zeros(1)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    denom = tp[-1] * fp[-1]
    auc = torch.where(denom > 0, area / torch.clamp_min(denom, 1.0),
                      torch.zeros_like(area))
    return {"AUC": [auc.reshape(1)], "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg]}


# ---------------------------------------------------------------------------
# data parallelism (registry.DpRule): batch reductions
# ---------------------------------------------------------------------------


def _dp_accuracy(ctx, ins, attrs, sharded):
    """One all-reduce of [correct, total] (fp32: exact integers)."""
    from ..parallel.collective import reduce_replicated

    indices = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1)
    local = torch.stack([
        (indices == label).any(dim=1).float().sum(),
        indices.new_tensor(float(indices.shape[0]), dtype=torch.float32)])
    correct, total = reduce_replicated(local, ctx.dp, "sum")
    return {"Accuracy": [(correct / total).reshape(1)],
            "Correct": [correct.to(torch.int32).reshape(1)],
            "Total": [total.to(torch.int32).reshape(1)]}


def _dp_auc(ctx, ins, attrs, sharded):
    """The batch's bin counts of the local rows, one all-reduce of the
    positive and negative histograms, then the op on the global
    counts."""
    from ..parallel.collective import reduce_replicated

    predict = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = stat_pos.shape[0] - 1
    score = predict[:, 1] if predict.ndim == 2 and predict.shape[1] >= 2 \
        else predict.reshape(-1)
    bins = torch.clamp((score.float() * num_thresholds).to(torch.int32),
                       0, num_thresholds).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    zeros = torch.zeros_like(stat_pos)
    hist = torch.cat([zeros.index_add(0, bins, is_pos),
                      zeros.index_add(0, bins, 1.0 - is_pos)])
    hist = reduce_replicated(hist, ctx.dp, "sum")
    n = stat_pos.shape[0]
    # every bin holds an exact integer count, so the global counts added
    # here equal the rows added one at a time
    return _auc(ctx, {"Predict": [predict.new_zeros((0, 2))],
                      "Label": [label.new_zeros((0,))],
                      "StatPos": [stat_pos + hist[:n]],
                      "StatNeg": [stat_neg + hist[n:]]}, attrs)


def _metric_plan(*sharded_outs):
    def plan(op, sharded, block):
        replicated_slots("StatPos", "StatNeg")(op, sharded, block)
        return {slot: [slot in sharded_outs] * len(vs)
                for slot, vs in op.outputs.items()}
    return plan


def _accuracy_collectives(op, block, sharded, wanted, tp=(1, {})):
    return 1, 8


def _auc_collectives(op, block, sharded, wanted, tp=(1, {})):
    n = op.inputs["StatPos"][0].shape[0]
    return 1, 2 * n * 4


def _declare_dp():
    dp_rule("accuracy", DpRule(plan=_metric_plan(),
                               impl=_dp_accuracy,
                               collectives=_accuracy_collectives))
    dp_rule("auc", DpRule(plan=_metric_plan(), impl=_dp_auc,
                          collectives=_auc_collectives))


_declare_dp()

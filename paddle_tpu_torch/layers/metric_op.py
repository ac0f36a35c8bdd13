"""In-graph metric layers (parity: the JAX package's
``layers/metric_op.py`` accuracy :10, auc :39)."""

from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of `input` (probabilities, [N, C]) against int
    `label`: a top_k op, then an accuracy op."""
    helper = LayerHelper("accuracy", **locals())
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="top_k", inputs={"X": [input]},
        outputs={"Out": [topk_out], "Indices": [topk_indices]},
        attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]},
        attrs={})
    acc_out.shape = (1,)
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=2**12 - 1, topk=1,
        slide_steps=1):
    """Streaming AUC: an auc op over the persistable histograms StatPos
    and StatNeg ([num_thresholds + 1] float32, zeroed by the startup
    program), which it updates. Returns (auc, auc, [stat_pos,
    stat_neg])."""
    helper = LayerHelper("auc", **locals())
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="float32", shape=[num_thresholds + 1])
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="float32", shape=[num_thresholds + 1])
    for var in (stat_pos, stat_neg):
        helper.set_variable_initializer(var, Constant(value=0.0))
    auc_out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    auc_out.shape = (1,)
    return auc_out, auc_out, [stat_pos, stat_neg]

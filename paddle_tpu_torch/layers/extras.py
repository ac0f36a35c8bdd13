"""Beam search layers (parity: the JAX package's ``layers/extras.py``
beam_search :358 and beam_search_decode :383). The file's other layers
(CRF, CTC, the sampled losses, distributed_embedding and the rest) are
not ported yet."""

from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One step of beam search over dense [batch, beam(, K)] tensors (the
    reference's LoD lanes as a dense beam axis)."""
    helper = LayerHelper("beam_search", **locals())
    sel_ids = helper.create_variable_for_type_inference(dtype="int64")
    sel_scores = helper.create_variable_for_type_inference(dtype="float32")
    parent_idx = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "ids": [ids], "scores": [scores]},
        outputs={"selected_ids": [sel_ids],
                 "selected_scores": [sel_scores],
                 "parent_idx": [parent_idx]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level,
               "is_accumulated": is_accumulated})
    for v in (sel_ids, sel_scores, parent_idx):
        v.stop_gradient = True
    if return_parent_idx:
        return sel_ids, sel_scores, parent_idx
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, parents, beam_size=None, end_id=0,
                       name=None):
    """Backtrack stacked beam-search steps [T, batch, beam] into
    sentences [batch, beam, T]."""
    helper = LayerHelper("beam_search_decode", **locals())
    sent_ids = helper.create_variable_for_type_inference(dtype="int64")
    sent_scores = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores], "Parents": [parents]},
        outputs={"SentenceIds": [sent_ids],
                 "SentenceScores": [sent_scores]},
        attrs={"end_id": end_id})
    sent_ids.stop_gradient = True
    sent_scores.stop_gradient = True
    return sent_ids, sent_scores

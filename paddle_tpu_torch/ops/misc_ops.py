"""Beam search (parity: the JAX package's ``ops/misc_ops.py``
beam_search :495 and beam_search_decode :527): one pruning step and the
backtrack, over dense [batch, beam] lanes in place of the reference's
LoD. The rest of the JAX file (CRF, CTC, the sampled losses, chunk_eval,
py_func and the others) is not ported yet."""

import torch

from .registry import register

_NEG = -1e30


@register("beam_search", differentiable=False,
          nondiff_inputs=("pre_ids", "pre_scores", "ids", "scores"))
def _beam_search(ctx, ins, attrs):
    """pre_ids, pre_scores [batch, beam]; ids, scores [batch, beam, K]
    the K candidates of each lane. A candidate's score is its lane's
    plus log(max(p, 1e-20)); a finished lane (pre_id == end_id) carries
    itself on, unchanged, as its first candidate, its other candidates
    at -1e30. The `beam_size` best of the beam * K candidates of each
    source, equal scores in index order (``lax.top_k``'s order: a
    stable descending sort), with the lane each came from."""
    pre_ids = ins["pre_ids"][0].long()
    pre_scores = ins["pre_scores"][0].float()
    ids = ins["ids"][0].long()
    scores = ins["scores"][0].float()
    beam_size = attrs.get("beam_size", ids.shape[1])
    end_id = attrs.get("end_id", 0)
    B, W, K = scores.shape
    finished = (pre_ids == end_id)[:, :, None]
    first = torch.arange(K, device=scores.device)[None, None, :] == 0
    cand = pre_scores[:, :, None] + torch.log(torch.clamp_min(scores, 1e-20))
    cand = torch.where(finished, torch.where(
        first, pre_scores[:, :, None], torch.full_like(cand, _NEG)), cand)
    cand_ids = torch.where(finished, torch.full_like(ids, end_id), ids)
    flat = cand.reshape(B, W * K)
    top_s, top_i = torch.sort(flat, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :beam_size], top_i[:, :beam_size]
    sel = torch.gather(cand_ids.reshape(B, W * K), 1, top_i)
    return {"selected_ids": [sel], "selected_scores": [top_s],
            "parent_idx": [torch.div(top_i, K, rounding_mode="floor")
                           .to(torch.int32)]}


@register("beam_search_decode", differentiable=False,
          nondiff_inputs=("Ids", "Scores", "Parents"))
def _beam_search_decode(ctx, ins, attrs):
    """Ids, Scores, Parents [T, batch, beam] stacked steps -> the
    sentences [batch, beam, T], each lane walked back from the last step
    through its parents, and the last step's scores."""
    ids = ins["Ids"][0].long()
    parents = ins["Parents"][0].long()
    T, B, W = ids.shape
    ptr = torch.arange(W, device=ids.device)[None, :].expand(B, W)
    toks = [None] * T
    for t in reversed(range(T)):
        toks[t] = torch.gather(ids[t], 1, ptr)
        ptr = torch.gather(parents[t], 1, ptr)
    return {"SentenceIds": [torch.stack(toks, dim=-1)],
            "SentenceScores": [ins["Scores"][0][-1].float()]}

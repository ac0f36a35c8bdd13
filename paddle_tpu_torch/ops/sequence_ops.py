"""Sequence ops (parity: the JAX package's ``ops/sequence_ops.py``:
`_mask` :15, sequence_pool :25, sequence_conv :51, sequence_softmax :74,
sequence_expand :85, sequence_expand_as :96, sequence_reshape :104,
sequence_reverse :112, sequence_concat :128, sequence_slice :133,
sequence_pad :141, sequence_unpad :149, sequence_mask :159,
sequence_enumerate :172, sequence_erase :186, sequence_scatter :198,
similarity_focus :210).

A batch of sequences is a padded dense tensor [B, T, ...] with an
optional Length input [B] (the reference's LoD offsets as lengths);
without Length every row is full length."""

import torch

from ..framework import torch_dtype
from .registry import register


def _mask(x, ins, time_axis=1):
    """([B, T] float32 validity mask, lengths [B]) from the optional
    Length input."""
    B, T = x.shape[0], x.shape[time_axis]
    steps = torch.arange(T, device=x.device)
    if ins.get("Length"):
        lens = ins["Length"][0].reshape(-1)
        return (steps[None, :] < lens[:, None]).to(torch.float32), lens
    return (torch.ones((B, T), dtype=torch.float32, device=x.device),
            torch.full((B,), T, dtype=torch.int32, device=x.device))


@register("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    """Pool [B, T, D] over the valid steps of each row: SUM, AVERAGE,
    SQRT (sum over sqrt(length)), MAX (equal maxima share the grad, as
    jnp.max's do: torch.amax, not torch.max(dim)), LAST or FIRST."""
    x = ins["X"][0]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    mask, lens = _mask(x, ins)
    m = mask[..., None]
    if ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / torch.clamp_min(lens[:, None], 1)
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(
            torch.clamp_min(lens[:, None], 1).to(torch.float32))
    elif ptype == "MAX":
        out = torch.amax(torch.where(m > 0, x, torch.full_like(
            x, float("-inf"))), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp_min(lens - 1, 0).long()
        out = x[torch.arange(x.shape[0], device=x.device), idx]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return {"Out": [out], "MaxIndex": [torch.zeros(
        out.shape, dtype=torch.int32, device=out.device)]}


def _shifted(x, off, fill):
    """x rolled left by `off` along time, the steps that wrapped set to
    `fill` (the JAX ops' roll-and-mask)."""
    T = x.shape[1]
    steps = torch.arange(T, device=x.device)
    valid = steps >= -off if off < 0 else steps < T - off
    valid = valid.reshape((1, T) + (1,) * (x.ndim - 2))
    return torch.where(valid, torch.roll(x, -off, dims=1),
                       torch.full_like(x, fill))


@register("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """A context window over time: the steps contextStart ..
    contextStart + contextLength - 1 around each step (zeros past the
    ends) concatenated, times Filter [contextLength * D, F]."""
    x, w = ins["X"][0], ins["Filter"][0]
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    cols = [_shifted(x, ctx_start + i, 0.0) for i in range(ctx_len)]
    return {"Out": [torch.matmul(torch.cat(cols, dim=-1), w)]}


@register("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's valid steps of [B, T] or [B, T, 1]; the
    padding steps come out 0."""
    x = ins["X"][0]
    squeeze = x.ndim == 3
    xs = x[..., 0] if squeeze else x
    mask, _ = _mask(xs, ins)
    logits = torch.where(mask > 0, xs, torch.full_like(xs, -1e30))
    out = torch.softmax(logits, dim=1) * mask
    return {"Out": [out[..., None] if squeeze else out]}


@register("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """X [B, ...] repeated along a new time axis to Y's T; otherwise X
    broadcast to Y's leading shape."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.shape[0] == y.shape[0] and x.ndim < y.ndim:
        return {"Out": [x[:, None].repeat_interleave(y.shape[1], dim=1)]}
    return {"Out": [x.expand(tuple(y.shape[:x.ndim]))]}


@register("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if x.shape[0] == y.shape[0] and x.ndim == 2 and y.ndim == 3:
        return {"Out": [x[:, None].repeat_interleave(y.shape[1], dim=1)]}
    return {"Out": [x.expand(tuple(y.shape))]}


@register("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(x.shape[0], -1, attrs["new_dim"])]}


@register("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    """Each row's valid steps reversed in place, the padding left where
    it is; without Length the whole time axis."""
    x = ins["X"][0]
    if not ins.get("Length"):
        return {"Y": [x.flip(1)]}
    lens = ins["Length"][0].reshape(-1)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < lens[:, None], lens[:, None] - 1 - idx,
                      idx).long()
    if x.ndim == 3:
        rev = rev[..., None].expand(-1, -1, x.shape[-1])
    return {"Y": [torch.gather(x, 1, rev)]}


@register("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=1)]}


@register("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    x = ins["X"][0]
    offset = int(attrs.get("offset_val", 0))
    length = int(attrs.get("length_val", x.shape[1]))
    return {"Out": [x.narrow(1, offset, length)]}


@register("sequence_pad", nondiff_inputs=("PadValue",))
def _sequence_pad(ctx, ins, attrs):
    """The batch is padded already: X as it is, and the lengths."""
    x = ins["X"][0]
    _, lens = _mask(x, ins)
    return {"Out": [x], "Length": [lens.to(torch.int64)]}


@register("sequence_unpad", nondiff_inputs=("Length",))
def _sequence_unpad(ctx, ins, attrs):
    """X with its padding steps set to 0."""
    x = ins["X"][0]
    lens = ins["Length"][0].reshape(-1)
    mask = torch.arange(x.shape[1], device=x.device)[None, :] \
        < lens[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))
    return {"Out": [torch.where(mask, x, torch.zeros_like(x))]}


@register("sequence_mask", differentiable=False)
def _sequence_mask(ctx, ins, attrs):
    """[N, maxlen] of step < length, in `out_dtype`; maxlen is static."""
    x = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        maxlen = int(attrs["__static_maxlen__"])
    dt = torch_dtype(attrs.get("out_dtype", attrs.get("dtype", "int64")))
    steps = torch.arange(maxlen, device=x.device)
    return {"Y": [(steps[None, :] < x[:, None]).to(dt)]}


@register("sequence_enumerate", differentiable=False)
def _sequence_enumerate(ctx, ins, attrs):
    """[B, T, win_size]: step t's window t .. t + win_size - 1, the steps
    past the end `pad_value`."""
    x = ins["X"][0]
    pad = attrs.get("pad_value", 0)
    return {"Out": [torch.stack([_shifted(x, i, pad)
                                 for i in range(attrs["win_size"])],
                                dim=-1)]}


@register("sequence_erase", differentiable=False)
def _sequence_erase(ctx, ins, attrs):
    """The `tokens` replaced by -1 (static shapes keep the slots; later
    masks skip them)."""
    x = ins["X"][0]
    bad = torch.zeros_like(x, dtype=torch.bool)
    for t in attrs.get("tokens", []):
        bad = bad | (x == t)
    return {"Out": [torch.where(bad, torch.full_like(x, -1), x)]}


@register("sequence_scatter", nondiff_inputs=("Ids",))
def _sequence_scatter(ctx, ins, attrs):
    """X[b, Ids[b, j]] += Updates[b, j]."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        -1, ids.shape[1])
    return {"Out": [x.index_put(
        (rows.reshape(-1), ids.reshape(-1).long()),
        upd.reshape((-1,) + tuple(upd.shape[2:])), accumulate=True)]}


@register("similarity_focus", differentiable=False)
def _similarity_focus(ctx, ins, attrs):
    """For each selected channel of [B, C, H, W], the cells that are the
    maximum of their row or column: a 0/1 mask over all channels."""
    x = ins["X"][0]
    if attrs["axis"] != 1:
        raise NotImplementedError("similarity_focus supports axis=1 (C)")
    out = torch.zeros_like(x)
    for idx in attrs["indexes"]:
        ch = x[:, idx]  # [B, H, W]
        row_max = ch == ch.amax(dim=2, keepdim=True)
        col_max = ch == ch.amax(dim=1, keepdim=True)
        out = torch.maximum(out, (row_max | col_max).to(x.dtype)[:, None])
    return {"Out": [out]}

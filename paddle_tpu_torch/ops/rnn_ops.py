"""Recurrent cell ops (parity: the JAX package's ``ops/rnn_ops.py``
gru_unit :21, lstm_unit :50, gru :64, lstm :105).

The JAX package's full-sequence gru and lstm are ``lax.scan`` over time;
here they are a Python loop over time of torch ops, one matrix product
``h_prev @ w`` and a few elementwise ops a step, and the generic grad op
asks autograd for the grad through the whole loop. The arithmetic is
the JAX op's, in its order: gru's gates ``u, r`` from ``x + h @ w[:,
:2D]``, then the candidate from ``(r * h) @ w[:, 2D:]``; lstm's gates
``i, f, cand, o`` from ``(x + h @ w) + bias[:, :4D]`` (a 2-D bias's
peephole columns are dropped). As in the JAX op, lstm runs its fixed
sigmoid/tanh gates over every step of the padded batch: the sequence
lengths mask only later, in ``sequence_pool``."""

import torch

from .registry import register


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda x: x}[name]


def _times(x, is_reverse):
    t = range(x.shape[1])
    return reversed(t) if is_reverse else t


def _in_time_order(ys, is_reverse):
    """The steps' outputs, produced in walk order, as [B, T, ...]."""
    return torch.stack(ys[::-1] if is_reverse else ys, dim=1)


def _gru_step(xt, h_prev, w, gate_act, act, origin_mode):
    d = h_prev.shape[-1]
    gates = gate_act(xt[:, :2 * d] + h_prev @ w[:, :2 * d])
    u, r = gates[:, :d], gates[:, d:]
    reset_h = r * h_prev
    cand = act(xt[:, 2 * d:] + reset_h @ w[:, 2 * d:])
    if origin_mode:
        h = u * h_prev + (1.0 - u) * cand
    else:
        h = (1.0 - u) * h_prev + u * cand
    return h, u, r, cand, reset_h


@register("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step: Input [B, 3D] projected input, HiddenPrev [B, D],
    Weight [D, 3D] (gates [D, 2D] | candidate [D, D])."""
    x = ins["Input"][0]
    if ins.get("Bias"):
        x = x + ins["Bias"][0]
    h, u, r, cand, reset_h = _gru_step(
        x, ins["HiddenPrev"][0], ins["Weight"][0],
        _act(attrs.get("gate_activation", "sigmoid")),
        _act(attrs.get("activation", "tanh")),
        attrs.get("origin_mode", False))
    return {"Hidden": [h], "Gate": [torch.cat([u, r, cand], -1)],
            "ResetHiddenPrev": [reset_h]}


@register("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step: X [B, 4D] pre-projected as (i, j, f, o), C_prev."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    i, j, f, o = torch.chunk(x, 4, dim=-1)
    c = c_prev * torch.sigmoid(f + attrs.get("forget_bias", 0.0)) \
        + torch.sigmoid(i) * torch.tanh(j)
    h = torch.tanh(c) * torch.sigmoid(o)
    return {"C": [c], "H": [h]}


@register("gru")
def _gru(ctx, ins, attrs):
    """The GRU over a padded batch: Input [B, T, 3D] pre-projected,
    Weight [D, 3D], optional Bias [1, 3D] (added to each step's input
    first) and H0 [B, D]."""
    x, w = ins["Input"][0], ins["Weight"][0]
    d = w.shape[0]
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((x.shape[0], d))
    bias = ins["Bias"][0] if ins.get("Bias") else None
    is_reverse = attrs.get("is_reverse", False)
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    act = _act(attrs.get("activation", "tanh"))
    origin_mode = attrs.get("origin_mode", False)
    hs = []
    for t in _times(x, is_reverse):
        xt = x[:, t] if bias is None else x[:, t] + bias
        h = _gru_step(xt, h, w, gate_act, act, origin_mode)[0]
        hs.append(h)
    hidden = _in_time_order(hs, is_reverse)
    return {"Hidden": [hidden], "BatchGate": [hidden],
            "BatchResetHiddenPrev": [hidden], "BatchHidden": [hidden]}


@register("lstm")
def _lstm(ctx, ins, attrs):
    """The LSTM over a padded batch: Input [B, T, 4D] pre-projected,
    Weight [D, 4D], optional Bias ([1, 4D], or wider with peephole
    columns, which are dropped), H0 and C0 [B, D]."""
    x, w = ins["Input"][0], ins["Weight"][0]
    d = w.shape[0]
    b = x.shape[0]
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, d))
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((b, d))
    bias = ins["Bias"][0] if ins.get("Bias") else None
    if bias is not None and bias.ndim == 2:
        bias = bias[:, :4 * d]
    is_reverse = attrs.get("is_reverse", False)
    hs, cs = [], []
    for t in _times(x, is_reverse):
        g = x[:, t] + h @ w
        if bias is not None:
            g = g + bias
        i, f, cand, o = torch.chunk(g, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cand)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    hidden = _in_time_order(hs, is_reverse)
    cell = _in_time_order(cs, is_reverse)
    return {"Hidden": [hidden], "Cell": [cell], "BatchGate": [hidden],
            "BatchCellPreAct": [cell]}

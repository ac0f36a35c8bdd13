"""Helpers of the ops' data-parallel rules (``registry.DpRule``): the
plan-time checks that an op keeps the batch axis leading, and the rank's
rows of a global value.

A rank holds rows [rank * b, (rank + 1) * b) of each batch-sharded var,
b = B / world. A row-local op keeps that block structure when the
batch stays the leading axis, so the checks below refuse attrs that
move it, contract it or cut it (a transpose whose first axis is not 0,
a split or concat on axis 0, a squeeze of axis 0).
"""

from .registry import DataParallelError, DpRule

__all__ = ["axes_exclude_batch", "refuse", "replicated_slots", "row_rule",
           "rows"]


def _ndim(v):
    shape = getattr(v, "shape", None)
    return None if shape is None else len(shape)


def refuse(op, why):
    """Raise: `op` is not row-local on a batch-sharded input."""
    raise DataParallelError(
        "op %r is not row-local on a batch-sharded input: %s"
        % (op.type, why))


def rows(t, group, dim=0):
    """The rank's block of rows of global `t` along `dim`."""
    n = t.shape[dim] // group.world
    return t.narrow(dim, group.rank * n, n)


def replicated_slots(*slots):
    """A plan check: the inputs of `slots` (weights) must be
    replicated."""
    def check(op, sharded, block):
        for s in slots:
            if any(sharded.get(s, ())):
                refuse(op, "its %s input is batch-sharded" % s)
    return check


def axes_exclude_batch(attr, default, slot="X", rank_delta=0):
    """A plan check: axis attr `attr` (an int or a list) never names the
    batch axis 0 (negative axes counted from the input's rank plus
    `rank_delta`)."""
    def check(op, sharded, block):
        axes = op.attrs.get(attr, default)
        axes = axes if isinstance(axes, (list, tuple)) else [axes]
        if not axes and default is None:
            refuse(op, "%s is empty, so it may touch the batch axis"
                    % attr)
        nd = _ndim(op.inputs[slot][0]) if op.inputs.get(slot) else None
        for a in axes:
            if a is None:
                continue
            if a < 0 and nd is not None:
                a += nd + rank_delta
            if a == 0:
                refuse(op, "%s=%r names the batch axis" % (attr, axes))
    return check


def row_rule(*checks, outs=None):
    """A row-local DpRule running `checks` at plan time; every output
    batch-sharded unless `outs` ({slot: False}) says otherwise."""
    def plan(op, sharded, block):
        for c in checks:
            c(op, sharded, block)
        return {slot: [(outs or {}).get(slot, True)] * len(vs)
                for slot, vs in op.outputs.items()}
    return DpRule(plan=plan)

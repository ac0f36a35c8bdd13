"""The Fluid step's tensor-parallel region: the planned op (`TpOp`),
the generic kernel wrapper, and the rule helpers the ops modules share
(parity: what GSPMD does for the JAX step over its (dp, tp) mesh).

A rank holds its block of each tp-sharded var: rank t of the tp line
holds block t of the sharded dim (a var's tp mark is that dim, or None
for a replicated var). An op that reads a tp-sharded var runs under its
op type's `TpRule` (``registry.tp_rule``), which gives each input one
action:

- `KEEP`: the value as the rank holds it;
- `ENTER`: a replicated operand of an op whose rank-local part covers
  only the rank's share of the output (``collective.enter_tp``: its
  grad summed over the tp line in backward);
- `NARROW + dim`: a replicated operand cut to the rank's block of
  `dim` after it enters;
- `GATHER`: the seam, the sharded value all-gathered into its
  replicated value (``collective.gather_tp``).

An op with no rule, or whose rule does not cover these marks, gathers
every sharded input and runs replicated: correct whatever the rule
coverage, at the price of the gathers (``BatchPlan.seams`` lists
them). A persistable the op writes with another mark than the plan
gives it is converted (gathered, or cut to the rank's block).
"""

from .registry import DataParallelError

__all__ = ["ENTER", "GATHER", "KEEP", "NARROW", "TpOp", "binary_plan",
           "pointwise_plan", "wrap"]

KEEP, ENTER, GATHER, NARROW = "keep", "enter", "gather", "narrow"

_FLOATS = ("float16", "bfloat16", "float32", "float64")


class TpOp:
    """One op that reads (or writes) a tp-sharded var.

    `marks` {slot: [dim or None]} its inputs' tp marks, `batch` {slot:
    [bool]} their batch marks, `tp` and `dp` the line sizes, `wanted`
    its grad op's {slot: [grad name or None]} (empty without one).
    The rule sets `actions` {slot: [action]} (``(NARROW, dim)`` for a
    narrow), `outs` {slot: [mark]} and appends to `calls` the (count
    key, bytes) of the collectives its kernel issues; `zero` is set by
    the planner for a ZeRO-1 update (the dp rows of its state)."""

    def __init__(self, op, rule, marks, batch, tp, dp, wanted, nbytes):
        self.op = op
        self.rule = rule
        self.marks = marks
        self.batch = batch
        self.tp = tp
        self.dp = dp
        self.wanted = wanted
        self._nbytes = nbytes
        self.actions = {slot: [KEEP] * len(vs)
                        for slot, vs in op.inputs.items()}
        self.outs = {slot: [None] * len(vs)
                     for slot, vs in op.outputs.items()}
        self.calls = []
        self.fix = {}
        self.zero = False
        self.seam = False
        self.row = False  # the kernel sums its output over the tp line
        self.run = None

    def var(self, slot, i=0):
        return self.op.inputs[slot][i]

    def mark(self, slot, i=0):
        ms = self.marks.get(slot)
        return ms[i] if ms and i < len(ms) else None

    def grad_wanted(self, slot, i=0):
        names = self.wanted.get(slot, ())
        return i < len(names) and names[i] is not None

    def out_bytes(self, slot, i=0, mark=None, itemsize=None):
        """The bytes of output i of `slot` as a rank holds it with tp
        mark `mark` (batch-sharded where an input is), in its dtype or
        `itemsize` bytes an element."""
        rows = any(any(ms) for ms in self.batch.values())
        return self._nbytes(self.op.outputs[slot][i], mark, rows, itemsize)

    def in_bytes(self, slot, i=0, mark=None):
        """The bytes of input i of `slot` as a rank holds it with tp
        mark `mark`."""
        return self._nbytes(self.var(slot, i), mark, self.batch[slot][i])

    def nbytes(self, v, mark, rows=False):
        return self._nbytes(v, mark, rows)

    def enter(self, slot, i=0, dim=None):
        """Input i of `slot` enters the region (narrowed to the rank's
        block of `dim` when it is given); its grad's sum is counted where
        the grad op forms it."""
        v = self.var(slot, i)
        self.actions[slot][i] = ENTER if dim is None else (NARROW, dim)
        if self.grad_wanted(slot, i) and v.dtype in _FLOATS:
            self.calls.append(("enter_tp_bwd", self.in_bytes(slot, i)))

    def reduce(self, slot="Out", i=0, mark=None):
        """The kernel sums output i of `slot` over the tp line."""
        self.calls.append(("reduce_tp", self.out_bytes(slot, i, mark)))

    def gather_all(self):
        """The seam: every sharded input gathered, outputs replicated."""
        self.seam = True
        self.calls = []
        for slot, ms in self.marks.items():
            for i, m in enumerate(ms):
                self.actions[slot][i] = GATHER if m is not None else KEEP
                if m is not None:
                    self.calls.append(("gather_tp",
                                       self.in_bytes(slot, i, m)))
        for slot in self.outs:
            self.outs[slot] = [None] * len(self.outs[slot])

    def gathered(self):
        """(var name, dim) of each input this op gathers."""
        return [(self.op.inputs[slot][i].name, self.marks[slot][i])
                for slot, acts in self.actions.items()
                for i, a in enumerate(acts) if a == GATHER]


def wrap(kernel, top):
    """`kernel` run under the planned op `top`: the inputs' actions, the
    rule's kernel (or `kernel`), then the written persistables'
    conversions."""
    from ..parallel.collective import _gather, enter_tp, gather_tp, \
        local_part

    rule = top.rule

    def impl(ctx, ins, attrs):
        g = ctx.tp
        new = {}
        for slot, ts in ins.items():
            acts = top.actions.get(slot, ())
            out = []
            for i, t in enumerate(ts):
                a = acts[i] if i < len(acts) else KEEP
                if a == GATHER:
                    t = gather_tp(t, g, top.marks[slot][i])
                elif a == ENTER:
                    t = enter_tp(t, g)
                elif a != KEEP:
                    t = local_part(enter_tp(t, g), g, a[1])
                out.append(t)
            new[slot] = out
        if rule is not None and rule.impl is not None and not top.seam:
            outs = rule.impl(ctx, new, attrs, kernel, top)
        else:
            outs = kernel(ctx, new, attrs)
        for (slot, i), (have, want) in top.fix.items():
            t = outs[slot][i]
            if have is not None:
                t = _gather(t.detach(), g, have, kind="gather_tp")
            if want is not None:
                t = local_part(t, g, want).contiguous()
            outs[slot][i] = t
        return outs

    return impl


def _ndim(v):
    shape = getattr(v, "shape", None)
    return None if shape is None else len(shape)


def pointwise_plan(slots=("X",)):
    """Elementwise in its inputs of `slots`, which share one mark (or are
    replicated and narrowed to it): every output takes that mark."""
    def plan(top):
        marks = {m for s in slots for m in top.marks.get(s, ())}
        marks.discard(None)
        if len(marks) != 1:
            return False
        d = marks.pop()
        for s in slots:
            for i, m in enumerate(top.marks.get(s, ())):
                if m is None:
                    v = top.var(s, i)
                    if _ndim(v) is None or _ndim(v) <= d:
                        return False
                    top.enter(s, i, d)
        for slot, vs in top.op.outputs.items():
            top.outs[slot] = [d] * len(vs)
        return True
    return plan


def y_dim_of(x_nd, y_nd, axis, xdim):
    """The dim of Y aligned with X's dim `xdim` under Fluid's
    elementwise broadcast (None: Y has no such dim)."""
    if axis is None or axis == -1 or y_nd == x_nd:
        axis = x_nd - y_nd
    j = xdim - axis
    return j if 0 <= j < y_nd else None


def binary_plan(top):
    """Fluid elementwise X (op) Y, Y broadcast into X from `axis`: the
    output keeps X's dims, so it takes the sharded dim; a replicated
    operand that spans that dim is narrowed to the rank's block, one
    broadcast over it enters whole."""
    x, y = top.var("X"), top.var("Y")
    mx, my = top.mark("X"), top.mark("Y")
    xn, yn = _ndim(x), _ndim(y)
    if xn is None or yn is None:
        return False
    axis = top.op.attrs.get("axis", -1)
    if mx is not None:
        j = y_dim_of(xn, yn, axis, mx)
        if my is not None and my != j:
            return False
        if my is None:
            if j is not None and y.shape[j] not in (1,):
                top.enter("Y", 0, j)
            else:
                top.enter("Y", 0)
        top.outs["Out"] = [mx]
        return True
    # X replicated, Y sharded on its dim my: X's aligned dim is cut
    d = None
    for xd in range(xn):
        if y_dim_of(xn, yn, axis, xd) == my:
            d = xd
    if d is None or x.shape[d] == 1:
        return False
    top.enter("X", 0, d)
    top.outs["Out"] = [d]
    return True


def check_divides(top, size, what):
    if size is not None and size > 0 and size % top.tp:
        raise DataParallelError(
            "op %r: %s of size %d does not divide over %d tp ranks"
            % (top.op.type, what, size, top.tp))


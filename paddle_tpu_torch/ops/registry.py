"""Op registry of the PyTorch port (parity: the JAX package's
``ops/registry.py``).

An op kernel is a plain function on torch tensors

    impl(ctx, ins, attrs) -> outs

where ins/outs map Fluid's named slots to lists of tensors. There are no
hand-written grad kernels: ``core/lowering.py`` runs a differentiable op
under autograd and its grad op asks autograd for the input grads.
``backward.py`` reads ``differentiable`` and ``nondiff_inputs``;
``LayerHelper`` reads ``stateful`` (an op that draws random numbers gets
an ``__op_seed__``).

Under data parallelism (``compiler.py``'s `_DataParallelStep`) a rank
holds only its rows of each batch-sharded var, so every op type that
may read one declares a `DpRule` (``dp_rule``) beside its kernel:
row-local (output row i reads only input row i) or a batch reduction
with its collective. The planner (``parallel/planner.py``) refuses, at
plan time and naming the op, any op that reads a batch-sharded var and
declares neither.

Under tensor parallelism a rank holds its tp shard of each var the plan
marks tp-sharded, and an op type may declare a `TpRule` (``tp_rule``)
that runs it on shards (``ops/tp.py``). An op that reads a tp-sharded
var and declares none gets that var all-gathered on its sharded dim (a
seam, listed in the plan) and runs replicated, as GSPMD would run it.
"""

import torch

_REGISTRY = {}


class OpDef:
    def __init__(self, name, impl, differentiable=True, nondiff_inputs=(),
                 stateful=False):
        self.name = name
        self.impl = impl
        self.differentiable = differentiable
        # input slots that never receive gradients (e.g. integer ids)
        self.nondiff_inputs = frozenset(nondiff_inputs)
        self.stateful = stateful
        # the DpRule of a batch-sharded input; None: the op has none
        self.dp = None
        # the TpRule of a tp-sharded input; None: the seam
        self.tp = None

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, differentiable=True, nondiff_inputs=(), stateful=False):
    """Decorator: register `impl(ctx, ins, attrs) -> outs` for op `name`."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError("op %r already registered" % name)
        _REGISTRY[name] = OpDef(name, fn, differentiable, nondiff_inputs,
                                stateful)
        return fn

    return deco


def simple_op(name, in_slots=("X",), out_slot="Out", differentiable=True,
              nondiff_inputs=(), stateful=False):
    """Register an op whose slots each carry one tensor:
    fn(ctx, *tensors, **attrs) -> one tensor bound to `out_slot`."""

    def deco(fn):
        def impl(ctx, ins, attrs):
            args = []
            for s in in_slots:
                vs = ins.get(s, [])
                args.append(vs[0] if vs else None)
            return {out_slot: [fn(ctx, *args, **attrs)]}

        register(name, differentiable, nondiff_inputs, stateful)(impl)
        return fn

    return deco


class DataParallelError(NotImplementedError):
    """An op or a write that the data-parallel step cannot run."""


class DpRule:
    """How an op runs on a rank's rows of a batch-sharded input: row-local
    (output row i reads only input row i, so the op runs on the rank's
    rows as it is), or, with `collectives`, a batch reduction (partial
    sums on the local rows, an all-reduce over the data group, the rest
    on the replicated global value).

    `plan(op, sharded, block)` checks the op's attrs and static shapes
    and returns its outputs' marks ({slot: [bool]}, True batch-sharded);
    it raises `DataParallelError` where the op is not row-local with
    these attrs (a transpose that moves the batch axis). The default
    marks every output batch-sharded.

    `impl(ctx, ins, attrs, sharded)` replaces the op's kernel under data
    parallelism (the reductions, and ops that read the global batch's
    shape or draw the global batch's random numbers); None runs the
    op's own kernel.

    `enter` (default True): a replicated float operand of the op (a
    parameter, a replicated activation) enters the sharded region:
    unchanged in forward, its grad all-reduced (SUM) in backward. An op
    whose sub-block runs planned ops of its own (`recompute`) sets it
    False, so its operands enter once, inside.

    `collectives(op, block, sharded, wanted, tp)` the (calls, bytes) of the
    all-reduces one run of the reduction issues (`wanted`: its grad op's
    {slot: [grad name or None]}, empty without one; `tp` the tp line's
    size and the op's inputs' tp marks, {slot: [dim or None]}), for the
    plan's prediction of the step's collectives."""

    def __init__(self, plan=None, impl=None, enter=True, collectives=None):
        self.plan = plan
        self.impl = impl
        self.enter = enter
        self.collectives = collectives

    def out_marks(self, op, sharded, block):
        if self.plan is not None:
            return self.plan(op, sharded, block)
        return {slot: [True] * len(vs) for slot, vs in op.outputs.items()}


ROW = DpRule()


def dp_rule(names, rule=ROW):
    """Declare `rule` the DpRule of each registered op in `names`."""
    for name in ([names] if isinstance(names, str) else names):
        get(name).dp = rule


class TpRule:
    """How an op runs on tp shards (``ops/tp.py``).

    `plan(top)` reads the planned op `top` (an ``ops.tp.TpOp``: the op,
    its inputs' tp marks, each a dim or None, and the mesh's sizes) and
    sets each input's action (keep the value as the rank holds it, enter
    the region, narrow a replicated value to the rank's block, gather),
    each output's mark and the collectives one run issues. It returns
    False where these marks are not the rule's case (the op then takes
    the seam) and raises `DataParallelError` where the op cannot run on
    them at all.

    `impl(ctx, ins, attrs, inner, top)` replaces the kernel (`inner`:
    the op's own, or its DpRule's under data parallelism); None runs
    `inner` on the inputs the actions made."""

    def __init__(self, plan, impl=None):
        self.plan = plan
        self.impl = impl


def tp_rule(names, rule):
    """Declare `rule` the TpRule of each registered op in `names`."""
    for name in ([names] if isinstance(names, str) else names):
        get(name).tp = rule


def get(name):
    od = _REGISTRY.get(name)
    if od is None:
        raise KeyError("no kernel registered for op %r in the PyTorch port "
                       "(registered: %s)" % (name, sorted(_REGISTRY)))
    return od


def has(name):
    return name in _REGISTRY


def broadcast_to_axis(y, x_ndim, axis):
    """Fluid elementwise broadcasting: align y's dims to x starting at
    `axis`; axis=-1 means trailing alignment (numpy's)."""
    if axis is None or axis == -1 or y.ndim == 0 or y.ndim == x_ndim:
        return y
    shape = (1,) * axis + tuple(y.shape) + (1,) * (x_ndim - axis - y.ndim)
    return y.reshape(shape)


def weak_scalar(x, value):
    """A Python scalar as jnp combines it with x: a low-precision float
    tensor takes it rounded to its own dtype first (bf16 * 0.7 is bf16 *
    bf16(0.7) in jnp, while torch would multiply by the fp32 0.7). The
    rounded value stays a Python float (rounded on the host: no device
    tensor, no copy to the card); torch computes the product in fp32,
    where a bf16 or fp16 value is exact, and rounds it once, as XLA
    does."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(value, dtype=x.dtype).item()
    return value

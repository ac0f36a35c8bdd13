"""The sharding planner (parity: the JAX package's ``parallel/planner.py``
`ShardingPlan` :37 and `plan_program` :91) and the step's batch and tp
plan.

`plan_program` is the JAX planner's walk, line for line: every
persistable gets a spec over the (dp, tp) mesh — explicit annotations
first (``BuildStrategy.sharding_specs``, then ``ParamAttr.shard_spec``,
with the axes the mesh lacks dropped, dims that do not divide demoted and
over-long specs truncated), else the Megatron walk (``mul`` / ``matmul``
column then row, ``conv2d`` out-channel then in-channel, ``batch_norm``'s
per-channel params, ``lookup_table`` vocab rows; elementwise ops, pools
and ``split`` carry the mark); a tp degree that shards nothing warns;
under ``ReduceStrategy.Reduce`` (``zero_sharding``, ZeRO-1) each
optimizer-state var is sharded over dp on dim 0. Specs are tuples here
(`UNCONSTRAINED` stands for ``P.UNCONSTRAINED`` in the row-parallel
seams of `ShardingPlan.constraints`); `summary()` equals the JAX plan's.

`plan_batch` is what GSPMD's propagation does for the JAX step, done
ahead of the run. It walks the program (into ``recompute`` segments) and
gives each var two marks:

- batch-sharded (each rank of the data line holds its block of rows) or
  replicated over dp. A feed whose leading dim divides by the data
  line's size is batch-sharded; a persistable is replicated; a grad var
  takes its primal's mark. An op that reads a batch-sharded var runs
  under its op type's `DpRule` (``ops/registry.py``), and the plan
  raises, naming the op, where there is none, or where a persistable
  would be written from batch-sharded rows other than through a
  reduction.
- its tp mark: the dim it is sharded on over the tp line, or None. A
  persistable takes the step's layout (the sharding plan's tp dim; an
  optimizer's state the dim of its parameter); an op that reads a
  tp-sharded var runs under its `TpRule` (``ops/tp.py``) or, without
  one, gathers it (a seam, in `BatchPlan.seams`).

The plan also predicts the collectives one step issues
(`BatchPlan.expected` for the data line's all-reduces,
`BatchPlan.expected_tp` for the tp line's calls and ZeRO's gathers).
"""

import warnings

import numpy as np

from ..core.lowering import _STRUCTURAL
from ..framework import torch_dtype
from ..ops import registry
from ..ops.registry import DataParallelError, TpRule
from ..ops.tp import TpOp

__all__ = ["BatchPlan", "DataParallelError", "ShardingPlan",
           "UNCONSTRAINED", "plan_batch", "plan_program"]

_ITEM = {}

# activation mark propagates "last dim is tp-sharded" through these
_ELEMENTWISE_FWD = {
    "relu", "gelu", "tanh", "sigmoid", "dropout", "scale", "cast",
    "elementwise_add", "elementwise_mul", "elementwise_sub", "relu6",
    "swish", "hard_swish", "leaky_relu", "elu", "pow", "square", "abs",
}

# optimizer ops: anything with a Param slot; these slots are NOT state
_NON_STATE_SLOTS = {"Param", "Grad", "LearningRate", "Input", "X"}


class _Unconstrained:
    """``P.UNCONSTRAINED``: a dim GSPMD may shard as it likes."""

    def __repr__(self):
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


class ShardingPlan:
    """specs: {persistable var name: spec tuple} (absent: replicated).
    constraints: {activation var name: spec with UNCONSTRAINED dims}, the
    row-parallel seams."""

    def __init__(self):
        self.specs = {}
        self.constraints = {}

    def spec_of(self, name):
        return self.specs.get(name, ())

    def summary(self):
        return {n: tuple(s) for n, s in sorted(self.specs.items())}


def _sanitize(spec, mesh_axes):
    """Drop axis names the step mesh doesn't have: annotations like
    (None, "tp") are inert on a dp-only mesh instead of erroring."""
    dims = []
    for d in tuple(spec):
        if d is None or d is UNCONSTRAINED:
            dims.append(d)
        elif isinstance(d, (tuple, list)):
            kept = tuple(a for a in d if a in mesh_axes)
            dims.append(kept if kept else None)
        else:
            dims.append(d if d in mesh_axes else None)
    return tuple(dims)


def _explicit_spec(var, build_strategy, mesh_axes):
    bs_specs = getattr(build_strategy, "sharding_specs", None) or {}
    if var.name in bs_specs:
        return _sanitize(tuple(bs_specs[var.name]), mesh_axes)
    ss = getattr(var, "shard_spec", None)
    if ss is not None:
        return _sanitize(tuple(ss), mesh_axes)
    return None


def _divisible(dim, n):
    return dim is not None and dim > 0 and dim % n == 0


def _op_stream(block):
    """All ops, descending into control-flow and recompute sub-blocks
    inline (sub-block vars share outer names, so marks flow through)."""
    for op in block.ops:
        for key in ("sub_block", "true_block", "false_block"):
            sub = op.attrs.get(key) if op.attrs else None
            if sub is not None and getattr(sub, "ops", None) is not None:
                yield from _op_stream(sub)
        yield op


def _axis_sizes(mesh):
    """{axis: size} of a mesh (anything with a `shape` mapping) or of a
    dict given as it is."""
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def plan_program(program, mesh, build_strategy=None, zero_sharding=False):
    """Derive a ShardingPlan for `program` over `mesh` (axes "dp" and
    optionally "tp"; a `{axis: size}` dict will do, no group needed).
    With a tp axis of size > 1, fc / embedding / conv params are given
    Megatron column / row specs unless annotated; with `zero_sharding`
    (ReduceStrategy.Reduce) optimizer-state vars are sharded over dp on
    their leading dim (ZeRO-1)."""
    plan = ShardingPlan()
    block = program.global_block()
    axis_sizes = _axis_sizes(mesh)
    mesh_axes = set(axis_sizes)
    tp = axis_sizes.get("tp", 1)
    dp = axis_sizes.get("dp", 1)
    ops = list(_op_stream(block))

    def _fit(var, spec):
        """Demote spec dims the var's static shape can't divide; specs
        longer than the var's rank truncate (annotations demote, never
        error)."""
        shape = getattr(var, "shape", None)
        if shape is None:
            return spec
        spec = tuple(spec)[:len(shape)]
        dims = []
        for i, d in enumerate(spec):
            if d is None or shape[i] is None or shape[i] < 0:
                dims.append(d)
                continue
            axes = d if isinstance(d, (tuple, list)) else (d,)
            n = 1
            for a in axes:
                n *= axis_sizes.get(a, 1)
            dims.append(d if n and shape[i] % n == 0 else None)
        return tuple(dims)

    def note(var, spec):
        if var.name not in plan.specs:
            plan.specs[var.name] = _fit(var, spec)

    def explicit(var):
        s = _explicit_spec(var, build_strategy, mesh_axes)
        if s is not None:
            plan.specs[var.name] = _fit(var, s)
            return True
        return False

    # the Megatron walk: column / row alternation along each matmul
    # chain, elementwise ops carry the "tp-sharded last dim" mark; conv
    # chains the channel-wise analogue on NCHW dim 1
    sharded_last = set()
    ch_sharded = set()
    for op in ops:
        t = op.type
        if t in ("mul", "matmul"):
            xs = op.inputs.get("X", [])
            ys = op.inputs.get("Y", [])
            if not xs or not ys:
                continue
            x, y = xs[0], ys[0]
            out = op.outputs.get("Out", [None])[0]
            if not getattr(y, "persistable", False) or y.shape is None \
                    or len(y.shape) != 2:
                continue
            if explicit(y):
                if plan.specs[y.name] and tuple(plan.specs[y.name])[-1:] \
                        == ("tp",) and out is not None:
                    sharded_last.add(out.name)
                continue
            if tp <= 1:
                continue
            if x.name not in sharded_last:
                if _divisible(y.shape[1], tp):
                    note(y, (None, "tp"))
                    if out is not None:
                        sharded_last.add(out.name)
            else:
                if _divisible(y.shape[0], tp):
                    note(y, ("tp", None))
                if out is not None and out.shape is not None:
                    nd = len(out.shape)
                    plan.constraints[out.name] = \
                        (UNCONSTRAINED,) * (nd - 1) + (None,)
        elif t == "conv2d":
            # depthwise / grouped convs stay replicated: their filter
            # layout couples both channel dims
            xs = op.inputs.get("Input", [])
            ws = op.inputs.get("Filter", [])
            out = op.outputs.get("Output", [None])[0]
            if not xs or not ws:
                continue
            x, w = xs[0], ws[0]
            if not getattr(w, "persistable", False) or w.shape is None \
                    or len(w.shape) != 4:
                continue
            if explicit(w):
                if tuple(plan.specs[w.name])[:1] == ("tp",) \
                        and out is not None:
                    ch_sharded.add(out.name)
                continue
            if tp <= 1 or (op.attrs or {}).get("groups", 1) not in (1, None):
                continue
            if x.name not in ch_sharded:
                if _divisible(w.shape[0], tp):
                    note(w, ("tp", None, None, None))
                    if out is not None:
                        ch_sharded.add(out.name)
            else:
                if _divisible(w.shape[1], tp):
                    note(w, (None, "tp", None, None))
                if out is not None and out.shape is not None:
                    nd = len(out.shape)
                    plan.constraints[out.name] = \
                        (UNCONSTRAINED, None) + (UNCONSTRAINED,) * (nd - 2)
        elif t == "batch_norm":
            xs = op.inputs.get("X", [])
            out = op.outputs.get("Y", [None])[0]
            if not xs or out is None or xs[0].name not in ch_sharded:
                continue
            for slot in ("Scale", "Bias", "Mean", "Variance"):
                for v in op.inputs.get(slot, []):
                    if getattr(v, "persistable", False) \
                            and v.shape is not None and len(v.shape) == 1 \
                            and not explicit(v) and _divisible(v.shape[0],
                                                               tp):
                        note(v, ("tp",))
            for vs in op.outputs.values():
                for v in vs:
                    if getattr(v, "persistable", False) \
                            and v.shape is not None and len(v.shape) == 1 \
                            and _divisible(v.shape[0], tp):
                        note(v, ("tp",))
            ch_sharded.add(out.name)
        elif (t == "pool2d" or t in _ELEMENTWISE_FWD) \
                and op.inputs.get("X") \
                and op.inputs["X"][0].name in ch_sharded \
                and t != "elementwise_add":
            for vs in op.outputs.values():
                for v in vs:
                    ch_sharded.add(v.name)
        elif t == "elementwise_add" and op.inputs.get("X") \
                and op.inputs.get("Y") \
                and op.inputs["X"][0].name in ch_sharded:
            y_in = op.inputs["Y"][0]
            out = op.outputs.get("Out", [None])[0]
            if getattr(y_in, "persistable", False) \
                    and y_in.shape is not None and len(y_in.shape) == 1:
                if not explicit(y_in) and tp > 1 \
                        and _divisible(y_in.shape[0], tp):
                    note(y_in, ("tp",))
                if out is not None:
                    ch_sharded.add(out.name)
            elif y_in.name in ch_sharded and out is not None:
                ch_sharded.add(out.name)
        elif t in ("lookup_table", "lookup_table_v2"):
            ws = op.inputs.get("W", [])
            if not ws:
                continue
            w = ws[0]
            if explicit(w):
                continue
            if tp > 1 and w.shape is not None and len(w.shape) == 2 \
                    and _divisible(w.shape[0], tp):
                note(w, ("tp", None))
        elif t == "elementwise_add":
            xs = op.inputs.get("X", [])
            ys = op.inputs.get("Y", [])
            out = op.outputs.get("Out", [None])[0]
            if not xs or not ys or out is None:
                continue
            x, y = xs[0], ys[0]
            if getattr(y, "persistable", False) and y.shape is not None \
                    and len(y.shape) == 1:
                if not explicit(y) and tp > 1 and x.name in sharded_last \
                        and _divisible(y.shape[0], tp):
                    note(y, ("tp",))
                if x.name in sharded_last:
                    sharded_last.add(out.name)
            elif x.name in sharded_last and y.name in sharded_last:
                sharded_last.add(out.name)
        elif t in _ELEMENTWISE_FWD:
            xs = op.inputs.get("X", [])
            out = op.outputs.get("Out", [None])[0]
            if xs and out is not None and xs[0].name in sharded_last:
                sharded_last.add(out.name)
        elif t == "split":
            xs = op.inputs.get("X", [])
            if xs and xs[0].name in sharded_last:
                for vs in op.outputs.values():
                    for v in vs:
                        sharded_last.add(v.name)

    # explicit annotations for params the walk never touched
    for op in ops:
        for vs in op.inputs.values():
            for v in vs:
                if getattr(v, "persistable", False) \
                        and v.name not in plan.specs:
                    explicit(v)

    # a tp degree that shards nothing: the user pays a tp-sliced mesh
    # for no model parallelism, so say so once
    if tp > 1 and not any(
            "tp" in (a for d in tuple(s) if d is not None
                     for a in (d if isinstance(d, (tuple, list)) else (d,)))
            for s in plan.specs.values()):
        warnings.warn(
            "tensor_parallel_degree=%d produced no tp-sharded parameters: "
            "no fc/embedding chain was auto-shardable (dims must divide "
            "tp) and no shard_spec annotation matched. The program runs "
            "correctly but fully replicated over the tp axis — annotate "
            "params via ParamAttr(shard_spec=...) or "
            "BuildStrategy.sharding_specs, or drop the tp degree." % tp,
            RuntimeWarning, stacklevel=3)

    # ZeRO-1 (Reduce mode): optimizer state sharded over dp on dim 0
    if zero_sharding and dp > 1:
        for op in ops:
            params = op.inputs.get("Param")
            if not params:
                continue
            pshape = params[0].shape
            for slot, vs in op.inputs.items():
                if slot in _NON_STATE_SLOTS:
                    continue
                for v in vs:
                    if not getattr(v, "persistable", False):
                        continue
                    if v.shape is None or len(v.shape) == 0 \
                            or tuple(v.shape) != tuple(pshape or ()):
                        continue
                    if v.shape[0] < dp:
                        continue
                    base = plan.specs.get(v.name)
                    if base is not None and len(base) > 0 \
                            and base[0] is not None:
                        continue  # dim 0 already taken (e.g. row-tp)
                    rest = tuple(base[1:]) if base else ()
                    rest = rest + (None,) * max(
                        0, len(v.shape) - 1 - len(rest))
                    plan.specs[v.name] = _fit(v, ("dp",) + rest)
    return plan


def state_layout(program, plan, tp, dp):
    """The port's layout of the persistables: ({name: tp dim} of each
    tp-sharded one, {names of the ZeRO-1 state held as dp rows}).

    A param takes its spec's "tp" dim. An optimizer's state var (a
    persistable of its param's shape in a non-param slot) takes its
    param's tp dim, so each rank updates its shard with state at the
    shard's shape; with a "dp" spec (ZeRO-1) it is also held as the
    rank's block of rows of that tp shard, where they divide. A spec
    that puts an axis the step cannot hold (a "dp" on anything but
    optimizer state, several axes on one dim, "tp" on two dims) raises."""
    layout, zero = {}, set()
    state = {}
    for op in _op_stream(program.global_block()):
        params = op.inputs.get("Param")
        if not params:
            continue
        p = params[0]
        for slot, vs in op.inputs.items():
            if slot in _NON_STATE_SLOTS:
                continue
            for v in vs:
                if getattr(v, "persistable", False) and v.shape is not None \
                        and len(v.shape) and tuple(v.shape) \
                        == tuple(p.shape or ()):
                    state[v.name] = p.name
    for name, spec in plan.specs.items():
        dims = [i for i, d in enumerate(spec) if d is not None]
        for i in dims:
            if isinstance(spec[i], (tuple, list)):
                raise DataParallelError(
                    "spec %r of %r shards one dim over several mesh axes: "
                    "the port's step does not hold it" % (spec, name))
        tps = [i for i in dims if spec[i] == "tp"]
        if len(tps) > 1:
            raise DataParallelError(
                "spec %r of %r shards two dims over tp" % (spec, name))
        if tps:
            layout[name] = tps[0]
        if "dp" in spec and name not in state:
            raise DataParallelError(
                "spec %r of %r shards a var that is not optimizer state "
                "over dp: only ReduceStrategy.Reduce's ZeRO-1 state is "
                "held as dp rows (parallel/zero.py's stages are ROADMAP.md "
                "Queue 1 item 9)" % (spec, name))
    for name, pname in state.items():
        if pname in layout and name not in layout:
            layout[name] = layout[pname]
    blk = program.global_block()
    for name, spec in plan.specs.items():
        if spec[:1] != ("dp",) or dp <= 1:
            continue
        v = blk._find_var_recursive(name)
        rows = v.shape[0] // (tp if layout.get(name) == 0 else 1)
        if rows % dp == 0:
            zero.add(name)
    return layout, zero


def _itemsize(dtype):
    if dtype not in _ITEM:
        import torch

        _ITEM[dtype] = torch.empty((), dtype=torch_dtype(dtype)) \
            .element_size()
    return _ITEM[dtype]


class PlannedOp:
    """One op that reads a batch-sharded var: its rule, its inputs'
    marks ({slot: [bool]}) and the grads its grad op forms ({slot:
    [grad name or None]}, empty without one)."""

    def __init__(self, op, rule, sharded, wanted):
        self.op = op
        self.rule = rule
        self.sharded = sharded
        self.wanted = wanted
        self.run = None  # the kernel under the rule (core/lowering.py)

    def entering(self, slot, i):
        """True where input i of `slot` is a replicated operand that
        enters the sharded region."""
        return self.rule.enter and not self.sharded[slot][i]


class BatchPlan:
    """`marks` {var name: True batch-sharded}, `ops` {id(op): PlannedOp},
    `entries` the (op, var) whose grads the backward all-reduces over
    the data line and `reductions` the ops that all-reduce in forward.
    Under tensor parallelism `tp_marks` {var name: sharded dim or None},
    `tp_ops` {id(op): ops.tp.TpOp} and `seams` the (op type, var name,
    dim) of each gather."""

    def __init__(self, world, tp=1, rows=None):
        self.world = world
        self.tp = tp
        self.rows = rows  # the global batch's rows
        self.marks = {}
        self.ops = {}
        self.entries = []
        self.reductions = []
        self.tp_marks = {}
        self.tp_ops = {}
        self.seams = []
        # a recompute segment re-runs its ops in backward, whose
        # collectives this prediction does not count
        self.remat = False

    def nbytes(self, v, mark=None, rows=None, itemsize=None):
        """The bytes of var `v` as a rank holds it: its static shape,
        the batch dim (-1) as the rank's rows (`rows`: batch-sharded;
        None reads its mark), dim `mark` over the tp line, in its dtype
        (or `itemsize` bytes an element)."""
        shape = list(v.shape or ())
        if rows is None:
            rows = self.marks.get(v.name, False)
        for i, s in enumerate(shape):
            if s is None or s < 0:
                if self.rows is None:
                    raise DataParallelError(
                        "the collective prediction needs the batch size "
                        "(var %r has an unknown dim)" % v.name)
                shape[i] = self.rows // (self.world if rows else 1)
        if mark is not None:
            shape[mark] //= self.tp
        return int(np.prod(shape)) * (itemsize or _itemsize(v.dtype))

    def _check(self):
        if self.remat:
            raise DataParallelError(
                "the collective prediction does not cover recompute "
                "segments")

    def expected(self, block):
        """(all-reduce calls, bytes) one step issues over the data line:
        a reduction's (its rule says them) and one a region entry whose
        grad the backward forms (the operand's bytes as the rank holds
        it)."""
        self._check()
        calls = nbytes = 0
        for pop in self.reductions:
            c, b = pop.rule.collectives(pop.op, block, pop.sharded,
                                        pop.wanted, tp=self._tp_of(pop.op))
            calls += c
            nbytes += b
        for _op, v in self.entries:
            calls += 1
            nbytes += self.nbytes(v, self.tp_marks.get(v.name), False)
        return calls, nbytes

    def _tp_of(self, op):
        top = self.tp_ops.get(id(op))
        return (self.tp, top.marks if top is not None else {})

    def expected_tp(self):
        """{count key: (calls, bytes)} one step issues over the tp line
        ("reduce_tp", "gather_tp", "enter_tp_bwd") and ZeRO-1's
        parameter gathers over the data line ("zero_gather")."""
        self._check()
        out = {}
        for top in self.tp_ops.values():
            for key, nb in top.calls:
                c, b = out.get(key, (0, 0))
                out[key] = (c + 1, b + nb)
        return out


_PASS = TpRule(plan=lambda top: True)  # the recompute segment's


def _sub_block_names(op):
    names = set()
    for key in ("sub_block", "true_block", "false_block"):
        sub = op.attrs.get(key) if op.attrs else None
        if sub is not None and getattr(sub, "ops", None) is not None:
            for inner in _op_stream(sub):
                names.update(inner.input_names())
                names.update(inner.output_names())
    return names


def plan_batch(program, sharded_feeds, world, tp=1, layout=None,
               zero=(), rows=None):
    """The BatchPlan of `program` with the feeds `sharded_feeds`
    batch-sharded over a data line of `world` ranks and, over a tp line
    of `tp` ranks, the persistables laid out as `layout` ({name: tp
    dim}) with the ZeRO-1 state `zero` held as dp rows. `rows`, the
    global batch's rows, sizes the collective prediction."""
    plan = BatchPlan(world, tp, rows)
    marks = plan.marks
    marks.update({n: True for n in sharded_feeds})
    layout = dict(layout or {})
    zero = set(zero)
    tmarks = plan.tp_marks
    tmarks.update(layout)
    in_marks = {}   # id(forward op) -> its inputs' marks
    in_tmarks = {}  # id(forward op) -> its inputs' tp marks
    grad_wanted = {}  # id(forward op) -> {slot: [grad name or None]}
    gblock = program.global_block()
    for op in _op_stream(gblock):
        if "__fwd_op__" in op.attrs:
            grad_wanted[id(op.attrs["__fwd_op__"])] = \
                op.attrs["__grad_in_map__"]

    def grad_marks(op):
        fwd = op.attrs["__fwd_op__"]
        fm = in_marks.get(id(fwd), {})
        ftm = in_tmarks.get(id(fwd), {})
        for slot, names in op.attrs["__grad_in_map__"].items():
            for i, g in enumerate(names):
                if g is None:
                    continue
                m = fm.get(slot, [False] * (i + 1))[i]
                if g in marks and marks[g] != m and \
                        op.attrs.get("__accumulate__", {}).get(g):
                    raise DataParallelError(
                        "grad var %r sums a batch-sharded and a "
                        "replicated contribution" % g)
                marks[g] = m
                tmarks[g] = ftm.get(slot, [None] * (i + 1))[i]

    def plan_tp(op, tin, sharded, wanted):
        """The op's TpOp: its rule's plan, else the seam; written
        persistables converted to their layout."""
        rule = registry.get(op.type).tp if registry.has(op.type) else None
        top = TpOp(op, rule, tin, sharded, tp, world, wanted, plan.nbytes)
        if op.type != "recompute" and tp > 1 and any(
                tmarks.get(n) is not None for n in _sub_block_names(op)):
            raise DataParallelError(
                "op %r runs a sub-block over tp-sharded vars: the Fluid "
                "step's tp region does not enter control flow (only "
                "recompute segments)" % op.type)
        top.zero = any(v.name in zero for vs in op.inputs.values()
                       for v in vs)
        if rule is None or not rule.plan(top):
            if top.zero:
                raise DataParallelError(
                    "op %r updates ZeRO-1 state but has no rule for it"
                    % op.type)
            top.gather_all()
        for slot, vs in op.outputs.items():
            for i, v in enumerate(vs):
                if not getattr(v, "persistable", False):
                    continue
                want = layout.get(v.name)
                have = top.outs[slot][i]
                if have != want:
                    top.fix[(slot, i)] = (have, want)
                    if have is not None:
                        top.calls.append(("gather_tp",
                                          plan.nbytes(v, have, False)))
                    top.outs[slot][i] = want
        for name, dim in top.gathered():
            plan.seams.append((op.type, name, dim))
        return top

    def walk(block):
        for op in block.ops:
            if "__fwd_op__" in op.attrs:
                grad_marks(op)
                continue
            if op.type in _STRUCTURAL:
                continue
            sharded = {slot: [marks.get(v.name, False) for v in vs]
                       for slot, vs in op.inputs.items()}
            tin = {slot: [tmarks.get(v.name) for v in vs]
                   for slot, vs in op.inputs.items()}
            any_dp = any(any(ms) for ms in sharded.values())
            any_tp = any(m is not None for ms in tin.values() for m in ms)
            writes_tp = any(getattr(v, "persistable", False)
                            and layout.get(v.name) is not None
                            for vs in op.outputs.values() for v in vs)
            wanted = grad_wanted.get(id(op), {})
            if op.type == "recompute" and (any_dp or any_tp):
                # the segment's ops are planned in place; its outputs
                # carry the marks their inner producers gave them
                walk(op.attrs["sub_block"])
                names = op.attrs["out_names"]
                outs = {"Out": [marks.get(n, False) for n in names]}
                touts = [tmarks.get(n) for n in names]
                plan.remat = True
                if any_dp:
                    pop = PlannedOp(op, registry.get(op.type).dp, sharded,
                                    wanted)
                    plan.ops[id(op)] = pop
                if any_tp:
                    top = TpOp(op, _PASS, tin, sharded, tp, world, wanted,
                               plan.nbytes)
                    plan.tp_ops[id(op)] = top
                in_marks[id(op)] = sharded
                in_tmarks[id(op)] = tin
                for v, m, tm in zip(op.outputs["Out"], outs["Out"], touts):
                    marks[v.name] = m
                    tmarks[v.name] = tm
                continue
            touts = {}
            if any_tp or writes_tp or (zero and op.inputs.get("Param")):
                top = plan_tp(op, tin, sharded, wanted)
                if any_tp or writes_tp or top.zero:
                    plan.tp_ops[id(op)] = top
                    in_tmarks[id(op)] = tin
                    touts = top.outs
            if not any_dp:
                for slot, vs in op.outputs.items():
                    for i, v in enumerate(vs):
                        marks[v.name] = False
                        tmarks[v.name] = (touts.get(slot) or
                                          [None] * len(vs))[i]
                continue
            rule = registry.get(op.type).dp \
                if registry.has(op.type) else None
            if rule is None:
                name = next(v.name for slot, vs in op.inputs.items()
                            for v, m in zip(vs, sharded[slot]) if m)
                raise DataParallelError(
                    "op %r reads the batch-sharded var %r and has no "
                    "data-parallel rule: declare one in its ops module "
                    "(registry.dp_rule) or feed its batch replicated"
                    % (op.type, name))
            outs = rule.out_marks(op, sharded, block)
            pop = PlannedOp(op, rule, sharded, wanted)
            plan.ops[id(op)] = pop
            in_marks[id(op)] = sharded
            if rule.collectives is not None:
                plan.reductions.append(pop)
            for slot, vs in op.inputs.items():
                names = wanted.get(slot, ())
                for i, v in enumerate(vs):
                    if pop.entering(slot, i) and i < len(names) \
                            and names[i] is not None \
                            and v.dtype in ("float16", "bfloat16",
                                            "float32", "float64"):
                        plan.entries.append((op, v))
            for slot, vs in op.outputs.items():
                for i, (v, m) in enumerate(
                        zip(vs, outs.get(slot, [False] * len(vs)))):
                    if m and v.persistable:
                        raise DataParallelError(
                            "op %r writes the persistable %r from "
                            "batch-sharded rows, not through a reduction: "
                            "each rank would keep its own rows"
                            % (op.type, v.name))
                    marks[v.name] = m
                    tmarks[v.name] = (touts.get(slot) or
                                      [None] * len(vs))[i]

    walk(gblock)
    return plan

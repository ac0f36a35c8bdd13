"""The data-parallel planner (parity: the JAX package's
``parallel/planner.py`` `ShardingPlan` :37 and the dp part of
`plan_program` :91).

`plan_program` gives every persistable its placement: on the port's
data mesh every persistable is replicated, and `ShardingPlan.summary()`
has the JAX plan's keys (each annotated parameter, its ``shard_spec``
with the axes the mesh lacks dropped). The tp walk and ZeRO's
``zero_sharding`` raise, naming ROADMAP.md Queue 1 item 9.

`plan_batch` is what GSPMD's propagation does for the JAX step, done
ahead of the run: it walks the program (into ``recompute`` segments)
and marks each var batch-sharded (each rank holds its block of rows)
or replicated. A feed whose leading dim divides by the world size is
batch-sharded; a persistable is replicated; a grad var takes its
primal's mark. An op that reads a batch-sharded var runs under its
op type's `DpRule` (``ops/registry.py``), and the plan raises, naming
the op, where there is none, or where a persistable would be written
from batch-sharded rows other than through a reduction. The plan also
predicts the collectives one step issues (`BatchPlan.expected`).
"""

import numpy as np

from ..core.lowering import _STRUCTURAL
from ..framework import torch_dtype
from ..ops import registry
from ..ops.registry import DataParallelError

__all__ = ["BatchPlan", "DataParallelError", "ShardingPlan", "plan_batch",
           "plan_program"]

_ITEM = {}


class ShardingPlan:
    """specs: {persistable var name: spec tuple} (absent: replicated)."""

    def __init__(self):
        self.specs = {}

    def summary(self):
        return {n: tuple(s) for n, s in sorted(self.specs.items())}


def _op_stream(block):
    """All ops, descending into control-flow and recompute sub-blocks."""
    for op in block.ops:
        for key in ("sub_block", "true_block", "false_block"):
            sub = op.attrs.get(key) if op.attrs else None
            if sub is not None and getattr(sub, "ops", None) is not None:
                yield from _op_stream(sub)
        yield op


def plan_program(program, mesh, build_strategy=None, zero_sharding=False):
    """The ShardingPlan of `program` over the data mesh: every
    persistable replicated; each annotated one keeps its annotation with
    the mesh's absent axes dropped, as the JAX planner records it."""
    axes = dict(mesh.shape)
    if any(n != "dp" and s > 1 for n, s in axes.items()):
        raise DataParallelError(
            "the planner's tp walk is not ported (ROADMAP.md Queue 1 "
            "item 9)")
    if zero_sharding:
        raise DataParallelError(
            "ReduceStrategy.Reduce (ZeRO optimizer-state sharding, "
            "parallel/zero.py) is not ported (ROADMAP.md Queue 1 item 9)")
    if getattr(build_strategy, "sharding_specs", None):
        raise DataParallelError(
            "BuildStrategy.sharding_specs is not ported (ROADMAP.md "
            "Queue 1 item 9)")
    plan = ShardingPlan()
    for op in _op_stream(program.global_block()):
        for vs in op.inputs.values():
            for v in vs:
                ss = getattr(v, "shard_spec", None)
                if not getattr(v, "persistable", False) or ss is None \
                        or v.name in plan.specs:
                    continue
                dims = [d if d in axes else None for d in tuple(ss)]
                shape = getattr(v, "shape", None)
                if shape is not None:
                    dims = dims[:len(shape)]
                plan.specs[v.name] = tuple(dims)
    return plan


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
    `entries` the (op, var) whose grads the backward all-reduces and
    `reductions` the ops that all-reduce in forward."""

    def __init__(self, world):
        self.world = world
        self.marks = {}
        self.ops = {}
        self.entries = []
        self.reductions = []
        # a recompute segment re-runs its ops in backward, whose
        # collectives this prediction does not count
        self.remat = False

    def expected(self, block):
        """(all-reduce calls, bytes) one step issues: a reduction's (its
        rule says them) and one a region entry whose grad the backward
        forms (the operand's bytes)."""
        if self.remat:
            raise DataParallelError(
                "the collective prediction does not cover recompute "
                "segments")
        calls = nbytes = 0
        for pop in self.reductions:
            c, b = pop.rule.collectives(pop.op, block, pop.sharded,
                                        pop.wanted)
            calls += c
            nbytes += b
        for _op, v in self.entries:
            calls += 1
            nbytes += int(np.prod(v.shape)) * _itemsize(v.dtype)
        return calls, nbytes


def plan_batch(program, sharded_feeds, world):
    """The BatchPlan of `program` with the feeds `sharded_feeds`
    batch-sharded over `world` ranks."""
    plan = BatchPlan(world)
    marks = plan.marks
    marks.update({n: True for n in sharded_feeds})
    in_marks = {}   # id(forward op) -> its inputs' marks
    grad_wanted = {}  # id(forward op) -> {slot: [grad name or None]}
    gblock = program.global_block()
    for op in _op_stream(gblock):
        if "__fwd_op__" in op.attrs:
            grad_wanted[id(op.attrs["__fwd_op__"])] = \
                op.attrs["__grad_in_map__"]

    def walk(block):
        for op in block.ops:
            if "__fwd_op__" in op.attrs:
                fwd = op.attrs["__fwd_op__"]
                fm = in_marks.get(id(fwd), {})
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
                continue
            if op.type in _STRUCTURAL:
                continue
            sharded = {slot: [marks.get(v.name, False) for v in vs]
                       for slot, vs in op.inputs.items()}
            if not any(any(ms) for ms in sharded.values()):
                for vs in op.outputs.values():
                    for v in vs:
                        marks[v.name] = False
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
            if op.type == "recompute":
                # the segment's ops are planned in place; its outputs
                # carry the marks their inner producers gave them
                walk(op.attrs["sub_block"])
                outs = {"Out": [marks.get(n, False)
                                for n in op.attrs["out_names"]]}
                plan.remat = True
            else:
                outs = rule.out_marks(op, sharded, block)
            wanted = grad_wanted.get(id(op), {})
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
                for v, m in zip(vs, outs.get(slot, [False] * len(vs))):
                    if m and v.persistable:
                        raise DataParallelError(
                            "op %r writes the persistable %r from "
                            "batch-sharded rows, not through a reduction: "
                            "each rank would keep its own rows"
                            % (op.type, v.name))
                    marks[v.name] = m

    walk(gblock)
    return plan

"""Program-pass infrastructure (parity: the JAX package's ``ir.py``
`Pass`, `register_pass`, `unregister_pass`, `get_pass`,
`registered_passes`, `apply_passes` :34-120, the op-chain matcher
`match_chain` :123-180, the DAG matcher `Pattern` :182-328 and the
passes `ConvBNFoldPass` :329, `DropoutRemovePass` :369-430 and
`ConvResidualAddFusePass` :432-506).

A pass rewrites a program in place (bumping its version when it changes
ops) and returns it; ``scope`` carries the materialized values for
passes that read or bake weights. Registered here: ``conv_bn_fold``,
``dropout_remove`` and ``conv_elementwise_add_fuse`` (the inference
predictor runs the three at load time); ``ir_passes.py`` registers
``fetch_dce``, ``cse`` and ``constant_fold``, ``amp.py``
``amp_rewrite`` and ``quant.py`` ``quant_rewrite``. The JAX package's
verifier hook (``PTPU_VERIFY_PASSES``) and ``memory_optimize`` are not
ported.

    @fluid.ir.register_pass("my_fold")
    class MyFold(fluid.ir.Pass):
        def apply(self, program, scope=None):
            for a, b in fluid.ir.match_chain(
                    program.global_block(), ("mul", "elementwise_add")):
                ...
    fluid.ir.apply_passes(program, ["my_fold"], scope)
"""

from .core.scope import global_scope

__all__ = ["Pass", "register_pass", "unregister_pass", "get_pass",
           "apply_passes", "registered_passes", "match_chain", "Pattern"]


class Pass:
    """One program transform: subclass and implement `apply`."""

    name = None

    def apply(self, program, scope=None):
        raise NotImplementedError

    def __call__(self, program, scope=None):
        return self.apply(program, scope)


_REGISTRY = {}


def register_pass(name):
    """Decorator registering a Pass subclass (or a plain
    ``fn(program, scope)``) under `name`; a duplicate name raises
    (`unregister_pass` frees a name deliberately)."""
    def deco(obj):
        if name in _REGISTRY:
            raise ValueError(
                "pass %r already registered; unregister_pass(%r) first "
                "to replace it deliberately" % (name, name))
        if isinstance(obj, type) and issubclass(obj, Pass):
            inst = obj()
        else:
            fn = obj

            class _FnPass(Pass):
                def apply(self, program, scope=None):
                    return fn(program, scope)

            inst = _FnPass()
        inst.name = name
        _REGISTRY[name] = inst
        return obj

    return deco


def unregister_pass(name):
    """Remove a registered pass (tests, deliberate replacement)."""
    _REGISTRY.pop(name, None)


def get_pass(name):
    if name not in _REGISTRY:
        raise KeyError("no pass registered under %r (have: %s)"
                       % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]


def registered_passes():
    return sorted(_REGISTRY)


def apply_passes(program, names, scope=None):
    """Run the named passes in order over `program`."""
    scope = scope if scope is not None else global_scope()
    for name in names:
        get_pass(name).apply(program, scope)
    return program


def _consumers(block):
    cons = {}
    for op in block.ops:
        for n in op.input_names():
            cons.setdefault(n, []).append(op)
    return cons


def match_chain(block, types, single_consumer=True):
    """Yield op lists [o1, ..., ok] with o1.type..ok.type == types, where
    each o_{j+1} consumes an output var of o_j (dataflow adjacency). With
    single_consumer every linking var has exactly one consuming op.
    Matches come in program order and never share an op; the op list and
    consumer map are snapshotted when iteration starts."""
    cons = _consumers(block)
    order = {id(op): i for i, op in enumerate(block.ops)}
    claimed = set()
    for op in list(block.ops):
        if op.type != types[0] or id(op) in claimed:
            continue
        chain = [op]
        ok = True
        for want in types[1:]:
            cur = chain[-1]
            nxt = None
            for out_name in cur.output_names():
                users = [u for u in cons.get(out_name, [])
                         if id(u) in order]
                if single_consumer and len(users) != 1:
                    continue
                for u in users:
                    if (u.type == want and id(u) not in claimed
                            and order[id(u)] > order[id(cur)]):
                        nxt = u
                        break
                if nxt is not None:
                    break
            if nxt is None:
                ok = False
                break
            chain.append(nxt)
        if ok:
            claimed.update(id(o) for o in chain)
            yield chain


class _Edge:
    __slots__ = ("src", "dst", "dst_slot", "src_slot", "single_consumer")

    def __init__(self, src, dst, dst_slot, src_slot, single_consumer):
        self.src, self.dst = src, dst
        self.dst_slot, self.src_slot = dst_slot, src_slot
        self.single_consumer = single_consumer


class Pattern:
    """Declarative op-DAG pattern: named nodes and dataflow edges.

        p = fluid.ir.Pattern()
        p.op("conv", "conv2d")
        p.op("add", "elementwise_add")
        p.edge("conv", "add", dst_slot="X")
        for m in p.match(block):            # {"conv": op, "add": op}
            ...

    A node's `type` is one op type or a tuple of them; `pred(op)` adds a
    test. An edge means some output var of `src` (of `src_slot` if given)
    is an input var of `dst` (of `dst_slot` if given); with
    single_consumer that var has exactly one consuming op in the block.
    Matches come in program order of the first-declared node, never
    share an op, and see a snapshot of the op list."""

    def __init__(self):
        self._nodes = {}   # name -> (types tuple or None, pred or None)
        self._order = []
        self._edges = []

    def op(self, name, type=None, pred=None):
        if name in self._nodes:
            raise ValueError("pattern node %r already defined" % name)
        types = (type,) if isinstance(type, str) else \
            (tuple(type) if type is not None else None)
        self._nodes[name] = (types, pred)
        self._order.append(name)
        return name

    def edge(self, src, dst, dst_slot=None, src_slot=None,
             single_consumer=True):
        for n in (src, dst):
            if n not in self._nodes:
                raise ValueError("pattern node %r not defined" % n)
        self._edges.append(_Edge(src, dst, dst_slot, src_slot,
                                 single_consumer))
        return self

    def _topo(self):
        """Pattern nodes in dependency order (edge sources first),
        insertion order breaking ties; a cycle raises."""
        indeg = {n: 0 for n in self._order}
        for e in self._edges:
            indeg[e.dst] += 1
        out = []
        ready = [n for n in self._order if indeg[n] == 0]
        while ready:
            n = ready.pop(0)
            out.append(n)
            for e in self._edges:
                if e.src == n:
                    indeg[e.dst] -= 1
                    if indeg[e.dst] == 0:
                        ready.append(e.dst)
        if len(out) != len(self._order):
            raise ValueError("pattern has a cycle")
        return out

    def match(self, block):
        ops = list(block.ops)
        order = {id(op): i for i, op in enumerate(ops)}
        cons = _consumers(block)
        topo = self._topo()
        claimed = set()

        def link_ok(e, src_op, dst_op):
            outs = src_op.output_names(e.src_slot) if e.src_slot \
                else src_op.output_names()
            ins = dst_op.input_names(e.dst_slot) if e.dst_slot \
                else dst_op.input_names()
            link = set(outs) & set(ins)
            if e.single_consumer:
                link = {n for n in link
                        if len([u for u in cons.get(n, [])
                                if id(u) in order]) == 1}
            return bool(link)

        def node_ok(name, op, assign):
            types, pred = self._nodes[name]
            if types is not None and op.type not in types:
                return False
            if id(op) in claimed:
                return False
            if any(o is op for o in assign.values()):
                return False  # injective
            if pred is not None and not pred(op):
                return False
            return all(link_ok(e, assign[e.src], op)
                       for e in self._edges
                       if e.dst == name and e.src in assign)

        def extend(assign, k):
            if k == len(topo):
                yield dict(assign)
                return
            name = topo[k]
            in_edges = [e for e in self._edges
                        if e.dst == name and e.src in assign]
            if in_edges:
                e0 = in_edges[0]
                src_op = assign[e0.src]
                outs = src_op.output_names(e0.src_slot) if e0.src_slot \
                    else src_op.output_names()
                seen, cands = set(), []
                for vn in outs:
                    for u in cons.get(vn, []):
                        if id(u) in order and id(u) not in seen:
                            seen.add(id(u))
                            cands.append(u)
            else:
                cands = ops
            for op in sorted(cands, key=lambda o: order[id(o)]):
                if not node_ok(name, op, assign):
                    continue
                assign[name] = op
                yield from extend(assign, k + 1)
                del assign[name]

        for m in extend({}, 0):
            if any(id(op) in claimed for op in m.values()):
                continue
            claimed.update(id(op) for op in m.values())
            yield m


@register_pass("conv_bn_fold")
class ConvBNFoldPass(Pass):
    """Fold batch_norm into the conv2d before it, editing the weights in
    `scope` (``transpiler/inference_transpiler.py`` `_fold_bn_weights`).
    Patterns: conv2d -> elementwise_add(bias) -> batch_norm, then
    conv2d -> batch_norm. A match whose params are not in the scope is
    skipped."""

    def apply(self, program, scope=None):
        from .transpiler.inference_transpiler import _fold_bn_weights

        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        changed = False
        # conv feeds the add's X slot (the bias rides Y), bn reads the add
        p = Pattern()
        p.op("conv", "conv2d")
        p.op("add", "elementwise_add")
        p.op("bn", "batch_norm")
        p.edge("conv", "add", dst_slot="X")
        p.edge("add", "bn", dst_slot="X")
        for m in p.match(block):
            conv, add, bn = m["conv"], m["add"], m["bn"]
            if _fold_bn_weights(conv, bn, scope, add.input_names("Y")[0]):
                add.outputs["Out"] = bn.outputs["Y"]
                block.ops.remove(bn)
                changed = True
        for conv, bn in match_chain(block, ("conv2d", "batch_norm")):
            if _fold_bn_weights(conv, bn, scope, None):
                conv.outputs["Output"] = bn.outputs["Y"]
                block.ops.remove(bn)
                changed = True
        if changed:
            program._bump_version()
        return program


@register_pass("dropout_remove")
class DropoutRemovePass(Pass):
    """Remove inference-identity dropout ops, rewiring consumers; the
    downgrade_in_infer variant becomes a scale op. The pipeline
    schedules it for every inference program."""

    def apply(self, program, scope=None):
        from .framework import Operator
        from .ir_passes import _fetch_targets, _outside_reads

        block = program.global_block()
        # a fetched or sub-block-read dropout output keeps a producer (an
        # identity scale); renaming needs single assignment
        protected = set(_fetch_targets(program) or ()) \
            | _outside_reads(program)
        writes = {}
        for blk in program.blocks:
            for op in blk.ops:
                for n in op.output_names():
                    writes[n] = writes.get(n, 0) + 1
        new_ops = []
        rename = {}
        changed = False
        for op in block.ops:
            if op.type == "dropout":
                changed = True
                src = op.inputs["X"][0]
                src = rename.get(src.name, src)  # chained dropouts
                impl = op.attrs.get("dropout_implementation",
                                    "downgrade_in_infer")
                if impl == "upscale_in_train":
                    outs = op.outputs.get("Out", [])
                    if any(v.name in protected
                           or writes.get(v.name, 0) != 1
                           for v in outs) \
                            or writes.get(src.name, 0) > 1:
                        new_ops.append(Operator(
                            block, "scale", inputs={"X": [src]},
                            outputs={"Out": [outs[0]]},
                            attrs={"scale": 1.0}))
                        continue
                    for outv in outs:
                        rename[outv.name] = src
                    continue
                p = op.attrs.get("dropout_prob", 0.5)
                new_ops.append(Operator(
                    block, "scale", inputs={"X": [src]},
                    outputs={"Out": [op.outputs["Out"][0]]},
                    attrs={"scale": 1.0 - p}))
                continue
            for slot, vs in op.inputs.items():
                op.inputs[slot] = [rename.get(v.name, v) for v in vs]
            new_ops.append(op)
        block.ops = new_ops
        if changed:
            program._bump_version()
        return program


@register_pass("conv_elementwise_add_fuse")
class ConvResidualAddFusePass(Pass):
    """conv2d + a same-shape elementwise_add (the residual) [+ relu] ->
    one conv2d_fusion carrying ResidualData. A bias-style add (a 1-D Y)
    is left for conv_bn_fold; a match whose interior outputs are fetched
    or read by a sub-block is left alone."""

    def apply(self, program, scope=None):
        from .framework import Operator
        from .ir_passes import _fetch_targets, _outside_reads

        block = program.global_block()
        protected = set(_fetch_targets(program) or ()) \
            | _outside_reads(program)

        def _same_shape_residual(op):
            # an axis-broadcast add (a bias) is not a residual:
            # conv2d_fusion adds ResidualData element-wise
            xs, ys = op.inputs.get("X", []), op.inputs.get("Y", [])
            if len(ys) != 1 or not xs:
                return False
            xshape = getattr(xs[0], "shape", None)
            yshape = getattr(ys[0], "shape", None)
            return (xshape is not None and yshape is not None
                    and tuple(xshape) == tuple(yshape))

        changed = False
        for with_act in (True, False):  # the longest pattern first
            p = Pattern()
            p.op("conv", "conv2d")
            p.op("add", "elementwise_add", pred=_same_shape_residual)
            p.edge("conv", "add", dst_slot="X")
            if with_act:
                p.op("act", "relu")
                p.edge("add", "act", dst_slot="X")
            for m in p.match(block):
                conv, add = m["conv"], m["add"]
                last = m["act"] if with_act else add
                interior = [o for o in (conv, add, m.get("act"))
                            if o is not None and o is not last]
                if any(n in protected for o in interior
                       for n in o.output_names()):
                    continue
                fused_ins = {"Input": conv.inputs["Input"],
                             "Filter": conv.inputs["Filter"],
                             "ResidualData": add.inputs["Y"]}
                if conv.inputs.get("FoldedBias"):
                    # the shift a conv+bn fold left: conv2d_fusion adds
                    # Bias before the residual and the activation, the
                    # order the unfused ops ran in
                    fused_ins["Bias"] = conv.inputs["FoldedBias"]
                fused = Operator(
                    block, "conv2d_fusion", inputs=fused_ins,
                    outputs={"Output": last.outputs["Out"]},
                    attrs=dict(conv.attrs,
                               activation="relu" if with_act
                               else "identity"))
                # at the last op's place: every input is produced by then
                block.ops[block.ops.index(last)] = fused
                for o in (conv, add):
                    if o is not last:
                        block.ops.remove(o)
                changed = True
        if changed:
            program._bump_version()
        return program


@register_pass("memory_optimize")
def _memory_optimize_pass(program, scope):
    """The lifetime analysis with its reuse plan annotated on the program
    (``transpiler/memory_optimization_transpiler.memory_optimize``; the
    step's own memory plan and PyTorch's allocator do the reuse). Bumps
    the version, so the pipeline keeps the annotated clone."""
    from .transpiler.memory_optimization_transpiler import memory_optimize

    memory_optimize(program)
    program._bump_version()
    return program

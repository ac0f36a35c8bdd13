"""Program-pass infrastructure (parity: the JAX package's ``ir.py``
`Pass`, `register_pass`, `unregister_pass`, `get_pass`,
`registered_passes`, `apply_passes` :34-120, the op-chain matcher
`match_chain` :123-180 and `DropoutRemovePass` :369-430).

A pass rewrites a program in place (bumping its version when it changes
ops) and returns it; ``scope`` carries the materialized values for
passes that read or bake weights. Registered here: ``dropout_remove``;
``ir_passes.py`` registers ``fetch_dce``, ``cse`` and
``constant_fold``, ``amp.py`` ``amp_rewrite`` and ``quant.py``
``quant_rewrite``. The JAX package's verifier hook
(``PTPU_VERIFY_PASSES``) is not ported.

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
           "apply_passes", "registered_passes", "match_chain"]


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


@register_pass("dropout_remove")
class DropoutRemovePass(Pass):
    """Remove inference-identity dropout ops, rewiring consumers; the
    downgrade_in_infer variant becomes a scale op. The port has no
    dropout op yet, so on its programs the pass changes nothing; the
    pipeline schedules it for every inference program."""

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

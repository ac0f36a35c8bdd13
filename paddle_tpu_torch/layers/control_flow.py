"""Control-flow layers (parity: the JAX package's
``layers/control_flow.py``: `increment` :37, the sub-block bookkeeping
:76-138 and `recompute` :193-270).

A sub-block is a real nested Block of the Program (`parent_idx`); the op
that owns it lists every outer var the sub-block reads as an input (slot
"X", names in attr `x_names`), so backward, the executor's state plan
and the passes see through it. Not ported yet: While, cond, Switch,
IfElse, StaticRNN and DynamicRNN.
"""

import contextlib

from .. import framework
from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["increment", "recompute"]


def increment(x, value=1.0, in_place=True):
    """x += value."""
    helper = LayerHelper("increment", **locals())
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    out.shape = x.shape
    return out


# ---------------------------------------------------------------------------
# sub-block bookkeeping
# ---------------------------------------------------------------------------

_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


def _block_reads_writes(block):
    """(outer-read names, parent-visible write names) of a sub-block
    tree, each in first-seen order."""
    reads, writes = [], []
    seen_r, seen_w = set(), set()

    def visit(b, local_names):
        for op in b.ops:
            for vs in op.inputs.values():
                for v in vs:
                    if v.name not in local_names and v.name not in seen_r:
                        seen_r.add(v.name)
                        reads.append(v.name)
            for battr in _BLOCK_ATTRS:
                sub = op.attrs.get(battr)
                if isinstance(sub, framework.Block):
                    visit(sub, local_names | set(sub.vars))
            for vs in op.outputs.values():
                for v in vs:
                    if v.name not in local_names and v.name not in seen_w:
                        seen_w.add(v.name)
                        writes.append(v.name)

    visit(block, set(block.vars))
    return reads, writes


@contextlib.contextmanager
def _sub_block():
    prog = default_main_program()
    blk = prog._create_block()
    try:
        yield blk
    finally:
        prog._rollback()


@contextlib.contextmanager
def _in_parent_block():
    """Append ops to the parent of the current (sub-)block meanwhile."""
    prog = default_main_program()
    cur = prog.current_block_idx
    parent = prog.blocks[cur].parent_idx
    if parent < 0:
        yield
        return
    prog.current_block_idx = parent
    try:
        yield
    finally:
        prog.current_block_idx = cur


def recompute(fn, *args):
    """Run `fn(*args)` as a rematerialized segment: the forward keeps
    only the segment's inputs, and the backward re-runs the segment from
    them to form its grads, so the activations inside it do not stay
    alive between the two passes.

    `fn` builds layers as usual and returns a Variable or a tuple of
    Variables; parameters created inside land in the global block and
    get their grads through the segment:

        h = layers.recompute(encoder_layer, h)
    """
    parent = default_main_program().current_block()
    with _sub_block() as blk:
        outs = fn(*args)
    single = not isinstance(outs, (list, tuple))
    out_list = [outs] if single else list(outs)
    for v in out_list:
        if not isinstance(v, framework.Variable):
            raise TypeError("recompute(fn): fn must return Variable(s), "
                            "got %r" % (v,))
    reads, writes = _block_reads_writes(blk)
    # an output fn returns unchanged (an outer var the segment never
    # produced) goes around the op: a parent output of the same name would
    # clobber the outer var, and the op could not produce it
    produced = set(writes)
    passthrough = {}
    for i, v in enumerate(out_list):
        if v.name not in produced:
            outer = parent._find_var_recursive(v.name)
            if outer is not None:
                passthrough[i] = outer
    routed = [v for i, v in enumerate(out_list) if i not in passthrough]
    out_names = [v.name for v in routed]
    x_names = [n for n in dict.fromkeys(reads)
               if n not in out_names
               and parent._find_var_recursive(n) is not None]
    # a segment's writes leave it only through its outputs: an in-place
    # write to an outer var would bypass the checkpoint
    for n in writes:
        if n not in out_names and parent._find_var_recursive(n) is not None:
            raise ValueError(
                "recompute(fn): fn writes outer var %r in place; return it "
                "from fn instead so the gradient flows through the "
                "checkpointed segment" % n)
    out_vars = [parent.create_var(name=v.name, shape=v.shape, dtype=v.dtype)
                for v in routed]
    if routed:
        parent.append_op(
            type="recompute",
            inputs={"X": [parent.var(n) for n in x_names]},
            outputs={"Out": out_vars},
            attrs={"sub_block": blk, "x_names": x_names,
                   "out_names": out_names})
    routed_iter = iter(out_vars)
    final = [passthrough[i] if i in passthrough else next(routed_iter)
             for i in range(len(out_list))]
    return final[0] if single else tuple(final)

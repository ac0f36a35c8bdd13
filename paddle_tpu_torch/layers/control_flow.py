"""Control-flow layers (parity: the JAX package's
``layers/control_flow.py``: `increment` :37, `Print` :47, `is_empty` :61,
the sub-block bookkeeping :76-138, `While` :140, `recompute` :193,
`_append_cond_op` :271, `cond` :304, `Switch` :345, `IfElse` :390,
`StaticRNN` :448, `DynamicRNN` :565 and the tensor arrays :630-682;
`tensor_array_to_tensor` is its ``layers/extras.py`` :275).

A sub-block is a real nested Block of the Program (`parent_idx`); the op
that owns it lists every outer var the sub-block reads as an input (slot
"X", names in attr `x_names`), so backward, the executor's state plan
and the passes see through it. The ops are ``ops/controlflow.py``'s.
"""

import contextlib

from .. import framework
from ..framework import default_main_program
from ..layer_helper import LayerHelper
from . import nn as nn_layers
from . import tensor as tensor_layers

__all__ = [
    "While", "Switch", "IfElse", "StaticRNN", "DynamicRNN", "cond",
    "increment", "array_write", "array_read", "array_length", "create_array",
    "tensor_array_to_tensor", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "Print", "is_empty", "recompute",
]

# the compare layers live in nn.py; Fluid exports them from here too
less_than = nn_layers.less_than
less_equal = nn_layers.less_equal
greater_than = nn_layers.greater_than
greater_equal = nn_layers.greater_equal
equal = nn_layers.equal
not_equal = nn_layers.not_equal


def increment(x, value=1.0, in_place=True):
    """x += value."""
    helper = LayerHelper("increment", **locals())
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    out.shape = x.shape
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print `input` when the op runs (the message, then the tensor);
    returns it unchanged."""
    helper = LayerHelper("print", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or input.name})
    out.shape = input.shape
    return out


def is_empty(x, cond=None):
    """A bool [1]: whether x has no elements."""
    helper = LayerHelper("is_empty", **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    cond.shape = (1,)
    return cond


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


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------


class While:
    """Fluid While:

        cond = layers.less_than(i, n)
        loop = layers.While(cond)
        with loop.block():
            ...                       # ops writing i and cond in place

    The loop reads its condition on the host before every trip. With
    `max_trip_count=N` it runs at most N trips (and warns when the
    condition still holds then) and is differentiable: its grad comes
    from the generic grad op over the recorded trips, which is the grad
    of the JAX op's N masked scan steps. Without it append_backward
    refuses a gradient through the loop, as the JAX package does."""

    def __init__(self, cond, is_test=False, name=None,
                 max_trip_count=None):
        self.cond_var = cond
        self.max_trip_count = max_trip_count
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        parent = default_main_program().current_block()
        with _sub_block() as blk:
            yield
        reads, writes = _block_reads_writes(blk)
        cond_name = self.cond_var.name
        # the inputs: every outer var the body reads or writes
        x_names = [n for n in dict.fromkeys(reads + writes)
                   if n != cond_name and parent._find_var_recursive(n)]
        out_names = [n for n in writes
                     if n != cond_name and parent._find_var_recursive(n)]
        carry_names = list(out_names)
        if cond_name not in carry_names:
            carry_names.append(cond_name)
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var],
                    "X": [parent.var(n) for n in x_names]},
            outputs={"Out": [parent.var(n) for n in out_names]},
            attrs={"sub_block": blk, "x_names": x_names,
                   "out_names": out_names, "carry_names": carry_names,
                   "cond_name": cond_name,
                   "max_trip_count": self.max_trip_count})


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


# ---------------------------------------------------------------------------
# cond / Switch / IfElse
# ---------------------------------------------------------------------------


def _append_cond_op(parent, pred, true_block, false_block, out_names):
    """Append a `cond` op over the two branch blocks. Its inputs are the
    branches' outer reads and each written outer var that holds a value
    before the op (a persistable, or one an op outside the branches last
    wrote): the value a branch that does not write it passes through."""
    reads = []
    for blk in (true_block, false_block):
        if blk is not None:
            r, w = _block_reads_writes(blk)
            reads += r
            for n in w:
                v = parent._find_var_recursive(n)
                if v is None:
                    continue
                producer = getattr(v, "op", None)
                if v.persistable or (
                        producer is not None
                        and producer.block not in (true_block, false_block)):
                    reads.append(n)
    x_names = [n for n in dict.fromkeys(reads)
               if n != pred.name and parent._find_var_recursive(n)]
    parent.append_op(
        type="cond",
        inputs={"Cond": [pred], "X": [parent.var(n) for n in x_names]},
        outputs={"Out": [parent.var(n) for n in out_names]},
        attrs={"true_block": true_block, "false_block": false_block,
               "x_names": x_names, "out_names": out_names})


def cond(pred, true_fn=None, false_fn=None, name=None):
    """The functional conditional: run `true_fn`'s ops when `pred` (a
    bool [1]) holds, else `false_fn`'s; returns the taken branch's
    outputs (a var or a list). Both functions return the same number of
    vars."""
    helper = LayerHelper("cond", name=name)
    parent = default_main_program().current_block()

    def build(fn):
        if fn is None:
            return None, None
        with _sub_block() as blk:
            ret = fn()
        rets = ret if isinstance(ret, (list, tuple)) else (
            [] if ret is None else [ret])
        return blk, list(rets)

    true_block, true_rets = build(true_fn)
    false_block, false_rets = build(false_fn)
    n_out = max(len(true_rets or []), len(false_rets or []))
    if (true_rets is not None and false_rets is not None
            and len(true_rets) != len(false_rets)):
        raise ValueError("cond branches must return the same number of vars")
    outs = []
    for i in range(n_out):
        proto = (true_rets or false_rets)[i]
        out = parent.create_var(name=helper.name + ".out%d" % i,
                                dtype=proto.dtype, shape=proto.shape)
        outs.append(out)
        # each branch assigns its result into the shared output var
        for blk, rets in ((true_block, true_rets), (false_block, false_rets)):
            if blk is not None and rets:
                blk.append_op(type="assign", inputs={"X": [rets[i]]},
                              outputs={"Out": [out]})
    _append_cond_op(parent, pred, true_block, false_block,
                    [o.name for o in outs])
    if not outs:
        return None
    return outs[0] if n_out == 1 else outs


class Switch:
    """The first case whose condition holds runs (the learning-rate
    schedules' multiway branch):

        with switch.case(cond1): ...assign...
        with switch.default():   ...assign...

    A chain of `cond` ops, each guarded by a running not-yet-matched
    flag."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._matched = None  # bool var: some earlier case held

    @contextlib.contextmanager
    def case(self, condition):
        parent = default_main_program().current_block()
        if self._matched is None:
            eff = condition
        else:
            eff = nn_layers.logical_and(
                condition, nn_layers.logical_not(self._matched))
        with _sub_block() as blk:
            yield
        _reads, writes = _block_reads_writes(blk)
        out_names = [n for n in writes if parent._find_var_recursive(n)]
        _append_cond_op(parent, eff, blk, None, out_names)
        self._matched = condition if self._matched is None else \
            nn_layers.logical_or(self._matched, condition)

    @contextlib.contextmanager
    def default(self):
        parent = default_main_program().current_block()
        if self._matched is None:
            raise ValueError("Switch.default() before any case()")
        pred = nn_layers.logical_not(self._matched)
        with _sub_block() as blk:
            yield
        _reads, writes = _block_reads_writes(blk)
        out_names = [n for n in writes if parent._find_var_recursive(n)]
        _append_cond_op(parent, pred, blk, None, out_names)


class IfElse:
    """The row-partitioned conditional: Fluid splits the batch by a bool
    mask, runs each block on its rows and merges them. Here both bodies
    run on the whole batch in the parent block and the outputs merge row
    by row (`select_rowwise`): the same result for the row-independent
    bodies IfElse takes, with static shapes."""

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._true_pending = []
        self._false_pending = []
        self._pending = None

    @contextlib.contextmanager
    def true_block(self):
        self._pending = self._true_pending
        yield
        self._pending = None

    @contextlib.contextmanager
    def false_block(self):
        self._pending = self._false_pending
        yield
        self._pending = None

    def input(self, x):
        return x

    def output(self, *outs):
        if self._pending is None:
            raise ValueError("IfElse.output() outside true/false block")
        self._pending.extend(outs)

    def __call__(self):
        t_outs, f_outs = self._true_pending, self._false_pending
        if len(t_outs) != len(f_outs):
            raise ValueError("IfElse branches must output the same vars")
        outs = []
        for t, f in zip(t_outs, f_outs):
            helper = LayerHelper("select")
            sel = helper.create_variable_for_type_inference(t.dtype)
            helper.append_op(type="select_rowwise",
                             inputs={"Cond": [self.cond], "X": [t],
                                     "Y": [f]},
                             outputs={"Out": [sel]})
            sel.shape = t.shape
            outs.append(sel)
        return outs if len(outs) != 1 else outs[0]


# ---------------------------------------------------------------------------
# StaticRNN / DynamicRNN: the `recurrent` op
# ---------------------------------------------------------------------------


class StaticRNN:
    """A time-major recurrence: step inputs are sliced on axis 0,
    memories carry across steps, step outputs stack on axis 0.

    remat=True rematerializes the step body in the backward (the forward
    keeps each step's incoming memories; ``core/lowering.py``): with
    stacked per-layer weights as step inputs, a layer stack whose
    activations do not stay alive between the passes."""

    def __init__(self, name=None, remat=False):
        self.remat = remat
        self.helper = LayerHelper("static_rnn", name=name)
        self._step_inputs = []   # (outer var, inner var)
        self._memories = []      # (pre var, boot var)
        self._mem_post = {}
        self._step_outputs = []
        self._blk = None

    @contextlib.contextmanager
    def step(self):
        with _sub_block() as blk:
            self._blk = blk
            yield

    def step_input(self, x):
        blk = default_main_program().current_block()
        inner = blk.create_var(
            name=self.helper.name + ".in%d" % len(self._step_inputs),
            dtype=x.dtype,
            shape=tuple(x.shape[1:]) if x.shape else None)
        self._step_inputs.append((x, inner))
        return inner

    def static_input(self, x):
        """An input every step sees unchanged: the recurrent op already
        reads every outer var of the body through its X slot."""
        return x

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32"):
        blk = default_main_program().current_block()
        if init is None:
            if shape is None:
                raise ValueError("StaticRNN.memory needs init or shape")
            with _in_parent_block():
                init = tensor_layers.fill_constant(
                    shape=list(shape), dtype=dtype, value=value)
        pre = blk.create_var(
            name=self.helper.name + ".mem%d" % len(self._memories),
            dtype=init.dtype, shape=init.shape)
        self._memories.append((pre, init))
        return pre

    def update_memory(self, mem, var):
        self._mem_post[mem.name] = var

    def step_output(self, o):
        self._step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        parent = default_main_program().current_block()
        blk = self._blk
        reads, _writes = _block_reads_writes(blk)
        inner_names = ({i.name for _, i in self._step_inputs}
                       | {p.name for p, _ in self._memories})
        x_names = [n for n in reads
                   if n not in inner_names and parent._find_var_recursive(n)]
        T = None
        for outer, _ in self._step_inputs:
            if outer.shape:
                T = outer.shape[0]
                break
        outs = [parent.create_var(
            name=self.helper.name + ".out%d" % i, dtype=o.dtype,
            shape=(T,) + tuple(o.shape or ()) if T else None)
            for i, o in enumerate(self._step_outputs)]
        finals = [parent.create_var(
            name=self.helper.name + ".final%d" % i, dtype=pre.dtype,
            shape=pre.shape) for i, (pre, _) in enumerate(self._memories)]
        mem_pairs = []
        for pre, _boot in self._memories:
            post = self._mem_post.get(pre.name)
            if post is None:
                raise ValueError("memory %s never updated" % pre.name)
            mem_pairs.append((pre.name, post.name))
        # final_memories[i]: the i-th memory() after the last step
        self.final_memories = finals
        parent.append_op(
            type="recurrent",
            inputs={"StepInputs": [o for o, _ in self._step_inputs],
                    "Boot": [b for _, b in self._memories],
                    "X": [parent.var(n) for n in x_names]},
            outputs={"StepOutputs": outs, "FinalMemories": finals},
            attrs={"sub_block": blk,
                   "step_input_names": [i.name for _, i in self._step_inputs],
                   "memory_names": mem_pairs,
                   "step_output_names": [o.name for o in self._step_outputs],
                   "x_names": x_names, "max_len": T,
                   "remat": self.remat})
        return outs if len(outs) != 1 else outs[0]


class DynamicRNN:
    """A variable-length recurrence over batch-major padded input
    [B, T, ...] with per-row lengths in place of LoD: a transpose in,
    StaticRNN, `SeqLen` on the recurrent op (a row whose sequence has
    ended keeps its memory and outputs zeros) and a transpose out."""

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._rnn = StaticRNN(name=(name or "") + "_drnn")
        self._seq_len = None

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            yield

    def step_input(self, x, sequence_length=None):
        if sequence_length is not None:
            self._seq_len = sequence_length
        # batch-major [B, T, ...] -> time-major [T, B, ...]
        perm = list(range(len(x.shape or (0, 0))))
        perm[0], perm[1] = perm[1], perm[0]
        with _in_parent_block():
            xt = nn_layers.transpose(x, perm=perm)
        return self._rnn.step_input(xt)

    def static_input(self, x):
        return self._rnn.static_input(x)

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               need_reorder=False):
        return self._rnn.memory(init=init, shape=shape, value=value,
                                dtype=dtype)

    def update_memory(self, mem, var):
        self._rnn.update_memory(mem, var)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self):
        parent = default_main_program().current_block()
        ret = self._rnn()
        op = parent.ops[-1]
        assert op.type == "recurrent"
        if self._seq_len is not None:
            op.inputs["SeqLen"] = [self._seq_len]
        rets = ret if isinstance(ret, (list, tuple)) else [ret]
        outs = []
        for r in rets:
            perm = list(range(len(r.shape or (0, 0))))
            perm[0], perm[1] = perm[1], perm[0]
            outs.append(nn_layers.transpose(r, perm=perm))
        return outs if len(outs) != 1 else outs[0]


# ---------------------------------------------------------------------------
# tensor arrays (a run-time value is a Python list of tensors)
# ---------------------------------------------------------------------------


def create_array(dtype):
    """An empty tensor array var."""
    helper = LayerHelper("array")
    v = default_main_program().current_block().create_var(
        name=helper.name, dtype=dtype, shape=None, persistable=False)
    v.is_tensor_array = True
    return v


def array_write(x, i, array=None):
    """The array with x at index i (i an int [1]); a new array when
    `array` is None."""
    helper = LayerHelper("array_write", **locals())
    ins = {"X": [x], "I": [i]}
    if array is None:
        array = create_array(x.dtype)
    else:
        ins["ArrayIn"] = [array]  # earlier writes survive
    helper.append_op(type="array_write", inputs=ins,
                     outputs={"Out": [array]})
    # the element shape for array_read, while the writes agree on it
    if getattr(x, "shape", None) is not None:
        if getattr(array, "shape", None) in (None, x.shape):
            array.shape = x.shape
            array.dtype = x.dtype
        else:
            array.shape = None
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", **locals())
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="array_read", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    if getattr(array, "shape", None) is not None:
        out.shape = array.shape
    return out


def array_length(array):
    helper = LayerHelper("array_length", **locals())
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    out.shape = (1,)
    return out


def tensor_array_to_tensor(input, axis=1, name=None):
    """The array's tensors concatenated along `axis`, and their sizes
    along it (int32)."""
    helper = LayerHelper("tensor_array_to_tensor", **locals())
    out = helper.create_variable_for_type_inference(
        dtype=input.dtype if hasattr(input, "dtype") else "float32")
    index = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="tensor_array_to_tensor", inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [index]},
                     attrs={"axis": axis})
    return out, index

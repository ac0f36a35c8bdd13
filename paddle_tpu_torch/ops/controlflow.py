"""Control-flow ops (parity: the JAX package's ``ops/controlflow.py``:
`increment` :27, `print` :32, `select_rowwise` :40, the tensor arrays
:62-138, `while` :151, `recompute` :282, `cond` :311 and `recurrent`
:334).

Each op that owns a sub-block lists every outer var the sub-block reads
as an input (slot "X", names in attr `x_names`), so backward, the
executor's state plan and the passes see through it. The JAX package
re-traces a sub-block inside ``lax.while_loop`` / ``lax.cond`` /
``lax.scan``; eager PyTorch runs it op by op (``run_sub_block``) in the
caller's grad mode, so a recorded op (one with a grad op) has autograd
record the whole loop or branch, and its grad comes from the generic
grad op. Two things are read on the host, one device-to-host sync each:

- `cond` reads its predicate and runs one branch, as ``lax.cond`` does
  (both branches run and one selected would run a GradientMerge update
  on every step);
- `while` reads its condition before every trip. With
  `max_trip_count` it stops after that many trips and warns when the
  condition still holds (the JAX op's masked scan truncates there too).

``host_syncs`` counts them by op type; ``reset_counts()`` zeroes it.

`recurrent` runs its steps over axis 0 of the step inputs. With
`remat=True` and a grad op in the program it takes the lowering of
``core/lowering.py``: the forward keeps each step's incoming carry and
no graph, and the grad op replays the steps in reverse.

A tensor array is a Python list of tensors: eager PyTorch needs no
fixed-capacity buffer (the JAX package's ``TensorArrayBuf`` is how a
traced loop carries one), so an array holds exactly what was written.
"""

import warnings

import torch

from .registry import DpRule, dp_rule, register, simple_op, weak_scalar

# device-to-host reads of a predicate, by op type
host_syncs = {"cond": 0, "while": 0}


def reset_counts():
    for k in host_syncs:
        host_syncs[k] = 0


def _read_predicate(t, kind):
    host_syncs[kind] += 1
    return bool(t.reshape(()).item())


@simple_op("increment")
def _increment(ctx, x, step=1.0, **_):
    # the step in x's dtype, as jnp.asarray(step, x.dtype) (an int64
    # counter stays int64), as a Python number: no copy to the card
    if not x.is_floating_point():
        return x + int(step)
    return x + weak_scalar(x, step)


@register("print", differentiable=False)
def _print(ctx, ins, attrs):
    x = ins["In"][0]
    print((attrs.get("message", "") or "") + " " + str(x), flush=True)
    return {"Out": [x]}


@register("is_empty", differentiable=False)
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.tensor([x.numel() == 0], device=x.device)]}


@register("select_rowwise")
def _select_rowwise(ctx, ins, attrs):
    """IfElse's row merge: out[b] = cond[b] ? x[b] : y[b]."""
    c = ins["Cond"][0]
    x, y = ins["X"][0], ins["Y"][0]
    c = c.to(torch.bool).reshape((-1,) + (1,) * (x.ndim - 1))
    return {"Out": [torch.where(c, x, y)]}


# ---------------------------------------------------------------------------
# tensor arrays: Python lists of tensors
# ---------------------------------------------------------------------------


def _index(i):
    return int(i.reshape(()).item())


@register("array_write", differentiable=False)
def _array_write(ctx, ins, attrs):
    """A copy of the array with x at index i (grown with None slots)."""
    arr = list(ins.get("ArrayIn", [None])[0] or [])
    i = _index(ins["I"][0])
    while len(arr) <= i:
        arr.append(None)
    arr[i] = ins["X"][0]
    return {"Out": [arr]}


@register("array_read", differentiable=False)
def _array_read(ctx, ins, attrs):
    return {"Out": [ins["X"][0][_index(ins["I"][0])]]}


@register("array_length", differentiable=False)
def _array_length(ctx, ins, attrs):
    return {"Out": [torch.tensor([len(ins["X"][0])], dtype=torch.int32,
                                 device=ctx.device)]}


@register("tensor_array_to_tensor", differentiable=False)
def _tensor_array_to_tensor(ctx, ins, attrs):
    """Concat (or with `use_stack`, stack) the array's tensors along
    `axis`; OutIndex holds each element's size along it."""
    elems = list(ins["X"][0])
    axis = attrs.get("axis", 1)
    if attrs.get("use_stack", False):
        out = torch.stack(elems, dim=axis)
        sizes = [1] * len(elems)
    else:
        out = torch.cat(elems, dim=axis)
        sizes = [a.shape[axis] for a in elems]
    return {"Out": [out], "OutIndex": [torch.tensor(
        sizes, dtype=torch.int32, device=out.device)]}


# ---------------------------------------------------------------------------
# while / cond / recompute / recurrent
# ---------------------------------------------------------------------------


def _env_of(ins, attrs):
    return dict(zip(attrs["x_names"], ins.get("X", [])))


def _walk(block):
    """The ops of `block` and of the sub-blocks they own."""
    for op in block.ops:
        yield op
        for key in ("sub_block", "true_block", "false_block"):
            sub = op.attrs.get(key)
            if sub is not None:
                yield from _walk(sub)


@register("while", nondiff_inputs=("Condition",))
def _while(ctx, ins, attrs):
    """Run the sub-block while the condition holds, carrying
    `carry_names` (the body's parent-visible writes and the condition).
    A tensor array written in a loop with no `max_trip_count` is
    refused, as the JAX op refuses it (its buffer needs a capacity)."""
    from ..core.lowering import run_sub_block

    block = attrs["sub_block"]
    carry_names = list(attrs["carry_names"])
    cond_name = attrs["cond_name"]
    env = _env_of(ins, attrs)
    env[cond_name] = ins["Condition"][0]
    max_trip = attrs.get("max_trip_count")
    if not max_trip:
        written = {n for op in _walk(block) if op.type == "array_write"
                   for n in op.output_names("Out")}
        for name, val in env.items():
            if isinstance(val, list) and name in written:
                raise RuntimeError(
                    "While writes tensor array %r but has no "
                    "max_trip_count: the in-graph array buffer needs a "
                    "static capacity. Build the loop as "
                    "layers.While(cond, max_trip_count=N)" % name)
    trips = 0
    while _read_predicate(env[cond_name], "while"):
        if max_trip and trips == int(max_trip):
            warnings.warn("While loop truncated: condition still true "
                          "after max_trip_count=%d steps" % int(max_trip))
            break
        local = dict(env)
        run_sub_block(block, local, ctx)
        env.update((n, local[n]) for n in carry_names)
        trips += 1
    return {"Out": [env[n] for n in attrs["out_names"]]}


@register("recompute")
def _recompute(ctx, ins, attrs):
    """The segment's sub-block over its inputs. Run this way (an
    inference program, or a segment nested in another's re-run) it keeps
    whatever the caller's grad mode keeps; a `recompute` op with a grad
    op in the program takes the lowering of ``core/lowering.py``: the
    forward keeps only its inputs and the grad op re-runs the segment."""
    from ..core.lowering import run_sub_block

    local = dict(zip(attrs["x_names"], ins.get("X", [])))
    run_sub_block(attrs["sub_block"], local, ctx)
    return {"Out": [local[n] for n in attrs["out_names"]]}


@register("cond")
def _cond(ctx, ins, attrs):
    """Read the predicate and run that branch; an output the branch does
    not write passes its incoming value through. A branch's writes reach
    the parent only through the op's outputs, as the JAX op's lax.cond
    returns only `out_names`: an input the branch writes but the op does
    not list (an optimizer's moments in a GradientMerge update block) is
    copied first, so the update ops' in-place writes stay in the
    branch."""
    from ..core.lowering import run_sub_block

    taken = _read_predicate(ins["Cond"][0], "cond")
    block = attrs["true_block"] if taken else attrs.get("false_block")
    local = _env_of(ins, attrs)
    if block is not None:
        kept = set(attrs["out_names"])
        for n in {n for op in _walk(block) for n in op.output_names()} - kept:
            val = local.get(n)
            if isinstance(val, torch.Tensor):
                local[n] = val.clone()
        run_sub_block(block, local, ctx)
    return {"Out": [local[n] for n in attrs["out_names"]]}


def recurrent_step(block, env, attrs, carry, xs_t, t, seq_len, ctx):
    """One step of the recurrence: the sub-block over the closure `env`,
    the step inputs' slices `xs_t` and the incoming memories `carry`, in
    the caller's grad mode. Returns (new memories, step outputs); with
    `seq_len`, a row whose sequence has ended (t >= its length) keeps
    its memory and outputs zeros."""
    from ..core.lowering import run_sub_block

    mem_pairs = attrs["memory_names"]
    local = dict(env)
    local.update(zip(attrs["step_input_names"], xs_t))
    local.update(zip([p for p, _ in mem_pairs], carry))
    run_sub_block(block, local, ctx)
    new = [local[q] for _, q in mem_pairs]
    ys = [local[n] for n in attrs["step_output_names"]]
    if seq_len is not None:
        alive = t < seq_len.reshape(-1)

        def rows(v):
            return alive.reshape((-1,) + (1,) * (v.ndim - 1))

        new = [torch.where(rows(n), n, c) for n, c in zip(new, carry)]
        ys = [torch.where(rows(y), y, torch.zeros_like(y)) for y in ys]
    return new, ys


def recurrent_order(ins, attrs):
    """The step indices in the order the recurrence runs them."""
    xs = ins.get("StepInputs", [])
    T = xs[0].shape[0] if xs else int(attrs["max_len"])
    order = range(T)
    return list(reversed(order)) if attrs.get("is_reverse") else list(order)


def run_recurrent(ctx, ins, attrs, carries=None):
    """Scan the sub-block over axis 0 of `StepInputs` from the `Boot`
    memories; `carries`, when a list, receives each step's incoming
    memories. Returns the op's outputs: the stacked step outputs and the
    final memories."""
    block = attrs["sub_block"]
    env = _env_of(ins, attrs)
    xs = ins.get("StepInputs", [])
    seq_len = ins.get("SeqLen", [None])[0]
    carry = list(ins.get("Boot", []))
    order = recurrent_order(ins, attrs)
    ys_at = [None] * len(order)
    for t in order:
        if carries is not None:
            carries.append(carry)
        carry, ys_at[t] = recurrent_step(block, env, attrs, carry,
                                         [x[t] for x in xs], t, seq_len,
                                         ctx)
    outs = [torch.stack([ys[k] for ys in ys_at])
            for k in range(len(attrs["step_output_names"]))]
    return {"StepOutputs": outs, "FinalMemories": carry}


@register("recurrent")
def _recurrent(ctx, ins, attrs):
    """StaticRNN's op: the sub-block scanned over the leading (time)
    axis. Slots: StepInputs (time-major [T, ...]), Boot (the initial
    memories), X (the closure), SeqLen (optional per-row lengths);
    attrs: step_input_names, memory_names ([pre, post] pairs),
    step_output_names, x_names, sub_block, max_len (the length when no
    step input gives it), is_reverse and remat."""
    return run_recurrent(ctx, ins, attrs)


# a recompute segment's ops are planned one by one (parallel/planner.py):
# its operands enter the sharded region inside, at the op that combines
# them with batch-sharded rows
dp_rule("recompute", DpRule(enter=False))

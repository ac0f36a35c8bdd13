"""Runs a program block op by op in eager PyTorch (parity: the JAX
package's ``core/lowering.py`` `execute_block` :116, `execute_op` :143,
and the generic grad op `_grad_apply` :299 / `_execute_grad_op` :400).

The JAX package traces the whole block into one function, and its grad
op re-runs the forward op inside ``jax.vjp``, leaving XLA to merge the
two copies. Eager PyTorch cannot merge them, so the port records the
forward instead of re-running it:

- a forward op that has a grad op in the program runs under autograd on
  its inputs detached into fresh leaves, so its graph is local to the op;
  the context keeps those leaves and the op's outputs (the counterpart of
  the JAX context's `fwd_snapshots`);
- its grad op calls ``torch.autograd.grad`` on the outputs that carry a
  cotangent and writes the leaves' grads into the grad vars, summing
  duplicate contributions as `__accumulate__` says.

Every other op runs under ``torch.no_grad()``. So the flash-attention
backward kernel is reached through its autograd Function, and no forward
runs twice, except inside a ``recompute`` segment (``_SPECIAL``, the
eager form of the JAX op's ``jax.checkpoint``): its forward runs the
sub-block under ``no_grad`` and keeps only the segment's inputs; its grad
op re-runs the sub-block from those inputs, detached into fresh leaves,
under ``enable_grad``, and asks autograd for the leaves' grads. Stateful
ops draw from generators seeded by (program seed, step, op seed), so the
re-run redraws the forward's dropout masks.

A recorded ``recurrent`` op with ``remat=True`` (``StaticRNN(remat=True)``,
the eager form of the JAX op's ``jax.checkpoint`` of its scan step) runs
its steps under ``no_grad`` and keeps only each step's incoming carry
(``_scan_forward``); its grad op replays the steps in reverse
(``_scan_grad``): step t re-runs from its kept carry, detached into fresh
leaves, under ``enable_grad``, and autograd takes the cotangents of its
new carry and its outputs back to the carry, the step inputs' slice t and
the closure. Only one step's graph is alive at a time. Without ``remat``
the op takes the generic record: autograd records the whole loop.

Under data parallelism (``compiler.py``'s `_DataParallelStep`) the
context carries the data group (`dp`, the counterpart of the JAX
context's ``data_axis``) and the batch plan's ops (`dp_ops`, from
``parallel/planner.py``). An op that reads a batch-sharded var runs
under its `DpRule`: its replicated float operands enter the sharded
region (``parallel/collective.enter_sharded``) inside the recorded
forward, so the grad op's ``torch.autograd.grad`` all-reduces their
grads and writes them whole; a reduction's own kernel all-reduces its
partial sums. Under tensor parallelism the context also carries the tp
line (`tp`) and the plan's tp ops (`tp_ops`): an op that reads a
tp-sharded var runs its kernel (its DpRule's under data parallelism)
inside its `TpRule`'s wrapper (``ops/tp.py``), and the batch region's
entries come first, on the values the rank holds.

While a ``profiler`` session is open (``set_op_ranges``), every op,
forward and grad, runs inside ``record_function("fluid/" +
_op_scope_name(op))``, the range ``profiler.device_op_profile`` gives
its CUDA kernels to.
"""

import torch

from ..observability import metrics as _obs_metrics
from ..ops import registry

__all__ = ["LoweringContext", "execute_block", "execute_op", "set_op_ranges"]

# while a ``profiler`` session is open every op runs inside a
# record_function("fluid/<op scope name>") range; with none open an op
# enters no range
_OP_RANGES = False


def set_op_ranges(on):
    """Turn the per-op ``fluid/`` profiler ranges on or off (the
    ``profiler`` session's switch)."""
    global _OP_RANGES
    _OP_RANGES = bool(on)


def _op_scope_name(op):
    """Stable profiler identity of one program op: its type plus its
    first output var, sanitized — the JAX package's ``_op_scope_name``,
    so the device table's rows name the ops the JAX package's do."""
    out = ""
    for vs in op.outputs.values():
        if vs:
            out = vs[0].name
            break
    name = "%s__%s" % (op.type, out) if out else op.type
    return "".join(c if (c.isalnum() or c in "_.-") else "_" for c in name)

# op types that the JAX package's executor runs outside the traced step
# (feeds, readers, RPC); the port runs none. Program passes leave them
# and the ops of `_SPECIAL` alone (quant.py's site scan reads both, as
# the JAX package's does).
_STRUCTURAL = frozenset({
    "feed", "fetch", "read", "double_buffer", "create_py_reader", "data",
    "depend", "send", "recv", "send_barrier", "fetch_barrier",
    "listen_and_serv", "checkpoint_notify", "gen_nccl_id"})


class LoweringContext:
    """What op kernels see of the run: the device, per-op random
    generators, and the forward ops recorded for their grad ops."""

    def __init__(self, device, seed=0, step=0, recorded=frozenset()):
        self.device = device
        self.seed = int(seed)
        self.step = int(step)
        # ids of forward ops whose grad op is in the block
        self.recorded = recorded
        self.fwd = {}  # id(forward op) -> (input leaves, outputs)
        # data parallelism: the DataGroup, {id(op): PlannedOp}, and the
        # backward seed's factor (BuildStrategy.GradientScaleStrategy)
        self.dp = None
        self.dp_ops = {}
        self.grad_seed_scale = 1.0
        # tensor parallelism: the tp line and {id(op): ops.tp.TpOp}
        self.tp = None
        self.tp_ops = {}
        # the pipeline's microbatch stream (parallel/pipeline_program.py:
        # dp rank * microbatches + microbatch), mixed into the generators
        # so each microbatch draws its own masks; None outside it
        self.stream = None

    def generator(self, attrs):
        """A torch.Generator for one stateful op: seeded from the
        program's random_seed, the step counter, the op's seed and the
        pipeline's microbatch stream, so runs repeat and steps (and
        microbatches) differ."""
        op_seed = attrs.get("__op_seed__")
        if op_seed is None:
            op_seed = attrs.get("seed", 0) or 0
        mixed = (self.seed * 1000003 + self.step) * 1000003 + int(op_seed)
        if self.stream is not None:
            mixed = mixed * 1000003 + self.stream
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mixed & 0x7FFFFFFFFFFFFFFF)
        return gen


def execute_block(block, env, ctx, free_after=None):
    """Run every op of `block` over env (name -> tensor). `free_after`
    maps an op index to the names env may drop once that op has run.
    With metrics on, ``lowering/blocks_traced`` and ``ops_traced`` count
    the blocks and ops lowered (the JAX package counts them once a
    trace; the port lowers eagerly, so once a run)."""
    if _obs_metrics.enabled():
        _obs_metrics.counter("lowering/blocks_traced").inc()
        _obs_metrics.counter("lowering/ops_traced").inc(len(block.ops))
    with torch.no_grad():
        for i, op in enumerate(block.ops):
            execute_op(op, env, ctx)
            for name in (free_after or {}).get(i, ()):
                env.pop(name, None)
    return env


def run_sub_block(block, env, ctx):
    """Run a sub-block's ops over env in the caller's grad mode: each
    inner op is called straight, so under ``enable_grad`` autograd
    records the whole sub-block."""
    for op in block.ops:
        execute_op(op, env, ctx)
    return env


def _value(env, v):
    val = env.get(v.name)
    if val is None:
        if getattr(v, "is_tensor_array", False):
            return []  # an array no op has written yet is empty
        if v.is_data:
            raise KeyError("feed %r is missing: the program reads it but "
                           "run() was not given it" % v.name)
        raise KeyError("var %r has no value: no op before its first use "
                       "produced it" % v.name)
    return val


def execute_op(op, env, ctx):
    if _OP_RANGES:
        with torch.profiler.record_function("fluid/" + _op_scope_name(op)):
            _execute_op(op, env, ctx)
    else:
        _execute_op(op, env, ctx)


def _execute_op(op, env, ctx):
    if "__fwd_op__" in op.attrs:
        _execute_grad_op(op, env, ctx)
        return
    if id(op) in ctx.recorded and op.type in _SPECIAL:
        _SPECIAL[op.type][0](op, env, ctx)
        return
    if id(op) in ctx.recorded and _remat_scan(op):
        _scan_forward(op, env, ctx)
        return
    opdef = registry.get(op.type)
    ins = {slot: [_value(env, v) for v in vs]
           for slot, vs in op.inputs.items() if vs}
    impl = opdef.impl
    planned = ctx.dp_ops.get(id(op)) if ctx.dp_ops else None
    tplanned = ctx.tp_ops.get(id(op)) if ctx.tp_ops else None
    if planned is not None or tplanned is not None:
        holder = tplanned if tplanned is not None else planned
        if holder.run is None:
            holder.run = _planned_impl(opdef, planned, tplanned)
        impl = holder.run
    if id(op) in ctx.recorded:
        leaves = {
            slot: [t.detach().requires_grad_()
                   if slot not in opdef.nondiff_inputs
                   and t.is_floating_point() else t for t in ts]
            for slot, ts in ins.items()}
        with torch.enable_grad():
            outs = impl(ctx, leaves, op.attrs)
        ctx.fwd[id(op)] = (leaves, outs)
        outs = {slot: [t.detach() for t in ts] for slot, ts in outs.items()}
    else:
        outs = impl(ctx, ins, op.attrs)
    for slot, vs in op.outputs.items():
        for v, val in zip(vs, outs.get(slot, ())):
            env[v.name] = val


def _planned_impl(opdef, planned, tplanned):
    """The op's kernel under its plans: its DpRule's kernel (or its
    own), run on tp shards under its TpRule (``ops/tp.py``), with its
    replicated float operands entering the batch-sharded region first."""
    from ..ops.tp import wrap
    from ..parallel.collective import enter_sharded

    kernel = opdef.impl
    if planned is not None and planned.rule.impl is not None:
        rule, sharded = planned.rule, planned.sharded

        def kernel(ctx, ins, attrs):
            return rule.impl(ctx, ins, attrs, sharded)
    if tplanned is not None:
        kernel = wrap(kernel, tplanned)
    if planned is None:
        return kernel

    def impl(ctx, ins, attrs):
        ins = {slot: [enter_sharded(t, ctx.dp)
                      if planned.entering(slot, i) else t
                      for i, t in enumerate(ts)]
               for slot, ts in ins.items()}
        return kernel(ctx, ins, attrs)

    return impl


def _execute_grad_op(op, env, ctx):
    """The generic grad op: autograd over the graph its forward op
    recorded, with the upstream cotangents of the outputs that have one;
    the grads land in env, accumulated where `__accumulate__` says."""
    fwd = op.attrs["__fwd_op__"]
    rec = ctx.fwd.pop(id(fwd), None)
    if rec is None:
        raise RuntimeError("grad op %s: its forward op %s was not recorded "
                           "in this run" % (op.type, fwd.type))
    if _remat_scan(fwd):
        _scan_grad(op, fwd, rec, ctx, env)
        return
    if fwd.type in _SPECIAL:
        leaves, outs = _SPECIAL[fwd.type][1](op, fwd, rec, ctx)
    else:
        leaves, outs = rec
    _apply_grads(op, leaves, outs, env)


def _apply_grads(op, leaves, outs, env):
    """Autograd from the outputs `outs` (slot -> tensors) that carry a
    cotangent in env back to the `leaves` (slot -> tensors) the grad op
    names, the grads written into env."""
    gout_map = op.attrs["__grad_out_map__"]
    gin_map = op.attrs["__grad_in_map__"]

    live, cots = [], []
    for out_slot, cot_slot in op.attrs["__cot_slots__"].items():
        idxs = [i for i, g in enumerate(gout_map[out_slot]) if g is not None]
        for i, gvar in zip(idxs, op.inputs[cot_slot]):
            g = env.get(gvar.name)
            out = outs.get(out_slot, [None] * (i + 1))[i]
            if g is None or out is None or not out.requires_grad:
                continue  # a dead cotangent, or an output off the graph
            live.append(out)
            cots.append(g.to(out.dtype))
    if not live:
        return
    targets = [(gname, leaf) for slot, names in gin_map.items()
               for gname, leaf in zip(names, leaves.get(slot, ()))
               if gname is not None and leaf.requires_grad]
    if not targets:
        return
    grads = torch.autograd.grad(live, [leaf for _, leaf in targets], cots,
                                allow_unused=True)
    produced = {}
    for (gname, leaf), g in zip(targets, grads):
        if g is None:  # the leaf does not reach a live output
            g = torch.zeros_like(leaf)
        produced[gname] = produced[gname] + g if gname in produced else g
    _write_grads(op, produced, env)


def _write_grads(op, produced, env):
    """Write each grad var's value into env, summed into what is there
    where `__accumulate__` says."""
    accumulate = op.attrs.get("__accumulate__", {})
    for gname, g in produced.items():
        if gname in env and accumulate.get(gname):
            env[gname] = env[gname] + g
        else:
            env[gname] = g


# ---------------------------------------------------------------------------
# recompute: the rematerialized segment (the JAX op's jax.checkpoint)
# ---------------------------------------------------------------------------


def _recompute_forward(op, env, ctx):
    """Run the segment under no_grad; keep only its input tensors."""
    xs = [_value(env, v) for v in op.inputs.get("X", [])]
    with torch.no_grad():
        outs = registry.get(op.type).impl(ctx, {"X": xs}, op.attrs)
    ctx.fwd[id(op)] = xs
    for v, val in zip(op.outputs["Out"], outs["Out"]):
        env[v.name] = val


def _recompute_replay(op, fwd, xs, ctx):
    """Re-run the segment from its kept inputs, those that take a grad
    detached into fresh leaves, under enable_grad: (leaves, outputs) for
    the generic grad step."""
    names = op.attrs["__grad_in_map__"].get("X", [None] * len(xs))
    leaves = [x.detach().requires_grad_()
              if g is not None and x.is_floating_point() else x
              for x, g in zip(xs, names)]
    with torch.enable_grad():
        outs = registry.get(fwd.type).impl(ctx, {"X": leaves}, fwd.attrs)
    return {"X": leaves}, outs


# op type -> (forward of a recorded op, the grad op's replay)
_SPECIAL = {"recompute": (_recompute_forward, _recompute_replay)}


# ---------------------------------------------------------------------------
# the rematerialized recurrence (StaticRNN(remat=True); the JAX op's
# jax.checkpoint of its scan step)
# ---------------------------------------------------------------------------


def _remat_scan(op):
    return op.type == "recurrent" and bool(op.attrs.get("remat"))


def _scan_forward(op, env, ctx):
    """Run the steps under no_grad; keep the op's inputs and each step's
    incoming carry, and no graph."""
    from ..ops.controlflow import run_recurrent

    ins = {slot: [_value(env, v) for v in vs]
           for slot, vs in op.inputs.items() if vs}
    carries = []
    with torch.no_grad():
        outs = run_recurrent(ctx, ins, op.attrs, carries)
    ctx.fwd[id(op)] = (ins, carries)
    for slot, vs in op.outputs.items():
        for v, val in zip(vs, outs.get(slot, ())):
            env[v.name] = val


def _cotangents(op, fwd, slot, env):
    """The upstream cotangents of forward output slot `slot`, one a
    forward output (None where there is none)."""
    vals = [None] * len(fwd.outputs.get(slot, ()))
    cslot = op.attrs["__cot_slots__"].get(slot)
    if cslot is not None:
        idxs = [i for i, g in enumerate(op.attrs["__grad_out_map__"][slot])
                if g is not None]
        for i, gvar in zip(idxs, op.inputs[cslot]):
            vals[i] = env.get(gvar.name)
    return vals


def _scan_grad(op, fwd, rec, ctx, env):
    """Replay the steps in reverse: step t re-runs from its kept carry
    (fresh leaves) under enable_grad, and autograd takes the cotangents
    of its new carry and of slice t of its outputs back to the carry,
    slice t of each step input (written into that input's grad) and the
    closure (summed over the steps)."""
    from ..ops.controlflow import recurrent_order, recurrent_step

    ins, carries = rec
    attrs = fwd.attrs
    gin_map = op.attrs["__grad_in_map__"]
    g_carry = _cotangents(op, fwd, "FinalMemories", env)
    g_ys = _cotangents(op, fwd, "StepOutputs", env)
    xs = ins.get("StepInputs", [])
    closure = ins.get("X", [])
    seq_len = ins.get("SeqLen", [None])[0]

    def wanted(t, gname):
        return gname is not None and t.is_floating_point()

    x_names = gin_map.get("StepInputs", [None] * len(xs))
    c_names = gin_map.get("X", [None] * len(closure))
    x_grads = [torch.zeros_like(x) if wanted(x, n) else None
               for x, n in zip(xs, x_names)]
    c_leaves = [c.detach().requires_grad_() if wanted(c, n) else c
                for c, n in zip(closure, c_names)]
    c_grads = [None] * len(closure)
    local = dict(zip(attrs["x_names"], c_leaves))
    for t, carry in zip(reversed(recurrent_order(ins, attrs)),
                        reversed(carries)):
        h = [c.detach().requires_grad_() if c.is_floating_point() else c
             for c in carry]
        x_t = [x[t].detach().requires_grad_() if g is not None else x[t]
               for x, g in zip(xs, x_grads)]
        with torch.enable_grad():
            new, ys = recurrent_step(attrs["sub_block"], local, attrs, h,
                                     x_t, t, seq_len, ctx)
        live, cots = [], []
        for out, g in list(zip(new, g_carry)) + [
                (y, None if g is None else g[t]) for y, g in zip(ys, g_ys)]:
            if g is not None and out.requires_grad:
                live.append(out)
                cots.append(g.to(out.dtype))
        leaves = [v for v in h + x_t + c_leaves
                  if isinstance(v, torch.Tensor) and v.requires_grad]
        grads = iter(torch.autograd.grad(live, leaves, cots,
                                         allow_unused=True)
                     if live and leaves else [None] * len(leaves))
        g_carry = [next(grads) if v.requires_grad else None for v in h]
        for i, v in enumerate(x_t):
            if v.requires_grad:
                g = next(grads)
                if g is not None:
                    x_grads[i][t] = g
        for i, v in enumerate(c_leaves):
            if isinstance(v, torch.Tensor) and v.requires_grad:
                g = next(grads)
                if g is not None:
                    c_grads[i] = g if c_grads[i] is None else c_grads[i] + g
    produced = {}

    def put(gname, g, primal):
        if gname is None or not primal.is_floating_point():
            return
        g = torch.zeros_like(primal) if g is None else g
        produced[gname] = produced[gname] + g if gname in produced else g

    for gname, g, b in zip(gin_map.get("Boot", ()), g_carry,
                           ins.get("Boot", [])):
        put(gname, g, b)
    for gname, g, x in zip(x_names, x_grads, xs):
        put(gname, g, x)
    for gname, g, c in zip(c_names, c_grads, closure):
        put(gname, g, c)
    _write_grads(op, produced, env)

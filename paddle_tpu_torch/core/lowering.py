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
runs twice.
"""

import torch

from ..ops import registry

__all__ = ["LoweringContext", "execute_block", "execute_op"]

# op types that the JAX package's executor runs outside the traced step
# (feeds, readers, RPC) and op types with a bespoke lowering (control
# flow). The port runs neither kind; program passes leave them alone
# (quant.py's site scan reads both, as the JAX package's does).
_STRUCTURAL = frozenset({
    "feed", "fetch", "read", "double_buffer", "create_py_reader", "data",
    "depend", "send", "recv", "send_barrier", "fetch_barrier",
    "listen_and_serv", "checkpoint_notify", "gen_nccl_id"})
_SPECIAL = {}


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

    def generator(self, attrs):
        """A torch.Generator for one stateful op: seeded from the
        program's random_seed, the step counter and the op's seed, so
        runs repeat and steps differ."""
        op_seed = attrs.get("__op_seed__")
        if op_seed is None:
            op_seed = attrs.get("seed", 0) or 0
        mixed = (self.seed * 1000003 + self.step) * 1000003 + int(op_seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mixed & 0x7FFFFFFFFFFFFFFF)
        return gen


def execute_block(block, env, ctx, free_after=None):
    """Run every op of `block` over env (name -> tensor). `free_after`
    maps an op index to the names env may drop once that op has run."""
    with torch.no_grad():
        for i, op in enumerate(block.ops):
            execute_op(op, env, ctx)
            for name in (free_after or {}).get(i, ()):
                env.pop(name, None)
    return env


def _value(env, v):
    val = env.get(v.name)
    if val is None:
        if v.is_data:
            raise KeyError("feed %r is missing: the program reads it but "
                           "run() was not given it" % v.name)
        raise KeyError("var %r has no value: no op before its first use "
                       "produced it" % v.name)
    return val


def execute_op(op, env, ctx):
    if "__fwd_op__" in op.attrs:
        _execute_grad_op(op, env, ctx)
        return
    opdef = registry.get(op.type)
    ins = {slot: [_value(env, v) for v in vs]
           for slot, vs in op.inputs.items() if vs}
    if id(op) in ctx.recorded:
        leaves = {
            slot: [t.detach().requires_grad_()
                   if slot not in opdef.nondiff_inputs
                   and t.is_floating_point() else t for t in ts]
            for slot, ts in ins.items()}
        with torch.enable_grad():
            outs = opdef.impl(ctx, leaves, op.attrs)
        ctx.fwd[id(op)] = (leaves, outs)
        outs = {slot: [t.detach() for t in ts] for slot, ts in outs.items()}
    else:
        outs = opdef.impl(ctx, ins, op.attrs)
    for slot, vs in op.outputs.items():
        for v, val in zip(vs, outs.get(slot, ())):
            env[v.name] = val


def _execute_grad_op(op, env, ctx):
    """The generic grad op: autograd over the graph its forward op
    recorded, with the upstream cotangents of the outputs that have one;
    the grads land in env, accumulated where `__accumulate__` says."""
    fwd = op.attrs["__fwd_op__"]
    rec = ctx.fwd.pop(id(fwd), None)
    if rec is None:
        raise RuntimeError("grad op %s: its forward op %s was not recorded "
                           "in this run" % (op.type, fwd.type))
    leaves, outs = rec
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
    accumulate = op.attrs.get("__accumulate__", {})
    for gname, g in produced.items():
        if gname in env and accumulate.get(gname):
            env[gname] = env[gname] + g
        else:
            env[gname] = g

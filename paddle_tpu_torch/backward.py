"""Static autodiff: append_backward (parity: the JAX package's
``backward.py`` :92, after Fluid's backward.py).

Walks the block's ops in reverse from the loss and appends one generic
`<type>_grad` op per differentiable forward op. A grad op holds its
forward op; the lowering (``core/lowering.py``) answers it with autograd
over the graph the forward op recorded. When a var feeds several ops,
its grad contributions are summed (`__accumulate__`). Names, order and
attrs are the JAX package's. A gradient through a While with no
`max_trip_count` is refused, as there. Not ported: ``gradients`` and
grads of grad ops.
"""

from .framework import grad_var_name
from .ops import registry

__all__ = ["append_backward"]


def _collect_need_grad(block, params, no_grad_set):
    """Which vars lie on a differentiable path from the trainables."""
    need = {p.name for p in params if p.name not in no_grad_set}
    for op in block.ops:
        if not registry.has(op.type):
            continue
        opdef = registry.get(op.type)
        if not opdef.differentiable:
            continue
        hit = any(v.name in need for slot, vs in op.inputs.items()
                  if slot not in opdef.nondiff_inputs for v in vs)
        if hit:
            for vs in op.outputs.values():
                for v in vs:
                    if not v.stop_gradient and v.name not in no_grad_set:
                        need.add(v.name)
    return need


def _create_grad_var(block, primal, gname):
    if block.has_var(gname):
        return block.var(gname)
    return block.create_var(name=gname, shape=primal.shape,
                            dtype=primal.dtype, stop_gradient=True)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append grad ops computing d loss / d param for every trainable
    param. Returns a list of (param Variable, grad Variable)."""
    program = loss.block.program
    block = program.global_block()
    no_grad_set = set(no_grad_set or ())
    if program._appending_grad_times:
        raise NotImplementedError(
            "a second backward pass over one program (grads of grads) is "
            "not ported")
    if parameter_list:
        params = [block.var(p if isinstance(p, str) else p.name)
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    need_grad = _collect_need_grad(block, params, no_grad_set)

    loss_idx = None
    for i in reversed(range(len(block.ops))):
        if loss.name in block.ops[i].output_names():
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError("loss var %r is not produced by any op"
                         % loss.name)
    program._appending_grad_times += 1

    # seed d loss / d loss = 1; fill_any_like takes the runtime shape
    loss_grad_name = grad_var_name(loss.name)
    loss_grad = _create_grad_var(block, loss, loss_grad_name)
    block.append_op(type="fill_any_like", inputs={"X": [loss]},
                    outputs={"Out": [loss_grad]},
                    attrs={"value": 1.0, "__op_role__": "backward",
                           "__loss_seed__": True})

    grad_map = {loss.name: loss_grad_name}  # primal name -> grad var name
    for op in reversed(block.ops[: loss_idx + 1]):
        if not registry.has(op.type):
            continue
        opdef = registry.get(op.type)
        if not opdef.differentiable:
            continue
        gout_map = {}
        any_gout = False
        for slot, vs in op.outputs.items():
            names = [grad_map.get(v.name) for v in vs]
            any_gout = any_gout or any(g is not None for g in names)
            gout_map[slot] = names
        if not any_gout:
            continue
        if op.type == "while" and not op.attrs.get("max_trip_count"):
            raise RuntimeError(
                "gradient demanded through a While loop with no "
                "max_trip_count: build it as fluid.layers.While(cond, "
                "max_trip_count=N) to differentiate its trips, or use "
                "StaticRNN/DynamicRNN for recurrences")
        # an output whose cotangent this op consumes and that is also its
        # input under the same name: the input grad replaces the grad var
        consumed = {v.name for slot, vs in op.outputs.items()
                    for i, v in enumerate(vs)
                    if gout_map[slot][i] is not None}

        gin_map = {}
        accumulate = {}
        grad_out_vars = []
        grad_out_seen = set()
        any_gin = False
        for slot, vs in op.inputs.items():
            if slot in opdef.nondiff_inputs:
                gin_map[slot] = [None] * len(vs)
                continue
            names = []
            for v in vs:
                if v.name not in need_grad or v.name in no_grad_set:
                    names.append(None)
                    continue
                gname = grad_var_name(v.name)
                gv = _create_grad_var(block, v, gname)
                if v.name in grad_map and v.name not in consumed:
                    accumulate[gname] = True  # a later consumer's grad
                else:
                    grad_map[v.name] = gname
                names.append(gname)
                if gname not in grad_out_seen:
                    grad_out_seen.add(gname)
                    grad_out_vars.append(gv)
                any_gin = True
            gin_map[slot] = names
        if not any_gin:
            continue

        gout_vars = {}
        cot_slots = {}
        for slot in op.outputs:
            gvs = [block.var(g) for g in gout_map[slot] if g is not None]
            if gvs:
                key = slot + "@GRAD"
                gout_vars[key] = gvs
                cot_slots[slot] = key
        block.append_op(
            type=op.type + "_grad",
            inputs={**op.inputs, **gout_vars},
            outputs={"InputGrads": grad_out_vars},
            attrs={
                "__fwd_op__": op,
                "__grad_out_map__": gout_map,
                "__grad_in_map__": gin_map,
                "__accumulate__": accumulate,
                "__cot_slots__": cot_slots,
                "__op_role__": "backward",
            })

    params_and_grads = [(p, block.var(grad_map[p.name])) for p in params
                        if p.name in grad_map]
    program.param_grad_map.update(
        {p.name: g.name for p, g in params_and_grads})
    return params_and_grads

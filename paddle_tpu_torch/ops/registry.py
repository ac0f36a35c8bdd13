"""Op registry of the PyTorch port (parity: the JAX package's
``ops/registry.py``).

An op kernel is a plain function on torch tensors

    impl(ctx, ins, attrs) -> outs

where ins/outs map Fluid's named slots to lists of tensors. There are no
hand-written grad kernels: ``core/lowering.py`` runs a differentiable op
under autograd and its grad op asks autograd for the input grads.
``backward.py`` reads ``differentiable`` and ``nondiff_inputs``;
``LayerHelper`` reads ``stateful`` (an op that draws random numbers gets
an ``__op_seed__``).
"""

import torch

_REGISTRY = {}


class OpDef:
    def __init__(self, name, impl, differentiable=True, nondiff_inputs=(),
                 stateful=False):
        self.name = name
        self.impl = impl
        self.differentiable = differentiable
        # input slots that never receive gradients (e.g. integer ids)
        self.nondiff_inputs = frozenset(nondiff_inputs)
        self.stateful = stateful

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, differentiable=True, nondiff_inputs=(), stateful=False):
    """Decorator: register `impl(ctx, ins, attrs) -> outs` for op `name`."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError("op %r already registered" % name)
        _REGISTRY[name] = OpDef(name, fn, differentiable, nondiff_inputs,
                                stateful)
        return fn

    return deco


def simple_op(name, in_slots=("X",), out_slot="Out", differentiable=True,
              nondiff_inputs=(), stateful=False):
    """Register an op whose slots each carry one tensor:
    fn(ctx, *tensors, **attrs) -> one tensor bound to `out_slot`."""

    def deco(fn):
        def impl(ctx, ins, attrs):
            args = []
            for s in in_slots:
                vs = ins.get(s, [])
                args.append(vs[0] if vs else None)
            return {out_slot: [fn(ctx, *args, **attrs)]}

        register(name, differentiable, nondiff_inputs, stateful)(impl)
        return fn

    return deco


def get(name):
    od = _REGISTRY.get(name)
    if od is None:
        raise KeyError("no kernel registered for op %r in the PyTorch port "
                       "(registered: %s)" % (name, sorted(_REGISTRY)))
    return od


def has(name):
    return name in _REGISTRY


def broadcast_to_axis(y, x_ndim, axis):
    """Fluid elementwise broadcasting: align y's dims to x starting at
    `axis`; axis=-1 means trailing alignment (numpy's)."""
    if axis is None or axis == -1 or y.ndim == 0 or y.ndim == x_ndim:
        return y
    shape = (1,) * axis + tuple(y.shape) + (1,) * (x_ndim - axis - y.ndim)
    return y.reshape(shape)


def weak_scalar(x, value):
    """A Python scalar as jnp combines it with x: a low-precision float
    tensor takes it rounded to its own dtype first (bf16 * 0.7 is bf16 *
    bf16(0.7) in jnp, while torch would multiply by the fp32 0.7). The
    rounded value stays a Python float (rounded on the host: no device
    tensor, no copy to the card); torch computes the product in fp32,
    where a bf16 or fp16 value is exact, and rounds it once, as XLA
    does."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(value, dtype=x.dtype).item()
    return value

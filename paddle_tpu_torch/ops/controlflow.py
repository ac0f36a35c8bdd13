"""Control-flow ops (parity: the JAX package's ``ops/controlflow.py``
`increment` :27 and `recompute` :282).

`recompute` runs its sub-block over the segment's inputs. Run this way
(an inference program, or a segment nested in another's re-run) it keeps
whatever the caller's grad mode keeps; a `recompute` op with a grad op
in the program takes the lowering of ``core/lowering.py`` (`_SPECIAL`):
the forward keeps only its inputs and the grad op re-runs the segment.
"""

from .registry import register, simple_op, weak_scalar


@simple_op("increment")
def _increment(ctx, x, step=1.0, **_):
    # the step in x's dtype, as jnp.asarray(step, x.dtype) (an int64
    # counter stays int64), as a Python number: no copy to the card
    if not x.is_floating_point():
        return x + int(step)
    return x + weak_scalar(x, step)


@register("recompute")
def _recompute(ctx, ins, attrs):
    from ..core.lowering import run_sub_block

    local = dict(zip(attrs["x_names"], ins.get("X", [])))
    run_sub_block(attrs["sub_block"], local, ctx)
    return {"Out": [local[n] for n in attrs["out_names"]]}

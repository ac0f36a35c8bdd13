"""Parameter-update and loss-unscaling ops (parity: the JAX package's
``ops/optimizer_ops.py`` sgd :34 and ``ops/quant_ops.py``
check_finite_and_unscale).

`sgd` updates the scope's parameter tensor in place, as the JAX step
does by donating its state buffers: the update math runs in fp32 and
rounds once, on the write-back.
"""

import torch

from .registry import register


@register("sgd", differentiable=False)
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(()).float()
    p.copy_(p.float() - lr * g.float())
    return {"ParamOut": [p]}


@register("check_finite_and_unscale")
def _check_finite_and_unscale(ctx, ins, attrs):
    grads = ins["X"]
    scale = ins["Scale"][0].reshape(())
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    outs = []
    for g in grads:
        # jnp promotes bf16 / f32 to f32; torch would keep bf16 for a 0-d
        # divisor, so promote by hand
        g = g.to(torch.promote_types(g.dtype, scale.dtype))
        outs.append(torch.where(finite, g / scale, torch.zeros_like(g)))
    return {"Out": outs, "FoundInfinite": [(~finite).reshape(1)]}


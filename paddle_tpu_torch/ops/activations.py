"""The activation family (parity: the JAX package's ``ops/activations.py``:
the 36 table-driven unary ops and `prelu`). Each op computes in its
input's dtype, as the jnp expression does; `ceil`, `floor` and `round`
have no grad (round half to even, as jnp.round)."""

import torch
import torch.nn.functional as F

from .registry import TpRule, dp_rule, register, tp_rule
from .tp import pointwise_plan

# elementwise: a tp-sharded input's output keeps its mark
_POINTWISE = TpRule(plan=pointwise_plan())


def _a(name, fn, differentiable=True):
    def impl(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], attrs)]}

    register(name, differentiable=differentiable)(impl)
    dp_rule(name)  # elementwise: row-local
    tp_rule(name, _POINTWISE)


def _where(cond, x, y):
    return torch.where(cond, x, y)


_a("abs", lambda x, a: torch.abs(x))
_a("acos", lambda x, a: torch.acos(x))
_a("asin", lambda x, a: torch.asin(x))
_a("atan", lambda x, a: torch.atan(x))
_a("ceil", lambda x, a: torch.ceil(x), differentiable=False)
_a("floor", lambda x, a: torch.floor(x), differentiable=False)
_a("round", lambda x, a: torch.round(x), differentiable=False)
_a("cos", lambda x, a: torch.cos(x))
_a("sin", lambda x, a: torch.sin(x))
_a("exp", lambda x, a: torch.exp(x))
_a("log", lambda x, a: torch.log(x))
_a("sqrt", lambda x, a: torch.sqrt(x))
_a("rsqrt", lambda x, a: torch.rsqrt(x))
_a("square", lambda x, a: x * x)
_a("reciprocal", lambda x, a: 1.0 / x)
_a("sigmoid", lambda x, a: torch.sigmoid(x))
_a("logsigmoid", lambda x, a: F.logsigmoid(x))
_a("tanh", lambda x, a: torch.tanh(x))
_a("tanh_shrink", lambda x, a: x - torch.tanh(x))
_a("relu", lambda x, a: torch.relu(x))
_a("relu6", lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)))
_a("gelu", lambda x, a: F.gelu(x))
# jax.nn.softplus is logaddexp(x, 0), with no linear cut-over
_a("softplus", lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_a("softsign", lambda x, a: x / (1 + torch.abs(x)))
_a("softshrink", lambda x, a: _where(
    x > a.get("lambda", 0.5), x - a.get("lambda", 0.5),
    _where(x < -a.get("lambda", 0.5), x + a.get("lambda", 0.5),
           torch.zeros_like(x))))
_a("hard_shrink", lambda x, a: _where(
    torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_a("hard_sigmoid", lambda x, a: torch.clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_a("brelu", lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                     a.get("t_max", 24.0)))
_a("leaky_relu", lambda x, a: _where(x >= 0, x, a.get("alpha", 0.02) * x))
_a("elu", lambda x, a: _where(
    x > 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1.0)))
_a("selu", lambda x, a: a.get("scale", 1.0507009873554805) * _where(
    x > 0, x, a.get("alpha", 1.6732632423543772) * (torch.exp(x) - 1.0)))
_a("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x))
_a("soft_relu", lambda x, a: torch.log(1.0 + torch.exp(torch.clamp(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_a("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_a("thresholded_relu", lambda x, a: _where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))
_a("pow", lambda x, a: x ** a.get("factor", 1.0))


@register("prelu")
def _prelu(ctx, ins, attrs):
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "all":
        al = alpha.reshape(())
    elif mode == "channel":
        al = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:  # element
        al = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": [torch.where(x >= 0, x, al * x)]}


dp_rule("prelu")

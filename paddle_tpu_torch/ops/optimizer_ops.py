"""Parameter-update and loss-unscaling ops (parity: the JAX package's
``ops/optimizer_ops.py`` :34-256, `average_accumulates` :263, and
``ops/quant_ops.py`` check_finite_and_unscale).

Each update op writes its results in place into the scope's tensors
(the parameter and its accumulators), as the JAX step does by donating
its state buffers. The state math runs in fp32 in the JAX op's order of
operations (a reordered formula drifts from the reference), the incoming
grad is cast to fp32 once, and the parameter rounds once, on the
write-back.
"""

import torch

from .registry import DataParallelError, TpRule, register, tp_rule


def _p(ins, slot):
    vs = ins.get(slot, [])
    return vs[0] if vs else None


def _lr(ins):
    return _p(ins, "LearningRate").reshape(()).float()


def _g32(ins):
    return _p(ins, "Grad").float()


def _write(outs):
    """Copy each computed value into the tensor it updates (slot ->
    (tensor, value)); returns the op's outputs."""
    for dst, val in outs.values():
        dst.copy_(val.reshape(dst.shape))
    return {slot: [dst] for slot, (dst, _) in outs.items()}


@register("sgd", differentiable=False)
def _sgd(ctx, ins, attrs):
    p = _p(ins, "Param")
    return _write({"ParamOut": (p, p.float() - _lr(ins) * _g32(ins))})


@register("momentum", differentiable=False)
def _momentum(ctx, ins, attrs):
    p, g, v = _p(ins, "Param"), _g32(ins), _p(ins, "Velocity")
    lr = _lr(ins)
    mu = attrs.get("mu", 0.9)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p.float() - (g + mu * v_out) * lr
    else:
        p_out = p.float() - lr * v_out
    return _write({"ParamOut": (p, p_out), "VelocityOut": (v, v_out)})


@register("lars_momentum", differentiable=False)
def _lars_momentum(ctx, ins, attrs):
    p, g, v = _p(ins, "Param"), _g32(ins), _p(ins, "Velocity")
    lr = _lr(ins)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    pn = torch.sqrt(torch.sum(p.float() ** 2))
    gn = torch.sqrt(torch.sum(g ** 2))
    local_lr = lr * coeff * pn / (gn + decay * pn + 1e-12)
    # decay * p in p's dtype, then promoted by the fp32 grad (jnp's order)
    v_out = mu * v + local_lr * (g + decay * p)
    return _write({"ParamOut": (p, p.float() - v_out),
                   "VelocityOut": (v, v_out)})


@register("adam", differentiable=False)
def _adam(ctx, ins, attrs):
    p, gf = _p(ins, "Param"), _g32(ins)
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p_t, b2p_t = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1p, b2p = b1p_t.reshape(()), b2p_t.reshape(())
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * gf
    v_out = b2 * v + (1.0 - b2) * gf * gf
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    p_out = p.float() - lr_t * m_out / (torch.sqrt(v_out) + eps)
    return _write({"ParamOut": (p, p_out), "Moment1Out": (m, m_out),
                   "Moment2Out": (v, v_out),
                   "Beta1PowOut": (b1p_t, b1p * b1),
                   "Beta2PowOut": (b2p_t, b2p * b2)})


@register("adamax", differentiable=False)
def _adamax(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _g32(ins)
    m, inf_norm = _p(ins, "Moment"), _p(ins, "InfNorm")
    b1p = _p(ins, "Beta1Pow").reshape(())
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, torch.abs(g))
    p_out = p.float() - (lr / (1.0 - b1p)) * m_out / (inf_out + eps)
    return _write({"ParamOut": (p, p_out), "MomentOut": (m, m_out),
                   "InfNormOut": (inf_norm, inf_out)})


@register("adagrad", differentiable=False)
def _adagrad(ctx, ins, attrs):
    p, g, mom = _p(ins, "Param"), _g32(ins), _p(ins, "Moment")
    lr = _lr(ins)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = mom + g * g
    p_out = p.float() - lr * g / (torch.sqrt(mom_out) + eps)
    return _write({"ParamOut": (p, p_out), "MomentOut": (mom, mom_out)})


@register("decayed_adagrad", differentiable=False)
def _decayed_adagrad(ctx, ins, attrs):
    p, g, mom = _p(ins, "Param"), _g32(ins), _p(ins, "Moment")
    lr = _lr(ins)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * mom + (1.0 - decay) * g * g
    p_out = p.float() - lr * g / (torch.sqrt(mom_out) + eps)
    return _write({"ParamOut": (p, p_out), "MomentOut": (mom, mom_out)})


@register("adadelta", differentiable=False)
def _adadelta(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _g32(ins)
    avg_sq_g = _p(ins, "AvgSquaredGrad")
    avg_sq_u = _p(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1.0 - rho) * g * g
    upd = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1.0 - rho) * upd * upd
    return _write({"ParamOut": (p, p.float() + upd),
                   "AvgSquaredGradOut": (avg_sq_g, g2),
                   "AvgSquaredUpdateOut": (avg_sq_u, u2)})


@register("rmsprop", differentiable=False)
def _rmsprop(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _g32(ins)
    ms, mom = _p(ins, "MeanSquare"), _p(ins, "Moment")
    lr = _lr(ins)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1.0 - rho) * g * g
    outs = {"MeanSquareOut": (ms, ms_out)}
    if attrs.get("centered", False):
        mg = _p(ins, "MeanGrad")
        mg_out = rho * mg + (1.0 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
        outs["MeanGradOut"] = (mg, mg_out)
    else:
        denom = ms_out + eps
    mom_out = momentum * mom + lr * g / torch.sqrt(denom)
    outs["MomentOut"] = (mom, mom_out)
    outs["ParamOut"] = (p, p.float() - mom_out)
    return _write(outs)


@register("ftrl", differentiable=False)
def _ftrl(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _g32(ins)
    sq, lin = _p(ins, "SquaredAccumulator"), _p(ins, "LinearAccumulator")
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (new_sq ** (-power) - sq ** (-power)) / lr
    lin_out = lin + g - sigma * p
    x = l1 * torch.sign(lin_out) - lin_out
    if power == -0.5:
        y = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        y = new_sq ** (-power) / lr + 2 * l2
    p_out = torch.where(torch.abs(lin_out) > l1, x / y,
                        torch.zeros_like(x))
    return _write({"ParamOut": (p, p_out), "SquaredAccumOut": (sq, new_sq),
                   "LinearAccumOut": (lin, lin_out)})


@register("lamb", differentiable=False)
def _lamb(ctx, ins, attrs):
    p, gf = _p(ins, "Param"), _g32(ins)
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p_t, b2p_t = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1p, b2p = b1p_t.reshape(()), b2p_t.reshape(())
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    pf = p.float()
    m_out = b1 * m + (1.0 - b1) * gf
    v_out = b2 * v + (1.0 - b2) * gf * gf
    m_hat = m_out / (1.0 - b1p)
    v_hat = v_out / (1.0 - b2p)
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * pf
    p_norm = torch.sqrt(torch.sum(pf * pf))
    r_norm = torch.sqrt(torch.sum(r * r))
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    return _write({"ParamOut": (p, pf - lr * ratio * r),
                   "Moment1Out": (m, m_out), "Moment2Out": (v, v_out),
                   "Beta1PowOut": (b1p_t, b1p * b1),
                   "Beta2PowOut": (b2p_t, b2p * b2)})


@register("proximal_gd", differentiable=False)
def _proximal_gd(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _g32(ins)
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    prox = p.float() - lr * g
    p_out = torch.sign(prox) * torch.clamp(
        torch.abs(prox) - lr * l1, min=0.0) / (1.0 + lr * l2)
    return _write({"ParamOut": (p, p_out)})


@register("proximal_adagrad", differentiable=False)
def _proximal_adagrad(ctx, ins, attrs):
    p, g, mom = _p(ins, "Param"), _g32(ins), _p(ins, "Moment")
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    mom_out = mom + g * g
    eff_lr = lr / torch.sqrt(mom_out)
    prox = p.float() - eff_lr * g
    p_out = torch.sign(prox) * torch.clamp(
        torch.abs(prox) - eff_lr * l1, min=0.0) / (1.0 + eff_lr * l2)
    return _write({"ParamOut": (p, p_out), "MomentOut": (mom, mom_out)})


@register("check_finite_and_unscale")
def _check_finite_and_unscale(ctx, ins, attrs, reduce=None):
    grads = ins["X"]
    scale = ins["Scale"][0].reshape(())
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    if reduce is not None:
        finite = reduce(finite)
    outs = []
    for g in grads:
        # jnp promotes bf16 / f32 to f32; torch would keep bf16 for a 0-d
        # divisor, so promote by hand
        g = g.to(torch.promote_types(g.dtype, scale.dtype))
        outs.append(torch.where(finite, g / scale, torch.zeros_like(g)))
    return {"Out": outs, "FoundInfinite": [(~finite).reshape(1)]}


@register("average_accumulates", differentiable=False)
def _average_accumulates(ctx, ins, attrs):
    """ModelAverage's window sums: sum_1 += param each run; when the run
    count reaches the window (min(max(min_average_window, num_updates *
    average_window), max_average_window)) sum_1 moves into sum_2, and
    when the old count reaches max_average_window sum_2 moves into sum_3.
    Written in place, as the JAX op's outputs replace its inputs."""
    param = _p(ins, "param")
    sum1, sum2, sum3 = (_p(ins, "in_sum_%d" % i) for i in (1, 2, 3))
    num_acc = _p(ins, "in_num_accumulates").reshape(()) + 1
    old_num = _p(ins, "in_old_num_accumulates").reshape(())
    num_upd = _p(ins, "in_num_updates").reshape(()) + 1
    max_avg = attrs.get("max_average_window", 10000)
    min_avg = attrs.get("min_average_window", 10000)
    window = torch.clamp(num_upd.float() * attrs.get("average_window",
                                                      0.15),
                         min=min_avg).clamp(max=max_avg)
    s1 = sum1 + param
    shift = num_acc >= window
    s2 = torch.where(shift, sum2 + s1, sum2)
    s1 = torch.where(shift, torch.zeros_like(s1), s1)
    old_num = torch.where(shift, num_acc + old_num, old_num)
    num_acc = torch.where(shift, torch.zeros_like(num_acc), num_acc)
    shift2 = old_num >= max_avg
    s3 = torch.where(shift2, s2, sum3)
    s2 = torch.where(shift2, torch.zeros_like(s2), s2)
    old_num = torch.where(shift2, torch.zeros_like(old_num), old_num)
    return _write({
        "out_sum_1": (sum1, s1), "out_sum_2": (sum2, s2),
        "out_sum_3": (sum3, s3),
        "out_num_accumulates": (_p(ins, "in_num_accumulates"), num_acc),
        "out_old_num_accumulates": (_p(ins, "in_old_num_accumulates"),
                                    old_num),
        "out_num_updates": (_p(ins, "in_num_updates"), num_upd)})


# ---------------------------------------------------------------------------
# tensor parallelism and ZeRO-1 (registry.TpRule)
# ---------------------------------------------------------------------------

# update ops that read a norm of the whole parameter
_WHOLE_NORM = ("lars_momentum", "lamb")


def _update_tp_plan(top):
    """An update on shards: every input shaped like the parameter (its
    grad, its state) holds the parameter's block, so the op runs on it
    as it is and writes the same block. Under ZeRO-1 (`top.zero`) the
    rank's dp rows of the (tp-local) parameter and grad are updated
    against its rows of state, then the parameter's rows are
    all-gathered over the data line."""
    op = top.op
    p = top.var("Param")
    d = top.mark("Param")
    if (d is not None or top.zero) and op.type in _WHOLE_NORM:
        raise DataParallelError(
            "op %r on a shard of the parameter %r (%s): its update reads "
            "the whole parameter's norm, which a shard's update would take "
            "per shard" % (op.type, p.name,
                           "tp-sharded" if d is not None else "ZeRO-1 rows"))
    for slot, vs in op.inputs.items():
        for i, v in enumerate(vs):
            m = top.mark(slot, i)
            shaped = v.shape is not None and p.shape is not None \
                and tuple(v.shape) == tuple(p.shape)
            if m != (d if shaped else None):
                return False
    names = {v.name: top.mark(slot, i) for slot, vs in op.inputs.items()
             for i, v in enumerate(vs)}
    for slot, vs in op.outputs.items():
        top.outs[slot] = [names.get(v.name) for v in vs]
    if top.zero:
        if top.dp <= 1:
            top.zero = False
        else:
            top.calls.append(("zero_gather",
                              top.nbytes(p, d, False) // top.dp))
    return True


def _update_tp_impl(ctx, ins, attrs, inner, top):
    if not top.zero:
        return inner(ctx, ins, attrs)
    from ..parallel.collective import _gather
    from .dp import rows

    p = ins["Param"][0]
    mine = rows(p, ctx.dp)  # a view: the update writes into p's rows
    outs = inner(ctx, dict(ins, Param=[mine],
                           Grad=[rows(ins["Grad"][0], ctx.dp)]), attrs)
    p.copy_(_gather(mine, ctx.dp, 0, kind="zero_gather"))
    outs["ParamOut"] = [p]
    return outs


def _unscale_tp_plan(top):
    """Grads on shards: each unscaled on its own; whether any is not
    finite is decided over the whole grads (a MAX over the tp line)."""
    top.outs["Out"] = list(top.marks["X"])
    top.calls.append(("reduce_tp", 1))
    return True


def _unscale_tp_impl(ctx, ins, attrs, inner, top):
    from ..parallel.collective import reduce_tp

    def everywhere(finite):
        bad = reduce_tp((~finite).to(torch.uint8).reshape(1), ctx.tp, "max")
        return bad.reshape(()) == 0

    return _check_finite_and_unscale(ctx, ins, attrs, everywhere)


def _declare_tp():
    from .registry import _REGISTRY

    updates = [n for n, od in _REGISTRY.items()
               if od.impl.__module__ == __name__ and not od.differentiable
               and n != "average_accumulates"]
    tp_rule(updates, TpRule(plan=_update_tp_plan, impl=_update_tp_impl))
    tp_rule("check_finite_and_unscale", TpRule(plan=_unscale_tp_plan,
                                               impl=_unscale_tp_impl))


_declare_tp()

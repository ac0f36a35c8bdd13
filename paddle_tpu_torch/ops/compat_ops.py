"""The attention graph ops (parity: the JAX package's
``ops/compat_ops.py`` flash_attention :465 and fused_multihead_attention
:571) and fused_elemwise_activation (:277). The sequence-parallel
(ring) branch of the JAX attention op is not ported (ROADMAP.md Queue 1
item 9). Under tensor parallelism both attention ops run on the rank's
heads: flash attention on head-sharded q/k/v as it is, the fused op
with its projections sharded by head (the output projection's partial
sums over the tp line, its bias added once after)."""

import torch

from .elementwise import promote
from .flash_attention import flash_attention
from .registry import TpRule, dp_rule, get, register, tp_rule


def flash_qualify(T, Tk, head_dim, causal):
    """The JAX op's gate for the blocked kernel (its `_flash_qualify`):
    sequence lengths multiples of 128, head_dim >= 64, Tq == Tk when
    causal. Other shapes take the plain softmax attention, as there."""
    return (T % 128 == 0 and Tk % 128 == 0 and head_dim >= 64
            and not (causal and Tk != T))


@register("flash_attention")
def _flash_attention_op(ctx, ins, attrs):
    """Fused attention as a graph op. Q/K/V layout [B, H, T, Dh]
    (layout="bhtd", the default) or [B, T, H, Dh] ("bthd"): the bthd
    tensors reach the kernel as strided [B, H, T, Dh] views, with no
    copy."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    if attrs.get("__amp_bf16__") and q.dtype == torch.float32:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out_dtype = q.dtype
    causal = attrs.get("causal", False)
    scale = attrs.get("sm_scale", None)
    layout = attrs.get("layout", "bhtd")
    t_axis = 2 if layout == "bhtd" else 1
    Dh = q.shape[-1]
    if flash_qualify(q.shape[t_axis], k.shape[t_axis], Dh, causal):
        if layout == "bthd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out = flash_attention(q, k, v, causal, scale)
        if layout == "bthd":
            out = out.transpose(1, 2)
    else:
        out = _softmax_attention(q, k, v, layout, causal, scale, Dh)
    return {"Out": [out.to(out_dtype)]}


@register("fused_multihead_attention")
def _fused_multihead_attention(ctx, ins, attrs):
    """The self-attention sublayer as one op: per-head q/k/v projections
    `btd,dhx->bthx`, attention through the flash_attention op in bthd
    layout, and the output projection.

    Inputs: X [B,T,D]; WQ/WK/WV [D,H,Dh]; WO [H,Dh,D]; optional BQ/BK/BV
    [H,Dh] and BO [D]. Attrs: causal, sm_scale (default Dh^-0.5)."""
    x = ins["X"][0]
    if attrs.get("__amp_bf16__") and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    cdt = x.dtype
    Dh = ins["WQ"][0].shape[-1]

    def proj(w, b):
        y = torch.einsum("btd,dhx->bthx", x, w.to(cdt))
        return y if b is None else y + b.to(cdt)

    def opt(slot):
        vs = ins.get(slot)
        return vs[0] if vs else None

    q = proj(ins["WQ"][0], opt("BQ"))
    k = proj(ins["WK"][0], opt("BK"))
    v = proj(ins["WV"][0], opt("BV"))
    ctx_out = get("flash_attention").impl(ctx, {"Q": [q], "K": [k],
                                               "V": [v]}, {
        "causal": bool(attrs.get("causal", False)),
        "sm_scale": attrs.get("sm_scale") or Dh ** -0.5,
        "layout": "bthd"})["Out"][0]
    out = torch.einsum("bthx,hxd->btd", ctx_out, ins["WO"][0].to(cdt))
    bo = opt("BO")
    return {"Out": [out if bo is None else out + bo.to(cdt)]}


def _softmax_attention(q, k, v, layout, causal, scale, Dh):
    """Softmax attention for shapes the kernel's gate turns away (the
    JAX op's `_xla_softmax_attention`): fp32 scores, P rounded to q's
    dtype before the product with v."""
    s = scale if scale is not None else Dh ** -0.5
    qs, ks = (("bhqd", "bhkd") if layout == "bhtd" else ("bqhd", "bkhd"))
    logits = torch.einsum("%s,%s->bhqk" % (qs, ks), q.float(),
                          k.float()) * s
    if causal:
        Tq, Tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out_spec = "bhqd" if layout == "bhtd" else "bqhd"
    return torch.einsum("bhqk,%s->%s" % (ks, out_spec), p, v)


@register("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """fused_elemwise_activation_op: functor_list[0] is the outer
    functor: ["binary", "unary"] computes Binary(X, Unary(Y)), ["unary",
    "binary"] computes Unary(Binary(X, Y)). IntermediateOut is the inner
    functor's result. The functors are the standalone ops' expressions
    (``fuse_elewise_add_act`` in ``ir_passes.py`` schedules the op)."""
    functors = [f.split(",")[0] for f in attrs.get("functor_list", [])]
    if len(functors) != 2:
        raise ValueError("fused_elemwise_activation needs functor_list of "
                         "two entries, got %r" % (functors,))
    x, y = ins["X"][0], ins["Y"][0]
    binary = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
              "elementwise_mul": torch.mul}
    scale = attrs.get("scale", 1.0)
    unary = {"relu": torch.relu, "scale": lambda v: v * scale,
             "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    f0, f1 = functors
    if f0 in binary:
        inner = unary[f1](y)
        out = binary[f0](*promote(x, inner))
    else:
        inner = binary[f1](*promote(x, y))
        out = unary[f0](inner)
    return {"Out": [out], "IntermediateOut": [inner]}


# batch-leading attention: row i attends within row i
dp_rule(["flash_attention", "fused_multihead_attention"])
dp_rule("fused_elemwise_activation", get("elementwise_add").dp)


# ---------------------------------------------------------------------------
# tensor parallelism (registry.TpRule): the rank's heads
# ---------------------------------------------------------------------------

_HEAD_MARKS = {"WQ": 1, "WK": 1, "WV": 1, "BQ": 0, "BK": 0, "BV": 0,
               "WO": 0, "BO": None}


def _fmha_tp_plan(top):
    """WQ/WK/WV [D, H/tp, Dh], BQ/BK/BV [H/tp, Dh] and WO [H/tp, Dh, D]:
    X enters, each rank attends over its H/tp heads (K1 on [B, H/tp, T,
    Dh]), and the output projection's partial sums are summed over the
    tp line before BO is added."""
    if top.mark("X") is not None:
        return False
    for slot, want in _HEAD_MARKS.items():
        if top.op.inputs.get(slot) and top.mark(slot) != want:
            return False
    top.enter("X")
    top.row = True
    top.reduce("Out")
    return True


def _fmha_tp_impl(ctx, ins, attrs, inner, top):
    from ..parallel.collective import reduce_tp

    ins = dict(ins)
    bo = ins.pop("BO", [None])[0]
    out = reduce_tp(inner(ctx, ins, attrs)["Out"][0], ctx.tp)
    return {"Out": [out if bo is None else out + bo.to(out.dtype)]}


def _flash_tp_plan(top):
    """q/k/v sharded on the head dim (1 in bhtd, 2 in bthd): local."""
    h = 1 if top.op.attrs.get("layout", "bhtd") == "bhtd" else 2
    if any(top.mark(s) != h for s in ("Q", "K", "V")):
        return False
    top.outs["Out"] = [h]
    return True


tp_rule("fused_multihead_attention", TpRule(plan=_fmha_tp_plan,
                                            impl=_fmha_tp_impl))
tp_rule("flash_attention", TpRule(plan=_flash_tp_plan))

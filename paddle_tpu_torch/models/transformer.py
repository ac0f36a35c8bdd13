"""The native flagship Transformer LM: the port of
``paddle_tpu/models/transformer.py``.

Plain functions on tensors over a nested dict of parameters with the
JAX pytree's keys and layouts. Each kind of layer weight is stacked on a
leading ``[n_layers]`` axis:

    embed [V, D], pos_embed [max_seq_len, D], final_ln_scale / _bias [D]
    layers: ln1_scale / ln1_bias / ln2_scale / ln2_bias [L, D],
            wqkv [L, D, 3, H, Dh], wo [L, H, Dh, D],
            w1 [L, D, F], b1 [L, F], w2 [L, F, D], b2 [L, D]
    lm_head [D, V]               (tie_embeddings=False)
    moe: router [D, E], w1 [E, D, F], w2 [E, F, D]   (n_experts > 0)

It is the model behind bench.py's ``bench_transformer``, the harness's
``--model transformer_native`` and the graft entry's forward
(``single_chip_forward``). Every product is a ``[*, D] x [D, *]`` GEMM
in the config's dtype; ``lm_logits`` returns fp32 logits accumulated
from those operands, never rounded to the dtype.

Attention (``causal_attention``) on CUDA tensors is the flash-attention
kernel K1 (``ops/flash_attention.py``) over [B, H, T, Dh] views of one
QKV GEMM's [B, T, 3, H, Dh] output, which it reads in place; CPU tensors
take the JAX package's einsum branch. The card has no plain path.

``init_params``, ``params_from_numpy`` run on ``cuda:0`` unless given
``device="cpu"`` (and raise without CUDA); the model functions run on
their tensors' device. They compute on whatever shard they are handed:
``parallel/transformer.py`` (the SPMD trainer) calls `attention_block`
and `ffn_block` with tp-local weights (``wqkv`` [D, 3, H/tp, Dh], so K1
runs on the H/tp local heads) and holds the switch MoE FFN (``moe``),
which the single-chip functions never read.
"""

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from ..core.place import resolve_device
from ..ops import flash_attention as _fa
from ..ops.nn_ops import _HardLabelCE
from ..ops.registry import weak_scalar

__all__ = ["TransformerConfig", "attention_block", "causal_attention",
           "embed_tokens", "ffn_block", "init_params", "layer_norm",
           "lm_logits", "logits_grads", "param_count", "params_from_numpy",
           "single_chip_forward", "single_chip_hidden", "single_chip_loss",
           "token_cross_entropy", "tree_leaves", "tree_map"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX config's fields; `dtype` is a torch dtype or its name."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 512
    dtype: Any = torch.bfloat16
    # MoE: 0 experts = dense
    n_experts: int = 0
    expert_capacity_factor: float = 2.0
    dropout: float = 0.0
    tie_embeddings: bool = True
    remat: bool = True

    def __post_init__(self):
        dtype = self.dtype
        if not isinstance(dtype, torch.dtype):
            dtype = _DTYPES[str(getattr(dtype, "__name__", dtype))]
        object.__setattr__(self, "dtype", dtype)

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def init_params(cfg, generator=None, device=None):
    """The full parameter tree: the JAX ``init_params`` shapes and scales
    (normal x 1/sqrt(fan_in) in fp32, layer norms ones and zeros), drawn
    on the CPU from `generator` (default: seed 0) in the JAX key order,
    then moved to `device`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    D, H, Dh, Fd, L, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_layers, cfg.vocab_size)

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * (1.0 / math.sqrt(fan_in)))

    def const(fill, shape):
        return torch.full(shape, fill, dtype=torch.float32)

    params = {
        "embed": dense((V, D), D),
        "pos_embed": dense((cfg.max_seq_len, D), D),
        "final_ln_scale": const(1.0, (D,)),
        "final_ln_bias": const(0.0, (D,)),
        "layers": {
            "ln1_scale": const(1.0, (L, D)),
            "ln1_bias": const(0.0, (L, D)),
            "wqkv": dense((L, D, 3, H, Dh), D),
            "wo": dense((L, H, Dh, D), D),
            "ln2_scale": const(1.0, (L, D)),
            "ln2_bias": const(0.0, (L, D)),
            "w1": dense((L, D, Fd), D),
            "b1": const(0.0, (L, Fd)),
            "w2": dense((L, Fd, D), Fd),
            "b2": const(0.0, (L, D)),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V), D)
    if cfg.n_experts:
        E = cfg.n_experts
        params["moe"] = {
            "router": dense((D, E), D),
            "w1": dense((E, D, Fd), D),
            "w2": dense((E, Fd, D), Fd),
        }
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree):
    """`fn` over the tree's tensors in ``tree_leaves``'s order, keeping
    the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree):
    """The tree's tensors in sorted-key order (jax.tree.leaves's)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _from_numpy(arr):
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":   # ml_dtypes: torch's bf16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree, device=None):
    """A parameter tree of numpy arrays (the JAX package's
    ``init_params``, each leaf through ``np.asarray``) as the port's,
    each leaf's dtype kept (bf16 bit for bit), on `device`."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a).to(device), tree)


def layer_norm(x, scale, bias, eps=1e-5):
    """fp32 statistics over the last axis, the result in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def causal_attention(q, k, v, seq_offset=0, use_flash=None):
    """q, k, v: [B, T, H, Dh] (H may be a tp-local slice). On CUDA
    tensors the flash-attention kernel K1 (causal, scale 1/sqrt(Dh)) on
    [B, H, T, Dh] views, at any T and Dh; a `seq_offset` other than 0
    raises there: the SPMD trainer's sequence parallelism gathers the
    whole sequence before attention, as the JAX package's does, and no
    caller passes one. CPU tensors take the JAX package's non-flash
    branch (fp32 logits, a -1e30 causal mask, fp32 softmax, probs in q's
    dtype) unless `use_flash`, which runs K1's plain version."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    cuda = q.device.type == "cuda"
    if use_flash is None:
        use_flash = cuda
    if cuda and not use_flash:
        raise ValueError("causal_attention on the card runs the flash "
                         "kernel K1; there is no plain path there")
    if use_flash:
        if seq_offset != 0:
            raise NotImplementedError(
                "causal_attention with seq_offset=%d on the kernel "
                "route: K1 runs self-attention over the whole sequence "
                "(the SPMD trainer's sequence parallelism gathers it "
                "first, as the JAX package's does); an offset query "
                "block has no kernel" % seq_offset)
        ctx = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), True,
                                  1.0 / math.sqrt(Dh))
        return ctx.transpose(1, 2)
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None] + seq_offset
    kpos = torch.arange(Tk, device=q.device)[None, :]
    logits = logits.masked_fill(~(qpos >= kpos), -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_block(lp, h_full, dtype):
    """One attention sublayer on a [B, T, D] input: one QKV GEMM whose
    [B, T, 3, H, Dh] output gives q, k and v (each element the dot
    product of the JAX package's three einsums), attention, and the
    output projection."""
    B, T, D = h_full.shape
    w = lp["wqkv"].to(dtype)
    H, Dh = w.shape[2], w.shape[3]
    qkv = (h_full.reshape(B * T, D) @ w.reshape(D, 3 * H * Dh)).view(
        B, T, 3, H, Dh)
    q, k, v = qkv.unbind(2)
    ctx = causal_attention(q, k, v)
    out = ctx.reshape(B * T, H * Dh) @ lp["wo"].to(dtype).reshape(H * Dh, D)
    return out.view(B, T, D)


def ffn_block(lp, h_full, dtype):
    """The dense FFN: GELU in its tanh form (jax.nn.gelu's default)."""
    a = h_full @ lp["w1"].to(dtype)
    a = F.gelu(a + lp["b1"].to(dtype), approximate="tanh")
    return a @ lp["w2"].to(dtype)


def embed_tokens(params, tokens, cfg):
    """Token rows times sqrt(D) (rounded to the dtype first, as jnp takes
    a Python scalar) plus the position rows."""
    h = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    h = h * weak_scalar(h, math.sqrt(cfg.d_model))
    pos = params["pos_embed"][: tokens.shape[1]].to(cfg.dtype)
    return h + pos[None]


def _head_weight(params, dtype):
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].t()
    return w.to(dtype)


# the card's logits grads against JAX's, in the 2-norm of each grad:
# rounding the fp32 cotangent to bf16 (2^-9 relative at most) before the
# GEMMs adds one rounding's worth: 2.6e-3 on the CPU's bf16 GEMM
# (tests/test_torch_native_transformer.py), 2.55e-3 on an NVIDIA H100
# 80GB HBM3 at 700 W at the flagship's head width (chip_smoke.py's phase
# 16a, which holds it); one bf16 epsilon, 2^-8, holds it
LOGITS_GRAD_RTOL = 2.0 ** -8


def logits_grads(h, w, g, round_cotangent):
    """The grads of the fp32 logits h [N, D] @ w [D, V] (a 16-bit dtype)
    from their cotangent g [N, V] (fp32), each in its operand's dtype.
    Without `round_cotangent`, JAX's transpose of a dot with
    ``preferred_element_type=float32``: the fp32 products g wᵀ and hᵀ g,
    rounded to the dtype (JAX's up to the order of the fp32 sums). With
    it (the
    card's route): g rounded to the dtype first, then two GEMMs in the
    dtype with fp32 accumulation on the tensor cores, in place of fp32
    GEMMs on the SIMT cores; the grads then differ from JAX's by up to
    LOGITS_GRAD_RTOL of their norm."""
    if round_cotangent:
        g = g.to(h.dtype)
        return g @ w.t(), h.t() @ g
    return ((g @ w.float().t()).to(h.dtype),
            (h.float().t() @ g).to(w.dtype))


class _F32Logits(torch.autograd.Function):
    """h [N, D] @ w [D, V] in a 16-bit dtype with fp32 logits: cuBLAS's
    GEMM with an fp32 output on the card, the fp32 product of the widened
    operands on the CPU (the same values up to the order of the sums).
    Backward: `logits_grads`, the cotangent rounded first on the card
    only."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.device.type == "cuda":
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        return logits_grads(h, w, g, h.device.type == "cuda")


def lm_logits(params, h, cfg):
    """fp32 logits [..., V] accumulated from h's dtype (the tied
    embedding's transpose, or ``lm_head``), never rounded to it: on the
    card cuBLAS's bf16 / fp16 GEMM with an fp32 output, on the CPU the
    fp32 product of the exactly widened operands (`_F32Logits`, which
    also carries the grads: `logits_grads`)."""
    w = _head_weight(params, h.dtype)
    h2 = h.reshape(-1, h.shape[-1])
    if h.dtype == torch.float32:
        out = h2 @ w
    else:
        out = _F32Logits.apply(h2, w)
    return out.view(*h.shape[:-1], w.shape[-1])


def _layer(h, lp, dtype):
    x = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"])
    h = h + attention_block(lp, x, dtype)
    x = layer_norm(h, lp["ln2_scale"], lp["ln2_bias"])
    return h + ffn_block(lp, x, dtype)


def single_chip_hidden(params, tokens, cfg):
    """Embed -> the layers, a loop over the stacked weights' leading
    axis (each under non-reentrant ``torch.utils.checkpoint`` with
    ``cfg.remat``: the counterpart of ``jax.checkpoint`` of the scan
    body) -> the final layer norm."""
    h = embed_tokens(params, tokens, cfg)
    layers = params["layers"]
    for i in range(layers["wqkv"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        if cfg.remat:
            h = _checkpoint.checkpoint(_layer, h, lp, cfg.dtype,
                                       use_reentrant=False)
        else:
            h = _layer(h, lp, cfg.dtype)
    return layer_norm(h, params["final_ln_scale"], params["final_ln_bias"])


def single_chip_forward(params, tokens, cfg):
    """The unsharded forward (the graft entry's): fp32 logits [B, T, V]."""
    return lm_logits(params, single_chip_hidden(params, tokens, cfg), cfg)


def token_cross_entropy(logits, labels):
    """Mean CE over tokens; logits fp32 [B, T, V]."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels.long()[..., None])
    return -picked.mean()


def single_chip_loss(params, tokens, labels, cfg):
    """The forward and the chunked CE head of the JAX function: the head
    a chunk of ``T`` (at most 256) or ``max(256, T // 4)`` positions at a
    time (a short last chunk when T is not a multiple), each chunk's
    logits in ``cfg.dtype`` through ``_HardLabelCE`` (ignore_index
    -100), the sum over chunks over B·T. A chunk's logits come out of the
    GEMM in the dtype directly: one rounding of the fp32 accumulation,
    the value of JAX's fp32 logits cast to it."""
    h = single_chip_hidden(params, tokens, cfg)
    B, T = labels.shape
    w = _head_weight(params, cfg.dtype)
    chunk = T if T <= 256 else max(256, T // 4)
    total = None
    for s in range(0, T, chunk):
        hs = h[:, s:s + chunk]
        logits = (hs.reshape(-1, hs.shape[-1]) @ w).view(
            B, hs.shape[1], w.shape[-1])
        ce = _HardLabelCE.apply(logits, labels[:, s:s + chunk].long(),
                                -100).sum()
        total = ce if total is None else total + ce
    return total / (B * T)


def param_count(params):
    return sum(int(t.numel()) for t in tree_leaves(params))

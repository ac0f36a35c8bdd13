"""The flagship Transformer LM built entirely from the Fluid layers API
(the port of the JAX package's ``models/transformer_fluid.py`` ``build``):
a pre-LN decoder-only LM — vocab 32000, d_model 512, 8 heads, 6 layers,
d_ff 2048 at its defaults — with the fused multihead-attention op (causal
flash attention inside) and a sequence-chunked cross-entropy head. With
``remat=True`` (the default) each pair of layers is one
``layers.recompute`` segment; with ``dropout_rate > 0`` attention takes
the fc + split path through ``nets.scaled_dot_product_attention``'s
explicit scores (no flash attention, as in the JAX package) and two
dropouts a layer.

Not ported yet: ``build_stacked`` (StaticRNN).
"""

from .. import layers, nets
from ..param_attr import ParamAttr

__all__ = ["build"]


def build(vocab_size=32000, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
          seq_len=512, dropout_rate=0.0, remat=True, dtype="float32",
          head_chunk=None):
    """Build the LM graph; returns (tokens, labels, mean_loss) Variables.

    Feeds: tokens int32 [B, seq_len], labels int32 [B, seq_len] (next-
    token ids). Loss = mean token cross-entropy in fp32.

    dtype="bfloat16" stores params AND the residual stream in bf16;
    layer_norm statistics, the cross-entropy log-softmax and the
    optimizers' update math stay fp32 inside their ops."""
    tokens = layers.data(name="tokens", shape=[seq_len], dtype="int32")
    labels = layers.data(name="labels", shape=[seq_len], dtype="int32")

    h = layers.embedding(tokens, size=[vocab_size, d_model], dtype=dtype,
                         param_attr=ParamAttr(shard_spec=("tp", None)))
    h = layers.scale(h, scale=float(d_model) ** 0.5)
    h = layers.add_position_encoding(h, alpha=1.0, beta=1.0)

    def encoder_layer(x):
        a = layers.layer_norm(x, begin_norm_axis=2)
        if not dropout_rate:
            proj = nets.fused_multihead_attention(a, n_heads, causal=True)
        else:
            qkv = layers.fc(a, 3 * d_model, num_flatten_dims=2,
                            param_attr=ParamAttr(shard_spec=(None, "tp")))
            q, k, v = layers.split(qkv, num_or_sections=3, dim=-1)
            attn = nets.scaled_dot_product_attention(
                q, k, v, num_heads=n_heads, dropout_rate=dropout_rate,
                causal=True)
            proj = layers.fc(attn, d_model, num_flatten_dims=2,
                             param_attr=ParamAttr(shard_spec=("tp", None)))
            proj = layers.dropout(proj, dropout_prob=dropout_rate)
        x = layers.elementwise_add(x, proj)
        b = layers.layer_norm(x, begin_norm_axis=2)
        f = layers.fc(b, d_ff, num_flatten_dims=2, act="gelu",
                      param_attr=ParamAttr(shard_spec=(None, "tp")))
        f = layers.fc(f, d_model, num_flatten_dims=2,
                      param_attr=ParamAttr(shard_spec=("tp", None)))
        if dropout_rate:
            f = layers.dropout(f, dropout_prob=dropout_rate)
        return layers.elementwise_add(x, f)

    def layer_pair(x):
        return encoder_layer(encoder_layer(x))

    # remat: two layers a segment (an odd last layer alone)
    i = 0
    while i < n_layers:
        if remat and i + 1 < n_layers:
            h = layers.recompute(layer_pair, h)
            i += 2
        elif remat:
            h = layers.recompute(encoder_layer, h)
            i += 1
        else:
            h = encoder_layer(h)
            i += 1

    h = layers.layer_norm(h, begin_norm_axis=2)
    loss = _chunked_lm_head(h, labels, vocab_size, seq_len, head_chunk)
    return tokens, labels, loss


def _chunked_lm_head(h, labels, vocab_size, seq_len, head_chunk=None):
    """Vocab projection -> mean CE, chunked along the sequence so the fp32
    log-softmax transient is [B, chunk, vocab]. The mean divides by the
    run-time token count (labels' shape)."""
    def lm_head_sum(x, y):
        logits = layers.fc(x, vocab_size, num_flatten_dims=2,
                           bias_attr=False,
                           param_attr=ParamAttr(name="lm_head_w",
                                                shard_spec=(None, "tp")))
        y3 = layers.reshape(y, shape=[0, 0, 1])
        ce = layers.softmax_with_cross_entropy(logits, y3)
        return layers.reduce_sum(ce)

    head_chunk = min(seq_len, head_chunk or 256)
    parts = []
    for s in range(0, seq_len, head_chunk):
        hs = layers.slice(h, axes=[1], starts=[s], ends=[s + head_chunk])
        ys = layers.slice(labels, axes=[1], starts=[s],
                          ends=[s + head_chunk])
        parts.append(lm_head_sum(hs, ys))
    total = parts[0] if len(parts) == 1 else layers.sums(parts)
    numel = layers.cast(layers.reduce_prod(layers.shape(labels)), "float32")
    return layers.elementwise_div(total, numel)

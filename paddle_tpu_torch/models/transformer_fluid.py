"""The flagship Transformer LM built entirely from the Fluid layers API
(the port of the JAX package's ``models/transformer_fluid.py`` ``build``):
a pre-LN decoder-only LM — vocab 32000, d_model 512, 8 heads, 6 layers,
d_ff 2048 at its defaults — with the fused multihead-attention op (causal
flash attention inside) and a sequence-chunked cross-entropy head. With
``remat=True`` (the default) each pair of layers is one
``layers.recompute`` segment; with ``dropout_rate > 0`` attention takes
the fc + split path through ``nets.scaled_dot_product_attention``'s
explicit scores (no flash attention, as in the JAX package) and two
dropouts a layer. ``build_stacked`` is the same LM with its layer stack
written as one ``StaticRNN(remat=True)`` over stacked ``[n_layers, ...]``
weights.
"""

from .. import layers, nets
from ..param_attr import ParamAttr

__all__ = ["build", "build_stacked"]


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


def build_stacked(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                  d_ff=2048, seq_len=512, dtype="bfloat16"):
    """The same LM with the layer stack written as ONE
    ``StaticRNN(remat=True)`` over stacked per-layer weights (``st_wqkv``
    [n_layers, d_model, 3 d_model] and the rest, each a step input
    sliced on axis 0). The carry is the residual stream; its layer norms
    are built from primitives (fp32 statistics, the stream dtype out)
    because the scanned parameters come in as step vars. Attention is
    ``nets.scaled_dot_product_attention`` with no dropout: one
    `flash_attention` op a step. Returns (tokens, labels, mean_loss)."""
    from ..initializer import Constant, Normal

    tokens = layers.data(name="tokens", shape=[seq_len], dtype="int32")
    labels = layers.data(name="labels", shape=[seq_len], dtype="int32")

    h = layers.embedding(tokens, size=[vocab_size, d_model], dtype=dtype)
    h = layers.scale(h, scale=float(d_model) ** 0.5)
    h = layers.add_position_encoding(h, alpha=1.0, beta=1.0)

    L, D, F = n_layers, d_model, d_ff

    def P(name, shape, init_std=0.02, const=None):
        init = (Constant(const) if const is not None
                else Normal(0.0, init_std))
        return layers.create_parameter(shape=shape, dtype=dtype, name=name,
                                       default_initializer=init)

    wqkv = P("st_wqkv", [L, D, 3 * D])
    bqkv = P("st_bqkv", [L, 3 * D], const=0.0)
    wproj = P("st_wproj", [L, D, D])
    bproj = P("st_bproj", [L, D], const=0.0)
    ln1_s = P("st_ln1_s", [L, D], const=1.0)
    ln1_b = P("st_ln1_b", [L, D], const=0.0)
    ln2_s = P("st_ln2_s", [L, D], const=1.0)
    ln2_b = P("st_ln2_b", [L, D], const=0.0)
    wff1 = P("st_wff1", [L, D, F])
    bff1 = P("st_bff1", [L, F], const=0.0)
    wff2 = P("st_wff2", [L, F, D])
    bff2 = P("st_bff2", [L, D], const=0.0)

    def ln(x, scale, shift):
        # fp32 statistics, the stream dtype out
        xf = layers.cast(x, "float32")
        mu = layers.reduce_mean(xf, dim=-1, keep_dim=True)
        d = layers.elementwise_sub(xf, mu)
        var = layers.reduce_mean(layers.elementwise_mul(d, d), dim=-1,
                                 keep_dim=True)
        inv = layers.rsqrt(layers.scale(var, scale=1.0, bias=1e-5))
        y = layers.cast(layers.elementwise_mul(d, inv), dtype)
        return layers.elementwise_add(
            layers.elementwise_mul(y, scale), shift)

    rnn = layers.StaticRNN(remat=True)
    with rnn.step():
        w1 = rnn.step_input(wqkv)
        b1 = rnn.step_input(bqkv)
        w2 = rnn.step_input(wproj)
        b2 = rnn.step_input(bproj)
        s1 = rnn.step_input(ln1_s)
        c1 = rnn.step_input(ln1_b)
        s2 = rnn.step_input(ln2_s)
        c2 = rnn.step_input(ln2_b)
        w3 = rnn.step_input(wff1)
        b3 = rnn.step_input(bff1)
        w4 = rnn.step_input(wff2)
        b4_ = rnn.step_input(bff2)
        xm = rnn.memory(init=h)
        a = ln(xm, s1, c1)
        qkv = layers.elementwise_add(layers.matmul(a, w1), b1)
        q, k, v = layers.split(qkv, num_or_sections=3, dim=-1)
        att3 = nets.scaled_dot_product_attention(
            q, k, v, num_heads=n_heads, causal=True)
        x = layers.elementwise_add(
            xm, layers.elementwise_add(layers.matmul(att3, w2), b2))
        bnorm = ln(x, s2, c2)
        f = layers.gelu(layers.elementwise_add(layers.matmul(bnorm, w3),
                                               b3))
        x_new = layers.elementwise_add(
            x, layers.elementwise_add(layers.matmul(f, w4), b4_))
        rnn.update_memory(xm, x_new)
    rnn()
    h = rnn.final_memories[0]

    h_f32 = layers.layer_norm(h, begin_norm_axis=2)
    loss = _chunked_lm_head(h_f32, labels, vocab_size, seq_len)
    return tokens, labels, loss

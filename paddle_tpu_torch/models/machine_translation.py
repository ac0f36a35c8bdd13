"""Seq2seq NMT with attention (parity: the JAX package's
``models/machine_translation.py`` `build` :36 and `build_beam_decoder`
:72; after benchmark/fluid/models/machine_translation.py: GRU encoder
and decoder, dot attention, teacher-forced training).

The reference builds the decoder with DynamicRNN over LoD batches; here
the whole decoder is one `dynamic_gru` pass plus a batched attention
matmul over padded [B, T] inputs with length masks."""

from .. import layers


def encoder(src_word, src_len, dict_size, embed_dim, hidden_dim):
    emb = layers.embedding(input=src_word, size=[dict_size, embed_dim])
    proj = layers.fc(input=emb, size=hidden_dim * 3, num_flatten_dims=2,
                     bias_attr=False)
    enc = layers.dynamic_gru(input=proj, size=hidden_dim)
    return enc


def attention(dec_state, enc_states, enc_mask):
    """Additive-free dot attention: scores = dec_state @ enc^T, masked
    softmax over source positions, context = weights @ enc."""
    # dec_state [B, Td, H]; enc_states [B, Ts, H]
    scores = layers.matmul(dec_state, enc_states, transpose_y=True)
    # mask [B, Ts] -> [B, 1, Ts]
    mask = layers.unsqueeze(enc_mask, axes=[1])
    big_neg = layers.scale(mask, scale=-1e9, bias=1e9)  # 0 where valid
    scores = layers.elementwise_add(scores, big_neg)
    weights = layers.softmax(scores)
    return layers.matmul(weights, enc_states)


def build(src_dict_size=10000, trg_dict_size=10000, embed_dim=512,
          hidden_dim=512, max_len=50):
    src = layers.data(name="src_word", shape=[max_len], dtype="int64")
    src_len = layers.data(name="src_len", shape=[1], dtype="int64")
    trg = layers.data(name="trg_word", shape=[max_len], dtype="int64")
    trg_next = layers.data(name="trg_next", shape=[max_len], dtype="int64")
    trg_len = layers.data(name="trg_len", shape=[1], dtype="int64")

    enc = encoder(src, src_len, src_dict_size, embed_dim, hidden_dim)
    src_mask = layers.cast(
        layers.sequence_mask(src_len, maxlen=max_len, dtype="float32"),
        "float32")

    trg_emb = layers.embedding(input=trg, size=[trg_dict_size, embed_dim])
    dec_proj = layers.fc(input=trg_emb, size=hidden_dim * 3,
                         num_flatten_dims=2, bias_attr=False)
    dec = layers.dynamic_gru(input=dec_proj, size=hidden_dim)

    ctxt = attention(dec, enc, src_mask)
    dec_ctx = layers.concat([dec, ctxt], axis=2)
    logits = layers.fc(input=dec_ctx, size=trg_dict_size, num_flatten_dims=2)

    # masked token cross-entropy over the padded target
    flat_logits = layers.reshape(logits, shape=[-1, trg_dict_size])
    flat_label = layers.reshape(trg_next, shape=[-1, 1])
    cost = layers.softmax_with_cross_entropy(logits=flat_logits,
                                             label=flat_label)
    cost = layers.reshape(cost, shape=[-1, max_len])
    trg_mask = layers.cast(
        layers.sequence_mask(trg_len, maxlen=max_len, dtype="float32"),
        "float32")
    masked = layers.elementwise_mul(cost, trg_mask)
    total = layers.reduce_sum(masked)
    denom = layers.reduce_sum(trg_mask)
    avg_cost = layers.elementwise_div(total, denom)
    return (src, src_len, trg, trg_next, trg_len), logits, avg_cost


def build_beam_decoder(dict_size=30000, word_dim=16, decoder_size=32,
                       beam_size=2, max_length=8, src_len=8, end_id=1):
    """Port of the reference book test's While-loop beam decoder — the
    level-2-LoD workload (tests/book/test_machine_translation.py
    decoder_decode :85-150: init_ids/init_scores arrive as lod_level=2
    tensors, per-step state flows through array_read/array_write,
    sequence_expand replicates state across beam lanes, beam_search prunes
    and beam_search_decode backtracks).

    Dense layout: the LoD beam lanes become a dense [batch, beam] axis
    (the JAX package's level-2 mapping) — lane replication is a
    broadcast instead of sequence_expand, and beam reordering is a
    one_hot(parent) matmul instead of LoD row shuffling. Feeds: `bd_src` [batch,
    src_len] int64, `bd_init_ids` [batch, beam] int64, `bd_init_scores`
    [batch, beam] float32 (the test builds the latter two from the
    reference's level-2 LoDTensors host-side). Returns (sentence ids
    [batch, beam, T], sentence scores [batch, beam])."""
    from ..param_attr import ParamAttr

    src = layers.data(name="bd_src", shape=[src_len], dtype="int64")
    init_ids = layers.data(name="bd_init_ids", shape=[beam_size],
                           dtype="int64")
    init_scores = layers.data(name="bd_init_scores", shape=[beam_size],
                              dtype="float32")

    # encoder context (reference: LSTM last step; here mean + tanh fc)
    src_emb = layers.embedding(src, size=[dict_size, word_dim],
                               param_attr=ParamAttr(name="bd_vemb"))
    pooled = layers.reduce_mean(src_emb, dim=1)
    context = layers.fc(pooled, decoder_size, act="tanh",
                        param_attr=ParamAttr(name="bd_enc_w"),
                        bias_attr=ParamAttr(name="bd_enc_b"))

    counter = layers.zeros(shape=[1], dtype="int64")
    array_len = layers.fill_constant(shape=[1], dtype="int64",
                                     value=max_length)

    # beam lanes exist from step 0 (init_scores = [0, -inf, ...] keeps
    # step 1 expanding only lane 0, the reference's single-row init)
    state0 = layers.expand(layers.unsqueeze(context, axes=[1]),
                           expand_times=[1, beam_size, 1])

    state_array = layers.array_write(state0, counter)
    ids_array = layers.array_write(init_ids, counter)
    scores_array = layers.array_write(init_scores, counter)
    zero_parent = layers.cast(
        layers.zeros_like(init_ids), "int32")
    parents_array = layers.array_write(zero_parent, counter)

    cond = layers.less_than(x=counter, y=array_len)
    # max_trip_count sizes the in-graph tensor-array buffers (the
    # reference's dynamic While grows LoD arrays; here capacity is static)
    loop = layers.While(cond=cond, max_trip_count=max_length)
    with loop.block():
        pre_ids = layers.array_read(ids_array, counter)
        pre_state = layers.array_read(state_array, counter)
        pre_score = layers.array_read(scores_array, counter)

        ids_emb = layers.embedding(pre_ids, size=[dict_size, word_dim],
                                   param_attr=ParamAttr(name="bd_vemb_dec"))
        cat = layers.concat([pre_state, ids_emb], axis=2)
        cur_state = layers.fc(cat, decoder_size, act="tanh",
                              num_flatten_dims=2,
                              param_attr=ParamAttr(name="bd_dec_w"),
                              bias_attr=ParamAttr(name="bd_dec_b"))
        cur_score = layers.fc(cur_state, dict_size, act="softmax",
                              num_flatten_dims=2,
                              param_attr=ParamAttr(name="bd_out_w"),
                              bias_attr=ParamAttr(name="bd_out_b"))
        topk_scores, topk_idx = layers.topk(cur_score, k=beam_size)
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_score, topk_idx, topk_scores, beam_size, end_id)
        # beam reorder (reference: LoD row shuffle): one_hot(parent) matmul
        perm = layers.one_hot(parent, beam_size)  # [B, beam, beam(old)]
        new_state = layers.matmul(perm, cur_state)

        layers.increment(counter, value=1, in_place=True)
        layers.array_write(sel_ids, counter, array=ids_array)
        layers.array_write(sel_scores, counter, array=scores_array)
        layers.array_write(new_state, counter, array=state_array)
        layers.array_write(parent, counter, array=parents_array)
        layers.less_than(x=counter, y=array_len, cond=cond)

    # stack decode steps 1..max_length into [T, batch, beam] (the init
    # slot 0 holds the bos seed, not a decoded step)
    def read_at(arr, t):
        idx = layers.fill_constant(shape=[1], dtype="int64", value=t)
        return layers.array_read(arr, idx)

    step_ids = layers.stack(
        [read_at(ids_array, t) for t in range(1, max_length + 1)], axis=0)
    step_scores = layers.stack(
        [read_at(scores_array, t) for t in range(1, max_length + 1)], axis=0)
    step_parents = layers.stack(
        [read_at(parents_array, t) for t in range(1, max_length + 1)],
        axis=0)
    sent_ids, sent_scores = layers.beam_search_decode(
        step_ids, step_scores, step_parents, beam_size=beam_size,
        end_id=end_id)
    return (src, init_ids, init_scores), sent_ids, sent_scores

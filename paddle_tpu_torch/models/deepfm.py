"""DeepFM CTR model (parity: the JAX package's ``models/deepfm.py``
`build` :58; BASELINE.md config 4).

Fields: `sparse_ids` [B, F] int64 feature ids (already hashed into one
shared vocab), `dense_x` [B, D] float features, `label` [B, 1].
FM first-order + second-order + deep MLP tower, sigmoid CTR output, the
sigmoid cross-entropy loss and a streaming AUC.
"""

from .. import layers


def build_distributed(*args, **kwargs):
    """DeepFM over host-RAM sharded embedding tables (the JAX package's
    :16) needs `distributed_embedding`, which the port has not yet."""
    raise NotImplementedError(
        "deepfm.build_distributed needs layers.distributed_embedding, which "
        "the PyTorch port does not have yet (ROADMAP.md Queue 1 item 9, "
        "the distributed runtime)")


def build(sparse_feature_dim=int(1e5), num_fields=26, dense_dim=13,
          embed_dim=16, mlp_dims=(400, 400, 400), is_sparse=True):
    sparse_ids = layers.data(name="sparse_ids", shape=[num_fields],
                             dtype="int64")
    dense_x = layers.data(name="dense_x", shape=[dense_dim], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")

    # first-order: per-id scalar weight
    w1 = layers.embedding(input=sparse_ids, size=[sparse_feature_dim, 1],
                          is_sparse=is_sparse)
    first_order = layers.reduce_sum(w1, dim=[1, 2], keep_dim=False)
    first_order = layers.reshape(first_order, shape=[-1, 1])

    # second-order FM: 0.5 * ((sum v)^2 - sum v^2)
    emb = layers.embedding(input=sparse_ids,
                           size=[sparse_feature_dim, embed_dim],
                           is_sparse=is_sparse)  # [B, F, K]
    sum_emb = layers.reduce_sum(emb, dim=[1])            # [B, K]
    sum_sq = layers.square(sum_emb)
    sq_sum = layers.reduce_sum(layers.square(emb), dim=[1])
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=[1],
                          keep_dim=True), scale=0.5)

    # deep tower over [flattened embeddings ; dense]
    deep_in = layers.concat(
        [layers.flatten(emb, axis=1), dense_x], axis=1)
    h = deep_in
    for dim in mlp_dims:
        h = layers.fc(input=h, size=dim, act="relu")
    deep_out = layers.fc(input=h, size=1, act=None)

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, second_order), deep_out)
    predict = layers.sigmoid(logit)
    cost = layers.sigmoid_cross_entropy_with_logits(
        x=logit, label=layers.cast(label, "float32"))
    avg_cost = layers.mean(cost)
    auc_var, _, _ = layers.auc(input=predict, label=label,
                               num_thresholds=2**10 - 1)
    return (sparse_ids, dense_x, label), predict, avg_cost, auc_var

"""Word2vec N-gram LM (parity: the JAX package's ``models/word2vec.py``;
after the book test's: 4 context words -> one shared embedding ->
concat -> hidden -> softmax over the vocab)."""

from .. import layers
from ..param_attr import ParamAttr


def build(dict_size=2073, embed_size=32, hidden_size=256, is_sparse=False):
    words = [layers.data(name=n, shape=[1], dtype="int64")
             for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")]

    embs = []
    for w in words[:4]:
        emb = layers.embedding(
            input=w, size=[dict_size, embed_size], dtype="float32",
            is_sparse=is_sparse, param_attr=ParamAttr(name="shared_w"))
        embs.append(emb)

    concat_embed = layers.concat(input=embs, axis=1)
    hidden1 = layers.fc(input=concat_embed, size=hidden_size, act="sigmoid")
    predict_word = layers.fc(input=hidden1, size=dict_size, act="softmax")
    cost = layers.cross_entropy(input=predict_word, label=words[4])
    avg_cost = layers.mean(cost)
    return words, predict_word, avg_cost

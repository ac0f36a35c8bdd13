"""Stacked LSTM sentiment classifier (parity: the JAX package's
``models/stacked_lstm.py``; after benchmark/fluid/models/
stacked_dynamic_lstm.py: embedding -> fc -> N x dynamic_lstm -> max
pools -> softmax over 2 classes).

Fluid's LoD ragged batches are padded [B, T] int batches with an
explicit `seq_len` var: the lstm ops run over the padding, and the max
pools mask it by sequence length.
"""

from .. import layers


def build(dict_size=30000, emb_dim=128, hid_dim=128, stacked_num=3,
          seq_len=80, class_dim=2):
    data = layers.data(name="words", shape=[seq_len], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    lengths = layers.data(name="seq_len", shape=[1], dtype="int64")

    emb = layers.embedding(input=data, size=[dict_size, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4, num_flatten_dims=2)
        lstm, cell = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                         is_reverse=False)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max",
                                   sequence_length=lengths)
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max",
                                     sequence_length=lengths)
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return data, label, lengths, prediction, avg_cost, acc

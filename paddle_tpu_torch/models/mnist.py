"""MNIST models (parity: the JAX package's ``models/mnist.py``; after
benchmark/fluid/models/mnist.py cnn_model and the book test's mlp)."""

from .. import layers


def mlp(img, label, hidden_sizes=(128, 64)):
    """Softmax-classifier MLP."""
    h = img
    for size in hidden_sizes:
        h = layers.fc(input=h, size=size, act="relu")
    prediction = layers.fc(input=h, size=10, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def cnn(img, label):
    """Two conv + max-pool stages and a softmax fc (LeNet-like)."""
    conv1 = layers.conv2d(input=img, num_filters=20, filter_size=5,
                          act="relu")
    pool1 = layers.pool2d(input=conv1, pool_size=2, pool_stride=2,
                          pool_type="max")
    conv2 = layers.conv2d(input=pool1, num_filters=50, filter_size=5,
                          act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=2, pool_stride=2,
                          pool_type="max")
    prediction = layers.fc(input=pool2, size=10, act="softmax",
                           num_flatten_dims=1)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def build(arch="mlp", img_shape=(1, 28, 28)):
    """Declare data vars + network; returns (img, label, pred, loss, acc)."""
    if arch == "mlp":
        img = layers.data(name="img", shape=[784], dtype="float32")
    else:
        img = layers.data(name="img", shape=list(img_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    net = mlp if arch == "mlp" else cnn
    prediction, avg_cost, acc = net(img, label)
    return img, label, prediction, avg_cost, acc

"""SE-ResNeXt (parity: the JAX package's ``models/se_resnext.py``; after
the reference's tests/unittests/dist_se_resnext.py): grouped 1-3-1
bottlenecks (cardinality 32) with squeeze-and-excitation gates."""

from .. import layers


def _conv_bn(x, ch_out, filter_size, stride, padding, act="relu",
             groups=1, is_test=False):
    conv = layers.conv2d(input=x, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, groups=groups, act=None,
                         bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def squeeze_excitation(x, num_channels, reduction_ratio=16):
    """A global average pool, two fcs and a sigmoid gate that scales each
    channel of x (elementwise_mul with axis 0)."""
    pool = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    gate = layers.reshape(excitation, shape=[-1, num_channels, 1, 1])
    return layers.elementwise_mul(x, gate, axis=0)


def bottleneck_block(x, num_filters, stride, cardinality=32,
                     reduction_ratio=16, is_test=False):
    ch_in = x.shape[1]
    conv0 = _conv_bn(x, num_filters, 1, 1, 0, is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride, 1, groups=cardinality,
                     is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 2, 1, 1, 0, act=None,
                     is_test=is_test)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    if ch_in != num_filters * 2 or stride != 1:
        short = _conv_bn(x, num_filters * 2, 1, stride, 0, act=None,
                         is_test=is_test)
    else:
        short = x
    return layers.relu(layers.elementwise_add(short, scaled))


def se_resnext(input, class_dim, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False):
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    num_filters = [128, 256, 512, 1024]
    x = _conv_bn(input, 64, 7, 2, 3, is_test=is_test)
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for block, n in enumerate(cfg):
        for i in range(n):
            x = bottleneck_block(
                x, num_filters[block], stride=2 if i == 0 and block != 0
                else 1, cardinality=cardinality,
                reduction_ratio=reduction_ratio, is_test=is_test)
    pool = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.2, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def build(class_dim=10, depth=50, img_shape=(3, 32, 32), is_test=False):
    """Declare data vars + network; returns (img, label, pred, loss, acc)
    (dist_se_resnext.py get_model shape)."""
    img = layers.data(name="img", shape=list(img_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = se_resnext(img, class_dim, depth=depth, is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return img, label, predict, avg_cost, acc

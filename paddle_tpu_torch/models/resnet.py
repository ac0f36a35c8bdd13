"""ResNet (parity: the JAX package's ``models/resnet.py``; after
benchmark/fluid/models/resnet.py: resnet_cifar10 and resnet_imagenet with
basic and bottleneck blocks). Each conv2d is followed by a batch_norm;
the convolutions run on cuDNN in NCHW."""

from .. import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_in, ch_out, stride, is_test=False):
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_test=is_test)
    return input


def basicblock(input, ch_in, ch_out, stride, is_test=False):
    short = shortcut(input, ch_in, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_in, ch_out, stride, is_test=False):
    short = shortcut(input, ch_in, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_in, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_in, ch_out, stride, is_test=is_test)
    ch_in = ch_out * 4 if block_func is bottleneck else ch_out
    for _ in range(1, count):
        res_out = block_func(res_out, ch_in, ch_out, 1, is_test=is_test)
    return res_out


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    if (depth - 2) % 6:
        raise ValueError("resnet_cifar10: depth must be 6n + 2, got %d"
                         % depth)
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, 16, n, 1, is_test=is_test)
    res2 = layer_warp(basicblock, res1, 16, 32, n, 2, is_test=is_test)
    res3 = layer_warp(basicblock, res2, 32, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         pool_stride=1)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    cfg = {18: ([2, 2, 2, 1], basicblock),
           34: ([3, 4, 6, 3], basicblock),
           50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, 64, stages[0], 1,
                      is_test=is_test)
    res2 = layer_warp(block_func, res1, 256, 128, stages[1], 2,
                      is_test=is_test)
    res3 = layer_warp(block_func, res2, 512, 256, stages[2], 2,
                      is_test=is_test)
    res4 = layer_warp(block_func, res3, 1024, 512, stages[3], 2,
                      is_test=is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          pool_stride=1, global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def build(dataset="cifar10", depth=None, class_dim=None, is_test=False):
    """Declare data vars + network (benchmark/fluid/models/resnet.py
    get_model); returns (img, label, pred, avg_cost, acc)."""
    if dataset == "cifar10":
        dshape = [3, 32, 32]
        net = resnet_cifar10
        depth = depth or 32
        class_dim = class_dim or 10
    else:
        dshape = [3, 224, 224]
        net = resnet_imagenet
        depth = depth or 50
        class_dim = class_dim or 1000
    img = layers.data(name="img", shape=dshape, dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = net(img, class_dim=class_dim, depth=depth, is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return img, label, predict, avg_cost, acc

"""VGG-16 with batch norm and dropout (parity: the JAX package's
``models/vgg.py``; after benchmark/fluid/models/vgg.py vgg16_bn_drop)."""

from .. import layers, nets


def vgg16_bn_drop(input, class_dim=10, is_test=False):
    def conv_block(ipt, num_filter, groups):
        return nets.img_conv_group(
            input=ipt,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            pool_type="max")

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)

    drop = layers.dropout(x=conv5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim, act="softmax")


def build(dataset="cifar10", class_dim=None, is_test=False):
    dshape = [3, 32, 32] if dataset == "cifar10" else [3, 224, 224]
    class_dim = class_dim or (10 if dataset == "cifar10" else 1000)
    img = layers.data(name="img", shape=dshape, dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = vgg16_bn_drop(img, class_dim=class_dim, is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return img, label, predict, avg_cost, acc

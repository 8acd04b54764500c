"""ResNet (the port's copy of ``paddle_tpu/models/resnet.py``): the
bottleneck ResNet-50/101/152 for ImageNet (``bench.py``'s headline
model) and the basic-block CIFAR ResNet.  NCHW; the compute dtype is
bf16 by default, with f32 batch-norm statistics and loss.  Both packages
build the same program, op for op and name for name."""

from .. import layers, optimizer as opt


def conv_bn_layer(input, num_filters, filter_size, stride=1, padding=None,
                  act="relu", is_test=False):
    padding = (filter_size - 1) // 2 if padding is None else padding
    conv = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding, bias_attr=False,
    )
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, 1, 0, is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    short = shortcut(input, num_filters * 4, stride, is_test=is_test)
    summed = layers.elementwise_add(short, conv2)
    return layers.relu(summed)


_DEPTH = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def basicblock(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, 1, is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1, 1, act=None,
                          is_test=is_test)
    short = shortcut(input, num_filters, stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(short, conv1))


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """Small basic-block ResNet (depth = 6n + 2)."""
    if (depth - 2) % 6:
        raise ValueError(f"cifar resnet depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    conv = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    for stage_idx, num_filters in enumerate((16, 32, 64)):
        for i in range(n):
            stride = 2 if i == 0 and stage_idx > 0 else 1
            conv = basicblock(conv, num_filters, stride, is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    stages = _DEPTH[depth]
    conv = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test)
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for stage_idx, count in enumerate(stages):
        num_filters = 64 * (2 ** stage_idx)
        for i in range(count):
            stride = 2 if i == 0 and stage_idx > 0 else 1
            pool = bottleneck_block(pool, num_filters, stride,
                                    is_test=is_test)
    pool = layers.pool2d(pool, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def build(depth=50, class_dim=1000, image_shape=(3, 224, 224),
          learning_rate=0.1, momentum=0.9, dtype="bfloat16", is_test=False):
    """The training program (``is_test=False``: Momentum on the mean
    cross-entropy of the softmax output) or the inference one; depths 50,
    101 and 152 are the ImageNet bottleneck nets, any other 6n + 2 the
    CIFAR net.  Returns ``feed``, ``prediction``, ``avg_cost`` and
    ``accuracy``."""
    img = layers.data("img", shape=list(image_shape), dtype=dtype)
    label = layers.data("label", shape=[1], dtype="int64")
    if depth in _DEPTH:
        prediction = resnet_imagenet(img, class_dim, depth, is_test=is_test)
    else:
        prediction = resnet_cifar10(img, class_dim, depth, is_test=is_test)
    pred32 = layers.cast(prediction, "float32")
    cost = layers.cross_entropy(input=pred32, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred32, label=label)
    if not is_test:
        optimizer = opt.Momentum(learning_rate=learning_rate,
                                 momentum=momentum)
        optimizer.minimize(avg_cost)
    return {
        "feed": [img, label],
        "prediction": prediction,
        "avg_cost": avg_cost,
        "accuracy": acc,
    }

"""GoogLeNet / Inception-v1 (``paddle_tpu/models/googlenet.py``; the
reference's ``benchmark/paddle/image/googlenet.py``,
``benchmarks/run.py``'s ``googlenet`` row): nine inception blocks, a
global average pool head, and the two auxiliary classifier heads summed
into the loss at the paper's 0.3 weights; bf16 by default, Momentum
0.9."""

from .. import layers, optimizer as opt
from ..layers import tensor as ltensor


def inception(input, filter1, filter3r, filter3, filter5r, filter5, proj):
    conv1 = layers.conv2d(input, num_filters=filter1, filter_size=1,
                          act="relu")
    conv3r = layers.conv2d(input, num_filters=filter3r, filter_size=1,
                           act="relu")
    conv3 = layers.conv2d(conv3r, num_filters=filter3, filter_size=3,
                          padding=1, act="relu")
    conv5r = layers.conv2d(input, num_filters=filter5r, filter_size=1,
                           act="relu")
    conv5 = layers.conv2d(conv5r, num_filters=filter5, filter_size=5,
                          padding=2, act="relu")
    pool = layers.pool2d(input, pool_size=3, pool_stride=1, pool_padding=1,
                         pool_type="max")
    convproj = layers.conv2d(pool, num_filters=proj, filter_size=1,
                             act="relu")
    return ltensor.concat([conv1, conv3, conv5, convproj], axis=1)


def _aux_head(input, class_dim):
    pool = layers.pool2d(input, pool_size=5, pool_stride=3, pool_type="avg")
    conv = layers.conv2d(pool, num_filters=128, filter_size=1, act="relu")
    fc = layers.fc(input=conv, size=1024, act="relu")
    drop = layers.dropout(fc, dropout_prob=0.7)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def googlenet(input, class_dim=1000, with_aux_heads=True):
    # stem
    conv = layers.conv2d(input, num_filters=64, filter_size=7, stride=2,
                         padding=3, act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_type="max")
    conv = layers.conv2d(pool, num_filters=64, filter_size=1, act="relu")
    conv = layers.conv2d(conv, num_filters=192, filter_size=3, padding=1,
                         act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_type="max")

    ince3a = inception(pool, 64, 96, 128, 16, 32, 32)
    ince3b = inception(ince3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(ince3b, pool_size=3, pool_stride=2,
                          pool_type="max")

    ince4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    ince4b = inception(ince4a, 160, 112, 224, 24, 64, 64)
    ince4c = inception(ince4b, 128, 128, 256, 24, 64, 64)
    ince4d = inception(ince4c, 112, 144, 288, 32, 64, 64)
    ince4e = inception(ince4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(ince4e, pool_size=3, pool_stride=2,
                          pool_type="max")

    ince5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    ince5b = inception(ince5a, 384, 192, 384, 48, 128, 128)
    # 7x7/7 avg pool at 224 input == global average pool; global keeps the
    # net resolution-independent
    pool5 = layers.pool2d(ince5b, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool5, dropout_prob=0.4)
    out = layers.fc(input=drop, size=class_dim, act="softmax")
    if not with_aux_heads:
        return out, None, None
    out1 = _aux_head(ince4a, class_dim)
    out2 = _aux_head(ince4d, class_dim)
    return out, out1, out2


def build(class_dim=1000, image_shape=(3, 224, 224), learning_rate=0.01,
          dtype="bfloat16", with_aux_heads=True):
    img = layers.data("img", shape=list(image_shape), dtype=dtype)
    label = layers.data("label", shape=[1], dtype="int64")
    prediction, out1, out2 = googlenet(img, class_dim,
                                       with_aux_heads=with_aux_heads)
    pred32 = layers.cast(prediction, "float32")
    cost = layers.mean(layers.cross_entropy(input=pred32, label=label))
    if with_aux_heads:
        cost1 = layers.mean(layers.cross_entropy(
            input=layers.cast(out1, "float32"), label=label))
        cost2 = layers.mean(layers.cross_entropy(
            input=layers.cast(out2, "float32"), label=label))
        avg_cost = cost + 0.3 * cost1 + 0.3 * cost2
    else:
        avg_cost = cost
    acc = layers.accuracy(input=pred32, label=label)
    optimizer = opt.Momentum(learning_rate=learning_rate, momentum=0.9)
    optimizer.minimize(avg_cost)
    return {"feed": [img, label], "prediction": prediction,
            "avg_cost": avg_cost, "accuracy": acc}

"""AlexNet (``paddle_tpu/models/alexnet.py``; the reference's
``benchmark/paddle/image/alexnet.py``, ``benchmarks/run.py``'s
``alexnet`` row): conv1..conv5 with LRN after conv1 and conv2, three fc
layers with dropout, bf16 by default, Momentum 0.9."""

from .. import layers, optimizer as opt


def alexnet(input, class_dim=1000, groups=1):
    # conv1: 11x11/4 -> LRN -> maxpool 3/2
    tmp = layers.conv2d(input, num_filters=96, filter_size=11, stride=4,
                        padding=1, act="relu")
    tmp = layers.lrn(tmp, n=5, alpha=1e-4, beta=0.75)
    tmp = layers.pool2d(tmp, pool_size=3, pool_stride=2, pool_type="max")
    # conv2: 5x5 grouped -> LRN -> maxpool
    tmp = layers.conv2d(tmp, num_filters=256, filter_size=5, stride=1,
                        padding=2, groups=groups, act="relu")
    tmp = layers.lrn(tmp, n=5, alpha=1e-4, beta=0.75)
    tmp = layers.pool2d(tmp, pool_size=3, pool_stride=2, pool_type="max")
    # conv3..conv5
    tmp = layers.conv2d(tmp, num_filters=384, filter_size=3, stride=1,
                        padding=1, act="relu")
    tmp = layers.conv2d(tmp, num_filters=384, filter_size=3, stride=1,
                        padding=1, groups=groups, act="relu")
    tmp = layers.conv2d(tmp, num_filters=256, filter_size=3, stride=1,
                        padding=1, groups=groups, act="relu")
    tmp = layers.pool2d(tmp, pool_size=3, pool_stride=2, pool_type="max")

    tmp = layers.fc(input=tmp, size=4096, act="relu")
    tmp = layers.dropout(tmp, dropout_prob=0.5)
    tmp = layers.fc(input=tmp, size=4096, act="relu")
    tmp = layers.dropout(tmp, dropout_prob=0.5)
    return layers.fc(input=tmp, size=class_dim, act="softmax")


def build(class_dim=1000, image_shape=(3, 227, 227), learning_rate=0.01,
          dtype="bfloat16", groups=1):
    img = layers.data("img", shape=list(image_shape), dtype=dtype)
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = alexnet(img, class_dim, groups=groups)
    pred32 = layers.cast(prediction, "float32")
    cost = layers.cross_entropy(input=pred32, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred32, label=label)
    optimizer = opt.Momentum(learning_rate=learning_rate, momentum=0.9)
    optimizer.minimize(avg_cost)
    return {"feed": [img, label], "prediction": prediction,
            "avg_cost": avg_cost, "accuracy": acc}

"""SmallNet, the CIFAR "quick" net (``paddle_tpu/models/smallnet.py``;
the reference's ``benchmark/paddle/image/smallnet_mnist_cifar.py``,
``benchmarks/run.py``'s ``smallnet`` row): three 5x5/3x3 convolutions
with overlapping pools and an fc64 head, Momentum 0.9."""

from .. import layers, optimizer as opt


def smallnet(input, class_dim=10):
    tmp = layers.conv2d(input, num_filters=32, filter_size=5, stride=1,
                        padding=2, act="relu")
    tmp = layers.pool2d(tmp, pool_size=3, pool_stride=2, pool_padding=1,
                        pool_type="max")
    tmp = layers.conv2d(tmp, num_filters=32, filter_size=5, stride=1,
                        padding=2, act="relu")
    tmp = layers.pool2d(tmp, pool_size=3, pool_stride=2, pool_padding=1,
                        pool_type="avg")
    tmp = layers.conv2d(tmp, num_filters=64, filter_size=3, stride=1,
                        padding=1, act="relu")
    tmp = layers.pool2d(tmp, pool_size=3, pool_stride=2, pool_padding=1,
                        pool_type="avg")
    tmp = layers.fc(input=tmp, size=64, act="relu")
    return layers.fc(input=tmp, size=class_dim, act="softmax")


def build(class_dim=10, image_shape=(3, 32, 32), learning_rate=0.01,
          dtype="float32"):
    img = layers.data("img", shape=list(image_shape), dtype=dtype)
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = smallnet(img, class_dim)
    pred32 = layers.cast(prediction, "float32")
    cost = layers.cross_entropy(input=pred32, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred32, label=label)
    optimizer = opt.Momentum(learning_rate=learning_rate, momentum=0.9)
    optimizer.minimize(avg_cost)
    return {"feed": [img, label], "prediction": prediction,
            "avg_cost": avg_cost, "accuracy": acc}

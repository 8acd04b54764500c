"""MNIST LeNet (``paddle_tpu/models/lenet.py``; the reference's
``fluid/tests/book/test_recognize_digits.py`` conv variant,
``BASELINE.json`` config 1): two conv-pool stages and a softmax fc."""

from .. import layers, nets, optimizer as opt


def build(learning_rate=0.01, batch_size=None, dtype="float32",
          optimizer_cls=opt.Adam):
    """Build the training program; returns its key variables."""
    img = layers.data("img", shape=[1, 28, 28], dtype=dtype)
    label = layers.data("label", shape=[1], dtype="int64")
    conv1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu",
    )
    conv2 = nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu",
    )
    prediction = layers.fc(input=conv2, size=10, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    optimizer = optimizer_cls(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {
        "feed": [img, label],
        "prediction": prediction,
        "avg_cost": avg_cost,
        "accuracy": acc,
    }

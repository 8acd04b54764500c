"""Linear regression on UCI housing (``paddle_tpu/models/fit_a_line.py``;
the reference's book ``test_fit_a_line.py``): one fc, the squared error,
SGD."""

from .. import layers, optimizer as opt


def build(learning_rate=0.01):
    x = layers.data("x", shape=[13], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    optimizer = opt.SGD(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": [x, y], "prediction": y_predict, "avg_cost": avg_cost}

"""VGG-16/19 with batch norm (``paddle_tpu/models/vgg.py``; the
reference's ``benchmark/paddle/image/vgg.py`` and the book's
``vgg16_bn``, ``benchmarks/run.py``'s ``vgg`` row at depth 19): five
``nets.img_conv_group`` stages and two dropout fc layers, bf16 by
default, Momentum 0.9."""

from .. import layers, nets, optimizer as opt

_GROUPS = {16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}


def vgg_net(input, class_dim=1000, depth=16, with_bn=True):
    filters = [64, 128, 256, 512, 512]
    tmp = input
    for nf, reps in zip(filters, _GROUPS[depth]):
        tmp = nets.img_conv_group(
            input=tmp, conv_num_filter=[nf] * reps, pool_size=2,
            conv_padding=1, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=with_bn, pool_stride=2, pool_type="max",
        )
    fc1 = layers.fc(input=tmp, size=4096, act="relu")
    drop1 = layers.dropout(fc1, dropout_prob=0.5)
    fc2 = layers.fc(input=drop1, size=4096, act="relu")
    drop2 = layers.dropout(fc2, dropout_prob=0.5)
    return layers.fc(input=drop2, size=class_dim, act="softmax")


def build(depth=16, class_dim=1000, image_shape=(3, 224, 224),
          learning_rate=0.01, dtype="bfloat16"):
    img = layers.data("img", shape=list(image_shape), dtype=dtype)
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = vgg_net(img, class_dim, depth)
    pred32 = layers.cast(prediction, "float32")
    cost = layers.cross_entropy(input=pred32, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred32, label=label)
    optimizer = opt.Momentum(learning_rate=learning_rate, momentum=0.9)
    optimizer.minimize(avg_cost)
    return {"feed": [img, label], "prediction": prediction,
            "avg_cost": avg_cost, "accuracy": acc}

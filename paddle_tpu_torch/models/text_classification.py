"""LSTM text classification (``paddle_tpu/models/text_classification.py``;
the reference's ``benchmark/paddle/rnn/rnn.py`` IMDB LSTM and the book's
``test_understand_sentiment`` stacked LSTM): embedding, an fc to the
four gates, stacked ``dynamic_lstm`` layers (every other one reversed),
a max pool over time and a softmax classifier, trained with Adam."""

from .. import layers, optimizer as opt


def stacked_lstm_net(data, input_dim, class_dim=2, emb_dim=128, hid_dim=512,
                     stacked_num=2):
    emb = layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4, num_flatten_dims=2)
    fc1.lod_level = emb.lod_level
    fc1.block.vars.setdefault(fc1.name + "@LENGTH", data.length_var())
    hidden, cell = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)
    inputs = hidden
    for i in range(1, stacked_num):
        fc = layers.fc(input=inputs, size=hid_dim * 4, num_flatten_dims=2)
        fc.lod_level = inputs.lod_level
        fc.block.vars.setdefault(fc.name + "@LENGTH", data.length_var())
        hidden, cell = layers.dynamic_lstm(
            input=fc, size=hid_dim * 4, is_reverse=(i % 2 == 1)
        )
        inputs = hidden
    last = layers.sequence_pool(input=inputs, pool_type="max")
    return layers.fc(input=last, size=class_dim, act="softmax")


def build(dict_dim, class_dim=2, emb_dim=128, hid_dim=512, stacked_num=2,
          learning_rate=0.002, max_len=128):
    data = layers.data("words", shape=[max_len], dtype="int64", lod_level=1)
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = stacked_lstm_net(
        data, dict_dim, class_dim, emb_dim, hid_dim, stacked_num
    )
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    optimizer = opt.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": [data, label], "prediction": prediction,
            "avg_cost": avg_cost, "accuracy": acc}

"""CTR-DNN with large sparse embeddings (``paddle_tpu/models/ctr_dnn.py``;
``BASELINE.json`` config 5's model, here its single-device program: the
pserver path stays with ``distributed/``, ``ROADMAP.md`` A9).  Dense
features beside one embedding per id slot, a ReLU tower, a two-way
softmax, the cross entropy, the batch's ``auc``, Adam."""

from .. import layers, optimizer as opt


def build(sparse_feature_dim=100000, num_slots=8, embedding_size=16,
          dense_dim=13, hidden=(64, 32), learning_rate=1e-3,
          is_sparse=True):
    dense = layers.data("dense_feature", shape=[dense_dim], dtype="float32")
    slots = [
        layers.data(f"slot_{i}", shape=[1], dtype="int64")
        for i in range(num_slots)
    ]
    label = layers.data("click", shape=[1], dtype="int64")
    embs = [
        layers.embedding(
            input=s, size=[sparse_feature_dim, embedding_size],
            is_sparse=is_sparse,
        )
        for s in slots
    ]
    concat = layers.concat(input=[dense] + embs, axis=1)
    x = concat
    for h in hidden:
        x = layers.fc(input=x, size=h, act="relu")
    predict = layers.fc(input=x, size=2, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    auc = layers.auc(input=predict, label=label)
    optimizer = opt.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": [dense] + slots + [label], "prediction": predict,
            "avg_cost": avg_cost, "auc": auc}


def build_sparse_slots(sparse_feature_dim=1_000_000, num_slots=4,
                       embedding_size=16, dense_dim=13, hidden=(64, 32),
                       learning_rate=1e-3):
    """The CTR configuration whose inputs are the reference's raw
    ``sparse_binary_vector`` / ``sparse_float_vector`` slots (multi-hot
    feature bags) rather than single ids: each slot is a
    ``layers.sparse_data`` handle, and the fc over it is the
    embedding-bag (a weighted sum of table rows, ``sparse_fc``), so the
    vocabulary is bounded by the ``[dim, emb]`` table, never by a
    densified input row."""
    dense = layers.data("dense_feature", shape=[dense_dim], dtype="float32")
    slots = [
        layers.sparse_data(f"slot_{i}", dim=sparse_feature_dim)
        for i in range(num_slots)
    ]
    label = layers.data("click", shape=[1], dtype="int64")
    embs = [layers.fc(input=s, size=embedding_size) for s in slots]
    x = layers.concat(input=[dense] + embs, axis=1)
    for h in hidden:
        x = layers.fc(input=x, size=h, act="relu")
    predict = layers.fc(input=x, size=2, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    auc = layers.auc(input=predict, label=label)
    optimizer = opt.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": [dense] + slots + [label], "prediction": predict,
            "avg_cost": avg_cost, "auc": auc}

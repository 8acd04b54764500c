"""The word2vec N-gram model (``paddle_tpu/models/word2vec.py``; the
reference's book ``test_word2vec.py``): ``n`` words through one shared
embedding table, a sigmoid hidden layer, a softmax over the dictionary
for the next word, SGD."""

from .. import layers, optimizer as opt
from ..param_attr import ParamAttr


def build(dict_size, embed_size=32, hidden_size=256, n=4, learning_rate=0.001):
    words = [
        layers.data(f"word_{i}", shape=[1], dtype="int64") for i in range(n)
    ]
    next_word = layers.data("next_word", shape=[1], dtype="int64")
    shared = ParamAttr(name="shared_w")
    embeds = [
        layers.embedding(
            input=w, size=[dict_size, embed_size], param_attr=shared
        )
        for w in words
    ]
    concat = layers.concat(input=embeds, axis=1)
    hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    predict = layers.fc(input=hidden, size=dict_size, act="softmax")
    cost = layers.cross_entropy(input=predict, label=next_word)
    avg_cost = layers.mean(cost)
    optimizer = opt.SGD(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": words + [next_word], "prediction": predict,
            "avg_cost": avg_cost}

"""Semantic role labelling with stacked LSTMs and a CRF
(``paddle_tpu/models/label_semantic_roles.py``; the reference's book
``test_label_semantic_roles.py``, ``db_lstm``): eight embeddings summed
after their projections, a stack of ``dynamic_lstm`` layers (every
other one reversed), ``linear_chain_crf`` with its transition ``crfw`` at
``10 * learning_rate`` times the rate, SGD; ``crf_decoding`` shares
``crfw``."""

from .. import layers, optimizer as opt
from ..param_attr import ParamAttr


def db_lstm(word_seqs, mark, word_dict_len, label_dict_len, pred_dict_len,
            mark_dict_len=2, word_dim=32, mark_dim=5, hidden_dim=512,
            depth=4):
    """``word_seqs``: [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
    predicate]."""
    predicate = word_seqs[-1]
    pred_emb = layers.embedding(
        input=predicate, size=[pred_dict_len, word_dim],
        param_attr=ParamAttr(name="vemb"),
    )
    word_embs = [
        layers.embedding(input=w, size=[word_dict_len, word_dim])
        for w in word_seqs[:-1]
    ]
    mark_emb = layers.embedding(input=mark, size=[mark_dict_len, mark_dim])
    emb_layers = word_embs + [pred_emb, mark_emb]
    hidden_0_layers = []
    for emb in emb_layers:
        h = layers.fc(input=emb, size=hidden_dim, num_flatten_dims=2,
                      bias_attr=False)
        layers.link_sequence(h, emb)
        hidden_0_layers.append(h)
    hidden_0 = layers.sums(input=hidden_0_layers)
    layers.link_sequence(hidden_0, emb_layers[0])
    lstm_0, _ = layers.dynamic_lstm(input=hidden_0, size=hidden_dim)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix0 = layers.fc(input=input_tmp[0], size=hidden_dim,
                         num_flatten_dims=2, bias_attr=False)
        mix1 = layers.fc(input=input_tmp[1], size=hidden_dim,
                         num_flatten_dims=2, bias_attr=False)
        mix = layers.sums(input=[mix0, mix1])
        layers.link_sequence(mix, input_tmp[0])
        lstm, _ = layers.dynamic_lstm(
            input=mix, size=hidden_dim, is_reverse=(i % 2 == 1)
        )
        input_tmp = [mix, lstm]
    f0 = layers.fc(input=input_tmp[0], size=label_dict_len,
                   num_flatten_dims=2, bias_attr=False)
    f1 = layers.fc(input=input_tmp[1], size=label_dict_len,
                   num_flatten_dims=2, bias_attr=False)
    feature_out = layers.sums(input=[f0, f1])
    layers.link_sequence(feature_out, input_tmp[0])
    return feature_out


def build(word_dict_len=44068, label_dict_len=67, pred_dict_len=3162,
          max_len=64, word_dim=32, hidden_dim=512, depth=4,
          learning_rate=0.01):
    names = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "verb"]
    word_seqs = [
        layers.data(n, shape=[max_len], dtype="int64", lod_level=1)
        for n in names
    ]
    mark = layers.data("mark", shape=[max_len], dtype="int64", lod_level=1)
    target = layers.data("target", shape=[max_len], dtype="int64",
                         lod_level=1)
    feature_out = db_lstm(
        word_seqs, mark, word_dict_len, label_dict_len, pred_dict_len,
        word_dim=word_dim, hidden_dim=hidden_dim, depth=depth,
    )
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name="crfw",
                             learning_rate=10.0 * learning_rate),
    )
    avg_cost = layers.mean(crf_cost)
    crf_decode = layers.crf_decoding(
        input=feature_out, param_attr=ParamAttr(name="crfw")
    )
    optimizer = opt.SGD(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": word_seqs + [mark, target], "avg_cost": avg_cost,
            "feature_out": feature_out, "crf_decode": crf_decode}

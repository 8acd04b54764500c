"""Seq2seq with attention, NMT (``paddle_tpu/models/seq2seq.py``; the
reference's book ``test_machine_translation.py`` and v2 book chapter 8
with ``simple_attention``, BASELINE config 3).

Training: a GRU encoder over the source, and an attention decoder run
over the target by ``StaticRNN`` (one ``scan_block`` op, its sub-block
a step).  The fixed-width beam-search decode (``build_decode``,
``decode_sentences``) needs ``while``, the tensor arrays and the beam
ops, which come with a later slice (``ROADMAP.md`` A9): they raise.
"""

from .. import layers, nets, optimizer as opt
from ..layers.control_flow import StaticRNN

_DECODE_LATER = ("seq2seq.{} needs the while op, the tensor arrays and "
                 "beam_search (ROADMAP.md A9, the seq2seq beam decode); "
                 "not ported yet")


def encoder(src_word_id, dict_size, word_dim=256, hidden_dim=512):
    emb = layers.embedding(input=src_word_id, size=[dict_size, word_dim])
    fc1 = layers.fc(input=emb, size=hidden_dim * 3, num_flatten_dims=2,
                    bias_attr=False)
    layers.link_sequence(fc1, emb)
    enc = layers.dynamic_gru(input=fc1, size=hidden_dim)
    return enc


def train_decoder(enc_seq, trg_embedding, hidden_dim=512,
                  target_dict_size=30000):
    enc_proj = layers.fc(input=enc_seq, size=hidden_dim, num_flatten_dims=2,
                         bias_attr=False)
    layers.link_sequence(enc_proj, enc_seq)
    init_state = layers.sequence_last_step(enc_seq)

    rnn = StaticRNN()
    with rnn.step():
        cur_word = rnn.step_input(trg_embedding)
        state = rnn.memory(init=init_state)
        context = nets.simple_attention(enc_seq, enc_proj, state, hidden_dim)
        decoder_inputs = layers.fc(
            input=[cur_word, context], size=hidden_dim * 3, bias_attr=False
        )
        new_state = layers.gru_unit(
            input=decoder_inputs, hidden=state, size=hidden_dim * 3
        )
        rnn.update_memory(state, new_state)
        out = layers.fc(input=new_state, size=target_dict_size, act="softmax")
        rnn.step_output(out)
    return rnn()


def build(src_dict_size=30000, trg_dict_size=30000, word_dim=256,
          hidden_dim=512, max_len=32, learning_rate=0.0002):
    src = layers.data("src_word_id", shape=[max_len], dtype="int64",
                      lod_level=1)
    trg = layers.data("target_language_word", shape=[max_len], dtype="int64",
                      lod_level=1)
    trg_next = layers.data("target_language_next_word", shape=[max_len],
                           dtype="int64", lod_level=1)
    enc = encoder(src, src_dict_size, word_dim, hidden_dim)
    trg_emb = layers.embedding(input=trg, size=[trg_dict_size, word_dim])
    prediction = train_decoder(enc, trg_emb, hidden_dim, trg_dict_size)
    layers.link_sequence(prediction, trg)
    # masked token-level cross entropy over the padded batch
    cost = layers.cross_entropy(input=prediction, label=trg_next)
    cost = layers.reshape(cost, [0, -1])
    layers.link_sequence(cost, trg)
    summed = layers.sequence_pool(cost, pool_type="sum")
    avg_cost = layers.mean(summed)
    optimizer = opt.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": [src, trg, trg_next], "prediction": prediction,
            "avg_cost": avg_cost, "encoder": enc}


def build_decode(*_args, **_kwargs):
    """The reference's fixed-width beam-search decode program."""
    raise NotImplementedError(_DECODE_LATER.format("build_decode"))


def decode_sentences(*_args, **_kwargs):
    """The reference's host-side backtrack over the fetched beam arrays."""
    raise NotImplementedError(_DECODE_LATER.format("decode_sentences"))

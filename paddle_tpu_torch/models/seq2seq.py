"""Seq2seq with attention, NMT (``paddle_tpu/models/seq2seq.py``; the
reference's book ``test_machine_translation.py`` and v2 book chapter 8
with ``simple_attention``, BASELINE config 3).

Training: a GRU encoder over the source, and an attention decoder run
over the target by ``StaticRNN`` (one ``scan_block`` op, its sub-block
a step).  Decoding: a fixed-width masked beam search (``build_decode``)
in a ``While`` loop whose sub-block is one decoder step and one
``beam_search`` expansion, writing ids and parents into tensor arrays;
``decode_sentences`` backtracks the fetched arrays.
"""

import numpy as np
import torch

from .. import layers, nets, optimizer as opt
from ..layers import control_flow as cf
from ..layers.control_flow import StaticRNN
from ..ops.beam_search_ops import beam_search_decode


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


def build_decode(src_dict_size=30000, trg_dict_size=30000, word_dim=256,
                 hidden_dim=512, max_len=32, beam_size=4, max_out_len=16,
                 end_id=1):
    """The fixed-width beam-search decode program (the reference's
    ``decoder_decode``, ``test_machine_translation.py:85-144``).  Feed
    ``src_word_id`` (and its ``@LENGTH``); fetch ``ids_array`` and
    ``parents_array`` (``[max_out_len, b, k]``), ``scores`` (``[b, k]``)
    and ``steps`` (the trips the loop ran)."""
    src = layers.data("src_word_id", shape=[max_len], dtype="int64",
                      lod_level=1)
    enc = encoder(src, src_dict_size, word_dim, hidden_dim)
    enc_proj = layers.fc(input=enc, size=hidden_dim, num_flatten_dims=2,
                         bias_attr=False)
    layers.link_sequence(enc_proj, enc)
    init_state = layers.sequence_last_step(enc)  # [b, h]
    batch = init_state.shape[0]

    # beam state tensors [b, k]; start token id 0 (<s>)
    pre_ids = layers.fill_constant_batch_size_like(
        init_state, [1, beam_size], "int64", 0.0
    )
    pre_scores = layers.fill_constant_batch_size_like(
        init_state, [1, beam_size], "float32", 0.0
    )
    counter = layers.zeros([1], "int64")
    cond = layers.fill_constant([1], "bool", 1.0)
    # arrays [t, b, k]: the batch dim from the run's batch
    ids_array = layers.fill_constant_batch_size_like(
        init_state, [max_out_len, 1, beam_size], "int64", 0.0,
        output_dim_idx=1,
    )
    parents_array = layers.fill_constant_batch_size_like(
        init_state, [max_out_len, 1, beam_size], "int64", 0.0,
        output_dim_idx=1,
    )
    # the decoder state replicated across beams: [b, k, h]
    state = layers.expand(
        layers.reshape(init_state, [batch, 1, hidden_dim]), [1, beam_size, 1]
    )

    w = cf.While(cond)
    with w.block():
        flat_state = layers.reshape(
            state,
            [batch * beam_size if batch > 0 else -1, hidden_dim],
        )
        context = nets.simple_attention(
            _tile_seq(enc, beam_size), _tile_seq(enc_proj, beam_size),
            flat_state, hidden_dim,
        )
        cur_emb = _beam_embedding(pre_ids, trg_dict_size, word_dim)
        dec_in = layers.fc(
            input=[cur_emb, context], size=hidden_dim * 3, bias_attr=False,
            name="decode_fc",
        )
        new_state = layers.gru_unit(
            input=dec_in, hidden=flat_state, size=hidden_dim * 3
        )
        probs = layers.fc(input=new_state, size=trg_dict_size, act="softmax",
                          name="decode_out")
        log_probs = layers.log(probs)
        scores3 = layers.reshape(log_probs, [batch, beam_size, trg_dict_size])
        sel_ids, sel_scores, parents = layers.beam_search(
            pre_ids, pre_scores, scores3, beam_size, end_id
        )
        cf.array_write(sel_ids, counter, ids_array)
        cf.array_write(parents, counter, parents_array)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)
        # regroup the state by parent beam
        st3 = layers.reshape(new_state, [batch, beam_size, hidden_dim])
        layers.assign(_gather_beams(st3, parents), state)
        layers.increment(counter, 1.0)
        # stop when every beam has emitted end_id or at the length cap
        limit = layers.fill_constant([1], "int64", float(max_out_len))
        running = layers.less_than(counter, limit)
        finished = layers.reduce_min(
            layers.cast(layers.equal(
                sel_ids,
                layers.fill_constant([1], "int64", float(end_id)),
            ), "float32")
        )
        not_all_done = layers.less_than(
            finished, layers.fill_constant([1], "float32", 1.0)
        )
        layers.assign(layers.logical_and(running, not_all_done), cond)

    return {"feed": [src], "ids_array": ids_array,
            "parents_array": parents_array, "scores": pre_scores,
            "steps": counter}


def _tile_seq(x, k):
    """``[b, t, d] -> [b * k, t, d]``, each row's lengths tiled alike."""
    b, t = x.shape[0], x.shape[1]
    d = x.shape[2]
    out = layers.reshape(
        layers.expand(layers.reshape(x, [b, 1, t, d]), [1, k, 1, 1]),
        [b * k if b > 0 else -1, t, d],
    )
    if x.lod_level > 0:
        ln = x.length_var()
        tiled = layers.reshape(
            layers.expand(layers.reshape(ln, [b, 1]), [1, k]),
            [b * k if b > 0 else -1])
        out.block.vars[out.name + "@LENGTH"] = tiled
        out.lod_level = x.lod_level
    return out


def _gather_beams(x, parents):
    """Regroup ``[b, k, d]`` by the parent beams ``[b, k]``:
    ``out[b, i] = x[b, parents[b, i]]``, as the product ``one_hot(parents)
    @ x`` (the reference's dense matmul in place of a gather; the
    ``matmul`` op takes f32 without TF32 on the card, so the rows come
    back exactly)."""
    k = x.shape[1]
    onehot = layers.one_hot(parents, k)  # [b, k, k] float32
    return layers.matmul(layers.cast(onehot, x.dtype), x)


def _beam_embedding(pre_ids, dict_size, word_dim):
    flat = layers.reshape(pre_ids, [-1, 1])
    return layers.embedding(input=flat, size=[dict_size, word_dim],
                            param_attr="trg_embedding_w")


def decode_sentences(ids_array_val, parents_array_val, steps, end_id=1):
    """Backtrack the fetched arrays of ``build_decode`` into sentences
    ``[b, k, steps]`` (numpy): ``beam_search_decode`` run outside the
    program, on the arrays' first ``steps`` rows (numpy arrays, or
    tensors on any device)."""
    t = int(np.asarray(torch.as_tensor(steps).cpu()).reshape(-1)[0])
    ids = torch.as_tensor(ids_array_val)[:t]
    parents = torch.as_tensor(parents_array_val)[:t]
    out = beam_search_decode(Ids=ids, ParentIdx=parents, end_id=end_id)
    return out["SentenceIds"].cpu().numpy()

"""DeepSpeech2 with CTC (``paddle_tpu/models/deep_speech2.py``;
``BASELINE.json`` config 4, ``benchmarks/run.py``'s ``ds2`` row): three
bidirectional GRU layers over the padded spectrogram, a ``row_conv``
lookahead of 4 frames with relu, an fc to vocab + 1 (the blank last),
``warpctc`` and Adam; the greedy CTC decoder on the softmax.  What the
reference builds: no convolutional front end."""

from .. import layers, optimizer as opt


def bigru_layer(input, size):
    fc_f = layers.fc(input=input, size=size * 3, num_flatten_dims=2,
                     bias_attr=False)
    layers.link_sequence(fc_f, input)
    fwd = layers.dynamic_gru(input=fc_f, size=size)
    fc_b = layers.fc(input=input, size=size * 3, num_flatten_dims=2,
                     bias_attr=False)
    layers.link_sequence(fc_b, input)
    bwd = layers.dynamic_gru(input=fc_b, size=size, is_reverse=True)
    out = layers.concat([fwd, bwd], axis=2)
    layers.link_sequence(out, input)
    return out


def ds2_network(audio, feat_dim, num_rnn_layers=3, rnn_size=256,
                vocab_size=29, lookahead=4):
    """``audio``: ``[b, t, feat_dim]`` padded spectrogram sequence."""
    x = audio
    for _ in range(num_rnn_layers):
        x = bigru_layer(x, rnn_size)
    x = layers.row_conv(input=x, future_context_size=lookahead, act="relu")
    logits = layers.fc(input=x, size=vocab_size + 1, num_flatten_dims=2)
    layers.link_sequence(logits, audio)
    return logits


def build(feat_dim=161, max_audio_len=256, max_label_len=64, rnn_size=256,
          num_rnn_layers=3, vocab_size=29, learning_rate=5e-4):
    audio = layers.data("audio", shape=[max_audio_len, feat_dim],
                        dtype="float32", lod_level=1)
    label = layers.data("transcript", shape=[max_label_len], dtype="int64",
                        lod_level=1)
    logits = ds2_network(audio, feat_dim, num_rnn_layers, rnn_size,
                         vocab_size)
    loss = layers.warpctc(input=logits, label=label, blank=vocab_size)
    avg_loss = layers.mean(loss)
    optimizer = opt.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_loss)
    probs = layers.softmax(logits)
    layers.link_sequence(probs, audio)
    decoded = layers.ctc_greedy_decoder(probs, blank=vocab_size)
    return {"feed": [audio, label], "logits": logits, "avg_cost": avg_loss,
            "decoded": decoded}

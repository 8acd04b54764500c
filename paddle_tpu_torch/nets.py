"""Composite networks (``paddle_tpu/nets.py``): ``simple_attention``
(seq2seq's decoder), ``sequence_conv_pool``, ``bidirectional_lstm`` /
``bidirectional_gru``, and the image helpers ``simple_img_conv_pool``,
``img_conv_group``, ``img_conv_bn_pool``, ``img_separable_conv``.
``scaled_dot_product_attention`` takes its fused path (the flash op);
its composed path, ``glu`` and ``dot_product_attention`` need
``transpose``, ``matmul`` and ``split``, which the op long tail brings
(``ROADMAP.md`` A9), and raise, naming it."""

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "img_conv_group",
    "img_conv_bn_pool",
    "img_separable_conv",
    "sequence_conv_pool",
    "glu",
    "scaled_dot_product_attention",
    "dot_product_attention",
    "simple_attention",
    "bidirectional_lstm",
    "bidirectional_gru",
]

_LATER = ("nets.{} needs the {} op, which the op long tail brings "
          "(ROADMAP.md A9); not ported yet")


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, pool_type="max", param_attr=None):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride,
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    tmp = input
    n = len(conv_num_filter)
    if not isinstance(conv_padding, (list, tuple)):
        conv_padding = [conv_padding] * n
    if not isinstance(conv_with_batchnorm, (list, tuple)):
        conv_with_batchnorm = [conv_with_batchnorm] * n
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * n
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=nf, filter_size=conv_filter_size,
            padding=conv_padding[i], param_attr=param_attr, act=local_act,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride,
    )


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max", param_attr=None):
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act,
    )
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    raise NotImplementedError(_LATER.format("glu", "split"))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, use_fused=True):
    """Multi-head scaled dot-product attention over dense ``[b, t, d]``
    tensors through the flash op (``use_fused`` and no dropout)."""
    d = queries.shape[-1]
    if d % num_heads != 0:
        raise ValueError(f"hidden size {d} not divisible by num_heads "
                         f"{num_heads}")
    if not use_fused or dropout_rate:
        raise NotImplementedError(_LATER.format(
            "scaled_dot_product_attention's composed path", "matmul"))
    tq, tk = queries.shape[1], keys.shape[1]
    hd = d // num_heads
    q4 = layers.reshape(queries, [0, tq, num_heads, hd])
    k4 = layers.reshape(keys, [0, tk, num_heads, hd])
    v4 = layers.reshape(values, [0, tk, num_heads, hd])
    out = layers.flash_attention(q4, k4, v4)
    return layers.reshape(out, [0, tq, d])


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     decoder_size):
    """Bahdanau-style additive attention over a padded sequence batch:
    ``encoded_sequence [b, t, d_enc]``, ``encoded_proj [b, t, d_dec]``,
    ``decoder_state [b, d_dec]`` -> context ``[b, d_enc]``."""
    decoder_state_proj = layers.fc(
        input=decoder_state, size=decoder_size, bias_attr=False
    )
    expanded = layers.sequence_expand(x=decoder_state_proj, y=encoded_proj)
    combined = layers.elementwise_add(encoded_proj, expanded)
    combined = layers.tanh(combined)
    # attention energies [b, t, 1] -> weights by a masked softmax
    attention_weights = layers.fc(
        input=combined, size=1, num_flatten_dims=2, bias_attr=False
    )
    attention_weights = layers.reshape(
        attention_weights,
        [attention_weights.shape[0], attention_weights.shape[1]]
    )
    attention_weights.lod_level = encoded_sequence.lod_level
    if encoded_sequence.lod_level > 0:
        attention_weights.block.vars.setdefault(
            attention_weights.name + "@LENGTH", encoded_sequence.length_var()
        )
    attention_weights = layers.sequence_softmax(attention_weights)
    scaled = layers.elementwise_mul(
        encoded_sequence, attention_weights, axis=0
    )
    scaled.lod_level = encoded_sequence.lod_level
    if encoded_sequence.lod_level > 0:
        scaled.block.vars.setdefault(
            scaled.name + "@LENGTH", encoded_sequence.length_var()
        )
    return layers.sequence_pool(scaled, pool_type="sum")


def img_conv_bn_pool(input, num_filters, filter_size, pool_size, pool_stride,
                     act="relu", conv_padding=0, pool_type="max",
                     is_test=False, param_attr=None):
    """conv -> batch_norm(act) -> pool."""
    conv = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        padding=conv_padding, param_attr=param_attr, act=None,
        bias_attr=False,
    )
    bn = layers.batch_norm(conv, act=act, is_test=is_test)
    return layers.pool2d(bn, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type=pool_type)


def img_separable_conv(input, num_channels, num_out_channels, filter_size,
                       stride=1, padding=0, act=None, bias_attr=None):
    """Depthwise + pointwise separable convolution."""
    depthwise = layers.conv2d(
        input=input, num_filters=num_channels, filter_size=filter_size,
        stride=stride, padding=padding, groups=num_channels,
        act=None, bias_attr=bias_attr,
    )
    return layers.conv2d(
        input=depthwise, num_filters=num_out_channels, filter_size=1,
        act=act, bias_attr=bias_attr,
    )


def bidirectional_lstm(input, size, return_concat=True):
    """Forward and backward dynamic LSTMs over a padded sequence batch:
    ``input [b, t, 4 * size]`` pre-projected -> ``[b, t, 2 * size]``
    (or the pair)."""
    fwd, _ = layers.dynamic_lstm(input, size=size * 4, is_reverse=False)
    bwd, _ = layers.dynamic_lstm(input, size=size * 4, is_reverse=True)
    if not return_concat:
        return fwd, bwd
    out = layers.concat([fwd, bwd], axis=2)
    layers.link_sequence(out, input)
    return out


def bidirectional_gru(input, size, return_concat=True):
    """Forward and backward dynamic GRUs; ``input [b, t, 3 * size]``
    pre-projected."""
    fwd = layers.dynamic_gru(input, size=size, is_reverse=False)
    bwd = layers.dynamic_gru(input, size=size, is_reverse=True)
    if not return_concat:
        return fwd, bwd
    out = layers.concat([fwd, bwd], axis=2)
    layers.link_sequence(out, input)
    return out


def dot_product_attention(queries, keys, values):
    raise NotImplementedError(_LATER.format("dot_product_attention",
                                            "matmul"))

"""Composite networks (``paddle_tpu/nets.py``): ``simple_attention``
(seq2seq's decoder), ``sequence_conv_pool``, ``bidirectional_lstm`` /
``bidirectional_gru``, the image helpers ``simple_img_conv_pool``,
``img_conv_group``, ``img_conv_bn_pool``, ``img_separable_conv``,
``glu``, and the attentions: ``scaled_dot_product_attention`` (the
flash op, or with dropout or ``use_fused=False`` the composed
softmax(QK^T)V) and ``dot_product_attention``."""

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
    """The gated linear unit: ``a * sigmoid(b)`` of ``input``'s two halves
    along ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, use_fused=True):
    """Multi-head scaled dot-product attention over dense ``[b, t, d]``
    tensors: the flash op (``use_fused`` and no dropout), or the
    composed softmax(QK^T)V with the same per-head scale ``hd ** -0.5``
    and dropout on the attention weights."""
    d = queries.shape[-1]
    if d % num_heads != 0:
        raise ValueError(f"hidden size {d} not divisible by num_heads "
                         f"{num_heads}")
    tq, tk = queries.shape[1], keys.shape[1]
    hd = d // num_heads
    q4 = layers.reshape(queries, [0, tq, num_heads, hd])
    k4 = layers.reshape(keys, [0, tk, num_heads, hd])
    v4 = layers.reshape(values, [0, tk, num_heads, hd])
    if use_fused and not dropout_rate:
        out = layers.flash_attention(q4, k4, v4)
        return layers.reshape(out, [0, tq, d])
    qh = layers.transpose(q4, [0, 2, 1, 3])  # [b, h, tq, hd]
    kh = layers.transpose(k4, [0, 2, 1, 3])
    vh = layers.transpose(v4, [0, 2, 1, 3])
    scaled_q = layers.scale(qh, scale=float(hd) ** -0.5)
    product = layers.matmul(scaled_q, kh, transpose_y=True)  # [b, h, tq, tk]
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    out = layers.matmul(weights, vh)  # [b, h, tq, hd]
    out = layers.transpose(out, [0, 2, 1, 3])
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
    """Unscaled single-head dot-product attention: softmax(Q K^T) V."""
    product = layers.matmul(queries, keys, transpose_y=True)
    weights = layers.softmax(product)
    return layers.matmul(weights, values)

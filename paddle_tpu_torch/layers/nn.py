"""Neural-net layers (``paddle_tpu/layers/nn.py``), the part
``models.transformer``, ``resnet``, ``text_classification`` and
``seq2seq`` reach: ``fc``, ``embedding``, ``layer_norm``, ``dropout``,
``softmax_with_cross_entropy``, ``fused_softmax_ce_head``,
``flash_attention`` / ``flash_attention_packed``,
``multi_head_attention``, ``scale``, ``reduce_sum``, ``conv2d``,
``pool2d``, ``batch_norm``, ``cross_entropy``, ``accuracy``,
``softmax``, ``topk``, ``mean``; the recurrent layers
``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``, ``gru_unit``,
``lstm_unit``; and the sequence layers ``link_sequence``,
``sequence_conv``, ``sequence_pool``, ``sequence_first_step`` /
``sequence_last_step``, ``sequence_expand``, ``sequence_reshape``,
``sequence_softmax``, ``sequence_reverse``, which wire the shadow
``@LENGTH`` variables as the reference does; CTC's ``warpctc``,
``ctc_greedy_decoder``, ``edit_distance`` and ``row_conv``; the CRF's
``linear_chain_crf`` and ``crf_decoding``; ``lrn``; ``prelu``; the
rest of the ``reduce_*`` family, ``matmul``, ``cos_sim``,
``square_error_cost``, ``auc``, the beam decode's ``beam_search``
and ``beam_search_decode``; and what the v1 DSL (``compat/``) reaches:
``conv3d``, ``pool3d``, ``spp``, ``maxout``, ``im2sequence``, the losses
``sigmoid_cross_entropy_with_logits``, ``smooth_l1``, ``nce``,
``hsigmoid``, ``bilinear_tensor_product``, ``selective_fc``,
``chunk_eval`` and the nested-sequence layers (``nested_sequence_pool``,
``_expand``, ``_slice``, ``sub_nested_seq``, ``nested_rnn``).  ``fc`` over a sparse slot
(``layers.sparse_data``) lowers to ``sparse_fc``.  Each layer creates
parameters through LayerHelper and appends ops; names, shapes, attrs
and initializers are the reference's, so both packages build the same
program and weights carry across by name."""

import numpy as np

from ..core.program import IDS_SUFFIX, VALS_SUFFIX
from ..param_attr import ParamAttr
from .. import initializer as init_mod
from .layer_helper import LayerHelper, seq_length

__all__ = [
    "link_sequence",
    "fc",
    "embedding",
    "dynamic_lstm",
    "dynamic_lstmp",
    "dynamic_gru",
    "gru_unit",
    "lstm_unit",
    "layer_norm",
    "dropout",
    "softmax_with_cross_entropy",
    "fused_softmax_ce_head",
    "flash_attention",
    "flash_attention_packed",
    "multi_head_attention",
    "scale",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "matmul",
    "mul",
    "clip",
    "clip_by_norm",
    "multiplex",
    "l2_normalize",
    "cos_sim",
    "square_error_cost",
    "auc",
    "beam_search",
    "beam_search_decode",
    "conv2d",
    "pool2d",
    "batch_norm",
    "cross_entropy",
    "accuracy",
    "softmax",
    "topk",
    "mean",
    "sequence_conv",
    "sequence_pool",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_expand",
    "sequence_reshape",
    "sequence_softmax",
    "sequence_reverse",
    "warpctc",
    "ctc_greedy_decoder",
    "edit_distance",
    "row_conv",
    "linear_chain_crf",
    "crf_decoding",
    "lrn",
    "prelu",
    "conv3d",
    "pool3d",
    "sigmoid_cross_entropy_with_logits",
    "smooth_l1",
    "chunk_eval",
    "bilinear_tensor_product",
    "im2sequence",
    "hsigmoid",
    "selective_fc",
    "nce",
    "maxout",
    "spp",
    "nested_sequence_pool",
    "nested_sequence_expand",
    "nested_sequence_slice",
    "sub_nested_seq",
    "nested_rnn",
]


def _ntuple(v, n):
    # sequences pass through, any scalar (python or numpy int) broadcasts
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _conv_osize(i, k, s, p, d=1):
    """Conv output extent (floor mode); -1 stays dynamic."""
    if i < 0:
        return -1
    eff = (k - 1) * d + 1
    return (i + 2 * p - eff) // s + 1


def _pool_osize(i, k, s, p, ceil_mode=False, global_pooling=False):
    if global_pooling:
        return 1
    if i < 0:
        return -1
    num = i + 2 * p - k
    return (num + s - 1) // s + 1 if ceil_mode else num // s + 1


def _seq_inputs(inputs, x):
    ln = seq_length(x)
    if ln is not None:
        inputs["Length"] = [ln.name]
    return ln


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, **kwargs):
    helper = LayerHelper("fc", bias_attr=bias_attr, act=act, name=name, **kwargs)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for i, x in enumerate(inputs):
        suffix = "w" if len(inputs) == 1 else f"w_{i}"
        if getattr(x, "sparse_slot", False):
            # a sparse input slot: the weighted gather-sum of O(nnz) rows
            # over its fed ``@IDS`` / ``@VALS`` (layers.sparse_data)
            w = helper.create_parameter(
                param_attr, shape=[x.shape[-1], size], dtype=x.dtype,
                suffix=suffix,
            )
            tmp = helper.create_tmp_variable(
                x.dtype, list(x.shape[:-1]) + [size], lod_level=x.lod_level)
            helper.append_op(
                type="sparse_fc",
                inputs={"Ids": [x.name + IDS_SUFFIX],
                        "Vals": [x.name + VALS_SUFFIX], "W": [w.name]},
                outputs={"Out": [tmp.name]},
            )
            _link_length(tmp, x)
            mul_results.append(tmp)
            continue
        in_dim = int(np.prod(x.shape[num_flatten_dims:]))
        # one weight per input (duplicable W slot); w_0, w_1... when several
        w = helper.create_parameter(
            param_attr, shape=[in_dim, size], dtype=x.dtype,
            suffix=suffix,
        )
        out_shape = list(x.shape[:num_flatten_dims]) + [size]
        tmp = helper.create_tmp_variable(x.dtype, out_shape, lod_level=x.lod_level)
        helper.append_op(
            type="mul",
            inputs={"X": [x.name], "Y": [w.name]},
            outputs={"Out": [tmp.name]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(
            mul_results[0].dtype, mul_results[0].shape,
            lod_level=mul_results[0].lod_level,
        )
        helper.append_op(
            type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias.name]}
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=len(pre_bias.shape) - 1)
    out = helper.append_activation(pre_act)
    out.lod_level = inputs[0].lod_level
    return out


def embedding(input, size, is_sparse=False, padding_idx=None, param_attr=None,
              dtype="float32", name=None):
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(
        param_attr, shape=list(size), dtype=dtype, suffix="w",
        default_initializer=init_mod.Uniform(-0.05, 0.05),
    )
    ishape = list(input.shape)
    if ishape and ishape[-1] == 1:
        ishape = ishape[:-1]
    out = helper.create_tmp_variable(dtype, ishape + [size[1]], lod_level=input.lod_level)
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "is_sparse": is_sparse,
            "padding_idx": -1 if padding_idx is None else padding_idx,
        },
    )
    if input.lod_level > 0:
        # propagate sequence lengths to the embedded output
        out.block.vars[out.name + "@LENGTH"] = input.length_var()
        out.lod_level = input.lod_level
    return out


def _link_length(out, src):
    """Make ``out`` share ``src``'s sequence-length variable."""
    if getattr(src, "lod_level", 0) > 0:
        out.block.vars.setdefault(out.name + "@LENGTH", src.length_var())
        out.lod_level = src.lod_level
    return out


def link_sequence(out, src):
    """Mark ``out`` as a sequence batch sharing ``src``'s lengths (after
    a shape-preserving layer such as ``fc`` with ``num_flatten_dims=2``)."""
    return _link_length(out, src)


def dynamic_lstm(input, size, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", param_attr=None, bias_attr=None,
                 name=None):
    """LSTM over a padded sequence batch ``[b, t, 4d]`` (the input already
    projected to ``4 * hidden``); ``size = 4 * hidden``."""
    helper = LayerHelper("lstm", name=name)
    d = size // 4
    weight = helper.create_parameter(param_attr, shape=[d, 4 * d],
                                     dtype=input.dtype)
    bias_size = 7 * d if use_peepholes else 4 * d
    bias = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[1, bias_size],
        dtype=input.dtype, suffix="b",
        default_initializer=init_mod.Constant(0.0),
    )
    hidden = helper.create_tmp_variable(
        input.dtype, list(input.shape[:2]) + [d], lod_level=input.lod_level)
    cell = helper.create_tmp_variable(
        input.dtype, list(input.shape[:2]) + [d], lod_level=input.lod_level)
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    _seq_inputs(inputs, input)
    helper.append_op(
        type="lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    _link_length(hidden, input)
    _link_length(cell, input)
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", param_attr=None, bias_attr=None,
                  name=None):
    """LSTM with a recurrent projection to ``proj_size``."""
    helper = LayerHelper("lstmp", name=name)
    d = size // 4
    weight = helper.create_parameter(
        param_attr, shape=[proj_size, 4 * d], dtype=input.dtype)
    proj_weight = helper.create_parameter(
        param_attr, shape=[d, proj_size], dtype=input.dtype, suffix="proj_w")
    bias_size = 7 * d if use_peepholes else 4 * d
    bias = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[1, bias_size],
        dtype=input.dtype, suffix="b",
        default_initializer=init_mod.Constant(0.0),
    )
    proj = helper.create_tmp_variable(
        input.dtype, list(input.shape[:2]) + [proj_size],
        lod_level=input.lod_level)
    inputs = {
        "Input": [input.name],
        "Weight": [weight.name],
        "ProjWeight": [proj_weight.name],
        "Bias": [bias.name],
    }
    _seq_inputs(inputs, input)
    helper.append_op(
        type="lstmp",
        inputs=inputs,
        outputs={"Projection": [proj.name]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
            "proj_activation": proj_activation,
        },
    )
    return _link_length(proj, input)


def dynamic_gru(input, size, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", param_attr=None, bias_attr=None,
                h_0=None, name=None):
    """GRU over a padded batch ``[b, t, 3d]``; ``size = d``."""
    helper = LayerHelper("gru", name=name)
    d = size
    weight = helper.create_parameter(param_attr, shape=[d, 3 * d],
                                     dtype=input.dtype)
    bias = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[1, 3 * d],
        dtype=input.dtype, suffix="b",
        default_initializer=init_mod.Constant(0.0),
    )
    hidden = helper.create_tmp_variable(
        input.dtype, list(input.shape[:2]) + [d], lod_level=input.lod_level)
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    _seq_inputs(inputs, input)
    helper.append_op(
        type="gru",
        inputs=inputs,
        outputs={"Hidden": [hidden.name]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    return _link_length(hidden, input)


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step; ``size = 3 * hidden_dim``."""
    helper = LayerHelper("gru_unit")
    d = size // 3
    weight = helper.create_parameter(param_attr, shape=[d, 3 * d],
                                     dtype=input.dtype)
    bias = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[1, 3 * d],
        dtype=input.dtype, suffix="b",
        default_initializer=init_mod.Constant(0.0),
    )
    out = helper.create_tmp_variable(input.dtype, list(hidden.shape))
    helper.append_op(
        type="gru_unit",
        inputs={
            "Input": [input.name],
            "HiddenPrev": [hidden.name],
            "Weight": [weight.name],
            "Bias": [bias.name],
        },
        outputs={"Hidden": [out.name]},
        attrs={"activation": activation, "gate_activation": gate_activation},
    )
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None):
    """One LSTM step with its own input projection."""
    d = cell_t_prev.shape[-1]
    gates = fc([x_t, hidden_t_prev], size=4 * d, param_attr=param_attr,
               bias_attr=bias_attr if bias_attr is not None else ParamAttr())
    helper = LayerHelper("lstm_unit")
    c = helper.create_tmp_variable(x_t.dtype, list(cell_t_prev.shape))
    h = helper.create_tmp_variable(x_t.dtype, list(cell_t_prev.shape))
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [gates.name], "C_prev": [cell_t_prev.name]},
        outputs={"C": [c.name], "H": [h.name]},
        attrs={"forget_bias": float(forget_bias)},
    )
    return h, c


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype=input.dtype, suffix="scale",
            default_initializer=init_mod.Constant(1.0),
        )
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(
            ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=norm_shape,
            dtype=input.dtype, suffix="bias",
            default_initializer=init_mod.Constant(0.0),
        )
        inputs["Bias"] = [b.name]
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    mean = helper.create_tmp_variable("float32", list(input.shape[:begin_norm_axis]), stop_gradient=True)
    var = helper.create_tmp_variable("float32", list(input.shape[:begin_norm_axis]), stop_gradient=True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=0, name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, list(x.shape), lod_level=x.lod_level)
    mask = helper.create_tmp_variable(x.dtype, list(x.shape), stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Mask": [mask.name]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed,
            "fix_seed": bool(seed),
        },
    )
    return _link_length(out, x)


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_tmp_variable(logits.dtype, list(logits.shape))
    loss = helper.create_tmp_variable(logits.dtype, list(logits.shape[:-1]) + [1])
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits.name], "Label": [label.name]},
        outputs={"Softmax": [softmax_out.name], "Loss": [loss.name]},
        attrs={"soft_label": soft_label},
    )
    return loss


def fused_softmax_ce_head(input, label, size, param_attr=None, name=None,
                          block_n=512, block_v=1024, block_v_fwd=2048,
                          backend=None):
    """Fused LM-head loss: projection ``[d -> size]`` + softmax
    cross-entropy in one pass that never materialises ``[..., size]``
    logits in device memory (``kernels/fused_ce.py``).  Replaces the
    composed ``fc(bias_attr=False) + softmax_with_cross_entropy`` head.
    Returns the per-position loss ``[..., 1]`` float32; rows with
    out-of-range labels must be masked by the caller, as on the composed
    path.  The block sizes and ``backend`` are recorded as attrs, as the
    reference records them; the CUDA kernels tile by their own sizes, and
    the op resolves ``backend`` (``cuda``, ``triton`` or ``torch_ref``) as
    a strict request through the kernel registry."""
    helper = LayerHelper("fused_softmax_ce_head", name=name)
    in_dim = int(input.shape[-1])
    w = helper.create_parameter(
        param_attr, shape=[in_dim, size], dtype=input.dtype, suffix="w")
    loss = helper.create_tmp_variable(
        "float32", list(input.shape[:-1]) + [1])
    attrs = {"block_n": block_n, "block_v": block_v,
             "block_v_fwd": block_v_fwd}
    if backend:
        attrs["backend"] = str(backend)
    helper.append_op(
        type="fused_softmax_ce_head",
        inputs={"X": [input.name], "W": [w.name], "Label": [label.name]},
        outputs={"Loss": [loss.name]},
        attrs=attrs,
    )
    return loss


def flash_attention_packed(q, k, v, n_head, causal=False, sm_scale=None,
                           block_q=None, block_k=None, backend=None,
                           name=None):
    """Fused attention on the raw projection layout: q/k/v [b, t, h*d]
    (what the QKV matmuls emit) -> [b, t, h*d] (what the out-projection
    consumes).  No [b,t,h,d]<->[bh,t,d] pack/unpack transposes exist: the
    kernels address heads through strides (kernels/flash_attention.py).
    ``block_q``/``block_k``/``backend`` are recorded as attrs, as the
    reference records them; the CUDA kernels tile by their own sizes, and
    the op resolves ``backend`` as a strict request through the kernel
    registry."""
    helper = LayerHelper("flash_attention_packed", name=name)
    out = helper.create_tmp_variable(q.dtype, q.shape)
    attrs = {"n_head": int(n_head), "causal": bool(causal),
             "sm_scale": 0.0 if sm_scale is None else float(sm_scale)}
    if backend:
        attrs["backend"] = str(backend)
    if block_q:
        attrs["block_q"] = int(block_q)
    if block_k:
        attrs["block_k"] = int(block_k)
    helper.append_op(
        type="flash_attention_packed",
        inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
        outputs={"Out": [out.name]},
        attrs=attrs,
    )
    return out


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=None,
                    block_k=None, backend=None, name=None):
    """Fused blockwise attention (kernels/flash_attention.py).
    q [b, t_q, h, d], k/v [b, t_k, h, d] -> [b, t_q, h, d].
    ``block_q``/``block_k``/``backend`` are recorded as attrs; the op
    resolves ``backend`` as a strict request through the kernel
    registry."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_tmp_variable(q.dtype, q.shape)
    attrs = {"causal": bool(causal),
             "sm_scale": 0.0 if sm_scale is None else float(sm_scale)}
    if backend:
        attrs["backend"] = str(backend)
    if block_q:
        attrs["block_q"] = int(block_q)
    if block_k:
        attrs["block_k"] = int(block_k)
    helper.append_op(
        type="flash_attention",
        inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
        outputs={"Out": [out.name]},
        attrs=attrs,
    )
    return out


def multi_head_attention(queries, keys, values, d_model, n_head,
                         dropout_rate=0.0, causal=False, is_test=False,
                         param_attr=None, block_q=None, block_k=None,
                         packed=None, backend=None, name=None):
    """Multi-head attention block: QKV projections -> fused flash
    attention -> output projection.  Inputs are ``[batch, time, dim]``;
    ``d_model`` must divide by ``n_head``.

    ``packed`` forces the head routing: True = the packed op (geometry
    permitting), False = the 4-D op, None = by geometry, with the
    reference's rule (``packed_sub_heads``), so both packages emit the
    same op.

    The geometry is TUNABLE (``tune.attention_config``): when the caller
    passes no ``block_q`` / ``block_k`` / ``backend`` for a causal
    self-attention, the tune cache's measured winner for this shape is
    used (its ``block_k`` picks the backward route, and a persisted
    ``backend`` becomes the op's attr); a miss or ``PADDLE_TPU_TUNE=0``
    keeps the defaults.  Explicit arguments win.
    """
    if d_model % n_head:
        raise ValueError(f"d_model {d_model} not divisible by n_head {n_head}")
    from .tensor import reshape
    from ..param_attr import ParamAttr

    def _proj_attr(suffix):
        # each projection needs its OWN parameter: a shared named attr
        # would silently tie Q/K/V/out weights together (create_parameter
        # reuses same-named params), so suffix any user-provided name.
        attr = ParamAttr.to_attr(param_attr)
        if attr is not None and attr.name is not None:
            import copy

            attr = copy.copy(attr)
            attr.name = f"{attr.name}_{suffix}"
        return attr

    b, tq = queries.shape[0], queries.shape[1]
    tk = keys.shape[1]
    dh = d_model // n_head
    if (block_q is None and block_k is None and backend is None
            and causal and tq == tk):
        from ..tune import attention_config

        tuned = attention_config(tq, dh, n_head, queries.dtype,
                                 causal=causal)
        if tuned:
            block_q = tuned.get("block_q")
            block_k = tuned.get("block_k")
            backend = tuned.get("backend")
            if packed is None:
                packed = tuned.get("packed")
    q = fc(queries, d_model, num_flatten_dims=2, param_attr=_proj_attr("q"),
           name=None if name is None else name + "_q")
    k = fc(keys, d_model, num_flatten_dims=2, param_attr=_proj_attr("k"),
           name=None if name is None else name + "_k")
    v = fc(values, d_model, num_flatten_dims=2, param_attr=_proj_attr("v"),
           name=None if name is None else name + "_v")
    from ..kernels.flash_attention import packed_sub_heads

    use_packed = packed_sub_heads(n_head, dh) is not None
    if packed is not None:
        use_packed = use_packed and bool(packed)
    if use_packed:
        # packable head geometry (d_head % 128 == 0, d_head == 64 with
        # even n_head, or n_head == 1): the packed op takes the
        # projection outputs as they are
        ctx = flash_attention_packed(q, k, v, n_head, causal=causal,
                                     sm_scale=1.0 / float(dh) ** 0.5,
                                     block_q=block_q, block_k=block_k,
                                     backend=backend)
    else:
        qh = reshape(q, [b, tq, n_head, dh])
        kh = reshape(k, [b, tk, n_head, dh])
        vh = reshape(v, [b, tk, n_head, dh])
        ctx = flash_attention(qh, kh, vh, causal=causal,
                              sm_scale=1.0 / float(dh) ** 0.5,
                              block_q=block_q, block_k=block_k,
                              backend=backend)
        ctx = reshape(ctx, [b, tq, d_model])
    out = fc(ctx, d_model, num_flatten_dims=2, param_attr=_proj_attr("out"),
             name=None if name is None else name + "_out")
    if dropout_rate:
        out = dropout(out, dropout_rate, is_test=is_test)
    return out


def scale(x, scale=1.0, bias=0.0, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_tmp_variable(x.dtype, list(x.shape), lod_level=x.lod_level)
    helper.append_op(
        type="scale", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"scale": float(scale), "bias": float(bias)},
    )
    return _link_length(out, x)


def _reduce_layer(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        if dim is None:
            shape = [1]
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            dims = [d % len(input.shape) for d in dims]
            shape = [
                (1 if i in dims and keep_dim else s)
                for i, s in enumerate(input.shape)
                if keep_dim or i not in dims
            ] or [1]
        out = helper.create_tmp_variable(input.dtype, shape)
        attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
        if dim is not None:
            attrs["dim"] = dim
        helper.append_op(
            type=op_type, inputs={"X": [input.name]},
            outputs={"Out": [out.name]}, attrs=attrs,
        )
        return out

    f.__name__ = op_type
    return f


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    out = helper.create_tmp_variable(x.dtype, xs[:-1] + ys[-1:])
    helper.append_op(
        type="matmul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The ``mul`` op: ``x`` flattened to 2-D at ``x_num_col_dims`` times
    ``y`` flattened at ``y_num_col_dims`` (the reference's
    ``layers.mul``)."""
    helper = LayerHelper("mul")
    out_shape = list(x.shape[:x_num_col_dims]) + list(y.shape[y_num_col_dims:])
    out = helper.create_tmp_variable(x.dtype, out_shape)
    helper.append_op(
        type="mul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims},
    )
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(
        type="clip", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"min": float(min), "max": float(max)},
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(
        type="clip_by_norm", inputs={"X": [x.name]},
        outputs={"Out": [out.name]}, attrs={"max_norm": float(max_norm)},
    )
    return out


def multiplex(inputs, index):
    """Row ``i`` of the output is row ``i`` of ``inputs[index[i]]``."""
    helper = LayerHelper("multiplex")
    out = helper.create_tmp_variable(inputs[0].dtype, list(inputs[0].shape))
    helper.append_op(
        type="multiplex",
        inputs={"X": [v.name for v in inputs], "Ids": [index.name]},
        outputs={"Out": [out.name]},
    )
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """``x / sqrt(max(sum(x**2, axis), epsilon))``, composed of registered
    ops as the reference composes it."""
    helper = LayerHelper("l2_normalize", name=name)
    square = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(type="square", inputs={"X": [x.name]},
                     outputs={"Out": [square.name]})
    ssum = helper.create_tmp_variable(
        x.dtype, [s if i != axis % len(x.shape) else 1
                  for i, s in enumerate(x.shape)])
    helper.append_op(
        type="reduce_sum", inputs={"X": [square.name]},
        outputs={"Out": [ssum.name]}, attrs={"dim": axis, "keep_dim": True},
    )
    eps = helper.create_tmp_variable(x.dtype, [1])
    helper.append_op(
        type="fill_constant", outputs={"Out": [eps.name]},
        attrs={"shape": [1], "dtype": str(x.dtype), "value": float(epsilon)},
    )
    maxed = helper.create_tmp_variable(x.dtype, ssum.shape)
    helper.append_op(
        type="elementwise_max", inputs={"X": [ssum.name], "Y": [eps.name]},
        outputs={"Out": [maxed.name]},
    )
    rsq = helper.create_tmp_variable(x.dtype, ssum.shape)
    helper.append_op(type="sqrt", inputs={"X": [maxed.name]},
                     outputs={"Out": [rsq.name]})
    out = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(
        type="elementwise_div", inputs={"X": [x.name], "Y": [rsq.name]},
        outputs={"Out": [out.name]}, attrs={"axis": 0},
    )
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity ``[b, 1]``."""
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(X.dtype, [X.shape[0], 1])
    xnorm = helper.create_tmp_variable(X.dtype, [X.shape[0], 1],
                                       stop_gradient=True)
    ynorm = helper.create_tmp_variable(X.dtype, [Y.shape[0], 1],
                                       stop_gradient=True)
    helper.append_op(
        type="cos_sim",
        inputs={"X": [X.name], "Y": [Y.name]},
        outputs={"Out": [out.name], "XNorm": [xnorm.name],
                 "YNorm": [ynorm.name]},
    )
    return out


def square_error_cost(input, label):
    """``(input - label) ** 2`` elementwise."""
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_tmp_variable(input.dtype, list(input.shape))
    helper.append_op(
        type="elementwise_sub",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [minus_out.name]},
    )
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    helper.append_op(
        type="square", inputs={"X": [minus_out.name]},
        outputs={"Out": [out.name]}
    )
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """NCHW convolution; the filter ``[num_filters, C / groups, kh, kw]``
    is created in ``input.dtype`` (bf16 under a bf16 build) with the
    ``MSRA(uniform=False)`` default."""
    helper = LayerHelper("conv2d", bias_attr=bias_attr, act=act, name=name)
    filter_size = _ntuple(filter_size, 2)
    stride, padding = _ntuple(stride, 2), _ntuple(padding, 2)
    dilation = _ntuple(dilation, 2)
    cin = input.shape[1]
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, cin // groups, filter_size[0], filter_size[1]],
        dtype=input.dtype,
        default_initializer=init_mod.MSRA(uniform=False),
    )
    oh = _conv_osize(input.shape[2], filter_size[0], stride[0], padding[0],
                     dilation[0])
    ow = _conv_osize(input.shape[3], filter_size[1], stride[1], padding[1],
                     dilation[1])
    pre_bias = helper.create_tmp_variable(
        input.dtype, [input.shape[0], num_filters, oh, ow])
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": list(stride), "paddings": list(padding),
               "dilations": list(dilation), "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False, name=None):
    helper = LayerHelper("pool2d", name=name)
    k = _ntuple(pool_size, 2)
    s, p = _ntuple(pool_stride, 2), _ntuple(pool_padding, 2)
    oh = _pool_osize(input.shape[2], k[0], s[0], p[0], ceil_mode,
                     global_pooling)
    ow = _pool_osize(input.shape[3], k[1], s[1], p[1], ceil_mode,
                     global_pooling)
    out = helper.create_tmp_variable(
        input.dtype, [input.shape[0], input.shape[1], oh, ow])
    helper.append_op(
        type="pool2d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"ksize": list(k), "strides": list(s), "paddings": list(p),
               "pooling_type": pool_type, "global_pooling": global_pooling,
               "ceil_mode": ceil_mode},
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None):
    """Batch norm whose scale, offset and running statistics are f32 even
    for bf16 activations; the running ``<name>.mean`` / ``<name>.variance``
    are persistables written back as their own ``MeanOut`` /
    ``VarianceOut``."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = "float32"
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype, suffix="scale",
        default_initializer=init_mod.Constant(1.0),
    )
    bias = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[c], dtype=dtype,
        suffix="offset", default_initializer=init_mod.Constant(0.0),
    )
    mean = helper.create_global_variable(
        shape=[c], dtype=dtype, name=f"{helper.name}.mean",
        initializer=init_mod.Constant(0.0),
    )
    variance = helper.create_global_variable(
        shape=[c], dtype=dtype, name=f"{helper.name}.variance",
        initializer=init_mod.Constant(1.0),
    )
    saved_mean = helper.create_tmp_variable(dtype, [c], stop_gradient=True)
    saved_var = helper.create_tmp_variable(dtype, [c], stop_gradient=True)
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean.name],
                "Variance": [variance.name]},
        outputs={"Y": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [variance.name],
                 "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout},
    )
    return helper.append_activation(out)


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype,
                                     list(input.shape[:-1]) + [1])
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input.name], "Label": [label.name]},
        outputs={"Y": [out.name]},
        attrs={"soft_label": soft_label},
    )
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_tmp_variable(input.dtype, [input.shape[0], k])
    topk_indices = helper.create_tmp_variable(
        "int64", [input.shape[0], k], stop_gradient=True)
    helper.append_op(
        type="top_k",
        inputs={"X": [input.name]},
        outputs={"Out": [topk_out.name], "Indices": [topk_indices.name]},
        attrs={"k": k},
    )
    acc_out = helper.create_tmp_variable("float32", [1], stop_gradient=True)
    correct = correct or helper.create_tmp_variable("int32", [1],
                                                    stop_gradient=True)
    total = total or helper.create_tmp_variable("int32", [1],
                                                stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out.name], "Indices": [topk_indices.name],
                "Label": [label.name]},
        outputs={"Accuracy": [acc_out.name], "Correct": [correct.name],
                 "Total": [total.name]},
    )
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=200):
    """The batch's ROC AUC ``[1]`` (``num_thresholds`` buckets)."""
    helper = LayerHelper("auc")
    out = helper.create_tmp_variable("float32", [1], stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Out": [input.name], "Label": [label.name]},
        outputs={"AUC": [out.name]},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return out


def softmax(x, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(type="softmax", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def topk(input, k):
    helper = LayerHelper("top_k")
    vals = helper.create_tmp_variable(input.dtype,
                                      list(input.shape[:-1]) + [k])
    idx = helper.create_tmp_variable(
        "int64", list(input.shape[:-1]) + [k], stop_gradient=True)
    helper.append_op(
        type="top_k",
        inputs={"X": [input.name]},
        outputs={"Out": [vals.name], "Indices": [idx.name]},
        attrs={"k": k},
    )
    return vals, idx


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype, [1])
    helper.append_op(type="mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, param_attr=None, bias_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", bias_attr=bias_attr, act=act,
                         name=name)
    d = input.shape[-1]
    w = helper.create_parameter(
        param_attr, shape=[filter_size * d, num_filters], dtype=input.dtype)
    out = helper.create_tmp_variable(
        input.dtype, list(input.shape[:2]) + [num_filters],
        lod_level=input.lod_level)
    inputs = {"X": [input.name], "Filter": [w.name]}
    _seq_inputs(inputs, input)
    helper.append_op(
        type="sequence_conv",
        inputs=inputs,
        outputs={"Out": [out.name]},
        attrs={"contextLength": filter_size,
               "contextStart": -(filter_size // 2)},
    )
    _link_length(out, input)
    pre_act = helper.append_bias_op(out, dim_start=len(out.shape) - 1)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_tmp_variable(
        input.dtype, [input.shape[0]] + list(input.shape[2:]))
    inputs = {"X": [input.name]}
    _seq_inputs(inputs, input)
    helper.append_op(
        type="sequence_pool",
        inputs=inputs,
        outputs={"Out": [out.name]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_expand(x, y, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    t = y.shape[1] if len(y.shape) > 1 else -1
    out = helper.create_tmp_variable(
        x.dtype, [x.shape[0], t] + list(x.shape[1:]), lod_level=1)
    inputs = {"X": [x.name], "Y": [y.name]}
    yl = seq_length(y)
    if yl is not None:
        inputs["YLength"] = [yl.name]
        out.block.vars[out.name + "@LENGTH"] = yl
    helper.append_op(type="sequence_expand", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    b, t, d = input.shape
    new_t = t * d // new_dim if t >= 0 else -1
    out = helper.create_tmp_variable(input.dtype, [b, new_t, new_dim],
                                     lod_level=1)
    inputs = {"X": [input.name]}
    _seq_inputs(inputs, input)
    helper.append_op(
        type="sequence_reshape",
        inputs=inputs,
        outputs={"Out": [out.name], "OutLength": [out.length_var().name]},
        attrs={"new_dim": new_dim},
    )
    return out


def sequence_softmax(x, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_tmp_variable(x.dtype, list(x.shape),
                                     lod_level=x.lod_level)
    inputs = {"X": [x.name]}
    _seq_inputs(inputs, x)
    helper.append_op(
        type="sequence_softmax", inputs=inputs, outputs={"Out": [out.name]}
    )
    return _link_length(out, x)


def sequence_reverse(x, name=None):
    """Length-aware reversal along the (outer) time axis: element t of
    each sequence swaps with element len-1-t; padding stays in place.
    For a nested (lod 2) input the outer order is reversed and the
    ``@SUBLENGTH`` shadow is permuted to match."""
    helper = LayerHelper("sequence_reverse", name=name)
    inputs = {"X": [x.name]}
    ln = seq_length(x)
    if ln is not None:
        inputs["Length"] = [ln.name]
    out = helper.create_tmp_variable(x.dtype, list(x.shape),
                                     lod_level=x.lod_level)
    helper.append_op(type="sequence_reverse", inputs=inputs,
                     outputs={"Out": [out.name]})
    _link_length(out, x)
    if getattr(x, "lod_level", 0) >= 2:
        sub = x.sub_length_var()
        sub_rev = helper.create_tmp_variable(sub.dtype, list(sub.shape))
        helper.append_op(
            type="sequence_reverse",
            inputs={"X": [sub.name], "Length": [x.length_var().name]},
            outputs={"Out": [sub_rev.name]})
        out.block.vars[out.name + "@SUBLENGTH"] = sub_rev
    return out


def warpctc(input, label, blank=0, norm_by_times=False):
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp_variable(input.dtype, [input.shape[0], 1])
    inputs = {"Logits": [input.name], "Label": [label.name]}
    il = seq_length(input)
    ll = seq_length(label)
    if il is not None:
        inputs["LogitsLength"] = [il.name]
    if ll is not None:
        inputs["LabelLength"] = [ll.name]
    helper.append_op(
        type="warpctc",
        inputs=inputs,
        outputs={"Loss": [loss.name]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return loss


def ctc_greedy_decoder(input, blank):
    """``input [b, t, V]`` probabilities -> argmax ids -> ``ctc_align``:
    a sequence whose lengths are the decoded lengths."""
    helper = LayerHelper("ctc_greedy_decoder")
    ids = helper.create_tmp_variable("int64", list(input.shape[:2]),
                                     stop_gradient=True)
    helper.append_op(
        type="arg_max", inputs={"X": [input.name]},
        outputs={"Out": [ids.name]}, attrs={"axis": -1},
    )
    out = helper.create_tmp_variable("int64", list(input.shape[:2]),
                                     lod_level=1, stop_gradient=True)
    inputs = {"Input": [ids.name]}
    il = seq_length(input)
    if il is not None:
        inputs["Length"] = [il.name]
    helper.append_op(
        type="ctc_align",
        inputs=inputs,
        outputs={"Output": [out.name],
                 "OutputLength": [out.length_var().name]},
        attrs={"blank": blank, "merge_repeated": True},
    )
    return out


def _erase(helper, x, tokens):
    """``x`` with ``tokens`` removed (``sequence_erase``), a sequence
    with its own lengths."""
    out = helper.create_tmp_variable(x.dtype, list(x.shape), lod_level=1,
                                     stop_gradient=True)
    inputs = {"X": [x.name]}
    ln = seq_length(x)
    if ln is not None:
        inputs["Length"] = [ln.name]
    helper.append_op(
        type="sequence_erase", inputs=inputs,
        outputs={"Out": [out.name], "OutLength": [out.length_var().name]},
        attrs={"tokens": list(tokens)},
    )
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None):
    """Levenshtein distance of each hypothesis row to its reference,
    ``[b, 1]`` float32, and the row count."""
    helper = LayerHelper("edit_distance")
    hyp, ref = input, label
    if ignored_tokens:
        hyp = _erase(helper, hyp, ignored_tokens)
        ref = _erase(helper, ref, ignored_tokens)
    out = helper.create_tmp_variable("float32", [input.shape[0], 1],
                                     stop_gradient=True)
    seq_num = helper.create_tmp_variable("int64", [1], stop_gradient=True)
    inputs = {"Hyps": [hyp.name], "Refs": [ref.name]}
    hl, rl = seq_length(hyp), seq_length(ref)
    if hl is not None:
        inputs["HypsLength"] = [hl.name]
    if rl is not None:
        inputs["RefsLength"] = [rl.name]
    helper.append_op(
        type="edit_distance",
        inputs=inputs,
        outputs={"Out": [out.name], "SequenceNum": [seq_num.name]},
        attrs={"normalized": normalized},
    )
    return out, seq_num


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    helper = LayerHelper("row_conv", act=act, name=name)
    d = input.shape[-1]
    w = helper.create_parameter(
        param_attr, shape=[future_context_size + 1, d], dtype=input.dtype
    )
    out = helper.create_tmp_variable(input.dtype, list(input.shape),
                                     lod_level=input.lod_level)
    inputs = {"X": [input.name], "Filter": [w.name]}
    _seq_inputs(inputs, input)
    helper.append_op(type="row_conv", inputs=inputs,
                     outputs={"Out": [out.name]})
    _link_length(out, input)
    return helper.append_activation(out)


def linear_chain_crf(input, label, param_attr=None):
    """The CRF's negative log-likelihood ``[b, 1]``; creates the
    ``[num_tags + 2, num_tags]`` transition parameter (start row, end
    row, transitions)."""
    helper = LayerHelper("linear_chain_crf")
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, shape=[num_tags + 2, num_tags], dtype="float32",
        suffix="transition", default_initializer=init_mod.Uniform(-0.1, 0.1),
    )
    b = input.shape[0]
    ll = helper.create_tmp_variable(input.dtype, [b, 1])
    emission_exps = helper.create_tmp_variable(
        input.dtype, list(input.shape), stop_gradient=True)
    transition_exps = helper.create_tmp_variable(
        "float32", [num_tags + 2, num_tags], stop_gradient=True)
    alpha = helper.create_tmp_variable(input.dtype, list(input.shape),
                                       stop_gradient=True)
    inputs = {"Emission": [input.name], "Transition": [transition.name],
              "Label": [label.name]}
    _seq_inputs(inputs, input)
    helper.append_op(
        type="linear_chain_crf",
        inputs=inputs,
        outputs={
            "LogLikelihood": [ll.name],
            "EmissionExps": [emission_exps.name],
            "TransitionExps": [transition_exps.name],
            "Alpha": [alpha.name],
        },
    )
    return ll


def crf_decoding(input, param_attr=None, label=None):
    """Viterbi decode with the transition parameter ``linear_chain_crf``
    created, found by ``param_attr``'s name."""
    helper = LayerHelper("crf_decoding")
    attr = ParamAttr.to_attr(param_attr)
    transition = helper.main_program.global_block().var(attr.name)
    out = helper.create_tmp_variable("int64", list(input.shape[:2]),
                                     stop_gradient=True)
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    _seq_inputs(inputs, input)
    helper.append_op(
        type="crf_decoding", inputs=inputs,
        outputs={"ViterbiPath": [out.name]}
    )
    return out


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    mid = helper.create_tmp_variable(input.dtype, list(input.shape),
                                     stop_gradient=True)
    helper.append_op(
        type="lrn", inputs={"X": [input.name]},
        outputs={"Out": [out.name], "MidOut": [mid.name]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def prelu(x, param_attr=None, name=None):
    """Parametric ReLU with a learnable scalar alpha (initialized to
    0.25)."""
    helper = LayerHelper("prelu", name=name)
    alpha = helper.create_parameter(
        param_attr, shape=[1], dtype=x.dtype, suffix="alpha",
        default_initializer=init_mod.Constant(0.25),
    )
    out = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(
        type="prelu", inputs={"X": [x.name], "Alpha": [alpha.name]},
        outputs={"Out": [out.name]},
    )
    return out


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id):
    """One fixed-width beam expansion: ``(ids, scores, parents)`` ``[b,
    k]`` from the beams ``pre_ids`` / ``pre_scores`` ``[b, k]`` and the
    step's log-probs ``scores [b, k, V]``."""
    helper = LayerHelper("beam_search")
    b, k = pre_ids.shape[0], beam_size
    sel_ids = helper.create_tmp_variable("int64", [b, k], stop_gradient=True)
    sel_scores = helper.create_tmp_variable("float32", [b, k],
                                            stop_gradient=True)
    parent = helper.create_tmp_variable("int64", [b, k], stop_gradient=True)
    helper.append_op(
        type="beam_search",
        inputs={
            "PreIds": [pre_ids.name],
            "PreScores": [pre_scores.name],
            "Scores": [scores.name],
        },
        outputs={
            "SelectedIds": [sel_ids.name],
            "SelectedScores": [sel_scores.name],
            "ParentIdx": [parent.name],
        },
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, parent_idx, scores=None, end_id=1, name=None):
    """Backtrack stacked per-step beams ``[T, b, k]`` into sentences
    ``[b, k, T]`` (and the final scores ``[b, k]`` given ``scores``)."""
    helper = LayerHelper("beam_search_decode", name=name)
    t, b, k = ids.shape[0], ids.shape[1], ids.shape[2]
    sent = helper.create_tmp_variable("int64", [b, k, t], stop_gradient=True)
    outputs = {"SentenceIds": [sent.name]}
    inputs = {"Ids": [ids.name], "ParentIdx": [parent_idx.name]}
    out_scores = None
    if scores is not None:
        inputs["Scores"] = [scores.name]
        out_scores = helper.create_tmp_variable("float32", [b, k],
                                                stop_gradient=True)
        outputs["SentenceScores"] = [out_scores.name]
    helper.append_op(
        type="beam_search_decode",
        inputs=inputs,
        outputs=outputs,
        attrs={"end_id": end_id},
    )
    return (sent, out_scores) if scores is not None else sent


# -- the v1 DSL's layers ------------------------------------------------------
def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """5-D (NCDHW) convolution (reference conv_op.cc conv3d)."""
    helper = LayerHelper("conv3d", bias_attr=bias_attr, act=act, name=name)
    filter_size = _ntuple(filter_size, 3)
    stride, padding = _ntuple(stride, 3), _ntuple(padding, 3)
    dilation = _ntuple(dilation, 3)
    cin = input.shape[1]
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, cin // groups, *filter_size],
        dtype=input.dtype,
        default_initializer=init_mod.MSRA(uniform=False),
    )
    spatial = [
        _conv_osize(input.shape[2 + i], filter_size[i], stride[i],
                    padding[i], dilation[i])
        for i in range(3)
    ]
    pre_bias = helper.create_tmp_variable(
        input.dtype, [input.shape[0], num_filters, *spatial]
    )
    helper.append_op(
        type="conv3d",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={
            "strides": list(stride),
            "paddings": list(padding),
            "dilations": list(dilation),
            "groups": groups,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, ceil_mode=False, name=None):
    """5-D (NCDHW) pooling (reference pool_op.cc pool3d)."""
    helper = LayerHelper("pool3d", name=name)
    k = _ntuple(pool_size, 3)
    s, p = _ntuple(pool_stride, 3), _ntuple(pool_padding, 3)
    spatial = [
        _pool_osize(input.shape[2 + i], k[i], s[i], p[i], ceil_mode,
                    global_pooling)
        for i in range(3)
    ]
    out = helper.create_tmp_variable(
        input.dtype, [input.shape[0], input.shape[1], *spatial]
    )
    helper.append_op(
        type="pool3d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"ksize": list(k), "strides": list(s), "paddings": list(p),
               "pooling_type": pool_type, "global_pooling": global_pooling,
               "ceil_mode": ceil_mode},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_tmp_variable(x.dtype, list(x.shape))
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x.name], "Label": [label.name]},
        outputs={"Out": [out.name]},
    )
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    helper = LayerHelper("smooth_l1")
    out = helper.create_tmp_variable(x.dtype, [x.shape[0], 1])
    diff = helper.create_tmp_variable(x.dtype, list(x.shape), stop_gradient=True)
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Out": [out.name], "Diff": [diff.name]},
        attrs={"sigma": sigma},
    )
    return out


def chunk_eval(input, label, chunk_scheme="IOB", num_chunk_types=1,
               excluded_chunk_types=None):
    helper = LayerHelper("chunk_eval")
    outs = {
        n: helper.create_tmp_variable(
            "float32" if i < 3 else "int64", [1], stop_gradient=True
        )
        for i, n in enumerate(
            ["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"]
        )
    }
    inputs = {"Inference": [input.name], "Label": [label.name]}
    _seq_inputs(inputs, input)
    helper.append_op(
        type="chunk_eval",
        inputs=inputs,
        outputs={k: [v.name] for k, v in outs.items()},
        attrs={"chunk_scheme": chunk_scheme, "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": tuple(excluded_chunk_types or ())},
    )
    return (
        outs["Precision"], outs["Recall"], outs["F1-Score"],
        outs["NumInferChunks"], outs["NumLabelChunks"], outs["NumCorrectChunks"],
    )


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            act=None, name=None):
    """out[b,i] = x[b] @ W[i] @ y[b] + bias[i] (reference
    bilinear_tensor_product_op.h:30)."""
    helper = LayerHelper("bilinear_tensor_product", bias_attr=bias_attr,
                         act=act, name=name)
    w = helper.create_parameter(
        param_attr, shape=[size, x.shape[-1], y.shape[-1]], dtype=x.dtype,
    )
    out = helper.create_tmp_variable(x.dtype, [x.shape[0], size])
    inputs = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(
            ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[size],
            dtype=x.dtype, suffix="b",
            default_initializer=init_mod.Constant(0.0),
        )
        inputs["Bias"] = [b.name]
    helper.append_op(
        type="bilinear_tensor_product",
        inputs=inputs,
        outputs={"Out": [out.name]},
    )
    return helper.append_activation(out)


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", name=name)
    k = (filter_size, filter_size) if isinstance(filter_size, int) else tuple(filter_size)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding,) * 4 if isinstance(padding, int) else tuple(padding)
    n, c, h, w = input.shape
    oh = (h + p[0] + p[2] - k[0]) // s[0] + 1 if h >= 0 else -1
    ow = (w + p[1] + p[3] - k[1]) // s[1] + 1 if w >= 0 else -1
    t = oh * ow if oh >= 0 and ow >= 0 else -1
    out = helper.create_tmp_variable(input.dtype, [n, t, c * k[0] * k[1]], lod_level=1)
    helper.append_op(
        type="im2sequence",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"kernels": list(k), "strides": list(s), "paddings": list(p)},
    )
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid over a complete binary tree — large-vocab
    classification at O(log C) cost (reference
    ``paddle/gserver/layers/HierarchicalSigmoidLayer.cpp:1``, config
    helper ``hsigmoid`` in trainer_config_helpers/layers.py)."""
    helper = LayerHelper("hsigmoid", name=name)
    dim = input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[num_classes - 1, dim], dtype=input.dtype)
    inputs = {"X": [input.name], "W": [w.name], "Label": [label.name]}
    if bias_attr is not False:
        b = helper.create_parameter(
            ParamAttr.to_attr(bias_attr) or ParamAttr(),
            shape=[num_classes - 1], dtype=input.dtype, suffix="b",
            default_initializer=init_mod.Constant(0.0),
        )
        inputs["Bias"] = [b.name]
    max_len = max(1, (2 * num_classes - 1).bit_length() - 1)
    cost = helper.create_tmp_variable(input.dtype, [input.shape[0], 1])
    pre_out = helper.create_tmp_variable(
        input.dtype, [input.shape[0], max_len], stop_gradient=True)
    helper.append_op(
        type="hierarchical_sigmoid",
        inputs=inputs,
        outputs={"Out": [cost.name], "PreOut": [pre_out.name]},
        attrs={"num_classes": num_classes},
    )
    return cost


def selective_fc(input, size, select=None, param_attr=None, bias_attr=None,
                 act=None, name=None):
    """Fully-connected layer that evaluates only the selected output
    columns per sample (reference
    ``paddle/gserver/layers/SelectiveFcLayer.cpp:1``; weight stored one
    row per output neuron, as there).  ``select`` is an int tensor
    [batch, s] of column ids (entries < 0 are padding); omit it for a
    plain full fc pass."""
    helper = LayerHelper("selective_fc", bias_attr=bias_attr, act=act,
                         name=name)
    dim = input.shape[1]
    w = helper.create_parameter(param_attr, shape=[size, dim],
                                dtype=input.dtype)
    inputs = {"X": [input.name], "W": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(
            ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[size],
            dtype=input.dtype, suffix="b",
            default_initializer=init_mod.Constant(0.0),
        )
        inputs["Bias"] = [b.name]
    out_cols = select.shape[1] if select is not None else size
    if select is not None:
        inputs["Select"] = [select.name]
    out = helper.create_tmp_variable(input.dtype, [input.shape[0], out_cols])
    helper.append_op(
        type="selective_fc", inputs=inputs, outputs={"Out": [out.name]},
    )
    return helper.append_activation(out)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=10, name=None):
    helper = LayerHelper("nce", name=name)
    dim = input.shape[1]
    w = helper.create_parameter(param_attr, shape=[num_total_classes, dim], dtype=input.dtype)
    b = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[num_total_classes],
        dtype=input.dtype, suffix="b", default_initializer=init_mod.Constant(0.0),
    )
    cost = helper.create_tmp_variable(input.dtype, [input.shape[0], 1])
    sample_logits = helper.create_tmp_variable(input.dtype, [input.shape[0], num_neg_samples + 1], stop_gradient=True)
    sample_labels = helper.create_tmp_variable("int64", [input.shape[0], num_neg_samples + 1], stop_gradient=True)
    inputs = {"Input": [input.name], "Label": [label.name], "Weight": [w.name], "Bias": [b.name]}
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    helper.append_op(
        type="nce",
        inputs=inputs,
        outputs={
            "Cost": [cost.name],
            "SampleLogits": [sample_logits.name],
            "SampleLabels": [sample_labels.name],
        },
        attrs={
            "num_neg_samples": num_neg_samples,
            "num_total_classes": num_total_classes,
        },
    )
    return cost


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    n, c, h, w = x.shape
    out = helper.create_tmp_variable(x.dtype, [n, c // groups, h, w])
    helper.append_op(
        type="maxout", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"groups": groups},
    )
    return out


def spp(input, pyramid_height=3, pool_type="max", name=None):
    helper = LayerHelper("spp", name=name)
    c = input.shape[1]
    total = sum((2 ** l) ** 2 for l in range(pyramid_height))
    out = helper.create_tmp_variable(input.dtype, [input.shape[0], c * total])
    helper.append_op(
        type="spp", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
        attrs={"pyramid_height": pyramid_height, "pooling_type": pool_type},
    )
    return out


def _nested_inputs(inputs, x):
    """Wire Length + SubLength for a nested (lod_level 2) input."""
    if getattr(x, "lod_level", 0) > 0:
        inputs["Length"] = [x.length_var().name]
    if getattr(x, "lod_level", 0) > 1:
        inputs["SubLength"] = [x.sub_length_var().name]


def _link_nested(out, length_var, sub_length_var):
    """Mark ``out`` as a nested sequence carrying the given shadows."""
    out.lod_level = 2
    out.block.vars[out.name + "@LENGTH"] = length_var
    out.block.vars[out.name + "@SUBLENGTH"] = sub_length_var
    return out


def nested_sequence_pool(input, pool_type):
    """Pool the INNER level of a [b, s, t, ...] nested batch ->
    [b, s, ...] 1-level sequence (lengths = the outer level's)."""
    helper = LayerHelper("nested_sequence_pool")
    out = helper.create_tmp_variable(
        input.dtype, [input.shape[0], input.shape[1]] + list(input.shape[3:]))
    inputs = {"X": [input.name]}
    _nested_inputs(inputs, input)
    helper.append_op(
        type="nested_sequence_pool", inputs=inputs,
        outputs={"Out": [out.name]},
        attrs={"pooltype": pool_type.upper()},
    )
    out.lod_level = 1
    out.block.vars[out.name + "@LENGTH"] = input.length_var()
    return out


def nested_sequence_expand(x, y):
    """Expand per-sub-seq values x [b, s, ...] over nested y's inner
    level -> [b, s, t, ...] (masked broadcast)."""
    helper = LayerHelper("nested_sequence_expand")
    t = y.shape[2]
    out = helper.create_tmp_variable(
        x.dtype, list(x.shape[:2]) + [t] + list(x.shape[2:]))
    inputs = {"X": [x.name], "Y": [y.name]}
    _nested_inputs(inputs, y)
    helper.append_op(type="nested_sequence_expand", inputs=inputs,
                     outputs={"Out": [out.name]})
    return _link_nested(out, y.length_var(), y.sub_length_var())


def nested_sequence_slice(input, offset, size):
    """Keep sub-sequences [offset, offset+size) of each sample."""
    helper = LayerHelper("nested_sequence_slice")
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    out_len = helper.create_tmp_variable("int32", [input.shape[0]],
                                         stop_gradient=True)
    out_sub = helper.create_tmp_variable(
        "int32", [input.shape[0], input.shape[1]], stop_gradient=True)
    inputs = {"X": [input.name], "Offset": [offset.name],
              "Size": [size.name]}
    _nested_inputs(inputs, input)
    helper.append_op(
        type="nested_sequence_slice", inputs=inputs,
        outputs={"Out": [out.name], "OutLength": [out_len.name],
                 "OutSubLength": [out_sub.name]})
    return _link_nested(out, out_len, out_sub)


def sub_nested_seq(input, selected_indices):
    """Select sub-sequences by per-sample indices (reference
    SubNestedSequenceLayer.cpp); negative indices = padding."""
    helper = LayerHelper("sub_nested_seq")
    k = selected_indices.shape[1]
    out = helper.create_tmp_variable(
        input.dtype, [input.shape[0], k] + list(input.shape[2:]))
    out_len = helper.create_tmp_variable("int32", [input.shape[0]],
                                         stop_gradient=True)
    out_sub = helper.create_tmp_variable("int32", [input.shape[0], k],
                                         stop_gradient=True)
    inputs = {"X": [input.name], "Indices": [selected_indices.name]}
    _nested_inputs(inputs, input)
    helper.append_op(
        type="sub_nested_seq", inputs=inputs,
        outputs={"Out": [out.name], "OutLength": [out_len.name],
                 "OutSubLength": [out_sub.name]})
    return _link_nested(out, out_len, out_sub)


def nested_rnn(input, size, param_attr=None, bias_attr=None, h_0=None,
               gate_activation="sigmoid", candidate_activation="tanh",
               name=None):
    """Hierarchical GRU over a nested batch [b, s, t, 3d] (input
    pre-projected to gates, the dynamic_gru convention): the inner RNN
    runs each sub-sequence booted from the outer state; the outer state
    advances to the last valid inner hidden.  Returns
    (inner_hiddens [b, s, t, d], outer_states [b, s, d]); outer_states
    is a 1-level sequence over the outer lengths."""
    helper = LayerHelper("nested_rnn", name=name)
    d = size
    weight = helper.create_parameter(param_attr, shape=[d, 3 * d],
                                     dtype=input.dtype)
    bias = helper.create_parameter(
        ParamAttr.to_attr(bias_attr) or ParamAttr(), shape=[1, 3 * d],
        dtype=input.dtype, suffix="b",
        default_initializer=init_mod.Constant(0.0),
    )
    hidden = helper.create_tmp_variable(
        input.dtype, list(input.shape[:3]) + [d])
    outer = helper.create_tmp_variable(
        input.dtype, list(input.shape[:2]) + [d])
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    _nested_inputs(inputs, input)
    helper.append_op(
        type="nested_rnn", inputs=inputs,
        outputs={"Hidden": [hidden.name], "OuterHidden": [outer.name]},
        attrs={"gate_activation": gate_activation,
               "activation": candidate_activation},
    )
    if getattr(input, "lod_level", 0) > 1:
        _link_nested(hidden, input.length_var(), input.sub_length_var())
        outer.lod_level = 1
        outer.block.vars[outer.name + "@LENGTH"] = input.length_var()
    return hidden, outer

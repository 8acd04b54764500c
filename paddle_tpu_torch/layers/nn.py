"""Neural-net layers (``paddle_tpu/layers/nn.py``), the part
``models.transformer.build`` reaches: ``fc``, ``embedding``,
``layer_norm``, ``dropout``, ``softmax_with_cross_entropy``,
``flash_attention`` / ``flash_attention_packed``, ``multi_head_attention``,
``scale``, ``reduce_sum``.  Each layer creates parameters
through LayerHelper and appends ops; names, shapes and attrs are the
reference's, so both packages build the same program."""

import numpy as np

from ..param_attr import ParamAttr
from .. import initializer as init_mod
from .layer_helper import LayerHelper

__all__ = [
    "fc",
    "embedding",
    "layer_norm",
    "dropout",
    "softmax_with_cross_entropy",
    "flash_attention",
    "flash_attention_packed",
    "multi_head_attention",
    "scale",
    "reduce_sum",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, **kwargs):
    helper = LayerHelper("fc", bias_attr=bias_attr, act=act, name=name, **kwargs)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for i, x in enumerate(inputs):
        suffix = "w" if len(inputs) == 1 else f"w_{i}"
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


def flash_attention_packed(q, k, v, n_head, causal=False, sm_scale=None,
                           block_q=None, block_k=None, backend=None,
                           name=None):
    """Fused attention on the raw projection layout: q/k/v [b, t, h*d]
    (what the QKV matmuls emit) -> [b, t, h*d] (what the out-projection
    consumes).  No [b,t,h,d]<->[bh,t,d] pack/unpack transposes exist: the
    kernels address heads through strides (kernels/flash_attention.py).
    ``block_q``/``block_k``/``backend`` are recorded as attrs, as the
    reference records them; the CUDA kernels tile by their own sizes."""
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
    ``block_q``/``block_k``/``backend`` are recorded as attrs only."""
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
    same op.  The reference also consults its autotune cache here when no
    geometry is given; that lookup is not ported, and its miss path (keep
    the defaults) is what this does.
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


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
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
        type="reduce_sum", inputs={"X": [input.name]},
        outputs={"Out": [out.name]}, attrs=attrs,
    )
    return out

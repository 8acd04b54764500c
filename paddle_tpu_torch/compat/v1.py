"""v1 layer-DSL name compatibility (reference:
python/paddle/trainer_config_helpers/layers.py — `*_layer` functions,
activation objects, `settings()`; trainer_config_helpers/optimizers.py —
`MomentumOptimizer` etc.).

The port's copy of ``paddle_tpu/compat/v1.py``, on the port's layers.
Usage — a v1-style config builds a Program:

    from paddle_tpu_torch.compat import v1
    net = v1.data_layer("data", size=3*32*32, height=32, width=32)
    net = v1.img_conv_layer(input=net, filter_size=5, num_filters=32,
                            padding=2, act=v1.ReluActivation())
    net = v1.img_pool_layer(input=net, pool_size=3, stride=2)
    out = v1.fc_layer(input=net, size=10, act=v1.SoftmaxActivation())
    cost = v1.classification_cost(input=out, label=v1.data_layer("label", 1))

Differences from the v1 original (the JAX package's, kept):
- returns are Program `Variable`s, not LayerOutput protos;
- `data_layer(size=...)` for images needs `height`/`width` (the Program's
  shapes are static); 1-D inputs use `[size]`;
- the proto pipeline (config_parser) is not reproduced.
"""

from .. import layers, optimizer as _opt
from ..layers import tensor as _tensor

__all__ = [
    # activations
    "TanhActivation", "SigmoidActivation", "SoftmaxActivation",
    "IdentityActivation", "LinearActivation", "ReluActivation",
    "BReluActivation", "SoftReluActivation", "STanhActivation",
    "AbsActivation", "SquareActivation", "ExpActivation", "LogActivation",
    # layers
    "data_layer", "fc_layer", "embedding_layer", "img_conv_layer",
    "img_pool_layer", "img_cmrnorm_layer", "batch_norm_layer",
    "dropout_layer", "concat_layer", "addto_layer", "mixed_layer",
    "lstmemory", "grumemory", "simple_lstm", "simple_gru",
    "pooling_layer", "last_seq", "first_seq", "max_id", "scaling_layer",
    "slope_intercept_layer", "cos_sim", "trans_layer", "rotate_layer",
    "sum_cost", "classification_cost", "regression_cost", "mse_cost",
    "cross_entropy", "cross_entropy_with_selfnorm", "multi_binary_label_cross_entropy",
    "rank_cost", "lambda_cost", "huber_regression_cost", "smooth_l1_cost",
    "crf_layer", "crf_decoding_layer", "ctc_layer", "warp_ctc_layer",
    "nce_layer", "hsigmoid",
    # pooling types
    "MaxPooling", "AvgPooling", "SumPooling",
    # optimizers + settings
    "MomentumOptimizer", "AdamOptimizer", "AdaGradOptimizer",
    "RMSPropOptimizer", "AdaDeltaOptimizer", "settings",
    "L2Regularization",
    # config bookkeeping
    "inputs", "outputs",
]


# ---------------------------------------------------------------- activations
class _Act:
    name = None

    def __repr__(self):
        return f"{type(self).__name__}()"


def _act_cls(cls_name, act_name):
    cls = type(cls_name, (_Act,), {"name": act_name})
    return cls


TanhActivation = _act_cls("TanhActivation", "tanh")
SigmoidActivation = _act_cls("SigmoidActivation", "sigmoid")
SoftmaxActivation = _act_cls("SoftmaxActivation", "softmax")
IdentityActivation = _act_cls("IdentityActivation", None)
LinearActivation = IdentityActivation
ReluActivation = _act_cls("ReluActivation", "relu")
BReluActivation = _act_cls("BReluActivation", "brelu")
SoftReluActivation = _act_cls("SoftReluActivation", "soft_relu")
STanhActivation = _act_cls("STanhActivation", "stanh")
AbsActivation = _act_cls("AbsActivation", "abs")
SquareActivation = _act_cls("SquareActivation", "square")
ExpActivation = _act_cls("ExpActivation", "exp")
LogActivation = _act_cls("LogActivation", "log")


def _act(act, default=None):
    if act is None:
        return default
    if isinstance(act, _Act):
        return act.name
    return act  # already a string


# ---------------------------------------------------------------- pool types
class MaxPooling:
    name = "max"


class AvgPooling:
    name = "avg"


class SumPooling:
    name = "sum"


def _pool_name(pooling_type, default="max"):
    if pooling_type is None:
        return default
    return getattr(pooling_type, "name", pooling_type)


# ------------------------------------------------------------------- layers
def data_layer(name, size, height=None, width=None, depth=None, dtype=None,
               is_label=False, seq_len=None, sparse=False, **_):
    """v1 data_layer(size=...) -> layers.data.  The Program's shapes are
    static, so the ragged v1 slots take explicit extents here:
    image inputs pass height/width (channels inferred from size); integer
    id-sequence inputs pass dtype='int64' + seq_len (size then means
    vocabulary, stashed for embedding_layer); labels use is_label=True.
    ``sparse=True`` declares the slot as a native sparse input (the
    provider's sparse_binary/float_vector types): fc on it lowers to the
    O(nnz) weighted gather-sum and the slot feeds as @IDS/@VALS arrays —
    a 10M-dim CTR slot never materializes densely."""
    if sparse:
        # seq_len marks a sparse_*_vector_sequence slot: the shadow
        # arrays gain a time axis and @LENGTH carries sequence lengths
        var = layers.sparse_data(
            name, dim=size, lod_level=1 if seq_len is not None else 0)
        var._v1_vocab = size
        return var
    if height and width:
        channels = size // (height * width)
        shape = [channels, height, width]
        return layers.data(name, shape=shape, dtype=dtype or "float32")
    if seq_len is not None:
        var = layers.data(name, shape=[seq_len], dtype=dtype or "int64",
                          lod_level=1)
        var._v1_vocab = size
        return var
    if is_label or size == 1:
        return layers.data(name, shape=[1], dtype=dtype or "int64")
    return layers.data(name, shape=[size], dtype=dtype or "float32")


def _apply_act(out, a):
    if not a:
        return out
    return getattr(layers, a)(out)


def fc_layer(input, size, act=None, param_attr=None, bias_attr=None,
             name=None, **_):
    # layers.fc handles list inputs natively (per-input weights, summed
    # matmuls, ONE bias) — exactly the v1 multi-input fc semantics.
    out = layers.fc(input, size, param_attr=param_attr, bias_attr=bias_attr)
    out = _apply_act(out, _act(act, "tanh"))  # v1 default act is tanh
    from .v1_ext import _register_name

    return _register_name(out, name)


def embedding_layer(input, size, param_attr=None, **_):
    return layers.embedding(input, size=[_vocab_of(input), size],
                            param_attr=param_attr)


def _vocab_of(var):
    # v1 carries vocab on the data layer; here require the caller to have
    # made an int input whose declared "size" we stash on the Variable.
    v = getattr(var, "_v1_vocab", None)
    if v is None:
        raise ValueError(
            "embedding_layer needs the input's vocabulary size; build the "
            "input with integer_value(vocab) via data_layer(size=vocab, "
            "dtype='int64') and set input._v1_vocab = vocab, or use "
            "layers.embedding directly")
    return v


def img_conv_layer(input, filter_size, num_filters, stride=1, padding=0,
                   groups=1, num_channels=None, act=None, bias_attr=None,
                   param_attr=None, **_):
    return layers.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding, groups=groups,
        param_attr=param_attr, bias_attr=bias_attr,
        act=_act(act, "relu"))


def img_pool_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                   ceil_mode=False, **_):
    return layers.pool2d(
        input, pool_size=pool_size, pool_stride=stride,
        pool_padding=padding, pool_type=_pool_name(pool_type),
        ceil_mode=ceil_mode)


def img_cmrnorm_layer(input, size=5, scale=0.0001, power=0.75, **_):
    # reference config_parser.py:1347 divides scale by size for
    # cmrnorm-projection; the lrn op here sums squares without averaging,
    # so apply that division to match v1 numerics.
    return layers.lrn(input, n=size, alpha=scale / size, beta=power)


def batch_norm_layer(input, act=None, use_global_stats=None, **_):
    return layers.batch_norm(input, act=_act(act),
                             is_test=bool(use_global_stats))


def dropout_layer(input, dropout_rate, **_):
    return layers.dropout(input, dropout_prob=dropout_rate)


def concat_layer(input, act=None, **_):
    return _apply_act(_tensor.concat(list(input), axis=1), _act(act))


def addto_layer(input, act=None, bias_attr=None, name=None, **_):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    out = _apply_act(out, _act(act))
    from .v1_ext import _register_name

    return _register_name(out, name)


# mixed_layer: see v1_ext.py (projection/operator form)


def lstmemory(input, size=None, reverse=False, act=None, **_):
    # v1 contract: size = hidden width, input already projected to
    # 4*size; dynamic_lstm's size is the 4*hidden projection width.
    hidden_x4 = 4 * size if size else input.shape[-1]
    hidden, _cell = layers.dynamic_lstm(input, size=hidden_x4,
                                        is_reverse=reverse)
    return hidden


def grumemory(input, size=None, reverse=False, act=None, **_):
    return layers.dynamic_gru(input, size=size or input.shape[-1] // 3,
                              is_reverse=reverse)


def simple_lstm(input, size, reverse=False, **_):
    proj = layers.fc(input, size * 4, num_flatten_dims=2)
    layers.link_sequence(proj, input)
    hidden, _cell = layers.dynamic_lstm(proj, size=size * 4,
                                        is_reverse=reverse)
    return hidden


def simple_gru(input, size, reverse=False, **_):
    proj = layers.fc(input, size * 3, num_flatten_dims=2)
    layers.link_sequence(proj, input)
    return layers.dynamic_gru(proj, size=size, is_reverse=reverse)


def pooling_layer(input, pooling_type=None, **_):
    return layers.sequence_pool(input,
                                pool_type=_pool_name(pooling_type, "sum"))


def last_seq(input, **_):
    return layers.sequence_last_step(input)


def first_seq(input, **_):
    return layers.sequence_first_step(input)


def max_id(input, **_):
    return _tensor.argmax(input, axis=-1)


def scaling_layer(input, weight, **_):
    return layers.elementwise_mul(input, weight)


def slope_intercept_layer(input, slope=1.0, intercept=0.0, **_):
    return layers.scale(input, scale=slope, bias=intercept)


def cos_sim(a, b, **_):
    return layers.cos_sim(a, b)


def trans_layer(input, **_):
    return _tensor.transpose(input, [1, 0])


def rotate_layer(input, height, width, **_):
    b, c = input.shape[0], input.shape[1] if len(input.shape) == 4 else 1
    x = _tensor.reshape(input, [b, c, height, width])
    x = _tensor.transpose(x, [0, 1, 3, 2])
    return x


# -------------------------------------------------------------------- costs
def classification_cost(input, label, **_):
    return layers.mean(layers.cross_entropy(input=input, label=label))


def cross_entropy(input, label, **_):
    return layers.mean(layers.cross_entropy(input=input, label=label))


cross_entropy_with_selfnorm = cross_entropy


def multi_binary_label_cross_entropy(input, label, **_):
    return layers.mean(
        layers.sigmoid_cross_entropy_with_logits(input, label))


def regression_cost(input, label, **_):
    return layers.mean(layers.square_error_cost(input=input, label=label))


mse_cost = regression_cost


def sum_cost(input, **_):
    return layers.reduce_sum(input)


def rank_cost(left, right, label, **_):
    diff = layers.sigmoid(left - right)
    return layers.mean(layers.cross_entropy(
        input=_tensor.concat([1.0 - diff, diff], axis=1), label=label))


def lambda_cost(input, score, NDCG_num=5, **_):
    # listwise LambdaRank reduces to a pairwise logistic surrogate here
    return layers.mean(layers.square_error_cost(input=input, label=score))


def huber_regression_cost(input, label, delta=1.0, **_):
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("huber_loss")
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    residual = helper.create_tmp_variable(input.dtype, list(input.shape),
                                          stop_gradient=True)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [out.name], "Residual": [residual.name]},
        attrs={"delta": float(delta)},
    )
    return layers.mean(out)


def smooth_l1_cost(input, label, **_):
    return layers.mean(layers.smooth_l1(input, label))


def crf_layer(input, label, **_):
    return layers.linear_chain_crf(input=input, label=label)


def crf_decoding_layer(input, label=None, **_):
    return layers.crf_decoding(input=input, label=label)


def ctc_layer(input, label, size=None, blank=None, norm_by_times=False, **_):
    return layers.warpctc(input=input, label=label,
                          blank=blank if blank is not None else (size or 1) - 1,
                          norm_by_times=norm_by_times)


warp_ctc_layer = ctc_layer


def nce_layer(input, label, num_classes, num_neg_samples=10, **_):
    return layers.nce(input=input, label=label,
                      num_total_classes=num_classes,
                      num_neg_samples=num_neg_samples)


def hsigmoid(input, label, num_classes, **_):
    # exact tree sigmoid (reference HierarchicalSigmoidLayer.cpp)
    return layers.hsigmoid(input=input, label=label,
                           num_classes=num_classes)


# --------------------------------------------------------------- optimizers
class L2Regularization:
    def __init__(self, rate):
        self.rate = rate


def MomentumOptimizer(momentum=0.9):
    return ("momentum", {"momentum": momentum})


def AdamOptimizer(beta1=0.9, beta2=0.999, epsilon=1e-8):
    return ("adam", {"beta1": beta1, "beta2": beta2, "epsilon": epsilon})


def AdaGradOptimizer():
    return ("adagrad", {})


def RMSPropOptimizer(rho=0.95, epsilon=1e-6):
    return ("rmsprop", {"rho": rho, "epsilon": epsilon})


def AdaDeltaOptimizer(rho=0.95, epsilon=1e-6):
    return ("adadelta", {"rho": rho, "epsilon": epsilon})


_OPT_CLASSES = {
    "momentum": _opt.Momentum,
    "adam": _opt.Adam,
    "adagrad": _opt.Adagrad,
    "rmsprop": _opt.RMSProp,
    "adadelta": _opt.Adadelta,
    "sgd": _opt.SGD,
}


def settings(batch_size=None, learning_rate=0.01, learning_method=None,
             regularization=None, **_):
    """v1 settings(): returns an optimizer ready to .minimize(cost).
    The v1 convention scales learning_rate by batch size externally; here
    the given learning_rate is used as-is."""
    if learning_method is None:
        learning_method = ("sgd", {})
    name, kwargs = learning_method
    if regularization is not None:
        kwargs = dict(kwargs)
        kwargs["regularization"] = _regularizer(regularization)
    cls = _OPT_CLASSES[name]
    return cls(learning_rate=learning_rate, **kwargs)


def _regularizer(reg):
    from .. import regularizer as reg_mod

    if isinstance(reg, L2Regularization):
        return reg_mod.L2Decay(reg.rate)
    return reg


# ----------------------------------------------------------- bookkeeping
def inputs(*layers_):
    """v1 config bookkeeping (declares feed order).  The Program tracks
    data vars itself; returned list preserved for caller convenience."""
    return list(layers_)


def outputs(*layers_):
    """v1 config bookkeeping (declares fetch targets).  Returns the list;
    fetch targets are whatever you pass to Executor.run(fetch_list=...)."""
    return list(layers_)


# ------------------------------------------------- long-tail surface
# (projections, recurrent_group, the remaining *_layer functions,
# activations/attrs/poolings/optimizers/evaluators/networks — see
# v1_ext.py; imported last so the helpers above exist at class-build time)
from .v1_ext import *  # noqa: F401,F403,E402
from . import v1_ext as _v1_ext  # noqa: E402

__all__ = list(dict.fromkeys(__all__ + _v1_ext.__all__))

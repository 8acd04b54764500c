"""Thin op wrappers (``paddle_tpu/layers/ops.py``): the elementwise,
compare and logical families, ``gelu``, ``relu``, ``tanh``, ``sigmoid``,
``log`` and ``square``.  Each wrapper creates an output temp var and
appends the op."""

from .layer_helper import LayerHelper

_UNARY_OPS = ["sigmoid", "relu", "tanh", "gelu", "log", "square"]

_BINARY_OPS = [
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "logical_and", "logical_or", "logical_xor",
]

__all__ = list(_UNARY_OPS) + list(_BINARY_OPS) + ["logical_not"]


def _make_unary(op_type):
    def f(x, **attrs):
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable(x.dtype, list(x.shape), lod_level=x.lod_level)
        helper.append_op(
            type=op_type, inputs={"X": [x.name]}, outputs={"Out": [out.name]},
            attrs=attrs,
        )
        return out

    f.__name__ = op_type
    return f


def _make_binary(op_type):
    bool_out = op_type.split("_")[0] in (
        "less", "greater", "equal", "not", "logical"
    ) or op_type in ("equal", "not_equal")

    def f(x, y, axis=-1, **attrs):
        helper = LayerHelper(op_type)
        dtype = "bool" if bool_out else x.dtype
        shape = list(x.shape) if len(x.shape) >= len(y.shape) else list(y.shape)
        out = helper.create_tmp_variable(dtype, shape)
        a = dict(attrs)
        if op_type.startswith("elementwise"):
            a["axis"] = axis
        helper.append_op(
            type=op_type, inputs={"X": [x.name], "Y": [y.name]},
            outputs={"Out": [out.name]}, attrs=a,
        )
        return out

    f.__name__ = op_type
    return f


for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)
for _op in _BINARY_OPS:
    globals()[_op] = _make_binary(_op)


def logical_not(x):
    helper = LayerHelper("logical_not")
    out = helper.create_tmp_variable("bool", list(x.shape))
    helper.append_op(
        type="logical_not", inputs={"X": [x.name]},
        outputs={"Out": [out.name]}
    )
    return out

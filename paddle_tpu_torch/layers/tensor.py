"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``create_parameter``,
``cast``, ``concat``, ``sums``, ``fill_constant``, ``reshape``."""

from .layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "concat", "sums", "fill_constant",
           "reshape"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    return helper.create_parameter(
        attr, shape, dtype, suffix="b" if is_bias else "w",
        default_initializer=default_initializer,
    )


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype, x.shape, lod_level=x.lod_level)
    helper.append_op(
        type="cast", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"out_dtype": str(dtype)},
    )
    return out


def concat(input, axis=0):
    helper = LayerHelper("concat")
    shape = list(input[0].shape)
    shape[axis] = sum(v.shape[axis] for v in input) if all(
        v.shape[axis] >= 0 for v in input
    ) else -1
    out = helper.create_tmp_variable(input[0].dtype, shape)
    helper.append_op(
        type="concat", inputs={"X": input}, outputs={"Out": [out.name]},
        attrs={"axis": axis},
    )
    return out


def sums(input, out=None):
    """The elementwise sum of the variables ``input`` (the ``sum`` op)."""
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_tmp_variable(input[0].dtype, input[0].shape)
    helper.append_op(type="sum", inputs={"X": input},
                     outputs={"Out": [out.name]})
    return out


def fill_constant(shape, dtype="float32", value=0.0, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_tmp_variable(dtype, shape, stop_gradient=True)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out.name]},
        attrs={"shape": list(shape), "dtype": str(dtype), "value": float(value)},
    )
    return out


def reshape(x, shape):
    helper = LayerHelper("reshape")
    # 0 = copy dim from input (Paddle reshape convention)
    out_shape = [
        x.shape[i] if s == 0 and i < len(x.shape) else s
        for i, s in enumerate(shape)
    ]
    out = helper.create_tmp_variable(x.dtype, out_shape)
    helper.append_op(
        type="reshape", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"shape": list(shape)},
    )
    return out

"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``create_parameter``,
``cast``, ``fill_constant``, ``reshape``."""

from .layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "fill_constant", "reshape"]


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

"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``create_parameter``,
``cast``, ``concat``, ``sums``, ``assign``, ``fill_constant``,
``fill_constant_batch_size_like``, ``ones``, ``zeros``, ``reshape``,
``expand``, ``increment``, ``one_hot``."""

from .layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "concat", "sums", "assign",
           "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
           "reshape", "expand", "increment", "one_hot"]


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


def assign(input, output=None):
    """A copy of ``input``, into ``output`` when given (a loop's carried
    variable)."""
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(
        type="assign", inputs={"X": [input.name]},
        outputs={"Out": [output.name]}
    )
    return output


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


def fill_constant_batch_size_like(input, shape, dtype="float32", value=0.0,
                                  input_dim_idx=0, output_dim_idx=0):
    """``fill_constant`` whose dim ``output_dim_idx`` is the run's size of
    ``input``'s dim ``input_dim_idx``."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype, shape, stop_gradient=True)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "shape": list(shape),
            "dtype": str(dtype),
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    return out


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


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


def expand(x, expand_times):
    """``x`` tiled ``expand_times[i]`` times along axis i."""
    helper = LayerHelper("expand")
    shape = [(s * t if s >= 0 else -1) for s, t in zip(x.shape, expand_times)]
    out = helper.create_tmp_variable(x.dtype, shape)
    helper.append_op(
        type="expand", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def increment(x, value=1.0, in_place=True):
    """``x + value``, written back to ``x`` by default (a loop counter)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(
        type="increment", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"step": float(value)},
    )
    return out


def one_hot(input, depth):
    """f32 one-hot rows of ``depth``; a trailing dim of 1 is squeezed."""
    helper = LayerHelper("one_hot")
    shape = list(input.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out = helper.create_tmp_variable("float32", shape + [depth])
    helper.append_op(
        type="one_hot", inputs={"X": [input.name]},
        outputs={"Out": [out.name]}, attrs={"depth": depth},
    )
    return out

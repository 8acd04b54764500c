"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``create_tensor``,
``create_parameter``,
``cast``, ``concat``, ``sums``, ``assign``, ``fill_constant``,
``fill_constant_batch_size_like``, ``ones``, ``zeros``, ``reshape``,
``transpose``, ``split``, ``expand``, ``gather``, ``scatter``, ``pad``,
``crop``, ``argmax``, ``argmin``, ``shape``, ``increment``,
``one_hot``.  Each sets its output's shape at build time as the
reference does (a model reads it while it builds)."""

from ..core import unique_name
from .layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "cast", "concat", "sums", "assign",
           "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
           "reshape", "transpose", "split", "expand", "gather", "scatter",
           "pad", "crop", "argmax", "argmin", "shape", "increment",
           "one_hot"]


def create_tensor(dtype, name=None, persistable=False):
    """A variable of ``dtype`` with no producer (an ``assign`` or a feed
    fills it)."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_block.create_var(
        name=name or unique_name.generate("create_tensor"),
        dtype=dtype,
        persistable=persistable,
    )


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


def transpose(x, perm):
    helper = LayerHelper("transpose")
    out = helper.create_tmp_variable(x.dtype, [x.shape[i] for i in perm])
    helper.append_op(
        type="transpose", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"axis": list(perm)},
    )
    return out


def split(input, num_or_sections, dim=0):
    """``input`` cut along ``dim`` into ``num_or_sections`` equal pieces,
    or pieces of the given sizes: a list of variables."""
    helper = LayerHelper("split")
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
        sizes = ([input.shape[dim] // num] * num if input.shape[dim] >= 0
                 else [-1] * num)
    else:
        num, sections = 0, list(num_or_sections)
        sizes = sections
    outs = []
    for s in sizes:
        shape = list(input.shape)
        shape[dim] = s
        outs.append(helper.create_tmp_variable(input.dtype, shape))
    helper.append_op(
        type="split", inputs={"X": [input.name]}, outputs={"Out": outs},
        attrs={"num": num if not sections else 0, "sections": sections,
               "axis": dim},
    )
    return outs


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


def gather(input, index):
    """Rows ``index`` of ``input``."""
    helper = LayerHelper("gather")
    shape = list(index.shape[:1]) + list(input.shape[1:])
    out = helper.create_tmp_variable(input.dtype, shape)
    helper.append_op(
        type="gather", inputs={"X": [input.name], "Index": [index.name]},
        outputs={"Out": [out.name]},
    )
    return out


def scatter(input, index, updates, overwrite=True):
    """``input`` with rows ``index`` set to (or, without ``overwrite``,
    added to) ``updates``."""
    helper = LayerHelper("scatter")
    out = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(
        type="scatter",
        inputs={"X": [input.name], "Ids": [index.name],
                "Updates": [updates.name]},
        outputs={"Out": [out.name]}, attrs={"overwrite": overwrite},
    )
    return out


def pad(x, paddings, pad_value=0.0):
    """``x`` padded by ``paddings`` (before, after) pairs, one per dim."""
    helper = LayerHelper("pad")
    shape = [(s + paddings[2 * i] + paddings[2 * i + 1]) if s >= 0 else -1
             for i, s in enumerate(x.shape)]
    out = helper.create_tmp_variable(x.dtype, shape)
    helper.append_op(
        type="pad", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
        attrs={"paddings": list(paddings), "pad_value": float(pad_value)},
    )
    return out


def crop(x, shape=None, offsets=None, y=None):
    """The window of ``x`` at ``offsets`` of ``y``'s shape or ``shape``."""
    helper = LayerHelper("crop")
    tgt = list(y.shape) if y is not None else list(shape)
    out = helper.create_tmp_variable(x.dtype, tgt)
    inputs = {"X": [x.name]}
    if y is not None:
        inputs["Y"] = [y.name]
    helper.append_op(
        type="crop", inputs=inputs, outputs={"Out": [out.name]},
        attrs={"offsets": list(offsets or []), "shape": list(shape or [])},
    )
    return out


def _arg_layer(op_type):
    def f(x, axis=-1):
        helper = LayerHelper(op_type)
        shape = [s for i, s in enumerate(x.shape)
                 if i != (axis % len(x.shape))]
        out = helper.create_tmp_variable("int64", shape, stop_gradient=True)
        helper.append_op(
            type=op_type, inputs={"X": [x.name]},
            outputs={"Out": [out.name]}, attrs={"axis": axis},
        )
        return out

    return f


argmax = _arg_layer("arg_max")
argmax.__name__ = "argmax"
argmin = _arg_layer("arg_min")
argmin.__name__ = "argmin"


def shape(input):
    """``input``'s run-time shape, an int vector."""
    helper = LayerHelper("shape")
    out = helper.create_tmp_variable("int64", [len(input.shape)],
                                     stop_gradient=True)
    helper.append_op(
        type="shape", inputs={"Input": [input.name]},
        outputs={"Out": [out.name]}
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

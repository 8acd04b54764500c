"""GEMM / elementwise / reduction ops (``paddle_tpu/ops/math_ops.py``):
``mul``, the ``elementwise_*`` family with the axis broadcast rule,
``reduce_sum``, ``mean``, ``scale``, ``cast``.  Matrix products are plain
``torch.matmul`` (bf16 inputs accumulate in f32 inside the library and
return bf16, as ``preferred_element_type=float32`` + cast does)."""

import math

import numpy as np
import torch

from ..core.dtypes import torch_dtype
from ..core.registry import register_op


def _broadcast_y(X, Y, axis):
    """Reference broadcast rule: Y's dims align with X's dims starting at
    ``axis`` (default -1 = align trailing)."""
    if Y.dim() == 0 or X.shape == Y.shape:
        return Y
    ax = axis if axis >= 0 else X.dim() - Y.dim()
    # trim trailing size-1 dims like the reference does
    yshape = list(Y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > X.dim() - ax:
        yshape.pop()
    newshape = [1] * X.dim()
    newshape[ax: ax + len(yshape)] = yshape
    return Y.reshape(newshape)


def _register_elementwise(name, fn):
    @register_op("elementwise_" + name)
    def _op(X, Y, axis=-1, **_):
        return {"Out": fn(X, _broadcast_y(X, Y, axis))}

    _op.__name__ = "elementwise_" + name
    return _op


_register_elementwise("add", torch.add)
_register_elementwise("sub", torch.sub)
_register_elementwise("mul", torch.mul)
_register_elementwise("div", torch.div)
_register_elementwise("max", torch.maximum)
_register_elementwise("min", torch.minimum)
_register_elementwise("pow", torch.pow)


def _mul_flops(op, shape, grad, train):
    """2·m·n·k, and the backward's product for each operand that takes a
    gradient."""
    x, y = op.inputs["X"][0], op.inputs["Y"][0]
    xs, ys = shape(x), shape(y)
    xc = int(op.attrs.get("x_num_col_dims", 1))
    yc = int(op.attrs.get("y_num_col_dims", 1))
    one = 2 * math.prod(xs[:xc]) * math.prod(xs[xc:]) * math.prod(ys[yc:])
    return one * (1 + grad(y) + grad(x))


@register_op("mul", flops=_mul_flops)
def mul(X, Y, x_num_col_dims=1, y_num_col_dims=1, **_):
    """Flattening matmul: X collapses to 2-D at x_num_col_dims, Y at
    y_num_col_dims; the result regains X's leading dims."""
    x2 = X.reshape(int(np.prod(X.shape[:x_num_col_dims])), -1)
    y2 = Y.reshape(int(np.prod(Y.shape[:y_num_col_dims])), -1)
    out = x2 @ y2
    out_shape = tuple(X.shape[:x_num_col_dims]) + tuple(
        Y.shape[y_num_col_dims:])
    return {"Out": out.reshape(out_shape)}


@register_op("scale")
def scale(X, scale=1.0, bias=0.0, bias_after_scale=True, **_):
    if bias_after_scale:
        return {"Out": X * scale + bias}
    return {"Out": (X + bias) * scale}


@register_op("cast")
def cast(X, out_dtype="float32", **_):
    return {"Out": X.to(torch_dtype(out_dtype))}


@register_op("reduce_sum")
def reduce_sum(X, dim=None, keep_dim=False, reduce_all=False, **_):
    if reduce_all or dim is None:
        out = torch.sum(X)
        return {"Out": out.reshape([1] * X.dim()) if keep_dim else out}
    axis = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    return {"Out": torch.sum(X, dim=axis, keepdim=keep_dim)}


@register_op("mean")
def mean(X, **_):
    """The mean of every element, shape ``[1]``."""
    return {"Out": torch.mean(X).reshape(1)}

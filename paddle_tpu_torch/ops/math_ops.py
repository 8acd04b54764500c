"""GEMM / elementwise / reduction ops (``paddle_tpu/ops/math_ops.py``):
``mul`` and ``matmul``, the ``elementwise_*`` family with the axis
broadcast rule, the ``reduce_*`` family, ``mean``, ``scale``, ``cast``,
``cos_sim``, and what the clips and regularizers append: ``sum``,
``sign``, ``clip``, ``clip_by_norm``, ``squared_l2_norm``,
``error_clip``; the v1 DSL's ``bilinear_tensor_product``, ``dot``,
``maxout`` and ``selective_fc``.  Matrix products are plain ``torch.matmul`` (bf16
inputs accumulate in f32 inside the library and return bf16, as
``preferred_element_type=float32`` + cast does).

The reference keeps its scalar results ``[1]``-shaped, and so does the
port: PyTorch lets a 0-d tensor's dtype drop out of type promotion (it
counts as a Python scalar), where JAX promotes it like any array."""

import contextlib
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


def _matmul_flops(op, shape, grad, train):
    """2·(batch)·m·n·k, and the backward's product for each operand that
    takes a gradient."""
    x, y = op.inputs["X"][0], op.inputs["Y"][0]
    xs, ys = shape(x), shape(y)
    if op.attrs.get("transpose_X"):
        xs = xs[:-2] + xs[-2:][::-1]
    if op.attrs.get("transpose_Y") and len(ys) >= 2:
        ys = ys[:-2] + ys[-2:][::-1]
    batch = math.prod(xs[:-2]) if len(xs) > len(ys) else math.prod(ys[:-2])
    m = xs[-2] if len(xs) >= 2 else 1
    n = ys[-1] if len(ys) >= 2 else 1
    one = 2 * batch * m * n * xs[-1]
    return one * (1 + grad(y) + grad(x))


@contextlib.contextmanager
def _exact_f32(t):
    """No TF32 for an f32 product on the card: the reference's f32
    matmul is an f32 product, and a one-hot product (the beam decode's
    regroup of its carried state) must give the rows back exactly."""
    if t.dtype != torch.float32 or t.device.type != "cuda":
        yield
        return
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@register_op("matmul", flops=_matmul_flops)
def matmul(X, Y, transpose_X=False, transpose_Y=False, alpha=1.0, **_):
    """``jnp.matmul`` with each operand's last two axes swapped when its
    flag is set, then scaled by ``alpha`` in the output dtype."""
    x = X.transpose(-1, -2) if transpose_X and X.dim() >= 2 else X
    y = Y.transpose(-1, -2) if transpose_Y and Y.dim() >= 2 else Y
    with _exact_f32(x):
        out = torch.matmul(x, y)
    if out.dtype != X.dtype:
        out = out.to(X.dtype)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("scale")
def scale(X, scale=1.0, bias=0.0, bias_after_scale=True, **_):
    if bias_after_scale:
        return {"Out": X * scale + bias}
    return {"Out": (X + bias) * scale}


@register_op("sum")
def sum_op(X, **_):
    """The inputs added in order (a duplicable slot), in the promoted
    dtype."""
    xs = X if isinstance(X, (list, tuple)) else [X]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("sign")
def sign(X, **_):
    return {"Out": torch.sign(X)}


@register_op("clip")
def clip(X, min=-1.0, max=1.0, **_):
    return {"Out": torch.clamp(X, min, max)}


@register_op("clip_by_norm")
def clip_by_norm(X, max_norm=1.0, norm=None, **_):
    """``X`` scaled to L2 norm ``max_norm`` where it is longer: the norm
    in f32, the factor cast to ``X``'s dtype before the product.
    ``norm``: the f32 norm of the whole value where ``X`` is one block of
    it (the mesh path's)."""
    if norm is None:
        norm = torch.sqrt(torch.sum(torch.square(X.float())))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    return {"Out": X * factor.to(X.dtype)}


@register_op("squared_l2_norm")
def squared_l2_norm(X, **_):
    """``sum(X * X)`` as ``[1]`` in ``X``'s dtype: squared in that dtype,
    summed with a wider accumulator (both frameworks upcast a bf16
    reduction)."""
    return {"Out": torch.sum(torch.square(X)).reshape(1)}


class _ErrorClip(torch.autograd.Function):
    """Identity forward; the cotangent flowing back through it is
    clipped to ``[lo, hi]`` (the reference's custom-VJP identity)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, ctx.lo, ctx.hi), None, None


@register_op("error_clip")
def error_clip(X, max=1.0, min=None, **_):
    """``ErrorClipByValue``: the value passes unchanged, the
    backpropagated error at this point is clipped to ``[min, max]``
    (``[-|max|, max]`` when ``min`` is None)."""
    lo = -abs(float(max)) if min is None else float(min)
    return {"Out": _ErrorClip.apply(X, lo, float(max))}


@register_op("cast")
def cast(X, out_dtype="float32", **_):
    return {"Out": X.to(torch_dtype(out_dtype))}


def _register_reduce(name, fn):
    """``reduce_<name>`` over ``dim`` (an int or a list), or over every
    axis with ``reduce_all`` or no ``dim`` (a 0-d result, ``[1] * ndim``
    with ``keep_dim``), as ``jnp.<name>(X, axis, keepdims)``."""

    @register_op("reduce_" + name)
    def _op(X, dim=None, keep_dim=False, reduce_all=False, **_):
        if reduce_all or dim is None:
            axis = tuple(range(X.dim()))
        else:
            axis = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        out = fn(X, axis, keep_dim)
        if name in ("sum", "prod") and not X.is_floating_point():
            # jnp keeps an int sum in its dtype (a bool one in int32);
            # torch widens to int64
            out = out.to(torch.int32 if X.dtype == torch.bool else X.dtype)
        return {"Out": out}

    _op.__name__ = "reduce_" + name
    return _op


def _prod(X, axis, keepdim):
    # torch.prod takes one dim at a time
    for a in sorted((a % max(X.dim(), 1) for a in axis), reverse=True):
        X = torch.prod(X, dim=a, keepdim=keepdim)
    return X


_register_reduce("sum", lambda X, a, k: torch.sum(X, dim=a, keepdim=k))
_register_reduce("mean", lambda X, a, k: torch.mean(
    X if X.is_floating_point() else X.float(), dim=a, keepdim=k))
_register_reduce("max", lambda X, a, k: torch.amax(X, dim=a, keepdim=k))
_register_reduce("min", lambda X, a, k: torch.amin(X, dim=a, keepdim=k))
_register_reduce("prod", _prod)


@register_op("mean")
def mean(X, **_):
    """The mean of every element, shape ``[1]``."""
    return {"Out": torch.mean(X).reshape(1)}


@register_op("cos_sim")
def cos_sim(X, Y, **_):
    """Row-wise cosine similarity ``[b, 1]`` of ``X`` and ``Y`` ``[b, d]``;
    a ``Y`` of batch 1 is held against every row of ``X``.  ``XNorm`` and
    ``YNorm`` are the rows' L2 norms; the denominator is at least
    1e-12."""
    if Y.shape[0] == 1 and X.shape[0] != 1:
        Y = Y.expand(X.shape)
    xn = torch.sqrt(torch.sum(torch.square(X), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(Y), dim=1, keepdim=True))
    out = torch.sum(X * Y, dim=1, keepdim=True) / torch.clamp(xn * yn,
                                                             min=1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(X, Y, Weight, Bias=None, **_):
    """``Out[b, i] = X[b] @ Weight[i] @ Y[b] (+ Bias[i])``
    (``bilinear_tensor_product_op.h``)."""
    out = torch.einsum("bj,ijk,bk->bi", X, Weight.to(X.dtype), Y)
    if Bias is not None:
        out = out + Bias.to(X.dtype)
    return {"Out": out}


@register_op("dot")
def dot(X, Y, **_):
    return {"Out": torch.sum(X * Y, dim=-1, keepdim=True)}


@register_op("maxout")
def maxout(X, groups=2, **_):
    """The max over each run of ``groups`` channels: ``[n, c, h, w] ->
    [n, c // groups, h, w]``."""
    n, c, h, w = X.shape
    return {"Out": X.reshape(n, c // groups, groups, h, w).amax(dim=2)}


@register_op("selective_fc")
def selective_fc(X, W, Bias=None, Select=None, **_):
    """Only the selected output columns (``SelectiveFcLayer.cpp``):
    ``W [k, d]`` one row an output neuron; ``Select [b, s]`` int ids, a
    negative id is padding and gives 0.  Without ``Select``, the full
    ``X @ W.T (+ Bias)``."""
    if Select is None:
        out = X @ W.T
        if Bias is not None:
            out = out + Bias.reshape(1, -1)
        return {"Out": out}
    sel = Select.long()
    valid = sel >= 0
    idx = torch.clamp_min(sel, 0)
    out = torch.einsum("bsd,bd->bs", W[idx], X)
    if Bias is not None:
        out = out + Bias.reshape(-1)[idx]
    return {"Out": torch.where(valid, out, torch.zeros_like(out))}

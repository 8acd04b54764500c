"""Gradient and error clipping (the port's copy of ``paddle_tpu/clip.py``):
``GradientClipByValue``, ``GradientClipByNorm`` (a parameter's
``ParamAttr(gradient_clip=...)``), ``GradientClipByGlobalNorm`` (an
optimizer's ``global_clip``), and ``ErrorClipByValue`` with
``error_clip_callback``.

The global clip is the reference's op chain, each op in the gradients'
dtype: ``squared_l2_norm`` of every gradient, their ``sum`` in order,
``sqrt``, a ``fill_constant`` of the clip norm, ``elementwise_max`` and
``elementwise_div`` for the factor ``clip / max(norm, clip)``, and one
``elementwise_mul`` per gradient.  Every scalar stays ``[1]``-shaped so
PyTorch promotes it as JAX does."""

from .core import unique_name
from .core.program import OpDesc, Variable

__all__ = ["BaseGradientClipAttr", "NullGradientClipAttr",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip_ops",
           "ErrorClipByValue", "error_clip_callback"]


def _tmp_like(block, ref, tag):
    v = Variable(
        block, name=unique_name.generate(f"{ref.name}.{tag}"),
        shape=ref.shape, dtype=ref.dtype, stop_gradient=True,
    )
    block.vars[v.name] = v
    return v


class BaseGradientClipAttr:
    def _append_clip_op(self, block, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _append_clip_op(self, block, grad):
        return grad


class GradientClipByValue(BaseGradientClipAttr):
    """Clip each gradient entry to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _append_clip_op(self, block, grad):
        block.append_op(
            type="clip", inputs={"X": [grad.name]},
            outputs={"Out": [grad.name]},
            attrs={"min": float(self.min), "max": float(self.max)},
        )
        return grad


class GradientClipByNorm(BaseGradientClipAttr):
    """Scale a gradient down to L2 norm ``clip_norm`` where it is
    longer."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _append_clip_op(self, block, grad):
        block.append_op(
            type="clip_by_norm", inputs={"X": [grad.name]},
            outputs={"Out": [grad.name]},
            attrs={"max_norm": float(self.clip_norm)},
        )
        return grad


class GradientClipByGlobalNorm:
    """Global-norm clipping across every gradient of the step, applied in
    one pass by ``append_gradient_clip_ops``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


def append_gradient_clip_ops(param_grads, global_clip=None):
    """A ``GradientClipByGlobalNorm`` over the whole list, else each
    parameter's ``gradient_clip_attr``."""
    if isinstance(global_clip, GradientClipByGlobalNorm):
        block = param_grads[0][0].block
        sq_norms = []
        for _, g in param_grads:
            sq = _tmp_like(block, g, "sq")
            block.append_op(
                type="squared_l2_norm", inputs={"X": [g.name]},
                outputs={"Out": [sq.name]},
            )
            sq.shape = (1,)
            sq_norms.append(sq)
        total = _tmp_like(block, sq_norms[0], "global_sq")
        total.shape = (1,)
        block.append_op(
            type="sum", inputs={"X": [v.name for v in sq_norms]},
            outputs={"Out": [total.name]},
        )
        gnorm = _tmp_like(block, total, "global_norm")
        block.append_op(type="sqrt", inputs={"X": [total.name]},
                        outputs={"Out": [gnorm.name]})
        # factor = clip_norm / max(global_norm, clip_norm)
        cn = _tmp_like(block, gnorm, "clip_norm")
        block.append_op(
            type="fill_constant", outputs={"Out": [cn.name]},
            attrs={"shape": [1], "dtype": gnorm.dtype.name,
                   "value": float(global_clip.clip_norm)},
        )
        maxed = _tmp_like(block, gnorm, "maxed")
        block.append_op(
            type="elementwise_max", inputs={"X": [gnorm.name], "Y": [cn.name]},
            outputs={"Out": [maxed.name]},
        )
        factor = _tmp_like(block, gnorm, "factor")
        block.append_op(
            type="elementwise_div", inputs={"X": [cn.name], "Y": [maxed.name]},
            outputs={"Out": [factor.name]},
        )
        for _, g in param_grads:
            block.append_op(
                type="elementwise_mul",
                inputs={"X": [g.name], "Y": [factor.name]},
                outputs={"Out": [g.name]}, attrs={"axis": 0},
            )
        return param_grads

    result = []
    for p, g in param_grads:
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if clip_attr is not None:
            g = clip_attr._append_clip_op(p.block, g)
        result.append((p, g))
    return result


class ErrorClipByValue:
    """Clip the backpropagated error at a variable to ``[min, max]``
    (``[-max, max]`` when ``min`` is omitted)."""

    def __init__(self, max, min=None):
        if min is None and max <= 0:
            raise ValueError(
                f"ErrorClipByValue needs max > 0 when min is omitted "
                f"(got max={max}); the range is [-max, max]")
        self.max = float(max)
        self.min = float(min) if min is not None else None


def error_clip_callback(var, clip_attr):
    """Clip the gradient flowing back through ``var`` with the
    ``ErrorClipByValue`` ``clip_attr``, its forward value unchanged: an
    ``error_clip`` op (an identity whose backward clips) goes in right
    after ``var``'s producer, and every later reader of ``var`` reads its
    output instead.  ``backward_index`` and the remat segments keep
    pointing at the same ops.  Returns the clipped variable."""
    block = var.block
    producer = None
    for i, op in enumerate(block.ops):
        if var.name in op.output_names():
            producer = i
    if producer is None:
        raise ValueError(f"{var.name!r} has no producing op in its block")
    clipped = _tmp_like(block, var, "error_clip")
    clipped.stop_gradient = False
    for op in block.ops[producer + 1:]:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [
                clipped.name if n == var.name else n for n in names
            ]
    attrs = {"max": clip_attr.max}
    if clip_attr.min is not None:
        attrs["min"] = clip_attr.min
    pos = producer + 1
    block.ops.insert(
        pos,
        OpDesc("error_clip", {"X": [var.name]}, {"Out": [clipped.name]},
               attrs),
    )
    if block.backward_index is not None and pos <= block.backward_index:
        block.backward_index += 1
    segs = getattr(block.program, "_remat_segments", None)
    if segs:
        block.program._remat_segments = [
            (seg[0] + (pos <= seg[0]), seg[1] + (pos <= seg[1]), *seg[2:])
            for seg in segs
        ]
    block.program._bump_version()
    return clipped

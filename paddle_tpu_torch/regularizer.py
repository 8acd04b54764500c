"""Weight-decay regularizers (the port's copy of
``paddle_tpu/regularizer.py``): ``append_regularization_ops`` adds each
parameter's penalty gradient to its gradient with ops appended after the
backward marker, so they run with the ``@GRAD`` values live.  A
parameter's own ``ParamAttr(regularizer=...)`` wins over the
optimizer's."""

from .core import unique_name
from .core.program import Variable

__all__ = ["append_regularization_ops", "WeightDecayRegularizer",
           "L1DecayRegularizer", "L2DecayRegularizer", "L1Decay", "L2Decay"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    """For each ``(param, grad)``: ``grad += reg_grad(param)``."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if regularizer is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = regularizer._append_ops(param, grad, param.block)
        params_and_grads.append((param, new_grad))
    return params_and_grads


def _tmp(block, param, tag):
    var = Variable(block, name=unique_name.generate(f"{param.name}.{tag}"),
                   shape=param.shape, dtype=param.dtype, stop_gradient=True)
    block.vars[var.name] = var
    return var


class WeightDecayRegularizer:
    def _append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """``grad += coeff * param``."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_ops(self, param, grad, block):
        decay = _tmp(block, param, "l2decay")
        block.append_op(
            type="scale", inputs={"X": [param.name]},
            outputs={"Out": [decay.name]}, attrs={"scale": self._coeff},
        )
        block.append_op(
            type="sum", inputs={"X": [grad.name, decay.name]},
            outputs={"Out": [grad.name]},
        )
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    """``grad += coeff * sign(param)``."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_ops(self, param, grad, block):
        sign = _tmp(block, param, "l1sign")
        block.append_op(
            type="sign", inputs={"X": [param.name]},
            outputs={"Out": [sign.name]}
        )
        block.append_op(
            type="scale", inputs={"X": [sign.name]},
            outputs={"Out": [sign.name]}, attrs={"scale": self._coeff},
        )
        block.append_op(
            type="sum", inputs={"X": [grad.name, sign.name]},
            outputs={"Out": [grad.name]},
        )
        return grad


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer

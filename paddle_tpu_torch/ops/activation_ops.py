"""Activation ops (``paddle_tpu/ops/activation_ops.py``): ``gelu`` in its
exact erf form, as the reference registers it, ``relu``, ``tanh`` and
``sigmoid`` (the attention and recurrent layers'), ``softmax`` over the
last axis, and the elementwise functions the learning-rate schedules
and the clips use: ``sqrt``, ``floor``, ``exp``, ``reciprocal``,
``pow``."""

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def gelu(X, **_):
    return {"Out": F.gelu(X, approximate="none")}


@register_op("relu")
def relu(X, **_):
    return {"Out": torch.relu(X)}


@register_op("tanh")
def tanh(X, **_):
    return {"Out": torch.tanh(X)}


@register_op("sigmoid")
def sigmoid(X, **_):
    return {"Out": torch.sigmoid(X)}


@register_op("softmax")
def softmax(X, **_):
    return {"Out": torch.softmax(X, dim=-1)}


@register_op("sqrt")
def sqrt(X, **_):
    return {"Out": torch.sqrt(X)}


@register_op("floor")
def floor(X, **_):
    return {"Out": torch.floor(X)}


@register_op("exp")
def exp(X, **_):
    return {"Out": torch.exp(X)}


@register_op("reciprocal")
def reciprocal(X, **_):
    return {"Out": 1.0 / X}


@register_op("pow")
def pow_op(X, factor=1.0, **_):
    return {"Out": torch.pow(X, factor)}

"""Activation ops (``paddle_tpu/ops/activation_ops.py``): ``gelu`` in its
exact erf form, as the reference registers it, ``relu`` and ``softmax``
over the last axis."""

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def gelu(X, **_):
    return {"Out": F.gelu(X, approximate="none")}


@register_op("relu")
def relu(X, **_):
    return {"Out": torch.relu(X)}


@register_op("softmax")
def softmax(X, **_):
    return {"Out": torch.softmax(X, dim=-1)}

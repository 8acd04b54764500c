"""Activation ops (``paddle_tpu/ops/activation_ops.py``): ``gelu`` in its
exact erf form, as the reference registers it."""

import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def gelu(X, **_):
    return {"Out": F.gelu(X, approximate="none")}

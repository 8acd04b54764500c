"""Compare ops (``paddle_tpu/ops/control_flow_ops.py``; the block-
structured control-flow ops there are not ported yet)."""

import torch

from ..core.registry import register_op


def _register_cmp(name, fn):
    @register_op(name, nondiff=True)
    def _op(X, Y, **_):
        return {"Out": fn(X, Y)}

    _op.__name__ = name


_register_cmp("less_than", torch.lt)
_register_cmp("less_equal", torch.le)
_register_cmp("greater_than", torch.gt)
_register_cmp("greater_equal", torch.ge)
_register_cmp("equal", torch.eq)
_register_cmp("not_equal", torch.ne)

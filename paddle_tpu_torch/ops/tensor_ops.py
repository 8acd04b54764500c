"""Tensor manipulation & fill ops (``paddle_tpu/ops/tensor_ops.py``):
``fill_constant``, ``reshape``, ``lookup_table``."""

import torch

from ..core.dtypes import torch_dtype
from ..core.registry import register_op


@register_op("fill_constant")
def fill_constant(shape=(), dtype="float32", value=0.0, _ctx=None, **_):
    dt = torch_dtype(dtype)
    if not dt.is_floating_point and dt != torch.bool:
        value = int(value)
    return {"Out": torch.full(tuple(shape), value, dtype=dt,
                              device=_ctx.device)}


@register_op("reshape")
def reshape(X, shape=(), **_):
    # Paddle convention: 0 means "copy this dim from the input".
    shape = [int(X.shape[i]) if int(s) == 0 else int(s)
             for i, s in enumerate(shape)]
    return {"Out": X.reshape(shape)}


@register_op("lookup_table")
def lookup_table(W, Ids, padding_idx=-1, is_sparse=False, **_):
    """Embedding lookup.  Ids may be [..., 1] (fluid convention);
    ``is_sparse`` is advisory: the gradient is a dense table."""
    ids = Ids
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    out = W[ids]
    if padding_idx is not None and padding_idx >= 0:
        mask = (ids != padding_idx)[..., None]
        out = torch.where(mask, out, torch.zeros_like(out))
    return {"Out": out}

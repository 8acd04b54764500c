"""Tensor manipulation & fill ops (``paddle_tpu/ops/tensor_ops.py``):
``fill_constant``, ``fill_constant_batch_size_like``, ``assign``,
``reshape``, ``concat``, ``expand``, ``increment``, ``one_hot``,
``lookup_table``, ``sparse_fc``, ``top_k``, ``arg_max``."""

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


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(Input, shape=(), dtype="float32", value=0.0,
                                  input_dim_idx=0, output_dim_idx=0, **_):
    """``fill_constant`` whose dim ``output_dim_idx`` is ``Input``'s dim
    ``input_dim_idx`` (the run's batch), on ``Input``'s device."""
    shape = list(shape)
    shape[output_dim_idx] = Input.shape[input_dim_idx]
    dt = torch_dtype(dtype)
    if not dt.is_floating_point and dt != torch.bool:
        value = int(value)
    return {"Out": torch.full(tuple(shape), value, dtype=dt,
                              device=Input.device)}


@register_op("assign")
def assign(X, **_):
    """A copy of ``X``.  The JAX package returns ``X`` itself (its arrays
    never change); here a parameter is updated in place, so an alias
    would carry the update into the copy (``ModelAverage``'s average
    starts as an ``assign`` of its parameter)."""
    return {"Out": X.clone()}


@register_op("reshape")
def reshape(X, shape=(), **_):
    # Paddle convention: 0 means "copy this dim from the input".
    shape = [int(X.shape[i]) if int(s) == 0 else int(s)
             for i, s in enumerate(shape)]
    return {"Out": X.reshape(shape)}


@register_op("concat")
def concat(X, axis=0, **_):
    xs = X if isinstance(X, (list, tuple)) else [X]
    return {"Out": torch.cat(xs, dim=axis)}


@register_op("expand")
def expand(X, expand_times=(), **_):
    """``X`` tiled ``expand_times[i]`` times along axis i (``jnp.tile``)."""
    return {"Out": X.repeat(tuple(int(t) for t in expand_times))}


@register_op("increment")
def increment(X, step=1.0, **_):
    """``X + step`` in ``X``'s dtype (the step cast first, as the
    reference's ``jnp.asarray(step, X.dtype)``), a new tensor: a
    recomputed region or a second microbatch must not advance a counter
    that was read before."""
    return {"Out": X + torch.tensor(step, dtype=X.dtype)}


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


@register_op("one_hot", nondiff=True)
def one_hot(X, depth=0, **_):
    """f32 one-hot rows of ``depth`` (``jax.nn.one_hot``): a trailing dim
    of 1 is squeezed first, and an id outside ``[0, depth)`` gives a row
    of zeros (``F.one_hot`` would raise)."""
    ids = X.reshape(X.shape[:-1]) if X.dim() and X.shape[-1] == 1 else X
    cols = torch.arange(int(depth), device=X.device)
    return {"Out": (ids.long()[..., None] == cols).to(torch.float32)}


@register_op("sparse_fc")
def sparse_fc(Ids, Vals, W, **_):
    """The fc over a sparse input slot: ``Out[..., :] = sum_n Vals[..., n]
    * W[Ids[..., n], :]``, a weighted gather-sum of O(nnz) rows.  Ids are
    0-padded and Vals 0.0-padded, so padding adds exactly zero, and a
    duplicate id adds its row twice; the gradient of ``W`` is the
    scatter-add of the rows' cotangents (autograd's ``index`` backward,
    which accumulates duplicates)."""
    rows = W[Ids.long()]                               # [..., n, size]
    return {"Out": torch.sum(rows * Vals[..., None].to(W.dtype), dim=-2)}


@register_op("top_k")
def top_k(X, k=1, **_):
    """The ``k`` largest entries of the last axis, in descending order,
    and their int32 indices.  ``jax.lax.top_k`` breaks ties toward the
    lower index and ``torch.topk`` promises no order among ties, so this
    takes a stable descending sort: among equal values the lower index
    comes first (a bf16 softmax over many classes has many ties)."""
    vals, idx = torch.sort(X, dim=-1, descending=True, stable=True)
    return {"Out": vals[..., :k], "Indices": idx[..., :k].to(torch.int32)}


@register_op("arg_max", nondiff=True)
def arg_max(X, axis=-1, **_):
    """The index of the largest entry along ``axis``, int32 whatever the
    layer declares (the reference's op); ties go to the first index, as
    ``jnp.argmax``'s and ``torch.argmax``'s do."""
    return {"Out": torch.argmax(X, dim=axis).to(torch.int32)}

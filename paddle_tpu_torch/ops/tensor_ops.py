"""Tensor manipulation & fill ops (``paddle_tpu/ops/tensor_ops.py``):
``fill_constant``, ``fill_constant_batch_size_like``,
``fill_zeros_like``, ``assign``, ``assign_value``, ``shape``,
``reshape``, ``transpose``, ``split``, ``concat``, ``expand``,
``gather``, ``scatter``, ``pad``, ``crop``, ``multiplex``,
``increment``, ``one_hot``, ``lookup_table``, ``sparse_fc``,
``embedding_grad_rows``, ``top_k``, ``arg_max``, ``arg_min``,
``is_empty``, ``isfinite``, ``scale_sub_region``.

Integer results keep the reference's dtypes (int32 shapes and indices,
bool scalars for the predicates); every result lies on the device of
the op's input, or the run's."""

import torch
import torch.nn.functional as F

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


@register_op("fill_zeros_like")
def fill_zeros_like(X, **_):
    return {"Out": torch.zeros_like(X)}


@register_op("assign_value")
def assign_value(shape=(), dtype="float32", values=(), _ctx=None, **_):
    """The constant ``values`` of ``shape`` in ``dtype``, made on the
    run's device."""
    out = torch.tensor(list(values), dtype=torch_dtype(dtype))
    return {"Out": out.reshape(tuple(shape)).to(_ctx.device)}


@register_op("shape", nondiff=True)
def shape_op(Input, **_):
    """``Input``'s shape as an int32 vector."""
    return {"Out": torch.tensor(list(Input.shape), dtype=torch.int32,
                                device=Input.device)}


@register_op("transpose")
def transpose(X, axis=(), **_):
    return {"Out": X.permute(tuple(axis))}


@register_op("split")
def split(X, num=0, sections=(), axis=0, **_):
    """A list of pieces along ``axis``: ``sections`` sizes, or ``num``
    equal ones (``jnp.split``, which refuses an uneven ``num``).  The
    gradient is the concat of the pieces' cotangents, zeros for a piece
    nobody reads."""
    if sections:
        return {"Out": list(torch.split(X, list(sections), dim=axis))}
    n = X.shape[axis]
    if n % num:
        raise ValueError(f"split: dim {axis} of size {n} does not divide "
                         f"into {num} equal pieces")
    return {"Out": list(torch.split(X, n // num, dim=axis))}


@register_op("gather")
def gather(X, Index, **_):
    """Rows ``Index`` of ``X`` (``jnp.take`` along axis 0): the result
    has ``Index``'s shape then ``X``'s trailing dims."""
    return {"Out": X[Index.long()]}


@register_op("scatter")
def scatter(X, Ids, Updates, overwrite=True, **_):
    """``X`` with rows ``Ids`` replaced by (``overwrite``) or added to
    ``Updates``' rows.  Among duplicate ids the last update wins, as the
    CPU's XLA scatter writes them; ``index_put_`` leaves that to the
    device, so each row here gathers its winning update, the largest
    position of its id (``scatter_reduce`` ``amax``, exact and
    deterministic).  A losing duplicate gets no gradient."""
    ids = Ids.reshape(-1).long()
    upd = Updates.reshape((ids.shape[0],) + tuple(X.shape[1:]))
    if not overwrite:
        return {"Out": X.index_add(0, ids, upd.to(X.dtype))}
    pos = torch.arange(ids.shape[0], device=X.device)
    win = torch.full((X.shape[0],), -1, dtype=torch.long, device=X.device)
    win = win.scatter_reduce(0, ids, pos, reduce="amax")
    hit = (win >= 0).reshape((-1,) + (1,) * (X.dim() - 1))
    return {"Out": torch.where(hit, upd[win.clamp(min=0)].to(X.dtype), X)}


@register_op("pad")
def pad(X, paddings=(), pad_value=0.0, **_):
    """``X`` padded by ``(before, after)`` pairs, one per dim in order,
    with ``pad_value``."""
    pairs = [int(p) for i in range(X.dim() - 1, -1, -1)
             for p in (paddings[2 * i], paddings[2 * i + 1])]
    return {"Out": F.pad(X, pairs, value=float(pad_value))}


@register_op("crop")
def crop(X, Y=None, offsets=(), shape=(), **_):
    """The window of ``X`` at ``offsets`` (zeros by default) of ``Y``'s
    shape or ``shape``; a ``-1`` extent runs to the end of its dim."""
    tgt = tuple(Y.shape) if Y is not None else tuple(shape)
    off = list(offsets) if offsets else [0] * X.dim()
    tgt = [X.shape[i] - off[i] if s == -1 else s for i, s in enumerate(tgt)]
    return {"Out": X[tuple(slice(o, o + s) for o, s in zip(off, tgt))]}


@register_op("multiplex")
def multiplex(Ids, X, **_):
    """Row ``r`` of the ``Ids[r]``-th input of ``X``."""
    xs = torch.stack(list(X) if isinstance(X, (list, tuple)) else [X])
    ids = Ids.reshape(-1).long()
    return {"Out": xs[ids, torch.arange(xs.shape[1], device=xs.device)]}


@register_op("embedding_grad_rows")
def embedding_grad_rows(Grad, Ids, table_height=0, **_):
    """The rows' gradients ``Grad`` added into a zero table of
    ``table_height`` rows at ``Ids`` (duplicates add up)."""
    ids = Ids.reshape(-1).long()
    g = Grad.reshape(ids.shape[0], -1)
    table = g.new_zeros((int(table_height), g.shape[1]))
    return {"Out": table.index_add(0, ids, g)}


@register_op("arg_min", nondiff=True)
def arg_min(X, axis=-1, **_):
    """The index of the smallest entry along ``axis``, int32; ties go to
    the first index."""
    return {"Out": torch.argmin(X, dim=axis).to(torch.int32)}


@register_op("is_empty", nondiff=True)
def is_empty(X, **_):
    """A bool scalar: whether ``X`` has no element."""
    return {"Out": torch.full((), X.numel() == 0, dtype=torch.bool,
                              device=X.device)}


@register_op("isfinite", nondiff=True)
def isfinite(X, **_):
    """A bool scalar: whether every entry of ``X`` (a tensor or a list)
    is finite, each taken in f32."""
    xs = X if isinstance(X, (list, tuple)) else [X]
    return {"Out": torch.stack([torch.isfinite(x.float()).all()
                                for x in xs]).all()}


@register_op("scale_sub_region")
def scale_sub_region(X, Indices, value=1.0, **_):
    """``X [N, C, H, W]`` with each sample's box ``Indices [N, 6] = (c1,
    c2, h1, h2, w1, w2)`` (1-based, inclusive) multiplied by ``value``."""
    idx = Indices.long()

    def axis_mask(lo, hi, dim):
        r = torch.arange(dim, device=X.device)[None, :]
        return (r >= lo[:, None] - 1) & (r <= hi[:, None] - 1)

    n, c, h, w = X.shape
    region = (axis_mask(idx[:, 0], idx[:, 1], c)[:, :, None, None]
              & axis_mask(idx[:, 2], idx[:, 3], h)[:, None, :, None]
              & axis_mask(idx[:, 4], idx[:, 5], w)[:, None, None, :])
    return {"Out": torch.where(region, X * value, X)}

"""Sequence ops (``paddle_tpu/ops/sequence_ops.py``): a sequence batch is
a padded dense tensor ``[batch, max_len, ...]`` plus an int32 ``Length``
``[batch]`` (the shadow ``<name>@LENGTH`` variable), and every op masks
by it.  Padded steps come out as the reference writes them: zeros, or
the value the op writes there (``sequence_pool``'s ``-1e38`` floor of
an empty MAX row, ``sequence_reverse``'s padding left in place).

Ported: ``time_mask`` and the flat ops ``sequence_pool`` (SUM, AVERAGE,
SQRT, MAX, LAST, FIRST), ``sequence_softmax``, ``sequence_expand``,
``sequence_conv``, ``sequence_concat``, ``sequence_slice``,
``sequence_reverse``, ``sequence_erase``, ``sequence_reshape``,
``sequence_scale``, and CTC's ``ctc_align`` and ``edit_distance``; the
two-level (nested) ops ``nested_sequence_pool``, ``nested_sequence_expand``,
``nested_sequence_slice`` and ``sub_nested_seq`` over the reference's
layout: ``[b, s, t, ...]`` padded dense, ``Length [b]`` sub-sequences a
sample and ``SubLength [b, s]`` items a sub-sequence."""

import torch

from ..core.registry import register_op


def time_mask(Length, max_len, dtype=torch.float32):
    """``[batch, max_len]`` 1/0 mask from lengths."""
    steps = torch.arange(max_len, device=Length.device)
    return (steps[None, :] < Length[:, None]).to(dtype)


def _mask_for(X, Length):
    m = time_mask(Length, X.shape[1], X.dtype)
    return m.reshape(m.shape + (1,) * (X.dim() - 2))


def _tail(X):
    """``(1,) * (X.dim() - 2)``: broadcast a ``[b, t]`` value over X's
    feature dims."""
    return (1,) * (X.dim() - 2)


@register_op("sequence_pool")
def sequence_pool(X, Length=None, pooltype="SUM", **_):
    b, t = X.shape[0], X.shape[1]
    if Length is None:
        Length = torch.full((b,), t, dtype=torch.int32, device=X.device)
    m = _mask_for(X, Length)
    lens = Length.to(torch.float32).reshape((b,) + (1,) * (X.dim() - 2))
    pt = pooltype.upper()
    if pt == "SUM":
        out = torch.sum(X * m, dim=1)
    elif pt == "AVERAGE":
        out = torch.sum(X * m, dim=1) / torch.clamp_min(lens, 1.0)
    elif pt == "SQRT":
        out = torch.sum(X * m, dim=1) / torch.sqrt(torch.clamp_min(lens, 1.0))
    elif pt == "MAX":
        # amax shares the gradient among ties, as JAX's max does; the
        # fill is a Python scalar (a device scalar made from the host
        # would cost a synchronizing copy)
        out = torch.amax(torch.where(m > 0, X, -1e38), dim=1)
    elif pt == "LAST":
        idx = torch.clamp_min(Length - 1, 0).long()
        idx = idx.reshape((b, 1) + _tail(X)).expand((b, 1) + X.shape[2:])
        out = torch.gather(X, 1, idx).squeeze(1)
    elif pt == "FIRST":
        out = X[:, 0]
    else:
        raise ValueError(f"unknown pooltype {pooltype}")
    return {"Out": out}


@register_op("sequence_softmax")
def sequence_softmax(X, Length=None, **_):
    """Softmax over the time axis of ``X [batch, max_len]``; padded steps
    get 0."""
    if Length is None:
        return {"Out": torch.softmax(X, dim=1)}
    m = time_mask(Length, X.shape[1], torch.bool)
    sm = torch.softmax(torch.where(m, X, -1e38), dim=1)
    return {"Out": torch.where(m, sm, torch.zeros_like(sm))}


def _seq_conv_flops(op, shape, grad, train):
    """The context product ``[b, t, ctx * d] x [ctx * d, out]``, and the
    backward's for each operand that takes a gradient."""
    xs, fs = shape(op.inputs["X"][0]), shape(op.inputs["Filter"][0])
    one = 2 * xs[0] * xs[1] * fs[0] * fs[1]
    return one * (1 + grad(op.inputs["Filter"][0]) + grad(op.inputs["X"][0]))


@register_op("sequence_conv", flops=_seq_conv_flops)
def sequence_conv(X, Filter, Length=None, contextLength=3, contextStart=None,
                  **_):
    """Context-window projection: ``X [b, t, d]``, ``Filter
    [contextLength * d, out]``; rows outside the sequence are zeros."""
    b, t, d = X.shape
    start = (contextStart if contextStart is not None
             else -((contextLength - 1) // 2))
    if Length is not None:
        X = X * _mask_for(X, Length)
    steps = torch.arange(t, device=X.device)
    cols = []
    for i in range(contextLength):
        off = start + i
        shifted = torch.roll(X, -off, dims=1)
        if off > 0:
            keep = (steps < t - off)[None, :, None]
        elif off < 0:
            keep = (steps >= -off)[None, :, None]
        else:
            cols.append(shifted)
            continue
        cols.append(torch.where(keep, shifted, torch.zeros_like(shifted)))
    ctx = torch.cat(cols, dim=-1)
    out = torch.matmul(ctx, Filter.to(X.dtype))
    if Length is not None:
        out = out * _mask_for(out, Length)
    return {"Out": out}


@register_op("sequence_concat")
def sequence_concat(X, Length=None, axis=1, **_):
    """Each batch item's sequences joined along time (lengths add);
    without lengths, or along another axis, a plain concatenation."""
    xs = X if isinstance(X, (list, tuple)) else [X]
    lens = (Length if isinstance(Length, (list, tuple))
            else ([Length] if Length is not None else None))
    if axis != 1 or lens is None:
        return {"Out": torch.cat(xs, dim=axis)}
    b = xs[0].shape[0]
    dev = xs[0].device
    total = sum(x.shape[1] for x in xs)
    feat = tuple(xs[0].shape[2:])
    out = torch.zeros((b, total) + feat, dtype=xs[0].dtype, device=dev)
    out_len = torch.zeros((b,), dtype=torch.int32, device=dev)
    pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    for x, ln in zip(xs, lens):
        t = x.shape[1]
        idx = pos[:, None] + torch.arange(t, device=dev)[None, :]
        valid = time_mask(ln, t, torch.bool)
        idx = torch.where(valid, idx, torch.full_like(idx, total)).long()
        pad = torch.zeros((b, 1) + feat, dtype=out.dtype, device=dev)
        outpad = torch.cat([out, pad], dim=1)
        bidx = torch.arange(b, device=dev)[:, None].expand(b, t)
        vm = valid.reshape(valid.shape + (1,) * len(feat))
        vals = torch.where(vm, x, outpad[bidx, idx])
        out = outpad.index_put((bidx, idx), vals)[:, :total]
        pos = pos + ln.to(torch.int32)
        out_len = out_len + ln.to(torch.int32)
    return {"Out": out, "OutLength": out_len}


@register_op("sequence_expand")
def sequence_expand(X, Y=None, YLength=None, **_):
    """Each batch item's vector broadcast over its target sequence's
    steps: ``X [b, d]`` (or ``[b, 1, d]``) -> ``[b, max_len_y, d]``,
    masked by ``YLength``."""
    if Y is None:
        raise ValueError("sequence_expand requires the Y input (its static "
                         "max_len defines the output time dimension)")
    x = X if X.dim() == 3 else X[:, None, :]
    t = Y.shape[1]
    out = x.expand((x.shape[0], t) + tuple(x.shape[2:]))
    if YLength is not None:
        out = out * _mask_for(out, YLength)
    return {"Out": out}


@register_op("sequence_slice")
def sequence_slice(X, Offset, SeqLength, **_):
    """``[offset, offset + len)`` of each row, padded to X's max_len."""
    b, t = X.shape[0], X.shape[1]
    off = Offset.reshape(-1).to(torch.int32)
    ln = SeqLength.reshape(-1).to(torch.int32)
    idx = off[:, None] + torch.arange(t, device=X.device)[None, :]
    idx = torch.clamp(idx, 0, t - 1).long()
    idx = idx.reshape((b, t) + _tail(X)).expand(X.shape)
    out = torch.gather(X, 1, idx)
    out = out * _mask_for(out, ln)
    return {"Out": out, "OutLength": ln}


@register_op("sequence_reverse")
def sequence_reverse(X, Length=None, **_):
    """``out[b, t] = x[b, len_b - 1 - t]`` for ``t < len_b``; padding
    stays in place."""
    b, t = X.shape[0], X.shape[1]
    if Length is None:
        return {"Out": torch.flip(X, dims=[1])}
    ln = Length.reshape(-1, 1).to(torch.int64)
    idx = torch.arange(t, device=X.device)[None, :]
    ridx = torch.where(idx < ln, ln - 1 - idx, idx)
    ridx = ridx.reshape((b, t) + _tail(X)).expand(X.shape)
    return {"Out": torch.gather(X, 1, ridx)}


def _compact(X, keep, t):
    """Kept entries moved left in order, the rest zero; the new
    lengths."""
    steps = torch.arange(t, device=X.device)[None, :]
    key = torch.where(keep, 0, 1) * t + steps
    order = torch.argsort(key, dim=1)
    gathered = torch.gather(X, 1, order)
    new_len = torch.sum(keep, dim=1).to(torch.int32)
    valid = time_mask(new_len, t, torch.bool)
    return torch.where(valid, gathered, torch.zeros_like(gathered)), new_len


@register_op("sequence_erase", nondiff=True)
def sequence_erase(X, Length=None, tokens=(), **_):
    """The given token ids removed from ``X int [b, t]``, each sequence
    compacted to the left."""
    b, t = X.shape
    keep = torch.ones_like(X, dtype=torch.bool)
    for tok in tokens:
        keep = keep & (X != tok)
    if Length is not None:
        keep = keep & time_mask(Length, t, torch.bool)
    out, new_len = _compact(X, keep, t)
    return {"Out": out, "OutLength": new_len}


@register_op("sequence_reshape")
def sequence_reshape(X, Length=None, new_dim=0, **_):
    b, t, d = X.shape
    factor = d / new_dim
    new_t = int(t * d // new_dim)
    out = X.reshape(b, new_t, new_dim)
    if Length is not None:
        new_len = (Length.to(torch.float32) * factor).to(torch.int32)
    else:
        new_len = torch.full((b,), new_t, dtype=torch.int32, device=X.device)
    return {"Out": out, "OutLength": new_len}


@register_op("sequence_scale")
def sequence_scale(X, Scales, Length=None, **_):
    """Each sequence scaled by its own factor."""
    return {"Out": X * Scales.reshape((-1,) + (1,) * (X.dim() - 1))}


@register_op("edit_distance", nondiff=True)
def edit_distance(Hyps, Refs, HypsLength=None, RefsLength=None,
                  normalized=False, **_):
    """Levenshtein distance of each row's hypothesis to its reference
    (``Hyps``/``Refs`` int ``[b, t]``), float32 ``[b, 1]``.

    One step a hypothesis token, the whole batch and every reference
    prefix at once: the substitution and deletion candidates come from
    the previous row, and the insertion chain ``row[j] = min(cand[j],
    row[j - 1] + 1)`` is ``j + cummin(cand[j] - j)``.  Past a row's
    hypothesis length the previous row is kept, and ``row[rl]`` is read
    as the reference's DP reads it."""
    b, th = Hyps.shape
    tr = Refs.shape[1]
    dev = Hyps.device
    hlen = (HypsLength if HypsLength is not None else
            torch.full((b,), th, dtype=torch.int32, device=dev))
    rlen = (RefsLength if RefsLength is not None else
            torch.full((b,), tr, dtype=torch.int32, device=dev))
    j = torch.arange(tr + 1, dtype=torch.int32, device=dev)
    row = j.expand(b, tr + 1)
    for i in range(th):
        sub = (Hyps[:, i:i + 1] != Refs).to(torch.int32)
        cand = torch.cat([row[:, :1] + 1,
                          torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)],
                         dim=1)
        new = torch.cummin(cand - j, dim=1).values + j
        row = torch.where((i < hlen)[:, None], new, row)
    dist = torch.gather(row, 1, rlen.long()[:, None]).to(torch.float32)
    if normalized:
        dist = dist / torch.clamp_min(rlen.to(torch.float32), 1.0)[:, None]
    return {"Out": dist,
            "SequenceNum": torch.full((1,), b, dtype=torch.int32,
                                      device=dev)}


@register_op("ctc_align", nondiff=True)
def ctc_align(Input, Length=None, blank=0, merge_repeated=True, **_):
    """CTC's greedy alignment of ``Input`` int ``[b, t]`` (argmax ids):
    repeats collapsed (with ``merge_repeated``), blanks dropped, what is
    kept moved to the front in order (``_compact``'s sort on keys unique
    in a row), zeros past the new length."""
    b, t = Input.shape
    x = Input
    if merge_repeated:
        prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype,
                                     device=x.device), x[:, :-1]], dim=1)
        keep = x != prev
    else:
        keep = torch.ones_like(x, dtype=torch.bool)
    keep = keep & (x != blank)
    if Length is not None:
        keep = keep & time_mask(Length, t, torch.bool)
    out, new_len = _compact(x, keep, t)
    return {"Output": out, "OutputLength": new_len}


# -- two-level (nested) sequences -------------------------------------------

def _nested_masks(X, Length, SubLength):
    """Defaults (every slot full) and the ``[b, s]`` outer and ``[b, s, t]``
    inner masks of a nested batch."""
    b, s, t = X.shape[:3]
    dev = X.device
    if Length is None:
        Length = torch.full((b,), s, dtype=torch.int32, device=dev)
    if SubLength is None:
        SubLength = torch.full((b, s), t, dtype=torch.int32, device=dev)
    outer = torch.arange(s, device=dev)[None, :] < Length[:, None]
    inner = torch.arange(t, device=dev)[None, None, :] < SubLength[:, :, None]
    return Length, SubLength, outer, inner & outer[:, :, None]


@register_op("nested_sequence_pool")
def nested_sequence_pool(X, Length=None, SubLength=None, pooltype="SUM",
                         **_):
    """Pool the inner level: ``[b, s, t, ...] -> [b, s, ...]``, a sequence
    over the outer lengths, each sub-sequence pooled as ``sequence_pool``
    pools a row.  A slot past ``Length`` is an empty sub-sequence."""
    Length, SubLength, outer, inner = _nested_masks(X, Length, SubLength)
    b, s = X.shape[:2]
    feat = (1,) * (X.dim() - 3)
    m = inner.to(X.dtype).reshape(inner.shape + feat)
    SubLength = torch.where(outer, SubLength, torch.zeros_like(SubLength))
    lens = SubLength.float().reshape((b, s) + feat)
    outer_m = outer.to(X.dtype).reshape((b, s) + feat)
    pt = pooltype.upper()
    if pt == "SUM":
        out = torch.sum(X * m, dim=2)
    elif pt == "AVERAGE":
        out = torch.sum(X * m, dim=2) / torch.clamp_min(lens, 1.0)
    elif pt == "SQRT":
        out = torch.sum(X * m, dim=2) / torch.sqrt(torch.clamp_min(lens, 1.0))
    elif pt == "MAX":
        floor = torch.full((), -1e38, dtype=X.dtype, device=X.device)
        out = torch.where(m > 0, X, floor).amax(dim=2)
        out = torch.where(lens > 0, out, torch.zeros_like(out))
    elif pt == "LAST":
        idx = torch.clamp_min(SubLength - 1, 0).long()
        idx = idx.reshape((b, s, 1) + feat).expand(
            (b, s, 1) + tuple(X.shape[3:]))
        out = torch.gather(X, 2, idx).squeeze(2) * outer_m
    elif pt == "FIRST":
        out = X[:, :, 0] * outer_m
    else:
        raise ValueError(f"unknown pooltype {pooltype}")
    return {"Out": out}


@register_op("nested_sequence_expand")
def nested_sequence_expand(X, Y, Length=None, SubLength=None, **_):
    """``Out[b, s, t] = X[b, s]`` where ``t < SubLength[b, s]`` (and the
    slot is inside ``Length``), else 0: ``X [b, s, ...]`` over ``Y``'s
    inner level."""
    _, _, _, inner = _nested_masks(Y, Length, SubLength)
    t = Y.shape[2]
    out = X[:, :, None].expand(X.shape[:2] + (t,) + X.shape[2:])
    m = inner.to(X.dtype).reshape(inner.shape + (1,) * (X.dim() - 2))
    return {"Out": out * m}


def _take_subseqs(X, pos, valid, Length, SubLength):
    """Sub-sequences ``pos [b, k]`` of each sample (0 where not
    ``valid``), with their sub-lengths: the nested slice's and
    ``sub_nested_seq``'s gather."""
    b, k = pos.shape
    feat = (1,) * (X.dim() - 2)
    idx = pos.long().reshape((b, k) + feat).expand((b, k) + X.shape[2:])
    vm = valid.reshape((b, k) + feat).to(X.dtype)
    out = torch.gather(X, 1, idx) * vm
    _, SubLength, _, _ = _nested_masks(X, Length, SubLength)
    sub = torch.gather(SubLength, 1, pos.long()) * valid
    return {"Out": out, "OutLength": valid.sum(dim=1).to(torch.int32),
            "OutSubLength": sub.to(torch.int32)}


@register_op("nested_sequence_slice")
def nested_sequence_slice(X, Offset, Size, Length=None, SubLength=None, **_):
    """Sample ``b`` keeps sub-sequences ``[Offset[b], Offset[b] + Size[b])``
    that lie inside its ``Length`` (fewer when the range runs past it):
    ``Out`` stays ``[b, s, t, ...]`` with ``OutLength`` and the gathered
    ``OutSubLength``."""
    b, s = X.shape[:2]
    offset = Offset.reshape(b).long()
    size = Size.reshape(b).long()
    slots = torch.arange(s, device=X.device)[None, :]
    pos = slots + offset[:, None]
    if Length is None:
        Length = torch.full((b,), s, dtype=torch.int32, device=X.device)
    valid = (slots < size[:, None]) & (pos < Length[:, None])
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    return _take_subseqs(X, pos, valid, Length, SubLength)


@register_op("sub_nested_seq")
def sub_nested_seq(X, Indices, Length=None, SubLength=None, **_):
    """Sub-sequences picked by ``Indices [b, k]``
    (``SubNestedSequenceLayer.cpp``); a negative index, or one past the
    sample's ``Length``, is padding and gives an empty sub-sequence.
    ``Out [b, k, t, ...]``, ``OutLength [b]``, ``OutSubLength [b, k]``."""
    b, s = X.shape[:2]
    idx = Indices.long()
    if Length is None:
        Length = torch.full((b,), s, dtype=torch.int32, device=X.device)
    valid = (idx >= 0) & (idx < Length[:, None])
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    return _take_subseqs(X, safe, valid, Length, SubLength)

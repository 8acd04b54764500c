"""Sequence/context parallelism: ring attention (the port's
``paddle_tpu/parallel/ring_attention.py``).

The sequence axis is cut over a mesh axis (``sp``): each rank holds a
Q/K/V block ``[b, t/sp, h, d]``, and the K/V blocks rotate around the
ring (:func:`~.collectives.ppermute`, one call for both) while an online
softmax accumulates the partial attentions.  The reference runs the ring
inside ``shard_map`` on global arrays; the port runs one process a rank,
so every function here takes this rank's blocks and returns this rank's
block of the output.

Two inner blocks, as in the reference:

* ``impl="dense"``: :func:`_attn_block` — the scores in f32, a causal
  step masked by a ``-1e30`` bias, merged as ``(o, m, l)``;
* ``impl="flash"``: the flash kernels through
  :func:`~paddle_tpu_torch.kernels.flash_attention.flash_attention_with_lse`
  — the diagonal step causal, a past step full, a future step skipped
  (no launch) — the partials cast to f32 and merged by their
  logsumexp, so the backward carries the merge's ``dlse`` into the
  kernels' backward.  On CPU tensors the kernels' wrappers run their
  plain versions.

The ring issues ``sp - 1`` shifts: the reference's last shift brings
each block back to its owner and its result is unused.  A step that is
skipped still shifts, and the accumulator rides through each shift (its
``carry``), so every rank issues the same shifts forward and backward.
"""

import torch

from .collectives import bound, current_comm, mesh_comm, ppermute

__all__ = ["ring_attention", "ring_attention_local", "blockwise_attention"]

NEG = -1e30


def _attn_block(q, k, v, bias=None, scale=None):
    """One dense block: (unnormalized out, row max, row sum).
    q [b, tq, h, d], k/v [b, tk, h, d] -> o [b, tq, h, d] in v's dtype,
    m/l [b, h, tq] f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m[..., 0], l[..., 0]


def _cast(x):
    """[b, h, q] -> [b, q, h, 1]."""
    return x.transpose(1, 2)[..., None]


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two partial attention results with online softmax."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * _cast(a1).to(o1.dtype) + o2 * _cast(a2).to(o2.dtype)
    return o, m, l


def _finalize(o, m, l):
    return o / _cast(l).to(o.dtype)


def _causal_bias(q0, tq, k0, tk, device):
    qpos = (q0 + torch.arange(tq, device=device))[:, None]
    kpos = (k0 + torch.arange(tk, device=device))[None, :]
    return torch.where(qpos >= kpos, 0.0, NEG)[None, None]


def blockwise_attention(q, k, v, block_size=512, causal=False):
    """Memory-efficient attention on one device: a loop over K/V blocks
    with online softmax; peak memory O(tq * block) instead of O(tq * tk)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    nblk = max(tk // block_size, 1)
    while tk % nblk:  # tk must split evenly; shrink block count until it does
        nblk -= 1
    bs = tk // nblk
    o = torch.zeros_like(q)
    m = torch.full((b, h, tq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    for idx in range(nblk):
        kk = k[:, idx * bs:(idx + 1) * bs]
        vv = v[:, idx * bs:(idx + 1) * bs]
        bias = _causal_bias(0, tq, idx * bs, bs, q.device) if causal else None
        o2, m2, l2 = _attn_block(q, kk, vv, bias=bias)
        o, m, l = _merge(o, m, l, o2, m2, l2)
    return _finalize(o, m, l)


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False,
                   impl="dense", block_q=1024, block_k=1024):
    """Ring attention over a sequence-sharded batch.

    q/k/v: this rank's ``[b, t/sp, h, d]`` blocks of the sequence cut on
    t over ``axis_name`` (rank i of the axis holds block i).  ``mesh``: a
    bound :class:`~.mesh.Mesh` or a :class:`~.collectives.MeshComm`.
    Returns this rank's block of the output.

    impl="flash" runs each step's inner block through the flash kernels of
    the backend the registry resolves for ``q``'s device (its
    ``call_with_lse``; on a card the CUDA kernels unless the env asks for
    another) and merges the per-step partials by their logsumexp; "dense"
    (default) is the composed inner block.
    """
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown ring_attention impl {impl!r}; "
                         f"choose 'dense' or 'flash'")
    comm = mesh_comm(mesh)
    sp = comm.size(axis_name)
    with bound(comm):
        if impl == "flash":
            return _ring_attention_flash(q, k, v, comm, axis_name, sp,
                                         causal, block_q, block_k)
        return ring_attention_local(q, k, v, sp, axis_name=axis_name,
                                    causal=causal)


def ring_attention_local(q_blk, k_blk, v_blk, sp, axis_name="sp",
                         causal=False, comm=None):
    """The ring's per-rank body (dense inner blocks), for callers that
    already run on a bound mesh — e.g. an attention stage inside
    ``parallel.pipeline`` (pp x sp composition), which binds its mesh
    while its stages run.  q_blk/k_blk/v_blk are this rank's
    ``[b, t/sp, h, d]`` blocks; ``sp`` is the ring size; ``comm``: the
    mesh's comm (default: the bound one)."""
    comm = comm if comm is not None else current_comm()
    if comm.size(axis_name) != sp:
        raise ValueError(f"ring of {sp} on mesh axis {axis_name!r} of "
                         f"{comm.size(axis_name)} ranks")
    b, tl, h, d = q_blk.shape
    my_idx = comm.index(axis_name)
    o = torch.zeros_like(q_blk)
    m = torch.full((b, h, tl), NEG, dtype=torch.float32, device=q_blk.device)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=q_blk.device)
    kk, vv = k_blk, v_blk
    for i in range(sp):
        if i:
            # rotate K/V one step around the ring; the accumulator rides
            (kk, vv), (o, m, l) = ppermute([kk, vv], comm, axis_name,
                                           carry=[o, m, l], var="ring_kv")
        src_idx = (my_idx - i) % sp  # whose K/V block we hold now
        bias = (_causal_bias(my_idx * tl, tl, src_idx * tl, tl,
                             q_blk.device) if causal else None)
        o2, m2, l2 = _attn_block(q_blk, kk, vv, bias=bias)
        o, m, l = _merge(o, m, l, o2, m2, l2)
    return _finalize(o, m, l)


def _ring_attention_flash(q, k, v, comm, axis_name, sp, causal, block_q,
                          block_k):
    """Flash-kernel inner blocks composed across the ring: each step the
    rank attends its Q block to the K/V block it holds now (diagonal
    steps causal, past steps full, future steps skipped), and the partial
    outputs merge by logsumexp in f32 — the same online softmax the dense
    path carries as (m, l)."""
    from ..kernels import registry

    flash_attention_with_lse = registry.resolve(
        "flash_attention", platform=q.device.type).impl.call_with_lse
    b, tl, h, d = q.shape
    my_idx = comm.index(axis_name)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, tl), NEG, dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for i in range(sp):
        if i:
            (kk, vv), (o, lse) = ppermute([kk, vv], comm, axis_name,
                                          carry=[o, lse], var="ring_kv")
        src_idx = (my_idx - i) % sp
        if causal and src_idx > my_idx:
            continue                      # a future block: no launch
        o2, lse2 = flash_attention_with_lse(
            q, kk, vv, causal=causal and src_idx == my_idx,
            block_q=block_q, block_k=block_k)
        o2, lse2 = o2.float(), lse2.float()
        new_lse = torch.logaddexp(lse, lse2)
        w1 = torch.exp(lse - new_lse)
        w2 = torch.exp(lse2 - new_lse)
        o = o * _cast(w1) + o2 * _cast(w2)
        lse = new_lse
    return o.to(q.dtype)

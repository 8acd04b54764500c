"""The ``flash_attention`` and ``flash_attention_packed`` ops — the op
registrations at the foot of ``paddle_tpu/ops/pallas_attention.py``,
single-device branch.  Both resolve the ``flash_attention`` op class
through the kernel registry (``kernels/registry.py``), as the reference's
``_resolve_backend`` does: the op's ``backend`` attr is a strict request,
and without one the per-op env, the global env, then auto decide (on a
card the hand-written CUDA kernels, on the CPU the plain versions).  The
TPU tile attrs ``block_q`` and ``block_k`` (default 1024, as in the
reference) pass through: the CUDA kernels tile by their own fixed sizes,
but the backward's route — fused or split — is the reference's rule over
``block_k``; the Triton kernels take them as caps of their tiles.  On a
mesh with a ``tp`` axis, :func:`_flash_tp` is the head-sharded branch
(``pallas_attention.py:1187-1241``), on whichever backend resolves."""

from ..core.registry import register_op
from ..kernels import registry as _kreg
from ..parallel.spmd import tp_rule


def _flash_flops(op, shape, grad, train):
    """The causal products: q·kᵀ and p·v forward; dv, dp, dq and dk
    backward (the model's own, not the backward's recompute of the
    scores)."""
    qs, ks = shape(op.inputs["Q"][0]), shape(op.inputs["K"][0])
    if op.type == "flash_attention":
        b, tq, h, d = qs
    else:
        h = int(op.attrs["n_head"])
        b, tq, d = qs[0], qs[1], qs[2] // h
    tk = ks[1]
    pairs = tq * tk
    if op.attrs.get("causal", False):
        pairs = tq * (tq + 1) // 2 if tq == tk else pairs // 2
    return 2 * b * h * pairs * d * (2 + (4 if train else 0))


def _impl(backend, q):
    """The resolved ``flash_attention`` backend for a call on ``q``'s
    device (``backend``: the op's attr, or None)."""
    return _kreg.resolve("flash_attention", backend or None,
                         q.device.type).impl


@register_op("flash_attention", flops=_flash_flops)
def flash_attention_op(Q, K, V, causal=False, sm_scale=0.0, block_q=1024,
                       block_k=1024, backend=None, **_):
    scale = None if not sm_scale else float(sm_scale)
    return {"Out": _impl(backend, Q).call(
        Q, K, V, causal=causal, sm_scale=scale, block_q=int(block_q),
        block_k=int(block_k))}


@register_op("flash_attention_packed", flops=_flash_flops)
def flash_attention_packed_op(Q, K, V, n_head=None, causal=False,
                              sm_scale=0.0, block_q=1024, block_k=1024,
                              backend=None, **_):
    if n_head is None:
        # no safe default: 1 would silently softmax across the whole
        # concatenated h*d feature dim as a single head
        raise ValueError("flash_attention_packed op requires the n_head attr")
    scale = None if not sm_scale else float(sm_scale)
    return {"Out": _impl(backend, Q).call_packed(
        Q, K, V, int(n_head), causal=causal, sm_scale=scale,
        block_q=int(block_q), block_k=int(block_k))}


@tp_rule("flash_attention", "flash_attention_packed")
def _flash_tp(sp, op, ins, pls, attrs, run):
    """Head-sharded tensor parallelism: the q/k/v projections are
    column-sharded, so a rank's block of ``[b, t, h*d]`` (or of the 4-D
    ``[b, t, h, d]`` on its head dim) holds ``h/tp`` whole heads and
    attention needs no communication — each rank runs the flash kernels
    on its local heads (the packed op with ``n_head/tp``), and the output
    stays sharded on the same dim.  Any other placement (or ``n_head``
    not divisible by tp) takes the gathered path."""
    head_dim = 2
    if any(pls.get(k) != head_dim for k in ("Q", "K", "V")):
        return None
    if op.type == "flash_attention_packed":
        n_head = int(attrs.get("n_head") or 0)
        if ins["Q"].dim() != 3 or not n_head or n_head % sp.tp:
            return None
        attrs = dict(attrs, n_head=n_head // sp.tp)
    elif ins["Q"].dim() != 4:
        return None
    return run(ins, attrs), {"Out": head_dim}

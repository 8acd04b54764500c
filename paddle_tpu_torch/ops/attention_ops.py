"""The ``flash_attention`` and ``flash_attention_packed`` ops — the op
registrations at the foot of ``paddle_tpu/ops/pallas_attention.py``,
single-device branch.  Both go to ``kernels/flash_attention.py``: the
hand-written CUDA kernels on the card, the plain versions on the CPU.
The TPU tile attrs (``block_q``, ``block_k``) and the kernel-registry
``backend`` attr are accepted and unused: the CUDA kernels tile by their
own fixed sizes.  The head-sharded ``tp`` branch waits for the multi-GPU
slice."""

from ..core.registry import register_op
from ..kernels import flash_attention as _fa


@register_op("flash_attention")
def flash_attention_op(Q, K, V, causal=False, sm_scale=0.0, **_):
    scale = None if not sm_scale else float(sm_scale)
    return {"Out": _fa.flash_attention(Q, K, V, causal=causal,
                                       sm_scale=scale)}


@register_op("flash_attention_packed")
def flash_attention_packed_op(Q, K, V, n_head=None, causal=False,
                              sm_scale=0.0, **_):
    if n_head is None:
        # no safe default: 1 would silently softmax across the whole
        # concatenated h*d feature dim as a single head
        raise ValueError("flash_attention_packed op requires the n_head attr")
    scale = None if not sm_scale else float(sm_scale)
    return {"Out": _fa.flash_attention_packed(
        Q, K, V, int(n_head), causal=causal, sm_scale=scale)}

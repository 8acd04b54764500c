"""Loss ops (``paddle_tpu/ops/loss_ops.py``): ``cross_entropy`` (over
probabilities, ResNet's loss), ``softmax_with_cross_entropy`` (the
unfused LM head's loss) and
``fused_softmax_ce_head`` (the fused head's, registered at the foot of
``paddle_tpu/ops/pallas_ce.py``)."""

import torch

from ..core.registry import register_op
from ..kernels import fused_ce as _ce


def _squeeze_label(Label):
    if Label.dim() >= 2 and Label.shape[-1] == 1:
        return Label.reshape(Label.shape[:-1])
    return Label


@register_op("cross_entropy")
def cross_entropy(X, Label, soft_label=False, **_):
    """``X`` holds probabilities, not logits: ``-log(max(p, 1e-20))`` of
    the label's entry (or the soft labels' weighted sum over the last
    axis), in f32, cast to ``X.dtype``, shape ``[..., 1]``."""
    xf = X.float()
    if soft_label:
        logp = torch.log(torch.clamp_min(xf, 1e-20))
        out = -torch.sum(Label.float() * logp, dim=-1, keepdim=True)
    else:
        lbl = _squeeze_label(Label).long()
        picked = torch.gather(xf, -1, lbl[..., None])
        out = -torch.log(torch.clamp_min(picked, 1e-20))
    return {"Y": out.to(X.dtype)}


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(Logits, Label, soft_label=False, _live=None,
                               **_):
    """log-softmax in f32, loss = -logp[label], both cast to the logits'
    dtype.  The ``Softmax`` output (``[..., vocab]``, as large as the
    logits) is materialised only when something reads it."""
    logp = torch.log_softmax(Logits.float(), dim=-1)
    if soft_label:
        loss = -(Label.float() * logp).sum(dim=-1, keepdim=True)
    else:
        lbl = _squeeze_label(Label).long()
        loss = -torch.gather(logp, -1, lbl[..., None])
    out = {"Loss": loss.to(Logits.dtype)}
    if _live is None or "Softmax" in _live:
        out["Softmax"] = torch.exp(logp).to(Logits.dtype)
    return out


@register_op("fused_softmax_ce_head")
def fused_softmax_ce_head(X, W, Label, **_):
    """Projection + softmax cross-entropy in one pass
    (``kernels/fused_ce.py``: the CUDA kernels on the card, the plain
    versions on the CPU): ``X [..., d]``, ``W [d, V]``, ``Label [...]`` or
    ``[..., 1]`` -> ``Loss [..., 1]`` f32.  The single-device branch of the
    reference; its attrs (``block_n``, ``block_v``, ``block_v_fwd``, the
    kernel-registry ``backend``) are accepted and unused: the CUDA kernels
    tile by their own sizes.  Its vocab-sharded ``tp`` branch waits for
    the multi-GPU slice."""
    lbl = Label
    if lbl.dim() == X.dim() and lbl.shape[-1] == 1:
        lbl = lbl.reshape(lbl.shape[:-1])
    return {"Loss": _ce.fused_softmax_ce_head(X, W, lbl)[..., None]}

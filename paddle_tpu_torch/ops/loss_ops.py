"""Loss ops (``paddle_tpu/ops/loss_ops.py``):
``softmax_with_cross_entropy`` (the unfused LM head's loss)."""

import torch

from ..core.registry import register_op


def _squeeze_label(Label):
    if Label.dim() >= 2 and Label.shape[-1] == 1:
        return Label.reshape(Label.shape[:-1])
    return Label


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

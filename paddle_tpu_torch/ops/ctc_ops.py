"""CTC loss (``paddle_tpu/ops/ctc_ops.py``), the reference's ``warpctc``.

The alpha recursion in log space over the expanded label sequence
(blank, l1, blank, l2, ..., blank), a Python loop over time on
``[b, 2L + 1]`` tensors (the reference's ``lax.scan``); the gradient
comes from autograd through the loop, as the reference's comes from AD
through its scan.  Inputs are padded dense ``[b, T, V]`` logits and
``[b, L]`` labels with explicit lengths.

Not ``F.ctc_loss``: that takes log-probabilities, gives ``inf`` where
this gives about ``1e30`` (a label longer than its frames), and its CUDA
gradient has its own form.
"""

import torch

from ..core.registry import register_op

_NEG_INF = -1e30


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m = torch.clamp_min(m, _NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def ctc_loss_dense(logits, logit_lengths, labels, label_lengths, blank=0):
    """Negative log-likelihood per batch row: ``logits [b, T, V]``
    (unnormalised), ``labels [b, L]`` int (no blanks)."""
    b, t, _ = logits.shape
    s = 2 * labels.shape[1] + 1
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    exp_labels = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    exp_labels[:, 1::2] = labels.long()
    # a skip from s - 2 to s where the labels differ (the CTC transition)
    prev2 = torch.cat([torch.full((b, 2), -1, dtype=torch.int64, device=dev),
                       exp_labels[:, :-2]], dim=1)
    odd = torch.arange(s, device=dev)[None, :] % 2 == 1
    can_skip = odd & (exp_labels != prev2)
    # every frame's emission of every expanded position, one gather
    emit = torch.gather(logp, 2, exp_labels[:, None, :].expand(b, t, s))
    neg = torch.full((), _NEG_INF, device=dev)
    first = torch.where(label_lengths > 0, emit[:, 0, 1], neg)
    alpha = torch.cat([emit[:, 0, :1], first[:, None],
                       torch.full((b, s - 2), _NEG_INF, device=dev)], dim=1)
    pad1 = torch.full((b, 1), _NEG_INF, device=dev)
    pad2 = torch.full((b, 2), _NEG_INF, device=dev)
    active = (torch.arange(t, device=dev)[None, :]
              < logit_lengths[:, None])[:, :, None]
    for tt in range(1, t):
        move1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        move2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                            neg)
        new_alpha = _logaddexp3(alpha, move1, move2) + emit[:, tt]
        # rows whose frames are used up keep their alpha
        alpha = torch.where(active[:, tt], new_alpha, alpha)
    # the last two valid positions: 2 * label_len and 2 * label_len - 1
    last = 2 * label_lengths.long()
    a_last = torch.gather(alpha, 1, last[:, None]).reshape(-1)
    a_prev = torch.gather(alpha, 1, torch.clamp_min(last - 1, 0)[:, None]
                          ).reshape(-1)
    a_prev = torch.where(label_lengths > 0, a_prev, neg)
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))


@register_op("warpctc")
def warpctc(Logits, Label, LogitsLength=None, LabelLength=None, blank=0,
            norm_by_times=False, **_):
    b, t, _ = Logits.shape
    dev = Logits.device
    logit_len = (LogitsLength.to(torch.int32) if LogitsLength is not None
                 else torch.full((b,), t, dtype=torch.int32, device=dev))
    lbl = Label
    if lbl.dim() == 3 and lbl.shape[-1] == 1:
        lbl = lbl.reshape(lbl.shape[:-1])
    label_len = (LabelLength.to(torch.int32) if LabelLength is not None
                 else torch.full((b,), lbl.shape[1], dtype=torch.int32,
                                 device=dev))
    loss = ctc_loss_dense(Logits, logit_len, lbl, label_len, blank)
    if norm_by_times:
        loss = loss / torch.clamp_min(logit_len.to(torch.float32), 1.0)
    return {"Loss": loss[:, None].to(Logits.dtype)}

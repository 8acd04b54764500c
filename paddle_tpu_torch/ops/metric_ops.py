"""Metric ops (``paddle_tpu/ops/metric_ops.py``): ``accuracy``, ``auc``."""

import torch

from ..core.registry import register_op


@register_op("accuracy", nondiff=True)
def accuracy(Out, Indices, Label, **_):
    """Top-k accuracy: a row is correct when any of its ``Indices``
    ``[b, k]`` (from ``top_k``) equals its label ``[b, 1]``.  ``Accuracy``
    is f32 ``[1]``; ``Correct`` and ``Total`` are int32 ``[1]``."""
    lbl = Label.reshape(-1, 1).to(Indices.dtype)
    correct = torch.any(Indices == lbl, dim=1)
    num_correct = torch.sum(correct.float())
    total = float(Indices.shape[0])
    return {"Accuracy": (num_correct / total).reshape(1),
            "Correct": num_correct.to(torch.int32).reshape(1),
            "Total": torch.full((1,), Indices.shape[0], dtype=torch.int32,
                                device=Indices.device)}


def _thresholds(n, device):
    """``jnp.linspace(0, 1, n)`` as the reference computes it on the CPU:
    ``i * f32(1 / (n - 1))``, the last one exactly 1 (a probability equal
    to a threshold counts as above it, so the bits matter)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=torch.float32)
    t[-1:].fill_(1.0)
    return t


@register_op("auc", nondiff=True)
def auc(Out, Indices=None, Label=None, curve="ROC", num_thresholds=200, **_):
    """The batch's ROC AUC over ``num_thresholds`` buckets (the
    reference's ``auc_op``): the positive-class probability (``Out[:, 1]``
    of a two-column ``Out``, else ``Out`` itself) against each threshold,
    true and false positive rates (each count over at least 1), and the
    trapezoid under the curve, ``[1]``."""
    pos_prob = (Out[:, 1] if Out.dim() == 2 and Out.shape[1] >= 2
                else Out.reshape(-1))
    lbl = Label.reshape(-1).to(torch.bool)
    pred_pos = pos_prob[None, :] >= _thresholds(int(num_thresholds),
                                                Out.device)[:, None]
    tp = torch.sum(pred_pos & lbl[None, :], dim=1).to(torch.float32)
    fp = torch.sum(pred_pos & ~lbl[None, :], dim=1).to(torch.float32)
    pos = torch.clamp(torch.sum(lbl.to(torch.float32)), min=1.0)
    neg = torch.clamp(torch.sum((~lbl).to(torch.float32)), min=1.0)
    # the thresholds rise, so fpr falls: the area is minus the trapezoid
    return {"AUC": (-torch.trapezoid(tp / pos, fp / neg)).reshape(1)}

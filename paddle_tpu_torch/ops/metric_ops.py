"""Metric ops (``paddle_tpu/ops/metric_ops.py``): ``accuracy``."""

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

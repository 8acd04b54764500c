"""Loss ops (``paddle_tpu/ops/loss_ops.py``): ``cross_entropy`` (over
probabilities, ResNet's loss), ``softmax_with_cross_entropy`` (the
unfused LM head's loss) and
``fused_softmax_ce_head`` (the fused head's, registered at the foot of
``paddle_tpu/ops/pallas_ce.py``), with its vocab-sharded tensor-parallel
branch for the mesh path; the v1 DSL's ``sigmoid_cross_entropy_with_logits``,
``smooth_l1_loss``, ``huber_loss``, ``modified_huber_loss``, ``nce`` and
``hierarchical_sigmoid``."""

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..kernels import registry as _kreg
from ..parallel.spmd import tp_rule


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


def _ce_head_flops(op, shape, grad, train):
    """2·N·d·V for the logits, and for dx and dW where X and W take a
    gradient."""
    xs, ws = shape(op.inputs["X"][0]), shape(op.inputs["W"][0])
    one = 2 * math.prod(xs[:-1]) * xs[-1] * ws[-1]
    return one * (1 + grad(op.inputs["W"][0]) + grad(op.inputs["X"][0]))


def _ce_impl(backend, x):
    """The resolved ``fused_ce`` backend for a call on ``x``'s device
    (``backend``: the op's attr, a strict request, or None)."""
    return _kreg.resolve("fused_ce", backend or None, x.device.type).impl


@register_op("fused_softmax_ce_head", flops=_ce_head_flops)
def fused_softmax_ce_head(X, W, Label, backend=None, **_):
    """Projection + softmax cross-entropy in one pass, through the kernel
    registry's ``fused_ce`` op class (``kernels/fused_ce.py``: on a card
    the CUDA kernels, on the CPU the plain versions, unless the
    ``backend`` attr or the env asks otherwise): ``X [..., d]``, ``W [d,
    V]``, ``Label [...]`` or ``[..., 1]`` -> ``Loss [..., 1]`` f32.  The
    single-device branch of the reference; its block attrs (``block_n``,
    ``block_v``, ``block_v_fwd``) are accepted and unused: the CUDA
    kernels tile by their own sizes.  The vocab-sharded branch is
    :func:`_fused_ce_tp`."""
    lbl = Label
    if lbl.dim() == X.dim() and lbl.shape[-1] == 1:
        lbl = lbl.reshape(lbl.shape[:-1])
    return {"Loss": _ce_impl(backend, X).call(X, W, lbl)[..., None]}


@tp_rule("fused_softmax_ce_head")
def _fused_ce_tp(sp, op, ins, pls, attrs, run):
    """The vocab-sharded head (the reference's ``tp`` branch of
    ``fused_softmax_ce_head_op``, ``pallas_ce.py:433-482``): ``W`` rests
    as this rank's ``V/tp`` columns, ``X`` is replicated.  Each rank runs
    the fused kernels on its columns with the labels made local (a label
    in another rank's columns becomes -1: the kernels pick nothing for
    it), and the shards' ``(loss_s, lse_s)`` merge by a logsumexp over
    tp: ``lse = log Σ exp(lse_s)``, ``loss = lse - Σ (lse_s - loss_s)``
    (the picked logit, nonzero on the label's shard only).  The max
    shift is detached (it cancels); ``X`` enters through
    :func:`reduce_grad`, so its gradient sums the shards'."""
    if pls.get("W") != 1 or pls.get("X") is not None \
            or pls.get("Label") is not None:
        return None
    x, w, lbl = ins["X"], ins["W"], ins["Label"]
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.reshape(lbl.shape[:-1])
    vs = w.shape[1]
    off = sp.comm.index("tp") * vs
    y = lbl.long()
    in_s = (y >= off) & (y < off + vs)
    y_loc = torch.where(in_s, y - off, torch.full_like(y, -1))
    x = sp.f(x, op.inputs["X"][0])
    loss_s, lse_s = _ce_impl(attrs.get("backend"), x).call_with_lse(
        x, w, y_loc)
    picked = torch.where(in_s, lse_s - loss_s, torch.zeros_like(lse_s))
    name = op.outputs["Loss"][0]
    m = sp.comm.all_reduce(lse_s.detach().clone(), "tp", name, op="max")
    lse = torch.log(sp.g(torch.exp(lse_s - m), name)) + m
    loss = lse - sp.g(picked, name)
    return {"Loss": loss[..., None]}, {"Loss": None}



@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(X, Label, **_):
    """``max(x, 0) - x * z + log1p(exp(-|x|))`` in f32, cast back to
    ``X.dtype``."""
    x, z = X.float(), Label.float()
    loss = torch.clamp_min(x, 0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return {"Out": loss.to(X.dtype)}


@register_op("smooth_l1_loss")
def smooth_l1_loss(X, Y, InsideWeight=None, OutsideWeight=None, sigma=1.0,
                   **_):
    """``d = (X - Y) * InsideWeight``; ``0.5 s2 d**2`` where
    ``|d| < 1 / s2`` (``s2 = sigma**2``), else ``|d| - 0.5 / s2``; times
    ``OutsideWeight``, summed over each row -> ``[b, 1]``; ``Diff = d``."""
    s2 = sigma * sigma
    d = X - Y
    if InsideWeight is not None:
        d = d * InsideWeight
    ad = d.abs()
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if OutsideWeight is not None:
        loss = loss * OutsideWeight
    return {"Out": loss.reshape(X.shape[0], -1).sum(dim=1, keepdim=True),
            "Diff": d}


@register_op("huber_loss")
def huber_loss(X, Y, delta=1.0, **_):
    r = Y - X
    ar = r.abs()
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": loss, "Residual": r}


@register_op("modified_huber_loss")
def modified_huber_loss(X, Y, **_):
    """Labels ``{0, 1}`` -> ``{-1, 1}``, ``z = X * y``: ``-4 z`` below -1,
    else ``max(1 - z, 0)**2`` (``modified_huber_loss_op.cc``)."""
    z = X * (Y.to(X.dtype) * 2.0 - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.square(torch.clamp_min(1.0 - z, 0.0)))
    return {"Out": loss, "IntermediateVal": z}


@register_op("nce", stateful_rng=True)
def nce(Input, Label, Weight, Bias=None, SampleWeight=None,
        num_neg_samples=10, num_total_classes=None, _gen=None, **_):
    """Noise-contrastive estimation with uniform negatives
    (``nce_op.cc``): ``num_neg_samples`` ids a row drawn uniformly from
    ``[0, num_total_classes)`` with the step's generator (the reference
    draws them with threefry, so the ids differ across packages; the
    cost is the same function of them).  Each logit is ``w[id] . x +
    b[id]``, its probability ``sigmoid(logit - log(k / total))``; the
    cost is ``-log p(label) - sum log(1 - p(neg))`` (each clamped at
    1e-20), times ``SampleWeight``.  ``SampleLabels`` int32 ``[b, 1 + k]``
    is the label then the negatives; ``SampleLogits`` their logits."""
    b = Input.shape[0]
    total = int(num_total_classes or Weight.shape[0])
    lbl = _squeeze_label(Label).long()
    neg = torch.randint(0, total, (b, int(num_neg_samples)), generator=_gen,
                        device=Input.device)
    ids = torch.cat([lbl[:, None], neg], dim=1)
    logits = torch.einsum("bkd,bd->bk", Weight[ids], Input)
    if Bias is not None:
        logits = logits + Bias[ids]
    p = torch.sigmoid(logits - math.log(num_neg_samples / total))
    loss = (-torch.log(torch.clamp_min(p[:, 0], 1e-20))
            - torch.log(torch.clamp_min(1 - p[:, 1:], 1e-20)).sum(dim=1))
    if SampleWeight is not None:
        loss = loss * SampleWeight.reshape(-1)
    return {"Cost": loss[:, None], "SampleLogits": logits,
            "SampleLabels": ids.to(torch.int32)}


@register_op("hierarchical_sigmoid")
def hierarchical_sigmoid(X, W, Label, Bias=None, num_classes=2, **_):
    """Tree softmax over a complete binary tree
    (``HierarchicalSigmoidLayer.cpp``; the reference's SimpleCode): class
    ``c`` has ``code = c + num_classes``; path node ``d`` reads row
    ``(code >> (d + 1)) - 1`` of ``W`` and targets bit ``(code >> d) & 1``,
    for ``d`` below ``floor(log2(code))``.  ``pre`` is clipped to
    [-40, 40] in value only (the backward stays ``sigmoid(pre) - bit``);
    ``Out [b, 1]`` sums ``softplus(pre) - bit * pre`` over the path,
    ``PreOut [b, max_len]`` holds ``pre`` on it and 0 off it."""
    lbl = _squeeze_label(Label).long()
    code = lbl + num_classes
    max_len = max(1, (2 * num_classes - 1).bit_length() - 1)
    d = torch.arange(max_len, device=X.device)
    shifted = torch.bitwise_right_shift(code[:, None], d[None, :] + 1)
    active = shifted > 0
    idx = torch.clamp_min(shifted - 1, 0)
    bits = (torch.bitwise_right_shift(code[:, None], d[None, :]) & 1).to(
        X.dtype)
    pre = torch.einsum("bld,bd->bl", W[idx], X)
    if Bias is not None:
        pre = pre + Bias.reshape(-1)[idx]
    pre = pre + (torch.clamp(pre, -40.0, 40.0) - pre).detach()
    terms = torch.where(active, F.softplus(pre) - bits * pre,
                        torch.zeros_like(pre))
    return {"Out": terms.sum(dim=1, keepdim=True),
            "PreOut": torch.where(active, pre, torch.zeros_like(pre))}

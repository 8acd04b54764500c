"""Loss ops (``paddle_tpu/ops/loss_ops.py``): ``cross_entropy`` (over
probabilities, ResNet's loss), ``softmax_with_cross_entropy`` (the
unfused LM head's loss) and
``fused_softmax_ce_head`` (the fused head's, registered at the foot of
``paddle_tpu/ops/pallas_ce.py``), with its vocab-sharded tensor-parallel
branch for the mesh path."""

import math

import torch

from ..core.registry import register_op
from ..kernels import fused_ce as _ce
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


@register_op("fused_softmax_ce_head", flops=_ce_head_flops)
def fused_softmax_ce_head(X, W, Label, **_):
    """Projection + softmax cross-entropy in one pass
    (``kernels/fused_ce.py``: the CUDA kernels on the card, the plain
    versions on the CPU): ``X [..., d]``, ``W [d, V]``, ``Label [...]`` or
    ``[..., 1]`` -> ``Loss [..., 1]`` f32.  The single-device branch of the
    reference; its attrs (``block_n``, ``block_v``, ``block_v_fwd``, the
    kernel-registry ``backend``) are accepted and unused: the CUDA kernels
    tile by their own sizes.  The vocab-sharded branch is
    :func:`_fused_ce_tp`."""
    lbl = Label
    if lbl.dim() == X.dim() and lbl.shape[-1] == 1:
        lbl = lbl.reshape(lbl.shape[:-1])
    return {"Loss": _ce.fused_softmax_ce_head(X, W, lbl)[..., None]}


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
    loss_s, lse_s = _ce.fused_softmax_ce_head_with_lse(x, w, y_loc)
    picked = torch.where(in_s, lse_s - loss_s, torch.zeros_like(lse_s))
    name = op.outputs["Loss"][0]
    m = sp.comm.all_reduce(lse_s.detach().clone(), "tp", name, op="max")
    lse = torch.log(sp.g(torch.exp(lse_s - m), name)) + m
    loss = lse - sp.g(picked, name)
    return {"Loss": loss[..., None]}, {"Loss": None}


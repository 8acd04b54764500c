"""Activation ops (``paddle_tpu/ops/activation_ops.py``): ``gelu`` in its
exact erf form, as the reference registers it, ``relu``, ``tanh`` and
``sigmoid`` (the attention and recurrent layers'), ``softmax`` over the
last axis, and the elementwise functions the learning-rate schedules
and the clips use: ``sqrt``, ``floor``, ``exp``, ``reciprocal``,
``pow``; ``log`` (the beam decode's log-probabilities) and ``square``
(``square_error_cost``); and the rest of the reference's activations,
``abs`` to ``thresholded_relu``, with ``prelu``'s scalar ``Alpha`` and
``log_softmax``.

Each gives the reference's value and, at a kink, JAX's gradient: a clip
(``relu6``, ``brelu``, ``hard_sigmoid``, ``soft_relu``) is a maximum
then a minimum, whose gradient at an edge is half the cotangent, where
``torch.clamp`` passes all of it; ``abs`` at 0 passes the cotangent
unchanged (JAX's ``select(x >= 0, g, -g)``), where ``torch.abs``
gives 0; ``round`` and ``ceil`` have zero gradients in both."""

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def gelu(X, **_):
    return {"Out": F.gelu(X, approximate="none")}


@register_op("relu")
def relu(X, **_):
    return {"Out": torch.relu(X)}


@register_op("tanh")
def tanh(X, **_):
    return {"Out": torch.tanh(X)}


@register_op("sigmoid")
def sigmoid(X, **_):
    return {"Out": torch.sigmoid(X)}


@register_op("softmax")
def softmax(X, **_):
    return {"Out": torch.softmax(X, dim=-1)}


@register_op("sqrt")
def sqrt(X, **_):
    return {"Out": torch.sqrt(X)}


@register_op("floor")
def floor(X, **_):
    return {"Out": torch.floor(X)}


@register_op("exp")
def exp(X, **_):
    return {"Out": torch.exp(X)}


@register_op("reciprocal")
def reciprocal(X, **_):
    return {"Out": 1.0 / X}


@register_op("log")
def log(X, **_):
    return {"Out": torch.log(X)}


@register_op("square")
def square(X, **_):
    return {"Out": torch.square(X)}


@register_op("pow")
def pow_op(X, factor=1.0, **_):
    return {"Out": torch.pow(X, factor)}


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a
    tie is half the cotangent.  The bounds are filled on ``x``'s device
    (a Python number copied there would synchronize)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


@register_op("abs")
def abs_op(X, **_):
    return {"Out": torch.where(X >= 0, X, -X)}


@register_op("ceil")
def ceil(X, **_):
    return {"Out": torch.ceil(X)}


@register_op("round")
def round_op(X, **_):
    """Half to even, as ``jnp.round``."""
    return {"Out": torch.round(X)}


@register_op("logsigmoid")
def logsigmoid(X, **_):
    return {"Out": F.logsigmoid(X)}


@register_op("tanh_shrink")
def tanh_shrink(X, **_):
    return {"Out": X - torch.tanh(X)}


@register_op("softplus")
def softplus(X, **_):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``); ``F.softplus`` turns linear past 20."""
    return {"Out": torch.logaddexp(X, X.new_zeros(()))}


@register_op("softsign")
def softsign(X, **_):
    return {"Out": X / (1 + torch.abs(X))}


@register_op("prelu")
def prelu(X, Alpha, **_):
    """``x`` where ``x >= 0``, else ``alpha * x``, for a learnable scalar
    ``Alpha``; a channel-wise one is refused, as the reference refuses
    it."""
    if Alpha.numel() != 1:
        raise ValueError(f"prelu Alpha must be a single scalar, got shape "
                         f"{tuple(Alpha.shape)}")
    return {"Out": torch.where(X >= 0, X, Alpha.reshape(()) * X)}


@register_op("brelu")
def brelu(X, t_min=0.0, t_max=24.0, **_):
    return {"Out": _clip(X, t_min, t_max)}


@register_op("leaky_relu")
def leaky_relu(X, alpha=0.02, **_):
    return {"Out": torch.where(X > 0, X, alpha * X)}


@register_op("soft_relu")
def soft_relu(X, threshold=40.0, **_):
    return {"Out": torch.log1p(torch.exp(_clip(X, -threshold, threshold)))}


@register_op("elu")
def elu(X, alpha=1.0, **_):
    """``jax.nn.elu``: the ``expm1`` branch owns 0, so the gradient there
    is ``alpha``."""
    neg = torch.where(X > 0, torch.zeros_like(X), X)
    return {"Out": torch.where(X > 0, X, alpha * torch.expm1(neg))}


@register_op("relu6")
def relu6(X, threshold=6.0, **_):
    return {"Out": _clip(X, 0.0, threshold)}


@register_op("stanh")
def stanh(X, scale_a=2.0 / 3.0, scale_b=1.7159, **_):
    return {"Out": scale_b * torch.tanh(scale_a * X)}


@register_op("hard_shrink")
def hard_shrink(X, threshold=0.5, **_):
    return {"Out": torch.where(torch.abs(X) > threshold, X,
                               torch.zeros_like(X))}


@register_op("softshrink")
def softshrink(X, lambda_=0.5, **attrs):
    """The attr is ``lambda`` in the program (a keyword here)."""
    lam = attrs.get("lambda", lambda_)
    zero = torch.zeros_like(X)
    return {"Out": torch.where(X > lam, X - lam,
                               torch.where(X < -lam, X + lam, zero))}


@register_op("thresholded_relu")
def thresholded_relu(X, threshold=1.0, **_):
    return {"Out": torch.where(X > threshold, X, torch.zeros_like(X))}


@register_op("hard_sigmoid")
def hard_sigmoid(X, slope=0.2, offset=0.5, **_):
    return {"Out": _clip(slope * X + offset, 0.0, 1.0)}


@register_op("swish")
def swish(X, beta=1.0, **_):
    return {"Out": X * torch.sigmoid(beta * X)}


@register_op("log_softmax")
def log_softmax(X, **_):
    return {"Out": F.log_softmax(X, dim=-1)}

"""Random ops (``paddle_tpu/ops/random_ops.py``): ``uniform_random``,
``gaussian_random``, ``dropout``, ``sampling_id``; and
:func:`categorical`, the one categorical draw that ``sampling_id`` and
``models.transformer.generate``'s temperature sampling share.

Randomness is explicit: a startup-program initializer seeds its own
``torch.Generator`` from its ``seed`` attr (reproducible run to run), and
``dropout`` draws from the step's generator, whose state lives in the
scope as ``@RNG@`` and advances every step.  On the card the generator
is Philox; the JAX package draws from threefry, so the two give
different numbers from the same seed by design — parity tests import the
reference's initial values and run with ``dropout_rate=0``."""

import torch

from ..core.dtypes import torch_dtype
from ..core.registry import register_op


def _seeded(seed, ctx):
    gen = torch.Generator(device=ctx.device)
    if isinstance(seed, (tuple, list)):
        base, ctr = seed
        gen.manual_seed((int(base) * 1000003 + int(ctr)) % (2 ** 63))
    elif seed:
        gen.manual_seed(int(seed))
    else:
        return ctx.gen
    return gen


@register_op("uniform_random")
def uniform_random(shape=(), dtype="float32", min=-1.0, max=1.0, seed=0,
                   _ctx=None, **_):
    u = torch.rand(tuple(shape), generator=_seeded(seed, _ctx),
                   dtype=torch.float32, device=_ctx.device)
    return {"Out": (min + (max - min) * u).to(torch_dtype(dtype))}


@register_op("gaussian_random")
def gaussian_random(shape=(), dtype="float32", mean=0.0, std=1.0, seed=0,
                    _ctx=None, **_):
    """``mean + std * N(0, 1)`` drawn in f32, cast to ``dtype`` (the
    ``MSRA(uniform=False)`` initializer of every conv filter)."""
    n = torch.randn(tuple(shape), generator=_seeded(seed, _ctx),
                    dtype=torch.float32, device=_ctx.device)
    return {"Out": (mean + std * n).to(torch_dtype(dtype))}


@register_op("dropout", stateful_rng=True)
def dropout(X, dropout_prob=0.5, is_test=False, seed=0, fix_seed=False,
            _gen=None, _live=None, **_):
    # v0.11 semantics: train -> out = x * mask (no rescale);
    # test -> out = x * (1 - p) so train/test magnitudes agree.
    want_mask = _live is None or "Mask" in _live
    if is_test or dropout_prob == 0.0:
        out = {"Out": X * (1.0 - dropout_prob) if is_test else X}
        if want_mask:
            out["Mask"] = torch.ones_like(X)
        return out
    if fix_seed:
        _gen = torch.Generator(device=X.device)
        _gen.manual_seed(int(seed))
    keep = 1.0 - dropout_prob
    mask = (torch.rand(X.shape, generator=_gen, device=X.device)
            < keep).to(X.dtype)
    return {"Out": X * mask, "Mask": mask}


def categorical(logits, generator=None):
    """One index a row of ``logits [..., k]``, drawn from
    ``softmax(logits)`` by the Gumbel-max trick: ``argmax(logits + g)``
    with ``g = -log(-log(u))``, ``u`` uniform in f32 from ``generator``
    (on the logits' device).  ``jax.random.categorical`` is the same
    construction over threefry bits, so the two packages draw from the
    same distribution but not the same ids.  Returns int64 ``[...]``."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits.float() + g, dim=-1)


@register_op("sampling_id", stateful_rng=True, nondiff=True)
def sampling_id(X, _gen=None, **_):
    """One id a row of ``X [b, k]``, a row of probabilities (need not sum
    to 1): :func:`categorical` over ``log(max(X, 1e-20))`` with the step's
    generator (``SamplingIdLayer.cpp``).  int32 ``[b]``."""
    logits = torch.log(torch.clamp_min(X.float(), 1e-20))
    return {"Out": categorical(logits, _gen).to(torch.int32)}

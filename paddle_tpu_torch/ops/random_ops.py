"""Random ops (``paddle_tpu/ops/random_ops.py``): ``uniform_random``,
``dropout``.

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

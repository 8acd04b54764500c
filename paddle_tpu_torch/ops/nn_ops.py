"""Neural-net ops (``paddle_tpu/ops/nn_ops.py``): ``layer_norm``."""

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("layer_norm")
def layer_norm(X, Scale=None, Bias=None, begin_norm_axis=1, epsilon=1e-5,
               _live=None, **_):
    """Statistics, normalisation and the affine all in f32, then one cast
    back to ``X.dtype`` — the reference's spelling.  ``Mean`` and
    ``Variance`` (``[leading dims]``, no gradient) are computed only when
    something reads them."""
    norm_shape = tuple(X.shape[begin_norm_axis:])
    xf = X.float()
    y = F.layer_norm(
        xf, norm_shape,
        None if Scale is None else Scale.float().reshape(norm_shape),
        None if Bias is None else Bias.float().reshape(norm_shape), epsilon)
    out = {"Y": y.to(X.dtype)}
    if _live is None or "Mean" in _live or "Variance" in _live:
        axes = tuple(range(begin_norm_axis, X.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=axes, unbiased=False)
        out["Mean"], out["Variance"] = mean, var
    return out

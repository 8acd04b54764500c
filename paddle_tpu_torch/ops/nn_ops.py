"""Neural-net ops (``paddle_tpu/ops/nn_ops.py``): ``layer_norm``,
``conv2d``, ``conv3d``, ``conv_shift``, ``pool2d``, ``pool3d``, ``spp``,
``batch_norm``, ``lrn``, ``im2sequence``, ``row_conv`` and
``bilinear_interp``.

Layout is NCHW (NCDHW) at the op, as in the reference.  The convolutions
and the pools lower to ATen (cuDNN on the card): the JAX package computes
them outside any Pallas kernel too."""

import math

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


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


@register_op("conv2d")
def conv2d(Input, Filter, strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
           groups=1, **_):
    """The filter is cast to the input's dtype and the output stays in it
    (the reference's note at ``nn_ops.py:20-22``: no wider output type)."""
    return {"Output": F.conv2d(Input, Filter.to(Input.dtype),
                               stride=_pair(strides),
                               padding=_pair(paddings),
                               dilation=_pair(dilations),
                               groups=int(groups))}


@register_op("conv3d")
def conv3d(Input, Filter, strides=(1, 1, 1), paddings=(0, 0, 0),
           dilations=(1, 1, 1), groups=1, **_):
    """NCDHW convolution, the filter cast to the input's dtype (reference
    ``conv_op.cc`` conv3d)."""
    return {"Output": F.conv3d(Input, Filter.to(Input.dtype),
                               stride=_pair(strides, 3),
                               padding=_pair(paddings, 3),
                               dilation=_pair(dilations, 3),
                               groups=int(groups))}


@register_op("conv_shift")
def conv_shift(X, Y, **_):
    """Circular correlation (``conv_shift_op.cc``): ``Out[i, j] = sum_k
    X[i, (j + k - M // 2) % W] * Y[i, k]`` for ``X [b, W]``,
    ``Y [b, M]``."""
    w, m = X.shape[1], Y.shape[1]
    dev = X.device
    idx = (torch.arange(w, device=dev)[:, None]
           + torch.arange(m, device=dev)[None, :] - m // 2) % w
    return {"Out": torch.einsum("bwm,bm->bw", X[:, idx], Y)}


def _ceil_pads(X, k, s, p):
    """The extra high-side padding of ``ceil_mode`` (reference
    ``_pool_nd``): enough that the last window that starts inside the
    padded extent is whole.  The low side keeps ``p``."""
    hi = []
    for i in range(len(k)):
        rem = (X.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
        hi.append((s[i] - rem) % s[i] if rem else 0)
    return hi


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_nd(X, k, s, p, pooling_type, global_pooling, ceil_mode=False,
             exclusive=True):
    """The reference's ``_pool_nd`` over the 2 or 3 spatial dims of an
    NC... tensor (``reduce_window`` semantics): padding is ``-inf`` for
    max and zero for the average, whose divisor counts only the window's
    elements inside the input when ``exclusive``
    (``count_include_pad=False``); ``ceil_mode`` pads the high side only,
    so a window that starts in that padding is computed over the padding
    (torch's own ``ceil_mode`` would drop it).  Any type but ``"max"``
    averages, as there."""
    nd = X.dim() - 2
    if global_pooling:
        k, p = tuple(X.shape[2:]), (0,) * nd
    hi = _ceil_pads(X, k, s, p) if ceil_mode else [0] * nd
    plain = not any(hi) and all(2 * pi <= ki for pi, ki in zip(p, k))
    pads = []
    for i in reversed(range(nd)):        # F.pad: the last dim first
        pads += [p[i], p[i] + hi[i]]
    if pooling_type == "max":
        if plain:
            return _MAX_POOL[nd](X, k, s, padding=p)
        return _MAX_POOL[nd](F.pad(X, pads, value=float("-inf")), k, s)
    if plain:
        return _AVG_POOL[nd](X, k, s, padding=p,
                             count_include_pad=not exclusive)
    summed = _AVG_POOL[nd](F.pad(X, pads), k, s, divisor_override=1)
    if exclusive:
        ones = F.pad(torch.ones_like(X[:1, :1]), pads)
        counts = _AVG_POOL[nd](ones, k, s, divisor_override=1)
    else:
        counts = float(math.prod(k))
    return summed / counts


@register_op("pool2d")
def pool2d(X, ksize=(2, 2), strides=(1, 1), paddings=(0, 0),
           pooling_type="max", global_pooling=False, ceil_mode=False,
           exclusive=True, **_):
    """Max or average pooling over NCHW (:func:`_pool_nd`)."""
    if pooling_type not in ("max", "avg"):
        raise ValueError(f"pool2d: pooling_type must be 'max' or 'avg', "
                         f"got {pooling_type!r}")
    return {"Out": _pool_nd(X, _pair(ksize), _pair(strides),
                            _pair(paddings), pooling_type, global_pooling,
                            ceil_mode, exclusive)}


@register_op("pool3d")
def pool3d(X, ksize=(2, 2, 2), strides=(1, 1, 1), paddings=(0, 0, 0),
           pooling_type="max", global_pooling=False, ceil_mode=False,
           exclusive=True, **_):
    """Pooling over NCDHW (reference ``pool_op.cc`` pool3d)."""
    return {"Out": _pool_nd(X, _pair(ksize, 3), _pair(strides, 3),
                            _pair(paddings, 3), pooling_type,
                            global_pooling, ceil_mode, exclusive)}


@register_op("spp")
def spp(X, pyramid_height=3, pooling_type="max", **_):
    """Spatial pyramid pooling (``spp_op.cc``): level ``l`` pools with
    ``2**l`` bins a side, window and stride ``ceil(h / bins)``, padding
    ``(k * bins - h + 1) // 2`` and the padding counted in an average's
    divisor; the levels' ``[n, c * bins**2]`` rows concatenated."""
    n, _c, h, w = X.shape
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        o = _pool_nd(X, (kh, kw), (kh, kw), (ph, pw), pooling_type, False,
                     False, False)
        outs.append(o.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}


def _bshape(X, axes):
    return [1 if i in axes else X.shape[i] for i in range(X.dim())]


def _bn_stats(X, axes, comm=None):
    """Per-channel mean and biased variance (``/ n``) with f32
    accumulation over the input dtype, in the centred two-pass form
    (reference ``_bn_stats``).  ``comm`` (the mesh path's, dp > 1): each
    sum is all-reduced over ``dp`` — the whole batch's statistics, as the
    reference's jitted step computes them."""
    n = _count(X, axes, comm)
    s = torch.sum(X, dim=axes, dtype=torch.float32)
    if comm is not None:
        comm.all_reduce(s, "dp", "batch_norm.sum")
    mean = s / n
    centered = X.float() - mean.reshape(_bshape(X, axes))
    sq = torch.sum(centered * centered, dim=axes)
    if comm is not None:
        comm.all_reduce(sq, "dp", "batch_norm.sq")
    var = sq / n
    return mean, var


def _count(X, axes, comm):
    n = 1
    for a in axes:
        n *= X.shape[a]
    return n * (comm.size("dp") if comm is not None else 1)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm with the reference's custom VJP
    (``_bn_train_fwd`` / ``_bn_train_bwd``): the forward normalises with
    ONE multiply-add in ``X.dtype`` from per-channel f32 coefficients and
    saves ``(X, Scale, mean, inv)``; the backward is the textbook form,
    f32 per-channel reductions and ``X.dtype`` elementwise work.  The batch
    statistics come out beside ``Y`` without a gradient.

    ``comm`` (dp > 1): the statistics are the whole batch's, and so are
    the backward's two row reductions where ``dX`` reads them (summed
    over ``dp``); ``dScale`` and ``dBias`` stay this rank's sums, which
    the optimizer boundary's mean over ``dp`` turns into the whole
    batch's gradient (each rank's loss is the mean over its rows)."""

    @staticmethod
    def forward(ctx, X, Scale, Bias, axes, epsilon, comm=None):
        mean, var = _bn_stats(X, axes, comm)
        inv = torch.rsqrt(var + epsilon)
        a = Scale.float() * inv
        b = Bias.float() - mean * a
        bs = _bshape(X, axes)
        y = X * a.reshape(bs).to(X.dtype) + b.reshape(bs).to(X.dtype)
        ctx.save_for_backward(X, Scale, mean, inv)
        ctx.axes, ctx.comm = axes, comm
        ctx.loop = comm.in_loop if comm is not None else False
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dY, _dmean, _dvar):
        X, Scale, mean, inv = ctx.saved_tensors
        axes, comm = ctx.axes, ctx.comm
        bs = _bshape(X, axes)
        n = _count(X, axes, comm)
        xhat = ((X - mean.reshape(bs).to(X.dtype))
                * inv.reshape(bs).to(X.dtype))
        sum_dy = torch.sum(dY, dim=axes, dtype=torch.float32)
        sum_dy_xhat = torch.sum((dY * xhat).float(), dim=axes)
        dscale, dbias = sum_dy_xhat, sum_dy
        if comm is not None:
            sum_dy, sum_dy_xhat = sum_dy.clone(), sum_dy_xhat.clone()
            with comm.where("backward", ctx.loop):
                comm.all_reduce(sum_dy, "dp", "batch_norm.sum_dy")
                comm.all_reduce(sum_dy_xhat, "dp", "batch_norm.sum_dy_xhat")
        coef = (Scale.float() * inv).reshape(bs)
        dX = coef.to(X.dtype) * (
            dY
            - (sum_dy / n).reshape(bs).to(X.dtype)
            - xhat * (sum_dy_xhat / n).reshape(bs).to(X.dtype))
        return (dX, dscale.to(Scale.dtype), dbias.to(Scale.dtype),
                None, None, None)


@register_op("batch_norm")
def batch_norm(X, Scale, Bias, Mean, Variance, momentum=0.9, epsilon=1e-5,
               is_test=False, data_layout="NCHW", _ctx=None, **_):
    """Batch norm over every axis but the channel's (axis 1 in NCHW).

    Training: batch statistics by :func:`_bn_stats`; ``MeanOut`` and
    ``VarianceOut`` blend them into the running statistics in f32 with
    ``momentum``, detached (no step's graph outlives it), as new tensors:
    the running statistics are never updated in place, so a checkpoint
    recompute of this op cannot apply the blend twice.  ``is_test``:
    normalise by the running statistics, which pass through.  On a mesh
    with dp > 1 the statistics are the whole batch's (summed over
    ``dp``), so every rank holds the same running statistics."""
    ch = 1 if data_layout == "NCHW" else X.dim() - 1
    axes = tuple(i for i in range(X.dim()) if i != ch)
    bs = _bshape(X, axes)
    if is_test:
        inv = torch.rsqrt(Variance.float() + epsilon)
        a = Scale.float() * inv
        b = Bias.float() - Mean.float() * a
        y = X * a.reshape(bs).to(X.dtype) + b.reshape(bs).to(X.dtype)
        return {"Y": y, "MeanOut": Mean, "VarianceOut": Variance,
                "SavedMean": Mean, "SavedVariance": Variance}
    sp = getattr(_ctx, "spmd", None)
    comm = sp.comm if sp is not None and sp.comm.size("dp") > 1 else None
    y, mean, var = _BatchNormTrain.apply(X, Scale, Bias, axes,
                                         float(epsilon), comm)
    with torch.no_grad():
        mean_out = (momentum * Mean.float()
                    + (1 - momentum) * mean).to(Mean.dtype)
        var_out = (momentum * Variance.float()
                   + (1 - momentum) * var).to(Variance.dtype)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": mean.detach(), "SavedVariance": var.detach()}


@register_op("lrn")
def lrn(X, n=5, k=2.0, alpha=1e-4, beta=0.75, **_):
    """Local response norm across channels (NCHW): ``mid = k + alpha *
    sum of x**2 over the n channels around c`` (zero-padded by ``n // 2``
    on each side), ``Out = X / mid**beta``, ``MidOut = mid``.  Not
    ``F.local_response_norm``, which divides ``alpha`` by ``n``.  The
    square, the window sum, the scale and the power stay in ``X``'s
    dtype, in the reference's order."""
    sq = X * X
    half = n // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    c = X.shape[1]
    windows = sum(padded[:, i:i + c] for i in range(n))
    mid = k + alpha * windows
    return {"Out": X / torch.pow(mid, beta), "MidOut": mid}


@register_op("row_conv")
def row_conv(X, Filter, Length=None, **_):
    """DeepSpeech2's lookahead convolution: ``X [b, t, d]`` padded on the
    right by ``future_context`` frames, ``Out[t] = sum_i X[t + i] *
    Filter[i]``.  Only the output is masked by ``Length``: a valid frame
    near a row's end reads the padded frames past it, as in the
    reference."""
    ctx_len = Filter.shape[0]
    t = X.shape[1]
    xp = F.pad(X, (0, 0, 0, ctx_len - 1))
    out = sum(xp[:, i:i + t, :] * Filter[i][None, None, :]
              for i in range(ctx_len))
    if Length is not None:
        steps = torch.arange(t, device=X.device)
        mask = (steps[None, :] < Length[:, None])[..., None]
        out = torch.where(mask, out, torch.zeros_like(out))
    return {"Out": out}


@register_op("im2sequence")
def im2sequence(X, kernels=(1, 1), strides=(1, 1), paddings=(0, 0, 0, 0),
                **_):
    """Sliding-window patches as a sequence (``im2sequence_op.cc``):
    ``X [N, C, H, W]`` padded by ``paddings`` (up, left, down, right; two
    values mean (up, left) on both sides) -> ``[N, oh * ow, C * kh * kw]``,
    windows in row-major order, each one's features channel-major."""
    kh, kw = _pair(kernels)
    sh, sw = _pair(strides)
    if len(paddings) == 4:
        pu, pl, pd, pr = paddings
    else:
        pu, pl, pd, pr = paddings[0], paddings[1], paddings[0], paddings[1]
    xp = F.pad(X, (pl, pr, pu, pd))
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))   # [N, C*kh*kw, L]
    return {"Out": patches.transpose(1, 2)}


def _interp_axis(in_dim, out_dim, device):
    """Source weights and the two neighbours of each output coordinate,
    align-corners (``ratio = (in - 1) / (out - 1)``); a size of 1 on
    either side reads index 0 with weight 0."""
    if out_dim == 1 or in_dim == 1:
        z = torch.zeros(out_dim, dtype=torch.long, device=device)
        return torch.zeros(out_dim, device=device), z, z
    ratio = (in_dim - 1.0) / (out_dim - 1.0)
    src = torch.arange(out_dim, dtype=torch.float32, device=device) * ratio
    lo = torch.clamp(torch.floor(src).long(), 0, in_dim - 1)
    hi = torch.clamp(lo + 1, 0, in_dim - 1)
    return src - lo.float(), lo, hi


@register_op("bilinear_interp")
def bilinear_interp(X, out_h=0, out_w=0, **_):
    """Bilinear resize ``[N, C, H, W] -> [N, C, out_h, out_w]`` with the
    reference's align-corners ratio (``BilinearInterpLayer.cpp``); not
    ``F.interpolate``, whose size-1 and odd-size conventions differ."""
    n, c, h, w = X.shape
    oh, ow = int(out_h), int(out_w)
    fy, y0, y1 = _interp_axis(h, oh, X.device)
    fx, x0, x1 = _interp_axis(w, ow, X.device)
    top, bot = X[:, :, y0], X[:, :, y1]
    tl, tr, bl, br = top[..., x0], top[..., x1], bot[..., x0], bot[..., x1]
    fy = fy.reshape(1, 1, oh, 1).to(X.dtype)
    fx = fx.reshape(1, 1, 1, ow).to(X.dtype)
    top = tl * (1 - fx) + tr * fx
    bot = bl * (1 - fx) + br * fx
    return {"Out": top * (1 - fy) + bot * fy}

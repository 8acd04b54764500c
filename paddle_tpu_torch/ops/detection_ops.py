"""Detection ops (``paddle_tpu/ops/detection_ops.py``): the SSD
detector's ``prior_box``, ``iou_similarity``, ``bipartite_match``,
``roi_pool``, ``detection_output`` and ``multibox_loss``, in the
reference's fixed-size masked forms (static shapes).

Every op stays on its inputs' device and never reads a value back to the
host: the two sequential loops (the greedy ``bipartite_match``, the
NMS of ``detection_output``) run a fixed number of trips that write
masks with ``torch.where``, and the NMS runs over every image and class
at once.  The reference's tie orders hold by construction:
``jax.lax.top_k`` and ``jnp.argsort`` are stable, so the sorts here are
``stable=True``; ``jnp.argmax`` takes the first maximum, as
``torch.argmax`` does; the CPU's XLA scatter keeps the last of
duplicate writes, which ``multibox_loss`` gets from a ``scatter_reduce``
``amax`` over the writers' indices.  A clamp at 0 is a maximum, whose
gradient at a tie is half the cotangent, as JAX's."""

import numpy as np
import torch

from ..core.registry import register_op


def expand_aspect_ratios(aspect_ratios, flip):
    """``[1.0]`` then each new ratio (within 1e-6 of none before it) and,
    with ``flip``, its reciprocal: the ratios of one ``min_size``."""
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    return ars


def _pos(x):
    """``jnp.maximum(x, 0)``: the gradient at 0 is half the cotangent."""
    return torch.maximum(x, x.new_zeros(()))


def _iou(a, b):
    """Pairwise IoU of corner boxes ``a [..., n, 4]`` and ``b [..., m,
    4]`` (xmin, ymin, xmax, ymax): ``[..., n, m]``, the union floored at
    1e-10."""
    area_a = _pos(a[..., 2] - a[..., 0]) * _pos(a[..., 3] - a[..., 1])
    area_b = _pos(b[..., 2] - b[..., 0]) * _pos(b[..., 3] - b[..., 1])
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = _pos(torch.minimum(a[..., 2], b[..., 2])
              - torch.maximum(a[..., 0], b[..., 0]))
    ih = _pos(torch.minimum(a[..., 3], b[..., 3])
              - torch.maximum(a[..., 1], b[..., 1]))
    inter = iw * ih
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.maximum(union, union.new_full((), 1e-10))


@register_op("prior_box", nondiff=True)
def prior_box(Input, Image, min_sizes=(), max_sizes=(), aspect_ratios=(1.0,),
              variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              step_w=0.0, step_h=0.0, offset=0.5, **_):
    """SSD's prior boxes over ``Input``'s feature map: ``Boxes [H, W, P,
    4]`` (corner form, normalized by ``Image``'s size) and their
    ``Variances`` broadcast to that shape.  The box sizes are host
    constants (f32-rounded, as the reference's array of them); the
    centre grids are made on the device."""
    fh, fw = Input.shape[2], Input.shape[3]
    ih, iw = Image.shape[2], Image.shape[3]
    sw = step_w or iw / fw
    sh = step_h or ih / fh
    half = [(ms * np.sqrt(ar) / 2.0, ms / np.sqrt(ar) / 2.0)
            for ms in min_sizes
            for ar in expand_aspect_ratios(aspect_ratios, flip)]
    # one more prior of sqrt(min * max) a pair, after the ratios
    half += [(np.sqrt(ms * mx) / 2.0,) * 2
             for ms, mx in zip(min_sizes, max_sizes or ())]
    dev = Input.device
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) * sw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) * sh
    cx, cy = cx[None, :].expand(fh, fw), cy[:, None].expand(fh, fw)
    boxes = []
    for bw, bh in half:
        bw, bh = float(np.float32(bw)), float(np.float32(bh))
        boxes.append(torch.stack([(cx - bw) / iw, (cy - bh) / ih,
                                  (cx + bw) / iw, (cy + bh) / ih], -1))
    out = torch.stack(boxes, 2)                        # [H, W, P, 4]
    if clip:
        out = out.clamp(0.0, 1.0)
    var = torch.stack([out.new_full(out.shape[:-1], float(v))
                       for v in variances], -1)
    return {"Boxes": out, "Variances": var}


@register_op("iou_similarity")
def iou_similarity(X, Y, **_):
    """IoU of every box of ``X`` with every box of ``Y`` (``[n, m]``),
    differentiable."""
    return {"Out": _iou(X.reshape(-1, 4), Y.reshape(-1, 4))}


@register_op("bipartite_match", nondiff=True)
def bipartite_match(DistMat, **_):
    """Greedy bipartite matching of ``DistMat [n, m]``: ``min(n, m)``
    times, the largest entry left (the first in flat order among equals)
    matches its row and column, if it is positive, and both are struck
    out.  ``ColToRowMatchIndices [1, m]`` int32 (-1 unmatched) and
    ``ColToRowMatchDist [1, m]``.  Each trip is a flat argmax and masked
    writes on the device."""
    d = DistMat
    n, m = d.shape
    rows = torch.arange(n, device=d.device)
    cols = torch.arange(m, device=d.device)
    row_of_col = torch.full((m,), -1, dtype=torch.int32, device=d.device)
    dist_of_col = d.new_zeros((m,))
    for _ in range(min(n, m)):
        flat = torch.argmax(d.reshape(-1)).reshape(1)
        r, c = flat // m, flat % m
        val = d.reshape(-1).gather(0, flat)
        ok = val > 0
        at = ok & (cols == c)
        row_of_col = torch.where(at, r.to(torch.int32), row_of_col)
        dist_of_col = torch.where(at, val, dist_of_col)
        d = torch.where(ok & ((rows == r)[:, None] | (cols == c)[None, :]),
                        -1.0, d)
    return {"ColToRowMatchIndices": row_of_col[None, :],
            "ColToRowMatchDist": dist_of_col[None, :]}


@register_op("roi_pool")
def roi_pool(X, ROIs, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             **_):
    """ROI max pooling: ``ROIs [R, 5] = (batch index, x1, y1, x2, y2)`` in
    input coordinates, rounded half to even after ``spatial_scale``;
    ``Out [R, C, pooled_height, pooled_width]``.  Each cell is the
    ``amax`` of a masked view (an empty one gives -inf), so tied maxima
    share the gradient as JAX's ``max`` shares it; ``Argmax`` is zeros,
    as the reference gives."""
    _, _, h, w = X.shape
    ph_n, pw_n = int(pooled_height), int(pooled_width)
    rois = ROIs.float()
    dev = X.device
    bi = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).long()
                      for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1, 1)[:, None]
    rw = torch.clamp_min(x2 - x1 + 1, 1)[:, None]

    def cells(lo, size, n, extent):
        """``[R, n, extent]``: which of ``extent`` positions each of the
        ``n`` cells of every ROI covers."""
        i = torch.arange(n, device=dev)[None, :]
        start = lo[:, None] + (i * size) // n
        end = lo[:, None] + ((i + 1) * size + n - 1) // n
        end = torch.maximum(end, start + 1)
        at = torch.arange(extent, device=dev)
        return (at >= start[..., None]) & (at < end[..., None])

    mh = cells(y1, rh, ph_n, h)                        # [R, PH, h]
    mw = cells(x1, rw, pw_n, w)                        # [R, PW, w]
    img = X[bi][:, :, None]                            # [R, C, 1, h, w]
    out = []
    for i in range(ph_n):
        mask = mh[:, i, None, :, None] & mw[:, :, None, :]  # [R, PW, h, w]
        out.append(torch.where(mask[:, None], img, -torch.inf).amax(
            dim=(-2, -1)))                             # [R, C, PW]
    out = torch.stack(out, 2)
    return {"Out": out, "Argmax": torch.zeros(out.shape, dtype=torch.int32,
                                              device=dev)}


def _decode(loc, prior, var):
    """Centre-size offsets ``loc [b, P, 4]`` against ``prior [P, 4]``
    scaled by ``var [P, 4]``: corner boxes ``[b, P, 4]``."""
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = (prior[:, 0] + prior[:, 2]) / 2
    pcy = (prior[:, 1] + prior[:, 3]) / 2
    dcx = var[:, 0] * loc[..., 0] * pw + pcx
    dcy = var[:, 1] * loc[..., 1] * ph + pcy
    dw = torch.exp(var[:, 2] * loc[..., 2]) * pw
    dh = torch.exp(var[:, 3] * loc[..., 3]) * ph
    return torch.stack([dcx - dw / 2, dcy - dh / 2, dcx + dw / 2,
                        dcy + dh / 2], -1)


def _default_variances(prior):
    """The fallback (0.1, 0.1, 0.2, 0.2) a prior, shared by the training
    loss and the decode."""
    var = prior.new_full(prior.shape, 0.1)
    var[:, 2:] = 0.2
    return var


def _without(x, drop):
    """``x`` without entry ``drop`` of its last axis (if it has one)."""
    if not 0 <= drop < x.shape[-1]:
        return x
    return torch.cat([x[..., :drop], x[..., drop + 1:]], -1)


def nms_keep(over, valid):
    """Greedy NMS over candidates sorted by score, for every leading
    index at once: ``over [..., k, k]`` (IoU above the threshold),
    ``valid [..., k]`` (score above its threshold) -> ``keep [..., k]``.
    Candidate ``i`` is kept if valid and no kept candidate before it
    overlaps it: ``k`` trips of two reductions and a write, on the
    device."""
    keep = torch.zeros_like(valid)
    for i in range(valid.shape[-1]):
        sup = torch.any(over[..., i, :] & keep, dim=-1)
        torch.gt(valid[..., i], sup, out=keep[..., i])   # valid and not sup
    return keep


@register_op("detection_output", nondiff=True)
def detection_output(Loc, Conf, PriorBox, background_label=0,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, _live=None, **_):
    """SSD's decode, per-class top-k and NMS: ``Out [b, keep_top_k, 6] =
    (label, score, x1, y1, x2, y2)``, empty slots -1.  ``Loc [b, P * 4]``
    or ``[b, P, 4]``, ``Conf [b, P, C]`` (probabilities), ``PriorBox [P,
    4]`` or ``[2, P, 4]`` (boxes and variances).

    Every class but the background keeps its ``min(nms_top_k, P)`` best
    priors (a stable descending sort: ties lower index first, as
    ``lax.top_k``), and the NMS runs over all images and classes at once.
    The survivors, classes in ascending order, then go through a stable
    descending sort by score, as the reference's ``jnp.argsort``.  A
    training step that does not read ``Out`` skips the op, as XLA drops
    it from the reference's."""
    if _live is not None and "Out" not in _live:
        return {}
    prior, var = PriorBox[..., :4], None
    if PriorBox.dim() == 3:
        prior, var = PriorBox[0], PriorBox[1]
    b, p, c = Conf.shape[0], prior.shape[0], Conf.shape[-1]
    if var is None:
        var = _default_variances(prior)
    boxes = _decode(Loc.reshape(b, p, 4), prior, var)   # [b, P, 4]
    scores = _without(Conf, background_label).transpose(1, 2)  # [b, C', P]
    labels = _without(torch.arange(c, dtype=torch.float32,
                                   device=Conf.device), background_label)
    nc, k = scores.shape[1], min(nms_top_k, p)
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[..., :k], top_i[..., :k]
    cand = torch.gather(boxes[:, None].expand(b, nc, p, 4), 2,
                        top_i[..., None].expand(b, nc, k, 4))  # [b, C', k, 4]
    keep = nms_keep(_iou(cand, cand) > nms_threshold,
                    top_s > score_threshold)
    entry = torch.cat([labels[None, :, None, None].expand(b, nc, k, 1),
                       top_s[..., None], cand], -1)
    entry = torch.where(keep[..., None], entry, -1.0).reshape(b, nc * k, 6)
    order = torch.argsort(-entry[..., 1], dim=-1, stable=True)
    entry = torch.gather(entry, 1, order[..., None].expand(b, nc * k, 6))
    entry = entry[:, :keep_top_k]
    if entry.shape[1] < keep_top_k:
        entry = torch.cat([entry, entry.new_full(
            (b, keep_top_k - entry.shape[1], 6), -1.0)], 1)
    return {"Out": entry}


@register_op("multibox_loss")
def multibox_loss(Loc, Conf, PriorBox, GtBox, GtLabel, overlap_threshold=0.5,
                  neg_pos_ratio=3.0, background_label=0, **_):
    """SSD's training loss: ``Loss [b, 1]``, each image's smooth-L1 over
    its matched priors' offsets plus softmax CE over the matched priors
    and the hardest negatives (up to ``neg_pos_ratio`` per positive),
    over its positives.  ``Loc [b, P, 4]``, ``Conf [b, P, C]``,
    ``PriorBox [P, 4]`` or ``[2, P, 4]``, ``GtBox [b, G, 4]`` corners,
    ``GtLabel [b, G]`` (< 0 is padding).  The gradient reaches ``Loc``
    and ``Conf`` only: the encoded targets are constants.

    A prior matches the gt of its best IoU at or past
    ``overlap_threshold``; besides, every valid gt claims its best prior.
    When two valid gts claim one prior the larger gt index wins, as the
    CPU's XLA scatter writes them; padded gts claim nothing.  Negatives
    are ranked by CE through two stable sorts (matched priors at -inf,
    ties lower index first), so the kept set is the reference's."""
    prior, var = PriorBox, None
    if PriorBox.dim() == 3:
        prior, var = PriorBox[0], PriorBox[1]
    prior = prior.detach()
    var = _default_variances(prior) if var is None else var.detach()
    gt = GtBox.detach()
    b, p, _ = Loc.shape
    g = gt.shape[1]
    dev = Loc.device

    valid_gt = GtLabel >= 0                                   # [b, G]
    ax1, ay1, ax2, ay2 = (prior[:, i] for i in range(4))
    area_p = (ax2 - ax1) * (ay2 - ay1)                        # [P]
    bx1, by1, bx2, by2 = (gt[..., i] for i in range(4))       # [b, G]
    ix1 = torch.maximum(ax1[None, :, None], bx1[:, None, :])
    iy1 = torch.maximum(ay1[None, :, None], by1[:, None, :])
    ix2 = torch.minimum(ax2[None, :, None], bx2[:, None, :])
    iy2 = torch.minimum(ay2[None, :, None], by2[:, None, :])
    inter = _pos(ix2 - ix1) * _pos(iy2 - iy1)                 # [b, P, G]
    area_g = ((bx2 - bx1) * (by2 - by1))[:, None, :]
    union = area_p[None, :, None] + area_g - inter
    iou = inter / torch.maximum(union, union.new_full((), 1e-10))
    iou = torch.where(valid_gt[:, None, :], iou, -1.0)

    best_iou, best_gt = torch.max(iou, dim=2)                 # [b, P]
    matched = best_iou >= overlap_threshold
    # every valid gt claims its best prior; among claimants of one prior
    # the largest gt index wins (-1: no claim)
    best_prior = torch.argmax(iou, dim=1)                     # [b, G]
    gidx = torch.arange(g, device=dev).expand(b, g)
    claim = torch.full((b, p), -1, dtype=torch.long, device=dev)
    claim = claim.scatter_reduce(1, best_prior,
                                 torch.where(valid_gt, gidx, -1),
                                 reduce="amax")
    force = claim >= 0
    best_gt = torch.where(force, claim, best_gt)
    matched = matched | force
    n_pos = matched.sum(1)                                    # [b]

    # the matched gt encoded against its prior (SSD's encode), a constant
    mb = torch.gather(gt, 1, best_gt[..., None].expand(b, p, 4))
    pw, ph = ax2 - ax1, ay2 - ay1
    pcx, pcy = (ax1 + ax2) / 2, (ay1 + ay2) / 2
    gcx = (mb[..., 0] + mb[..., 2]) / 2
    gcy = (mb[..., 1] + mb[..., 3]) / 2
    gw = torch.clamp_min(mb[..., 2] - mb[..., 0], 1e-10)
    gh = torch.clamp_min(mb[..., 3] - mb[..., 1], 1e-10)
    t = torch.stack([(gcx - pcx) / pw / var[:, 0],
                     (gcy - pcy) / ph / var[:, 1],
                     torch.log(gw / pw) / var[:, 2],
                     torch.log(gh / ph) / var[:, 3]], -1)   # [b, P, 4]
    ad = torch.abs(Loc - t)
    smooth_l1 = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
    loc_loss = torch.where(matched, smooth_l1, 0.0).sum(1)

    # softmax CE against the matched label (background if unmatched)
    tgt = torch.where(matched, torch.gather(GtLabel.long(), 1, best_gt),
                      background_label)
    logp = torch.log_softmax(Conf, dim=-1)
    ce = -torch.gather(logp, 2, tgt[..., None])[..., 0]      # [b, P]

    # hard negatives: the unmatched priors of largest CE, up to
    # neg_pos_ratio x the positives; rank = the inverse of a stable sort
    neg_ce = torch.where(matched, -torch.inf, ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(p, device=dev).expand(b, p))
    n_neg = torch.minimum((neg_pos_ratio * n_pos).to(torch.int32), p - n_pos)
    keep_neg = ~matched & (rank < n_neg[:, None])
    conf_loss = torch.where(matched | keep_neg, ce, 0.0).sum(1)

    denom = torch.clamp_min(n_pos.to(Loc.dtype), 1.0)
    return {"Loss": ((loc_loss + conf_loss) / denom)[:, None]}

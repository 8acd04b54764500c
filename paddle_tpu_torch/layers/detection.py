"""Detection layers (``paddle_tpu/layers/detection.py``): ``prior_box``,
``iou_similarity``, ``bipartite_match``, ``roi_pool``,
``detection_output`` and ``multibox_loss``, with the reference's
build-time shapes and attrs (``models.ssd`` reads ``prior_box``'s
``[H, W, P, 4]`` while it builds)."""

from ..ops.detection_ops import expand_aspect_ratios
from .layer_helper import LayerHelper

__all__ = ["prior_box", "iou_similarity", "bipartite_match", "roi_pool",
           "detection_output", "multibox_loss"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """SSD's prior boxes and their variances, each ``[H, W, P, 4]``: ``P``
    counts the ratios of each min size (a new ratio, then its flip) and
    one box a max size."""
    helper = LayerHelper("prior_box", name=name)
    p = (len(min_sizes) * len(expand_aspect_ratios(aspect_ratios, flip))
         + len(max_sizes or []))
    h, w = input.shape[2], input.shape[3]
    boxes = helper.create_tmp_variable("float32", [h, w, p, 4],
                                       stop_gradient=True)
    var = helper.create_tmp_variable("float32", [h, w, p, 4],
                                     stop_gradient=True)
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [boxes.name], "Variances": [var.name]},
        attrs={
            "min_sizes": list(min_sizes),
            "max_sizes": list(max_sizes or []),
            "aspect_ratios": list(aspect_ratios),
            "variances": list(variances),
            "flip": flip,
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
        },
    )
    return boxes, var


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_tmp_variable("float32", [x.shape[0], y.shape[0]],
                                     stop_gradient=True)
    helper.append_op(
        type="iou_similarity", inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
    )
    return out


def bipartite_match(dist_matrix, name=None):
    """Greedy matching of a distance matrix: the matched row of each
    column and its distance, each ``[1, m]``."""
    helper = LayerHelper("bipartite_match", name=name)
    m = dist_matrix.shape[1]
    idx = helper.create_tmp_variable("int32", [1, m], stop_gradient=True)
    dist = helper.create_tmp_variable("float32", [1, m], stop_gradient=True)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix.name]},
        outputs={"ColToRowMatchIndices": [idx.name],
                 "ColToRowMatchDist": [dist.name]},
    )
    return idx, dist


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             name=None):
    helper = LayerHelper("roi_pool", name=name)
    shape = [rois.shape[0], input.shape[1], pooled_height, pooled_width]
    out = helper.create_tmp_variable(input.dtype, shape)
    argmax = helper.create_tmp_variable("int64", shape, stop_gradient=True)
    helper.append_op(
        type="roi_pool",
        inputs={"X": [input.name], "ROIs": [rois.name]},
        outputs={"Out": [out.name], "Argmax": [argmax.name]},
        attrs={
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "spatial_scale": spatial_scale,
        },
    )
    return out


def detection_output(loc, scores, prior_box, background_label=0,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, name=None):
    """Decoded, per-class NMS'd detections ``[b, keep_top_k, 6]`` =
    (label, score, x1, y1, x2, y2), empty slots -1."""
    helper = LayerHelper("detection_output", name=name)
    out = helper.create_tmp_variable(
        "float32", [scores.shape[0], keep_top_k, 6], stop_gradient=True)
    helper.append_op(
        type="detection_output",
        inputs={"Loc": [loc.name], "Conf": [scores.name],
                "PriorBox": [prior_box.name]},
        outputs={"Out": [out.name]},
        attrs={
            "background_label": background_label,
            "nms_threshold": nms_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "score_threshold": score_threshold,
        },
    )
    return out


def multibox_loss(loc, conf, prior_box, gt_box, gt_label,
                  overlap_threshold=0.5, neg_pos_ratio=3.0,
                  background_label=0, name=None):
    """SSD's training loss, ``[b, 1]`` a batch: ``loc [b, P, 4]``, ``conf
    [b, P, C]``, ``prior_box [P, 4]`` or ``[2, P, 4]``, ``gt_box [b, G,
    4]``, ``gt_label [b, G]`` (< 0 is padding)."""
    helper = LayerHelper("multibox_loss", name=name)
    out = helper.create_tmp_variable(loc.dtype, [loc.shape[0], 1])
    helper.append_op(
        type="multibox_loss",
        inputs={"Loc": [loc.name], "Conf": [conf.name],
                "PriorBox": [prior_box.name], "GtBox": [gt_box.name],
                "GtLabel": [gt_label.name]},
        outputs={"Loss": [out.name]},
        attrs={"overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio,
               "background_label": background_label},
    )
    return out

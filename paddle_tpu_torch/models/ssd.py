"""The SSD single-shot detector (``paddle_tpu/models/ssd.py``; the
reference's v1 SSD config family: PriorBox, MultiBoxLossLayer and
DetectionOutputLayer).

Ground truth comes padded-dense: ``gt_box [b, max_gt, 4]`` (corner
form, normalized to 0-1) and ``gt_label [b, max_gt]``, an entry < 0
being padding, so a training step has static shapes.  A compact
two-scale detector over a small VGG-like backbone: loc and conf heads
on the feature maps at /4 and /8 and their concatenated priors, as in
SSD."""

import numpy as np

from .. import layers, optimizer as opt
from ..layers import tensor as _tensor


def _head(feat, num_priors, num_classes, prefix):
    """One feature map's loc and conf heads: 3x3 convs reshaped to ``[b,
    H*W*P, 4]`` and ``[b, H*W*P, C]``."""
    b = feat.shape[0]
    h, w = feat.shape[2], feat.shape[3]
    loc = layers.conv2d(feat, num_filters=num_priors * 4, filter_size=3,
                        padding=1, bias_attr=True, name=f"{prefix}_loc")
    conf = layers.conv2d(feat, num_filters=num_priors * num_classes,
                         filter_size=3, padding=1, bias_attr=True,
                         name=f"{prefix}_conf")
    # NCHW -> [b, H, W, P*x] -> [b, H*W*P, x]
    loc = _tensor.transpose(loc, [0, 2, 3, 1])
    loc = _tensor.reshape(loc, [b, h * w * num_priors, 4])
    conf = _tensor.transpose(conf, [0, 2, 3, 1])
    conf = _tensor.reshape(conf, [b, h * w * num_priors, num_classes])
    return loc, conf


def build(num_classes=4, image_shape=(3, 64, 64), max_gt=8,
          learning_rate=0.001, is_test=False):
    """The SSD program: the feeds, ``loc``, ``conf``, ``priors`` and the
    inference ``detections``; for training also the loss ``avg_cost``
    under Momentum 0.9."""
    c, ih, iw = image_shape
    img = layers.data("img", shape=list(image_shape), dtype="float32")

    # backbone: conv stages down to feature maps at /4 and /8
    f = layers.conv2d(img, 32, 3, padding=1, act="relu")
    f = layers.pool2d(f, pool_size=2, pool_stride=2)
    f = layers.conv2d(f, 64, 3, padding=1, act="relu")
    f = layers.pool2d(f, pool_size=2, pool_stride=2)
    feat1 = layers.conv2d(f, 64, 3, padding=1, act="relu")     # /4
    f = layers.pool2d(feat1, pool_size=2, pool_stride=2)
    feat2 = layers.conv2d(f, 128, 3, padding=1, act="relu")    # /8

    cfgs = [  # (feature map, min_size, max_size) in pixels
        (feat1, 0.15 * min(ih, iw), 0.35 * min(ih, iw)),
        (feat2, 0.35 * min(ih, iw), 0.65 * min(ih, iw)),
    ]
    locs, confs, priors, prior_vars = [], [], [], []
    for i, (feat, mn, mx) in enumerate(cfgs):
        boxes, var = layers.prior_box(
            feat, img, min_sizes=[mn], max_sizes=[mx],
            aspect_ratios=[2.0], flip=True, clip=True)
        p = boxes.shape[2]
        loc, conf = _head(feat, p, num_classes, f"head{i}")
        locs.append(loc)
        confs.append(conf)
        n_boxes = boxes.shape[0] * boxes.shape[1] * p
        priors.append(_tensor.reshape(boxes, [n_boxes, 4]))
        prior_vars.append(_tensor.reshape(var, [n_boxes, 4]))
    loc_all = _tensor.concat(locs, axis=1)        # [b, P, 4]
    conf_all = _tensor.concat(confs, axis=1)      # [b, P, C]
    # [2, P, 4]: the boxes and their variances stacked, so the loss and
    # the decode scale the offsets alike
    boxes_cat = _tensor.concat(priors, axis=0)
    vars_cat = _tensor.concat(prior_vars, axis=0)
    prior_all = _tensor.concat([
        _tensor.reshape(boxes_cat, [1, boxes_cat.shape[0], 4]),
        _tensor.reshape(vars_cat, [1, vars_cat.shape[0], 4]),
    ], axis=0)

    outs = {"feed": [img], "loc": loc_all, "conf": conf_all,
            "priors": prior_all}
    # the inference head lives in the training program too; a step that
    # does not fetch it skips it
    outs["detections"] = layers.detection_output(
        loc_all, layers.softmax(conf_all), prior_all,
        keep_top_k=20, score_threshold=0.3)
    if is_test:
        return outs

    gt_box = layers.data("gt_box", shape=[max_gt, 4], dtype="float32")
    gt_label = layers.data("gt_label", shape=[max_gt], dtype="int64")
    loss = layers.multibox_loss(loc_all, conf_all, prior_all,
                                gt_box, gt_label)
    avg_loss = layers.mean(loss)
    opt.Momentum(learning_rate=learning_rate,
                 momentum=0.9).minimize(avg_loss)
    outs["feed"] += [gt_box, gt_label]
    outs["avg_cost"] = avg_loss
    return outs


def synthetic_batch(batch, image_shape=(3, 64, 64), max_gt=8, num_classes=4,
                    seed=0):
    """A small synthetic detection task from ``seed``: one or two bright
    squares on a dark background a picture, each of a class from 1 to
    ``num_classes - 1``.  ``(imgs, gt_box, gt_label)``, the reference's
    draws."""
    rng = np.random.RandomState(seed)
    c, ih, iw = image_shape
    imgs = rng.rand(batch, c, ih, iw).astype(np.float32) * 0.1
    gt_box = np.zeros((batch, max_gt, 4), np.float32)
    gt_label = np.full((batch, max_gt), -1, np.int64)
    for i in range(batch):
        n = rng.randint(1, 3)
        for j in range(n):
            s = rng.uniform(0.15, 0.3)
            x1 = rng.uniform(0.05, 0.9 - s)
            y1 = rng.uniform(0.05, 0.9 - s)
            cls = 1 + rng.randint(num_classes - 1)
            gt_box[i, j] = (x1, y1, x1 + s, y1 + s)
            gt_label[i, j] = cls
            px1, py1 = int(x1 * iw), int(y1 * ih)
            px2, py2 = int((x1 + s) * iw), int((y1 + s) * ih)
            imgs[i, :, py1:py2, px1:px2] = 0.9 + 0.1 * rng.rand(
                c, py2 - py1, px2 - px1)
    return imgs, gt_box, gt_label

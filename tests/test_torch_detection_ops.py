"""The six detection ops of the port against the JAX package's on the CPU:
``prior_box``, ``iou_similarity``, ``bipartite_match``, ``roi_pool``,
``detection_output`` and ``multibox_loss``.

Inputs come from a numpy seed, several of them built to hold ties:

* ``prior_box`` with flip (a repeated ratio dropped), clip, ``max_sizes``
  and explicit steps, and without clip;
* ``iou_similarity`` with disjoint and touching boxes (a clamp at 0:
  half the cotangent each way, as JAX's maximum);
* ``bipartite_match`` on a matrix of repeated values (the first flat
  index wins a tie), taller and wider than square;
* ``roi_pool`` on quantized inputs (tied maxima share the gradient) with
  an ROI past the image;
* ``detection_output`` with tied scores (``top_k`` and the final sort
  keep lower indices first), fewer survivors than ``keep_top_k``, a
  background label in the middle, bare priors (the default variances)
  and a flat ``Loc``;
* ``multibox_loss`` with two valid gts sharing a best prior (the larger
  gt index wins, as the CPU's XLA scatter writes it), padded gts,
  tied hard-negative CE values (identical confidence rows) and a prior
  set without variances.

Float outputs within ORACLE_TOL f32's forward bound (2e-4 of the
largest), ints, bools and labels equal; the gradient of every float
input under one seeded cotangent within the gradient bound (1e-3 of the
largest); ``multibox_loss`` gives ``GtBox`` and ``PriorBox`` none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    return float(err / scale) if scale else float(err)


def _boxes(rng, n, lo=0.0, hi=1.0, min_side=0.05):
    """``[n, 4]`` corner boxes inside ``[lo, hi]``."""
    xy = rng.uniform(lo, hi - 0.3, (n, 2))
    wh = rng.uniform(min_side, 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _both(op, floats, fixed, attrs, outs, seed=3):
    """``op`` in both packages: each output of ``outs`` and the float
    inputs' gradients of ``sum(cot * out)`` over the float outputs,
    ``(got, want)`` as ``(outputs, gradients)``."""
    names = sorted(floats)
    fixed_j = {k: jnp.asarray(v) for k, v in fixed.items()}

    def jfn(*vals):
        r = jax_op(op).fn(**dict(zip(names, vals)), **fixed_j, **attrs)
        return [r[o] for o in outs]

    want = jax.jit(jfn)(*[jnp.asarray(floats[n]) for n in names])
    cots = [np.random.default_rng(seed + i).standard_normal(np.shape(w))
            .astype(np.float32) for i, w in enumerate(want)]
    diff = [jnp.issubdtype(w.dtype, jnp.floating) for w in want]
    want_grads = []
    if names and any(diff):
        def jloss(*vals):
            return sum(jnp.sum(o * c) for o, c, d in
                       zip(jfn(*vals), cots, diff) if d)
        want_grads = jax.jit(jax.grad(jloss, argnums=tuple(range(
            len(names)))))(*[jnp.asarray(floats[n]) for n in names])
    ts = {n: torch.tensor(floats[n]).requires_grad_() for n in names}
    r = torch_op(op).fn(**ts, **{k: torch.tensor(v)
                                 for k, v in fixed.items()}, **attrs)
    got = [r[o] for o in outs]
    grads = []
    if names and any(diff):
        total = sum((g * torch.tensor(c)).sum() for g, c, d in
                    zip(got, cots, diff) if d and g.requires_grad)
        grads = ([torch.zeros_like(ts[n]) for n in names]
                 if not torch.is_tensor(total) else
                 [torch.zeros_like(ts[n]) if g is None else g
                  for n, g in zip(names, torch.autograd.grad(
                      total, [ts[n] for n in names], allow_unused=True))])
    return ((([x.detach().numpy() for x in got]), [g.numpy() for g in grads]),
            ([np.asarray(w) for w in want], [np.asarray(g)
                                             for g in want_grads]))


def _hold(got, want, exact=()):
    """Outputs within the forward bound (their infinities equal), or
    equal (ints, bools, ``exact``); gradients within the gradient
    bound."""
    (g_out, g_grad), (w_out, w_grad) = got, want
    for i, (g, w) in enumerate(zip(g_out, w_out)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert str(g.dtype) == str(w.dtype), (i, g.dtype, w.dtype)
        if g.dtype.kind != "f" or i in exact:
            np.testing.assert_array_equal(g, w)
            continue
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        assert _rel(g[fin], w[fin]) <= FWD_TOL, (i, _rel(g[fin], w[fin]))
    for i, (g, w) in enumerate(zip(g_grad, w_grad)):
        assert g.shape == w.shape
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))


# -- prior_box ---------------------------------------------------------------

@pytest.mark.parametrize("clip", [True, False])
def test_prior_box(clip):
    attrs = dict(min_sizes=[8.0, 20.0], max_sizes=[16.0, 30.0],
                 aspect_ratios=[2.0, 3.0, 2.0000001], flip=True, clip=clip,
                 step_w=6.0 if clip else 0.0, step_h=5.0 if clip else 0.0,
                 offset=0.5, variances=[0.1, 0.1, 0.2, 0.2])
    fixed = {"Input": np.zeros((2, 4, 5, 7), np.float32),
             "Image": np.zeros((2, 3, 40, 50), np.float32)}
    got, want = _both("prior_box", {}, fixed, attrs, ["Boxes", "Variances"])
    # 2 min sizes x ratios (1, 2, 1/2, 3, 1/3) + one a max size
    assert got[0][0].shape == (5, 7, 12, 4)
    _hold(got, want)
    assert (got[0][0].min() >= 0) == clip


# -- iou_similarity -----------------------------------------------------------

def test_iou_similarity_with_disjoint_and_touching_boxes():
    rng = np.random.default_rng(1)
    x = _boxes(rng, 6)
    y = _boxes(rng, 5)
    y[0] = (x[0, 2], x[0, 1], x[0, 2] + 0.1, x[0, 3])   # touches x[0]
    y[1] = (2.0, 2.0, 2.5, 2.5)                          # overlaps nothing
    y[2] = x[3]                                          # the same box
    got, want = _both("iou_similarity", {"X": x, "Y": y}, {}, {}, ["Out"])
    _hold(got, want)


# -- bipartite_match ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 7), (7, 4), (5, 5)])
def test_bipartite_match_with_ties(shape):
    rng = np.random.default_rng(sum(shape))
    d = np.round(rng.uniform(-0.3, 1.0, shape), 1).astype(np.float32)
    d[0, :2] = d.max()                   # a tie at the top: first flat wins
    got, want = _both("bipartite_match", {}, {"DistMat": d}, {},
                      ["ColToRowMatchIndices", "ColToRowMatchDist"])
    _hold(got, want, exact=(1,))


# -- roi_pool ----------------------------------------------------------------

def test_roi_pool_ties_share_the_gradient():
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(0, 3, (2, 3, 9, 11))).astype(np.float32)
    rois = np.array([[0, 0, 0, 10, 8], [1, 2.4, 1.5, 7.6, 6.5],
                     [1, 4, 3, 4, 3], [0, 9, 7, 14, 12]], np.float32)
    got, want = _both("roi_pool", {"X": x}, {"ROIs": rois},
                      {"pooled_height": 2, "pooled_width": 3,
                       "spatial_scale": 1.0}, ["Out", "Argmax"])
    _hold(got, want)


def test_roi_pool_spatial_scale():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 2, 8, 8)).astype(np.float32)
    rois = np.array([[0, 3, 5, 20, 27], [0, 0, 0, 31, 31]], np.float32)
    got, want = _both("roi_pool", {"X": x}, {"ROIs": rois},
                      {"pooled_height": 3, "pooled_width": 2,
                       "spatial_scale": 0.25}, ["Out"])
    _hold(got, want)


# -- detection_output ---------------------------------------------------------

def _detection_inputs(rng, b, p, c, tie=False, with_var=True, flat=False):
    prior = _boxes(rng, p, min_side=0.1)
    loc = (0.5 * rng.standard_normal((b, p, 4))).astype(np.float32)
    logits = rng.standard_normal((b, p, c)).astype(np.float32) * 2
    if tie:
        # equal scores in runs of priors, and near-copies of one box
        logits[:, 4:12] = logits[:, 4:5]
        loc[:, 4:12] = loc[:, 4:5]
        prior[4:12] = prior[4] + np.linspace(0, 0.05, 8)[:, None]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    conf = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    pb = (np.stack([prior, np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                   (p, 1))]) if with_var else prior)
    return ({"Loc": loc.reshape(b, p * 4) if flat else loc, "Conf": conf,
             "PriorBox": pb.astype(np.float32)})


DETECTION_CASES = {
    # name -> (b, P, C, input options, attrs)
    "plain": (2, 30, 4, {}, {}),
    "tied_scores": (2, 30, 3, {"tie": True},
                    dict(nms_top_k=16, keep_top_k=12, nms_threshold=0.3)),
    "few_survivors": (2, 12, 3, {}, dict(keep_top_k=40,
                                         score_threshold=0.4)),
    "background_in_the_middle": (1, 25, 5, {}, dict(background_label=2,
                                                    nms_top_k=10)),
    "bare_priors_flat_loc": (2, 20, 3, {"with_var": False, "flat": True},
                             dict(keep_top_k=15)),
}


@pytest.mark.parametrize("name", list(DETECTION_CASES))
def test_detection_output(name):
    b, p, c, opts, attrs = DETECTION_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    fixed = _detection_inputs(rng, b, p, c, **opts)
    got, want = _both("detection_output", {}, fixed, attrs, ["Out"])
    _hold(got, want)
    out, ref = got[0][0], want[0][0]
    np.testing.assert_array_equal(out[..., 0], ref[..., 0])  # labels, slots
    if name == "few_survivors":
        assert (ref[..., 0] < 0).any()            # padded with -1 rows
        assert (out[ref[..., 0] < 0] == -1).all()


def test_detection_output_skips_when_nobody_reads_it():
    rng = np.random.default_rng(0)
    fixed = {k: torch.tensor(v) for k, v in
             _detection_inputs(rng, 1, 8, 3).items()}
    fn = torch_op("detection_output").fn
    assert fn(**fixed, _live=set()) == {}
    assert fn(**fixed, _live={"Out"})["Out"].shape == (1, 200, 6)


def test_nms_keeps_the_first_of_tied_overlapping_boxes():
    from paddle_tpu_torch.ops.detection_ops import nms_keep

    over = torch.tensor([[0, 1, 0, 1], [1, 0, 1, 0], [0, 1, 0, 0],
                         [1, 0, 0, 0]], dtype=torch.bool)
    valid = torch.tensor([True, True, True, False])
    # 0 kept, 1 overlaps 0, 2 overlaps only the dropped 1, 3 not valid
    assert nms_keep(over, valid).tolist() == [True, False, True, False]


# -- multibox_loss ------------------------------------------------------------

def _multibox_inputs(rng, b, p, g, c, share=False, tie=False,
                     with_var=True):
    prior = _boxes(rng, p, min_side=0.1)
    gt = np.stack([_boxes(rng, g, min_side=0.1) for _ in range(b)])
    label = rng.integers(1, c, (b, g)).astype(np.int32)
    label[:, g - 2:] = -1                            # padded gts
    gt[:, g - 2:] = 0.0
    if share:
        # gts 0 and 1 of image 0: the same box, so the same best prior,
        # with an IoU below the threshold (the forced match decides)
        gt[0, 1] = gt[0, 0] = prior[3] + np.float32([0.0, 0.0, 0.4, 0.4])
        label[0, :2] = (1, c - 1)
    conf = rng.standard_normal((b, p, c)).astype(np.float32)
    if tie:
        conf[:] = conf[:, :1]                        # every CE ties
    pb = (np.stack([prior, np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                   (p, 1))]) if with_var else prior)
    return ({"Loc": (0.5 * rng.standard_normal((b, p, 4))).astype(
        np.float32), "Conf": conf, "PriorBox": pb.astype(np.float32),
        "GtBox": gt}, {"GtLabel": label})


MULTIBOX_CASES = {
    "plain": (2, 40, 5, 4, {}, {}),
    "shared_best_prior": (2, 40, 5, 4, {"share": True}, {}),
    "tied_negatives": (2, 40, 5, 3, {"tie": True}, dict(neg_pos_ratio=2.0)),
    "bare_priors": (3, 30, 4, 3, {"with_var": False},
                    dict(overlap_threshold=0.3)),
}


@pytest.mark.parametrize("name", list(MULTIBOX_CASES))
def test_multibox_loss(name):
    b, p, g, c, opts, attrs = MULTIBOX_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    floats, fixed = _multibox_inputs(rng, b, p, g, c, **opts)
    got, want = _both("multibox_loss", floats, fixed, attrs, ["Loss"])
    _hold(got, want)
    grads = dict(zip(sorted(floats), got[1]))
    assert not grads["GtBox"].any() and not grads["PriorBox"].any()


def test_multibox_loss_shared_prior_goes_to_the_larger_gt_index():
    """Two valid gts claim one prior: the larger gt index wins, so the
    prior's CE target is gt 1's label, whatever the device's scatter
    order."""
    rng = np.random.default_rng(2)
    floats, fixed = _multibox_inputs(rng, 1, 20, 4, 5, share=True)
    fixed["GtLabel"][0, :2] = (1, 4)
    prior, gt = floats["PriorBox"][0], floats["GtBox"][0, 0]
    lt = np.maximum(prior[:, :2], gt[:2])
    rb = np.minimum(prior[:, 2:], gt[2:])
    inter = np.prod(np.clip(rb - lt, 0, None), 1)
    area = np.prod(prior[:, 2:] - prior[:, :2], 1)
    best = int(np.argmax(inter / (area + np.prod(gt[2:] - gt[:2]) - inter)))
    ins = {k: torch.tensor(v) for k, v in {**floats, **fixed}.items()}
    base = torch_op("multibox_loss").fn(**ins)["Loss"]
    # raise the shared prior's logit of class 4 only: the loss falls only
    # if the prior's target is class 4 (gt 1's label)
    conf = ins["Conf"].clone()
    conf[0, best, 4] += 5.0
    moved = torch_op("multibox_loss").fn(**dict(ins, Conf=conf))["Loss"]
    assert float(moved) < float(base)
    want = jax_op("multibox_loss").fn(**{
        k: jnp.asarray(v) for k, v in {**floats, **fixed,
                                       "Conf": conf.numpy()}.items()})["Loss"]
    assert _rel(moved.numpy(), want) <= FWD_TOL

"""The SSD detector in the port against the JAX package on the CPU, at
``tests/test_book.py``'s size (4 classes, 64x64 pictures, 8 gt slots,
batch 16 of ``ssd.synthetic_batch``).

* Both packages build the same training and ``is_test`` programs, every
  op registered in the port; ``prior_box``'s build-time shape gives
  P = 4 x (16^2 + 8^2) priors.
* From the reference's startup state (``load_numpy_state``), one
  Momentum step: the loss within ORACLE_TOL f32's forward bound (2e-4
  relative), every parameter's gradient and every parameter after the
  step within the gradient bound (1e-3 of the tensor's largest), and
  the ``detections`` fetched in the same run: labels (and so the empty
  slots and the order) equal, scores and boxes within 2e-4.
* The ``is_test`` program's detections on the same weights, held alike.
* The port alone: twelve steps, the loss finite and below 0.8 of the
  first (the reference test's check); a training step that does not
  fetch ``detections`` runs no NMS.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu.models import ssd as jssd
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3
CFG = dict(num_classes=4, image_shape=(3, 64, 64), max_gt=8)
BATCH = 16


def _build(pkg, **kw):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = pkg.models.ssd.build(**CFG, **kw)
    return main, startup, out


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, v.lod_level,
                  type(v).__name__)
                 for v in program.list_vars()]
    return ops, variables


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


def _feed(seed=0):
    imgs, gt_box, gt_label = jssd.synthetic_batch(BATCH, seed=seed)
    return {"img": imgs, "gt_box": gt_box, "gt_label": gt_label}


def _hold_detections(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (BATCH, 20, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert _rel(got[..., 1:], want[..., 1:]) <= FWD_TOL


@pytest.fixture(scope="module")
def reference():
    """The reference's programs, startup state and executor."""
    main, startup, out = _build(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    init = {v.name: np.asarray(scope.get(v.name))
            for v in main.persistable_vars()
            if scope.find_var(v.name) is not None}
    return main, out, scope, exe, init


@pytest.mark.parametrize("is_test", [False, True])
def test_build_gives_the_same_programs(is_test):
    jmain, jstart, _ = _build(pt, is_test=is_test)
    tmain, tstart, tout = _build(tpt, is_test=is_test)
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    for prog in (tmain, tstart):
        for blk in prog.blocks:
            for op in blk.ops:
                torch_op(op.type)               # every op is registered
    assert tuple(tout["priors"].shape) == (2, 4 * (16 * 16 + 8 * 8), 4)


def test_one_step_matches_the_reference(reference):
    jmain, jout, scope, exe, init = reference
    tmain, _, tout = _build(tpt)
    tscope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    params = [p.name for p in jmain.all_parameters()]
    fetch = ([jout["avg_cost"].name, jout["detections"].name]
             + [p + "@GRAD" for p in params])
    feed = _feed()
    want = exe.run(jmain, feed=feed, fetch_list=fetch, scope=scope)
    got = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=fetch, scope=tscope)
    assert _rel(got[0], want[0]) <= FWD_TOL
    _hold_detections(got[1], want[1])
    for p, g, w in zip(params, got[2:], want[2:]):
        assert _rel(g, w) <= GRAD_TOL, (p, _rel(g, w))
    for p in params:
        assert _rel(tscope.numpy(p), np.asarray(scope.get(p))) <= GRAD_TOL, p


def test_is_test_detections_match_the_reference(reference):
    _, _, scope, exe, init = reference
    jmain, _, jout = _build(pt, is_test=True)
    tmain, _, tout = _build(tpt, is_test=True)
    img = {"img": _feed(seed=1)["img"]}
    state = {n: np.asarray(scope.get(n)) for n in init}
    (want,) = exe.run(jmain, feed=img, fetch_list=[jout["detections"]],
                      scope=scope)
    (got,) = tpt.Executor(tpt.CPUPlace()).run(
        tmain, feed=img, fetch_list=[tout["detections"]],
        scope=tpt.load_numpy_state(tpt.Scope(), state, device="cpu"))
    _hold_detections(got, want)


def test_the_port_trains_and_skips_the_nms_when_not_fetched(monkeypatch):
    import paddle_tpu_torch.ops.detection_ops as det

    main, startup, out = _build(tpt)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    nms_runs = []
    real = det.nms_keep
    monkeypatch.setattr(det, "nms_keep",
                        lambda *a: nms_runs.append(1) or real(*a))
    feed = _feed()
    losses = [float(np.ravel(exe.run(main, feed=feed,
                                     fetch_list=[out["avg_cost"]],
                                     scope=scope)[0])[0])
              for _ in range(12)]
    assert not nms_runs
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.8, losses[::4]
    (dets,) = exe.run(main, feed=feed, fetch_list=[out["detections"]],
                      scope=scope)
    assert nms_runs and np.asarray(dets).shape == (BATCH, 20, 6)

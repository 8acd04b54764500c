"""The port's ``evaluator`` and ``metrics`` against the JAX package's on
the CPU (the evaluator cases of ``tests/test_aux.py``, across packages).

``Accuracy``, ``ChunkEvaluator`` and ``EditDistance`` keep their counts
in persistable states that the step's ops update: both packages build
the same program, start from the reference's startup state, run the same
batches (from a numpy seed) through ``Executor.run`` and ``reset()``
half way, and must read the same ``eval()`` after each batch (exactly:
the states are integer counts and one f32 sum of small integers), with
the batch metrics within ORACLE_TOL f32's forward bound (2e-4).
``Auc`` and ``DetectionMAP`` collect fetched batches on the host: the
same updates give the same area and mAP (1e-12), and the hand cases of
``test_aux.py`` give its numbers.  ``metrics`` is the same in both.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4


def _accuracy(pkg):
    x = pkg.layers.data("x", shape=[5])
    lbl = pkg.layers.data("lbl", shape=[1], dtype="int64")
    prob = pkg.layers.fc(x, 4, act="softmax")
    return pkg.evaluator.Accuracy(input=prob, label=lbl, k=2)


def _chunk(pkg):
    inf = pkg.layers.data("inf", shape=[9], dtype="int64", lod_level=1)
    lab = pkg.layers.data("lab", shape=[9], dtype="int64", lod_level=1)
    return pkg.evaluator.ChunkEvaluator(inf, lab, chunk_scheme="IOB",
                                        num_chunk_types=3)


def _edit(pkg):
    hyp = pkg.layers.data("hyp", shape=[5], dtype="int64", lod_level=1)
    ref = pkg.layers.data("ref", shape=[5], dtype="int64", lod_level=1)
    return pkg.evaluator.EditDistance(hyp, ref)


def _batch(name, rng):
    if name == "accuracy":
        return {"x": rng.normal(size=(6, 5)).astype(np.float32),
                "lbl": rng.integers(0, 4, (6, 1))}
    if name == "chunk":
        lens = rng.integers(1, 10, 5).astype(np.int32)
        inf = rng.integers(0, 7, (5, 9))
        lab = inf.copy()
        lab[rng.random(lab.shape) < 0.25] = 6
        return {"inf": inf, "inf@LENGTH": lens, "lab": lab,
                "lab@LENGTH": lens}
    return {"hyp": rng.integers(0, 4, (4, 5)),
            "hyp@LENGTH": rng.integers(1, 6, 4).astype(np.int32),
            "ref": rng.integers(0, 4, (4, 5)),
            "ref@LENGTH": rng.integers(1, 6, 4).astype(np.int32)}


BUILD = {"accuracy": _accuracy, "chunk": _chunk, "edit_distance": _edit}


def _setup(pkg, name):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ev = BUILD[name](pkg)
    return main, startup, ev


@pytest.mark.parametrize("name", sorted(BUILD))
def test_in_program_evaluator_accumulates_as_the_reference(name):
    jmain, jstart, jev = _setup(pt, name)
    tmain, tstart, tev = _setup(tpt, name)
    assert [s.name for s in tev.states] == [s.name for s in jev.states]
    jscope, tscope = pt.Scope(), tpt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    rng = np.random.default_rng(sum(map(ord, name)))
    with pt.core.scope.scope_guard(jscope), tpt.scope_guard(tscope):
        jexe.run(jstart)
        init = {v.name: np.asarray(jscope.get(v.name))
                for v in jmain.persistable_vars()}
        tpt.load_numpy_state(tscope, init, device="cpu")
        jev.reset()
        tev.reset()
        fetch = [m.name for m in jev.metrics]
        for i in range(6):
            if i == 3:                  # a new pass: the counts restart
                jev.reset(jexe)
                tev.reset(texe)
            feed = _batch(name, rng)
            want = jexe.run(jmain, feed=feed, fetch_list=fetch)
            got = texe.run(tmain, feed=feed, fetch_list=fetch)
            for g, w in zip(got, want):
                g, w = np.asarray(g), np.asarray(w)
                assert g.shape == w.shape
                assert np.abs(g - w).max() <= FWD_TOL * max(
                    np.abs(w).max(), 1e-30)
            for s in jev.states:
                np.testing.assert_array_equal(tscope.numpy(s.name),
                                              np.asarray(jscope.get(s.name)))
            j, t = jev.eval(), tev.eval()
            assert np.allclose(t, j, rtol=1e-6, atol=0), (i, t, j)


def test_edit_distance_evaluator_hand_case():
    """``test_aux.py``'s case: distances 0, 4 and 1 over three sequences
    in two batches -> average 5/3, error rate 2/3."""
    main, startup, ev = _setup(tpt, "edit_distance")
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())

    def feed(h, hl, r, rl):
        pad = lambda a: np.pad(np.asarray(a, np.int64),  # noqa: E731
                               ((0, 0), (0, 5 - len(a[0]))))
        return {"hyp": pad(h), "hyp@LENGTH": np.asarray(hl, np.int32),
                "ref": pad(r), "ref@LENGTH": np.asarray(rl, np.int32)}

    with tpt.scope_guard(scope):
        exe.run(startup)
        ev.reset()
        exe.run(main, feed=feed([[1, 2, 3, 0], [1, 1, 0, 0]], [3, 4],
                                [[1, 2, 3, 0], [2, 2, 0, 0]], [3, 2]),
                fetch_list=[ev.metrics[0]])
        exe.run(main, feed=feed([[5, 0, 0, 0]], [1], [[5, 6, 0, 0]], [2]),
                fetch_list=[ev.metrics[0]])
        avg, err = ev.eval()
    assert abs(avg - 5.0 / 3.0) < 1e-5 and abs(err - 2.0 / 3.0) < 1e-9


def test_auc_is_the_references():
    """Rank-sum AUC with ties: ``test_aux.py``'s hand case (3.5 / 4), and
    random batches (tensors or arrays) give the reference's area."""
    auc = tpt.evaluator.Auc()
    auc.update([0.9, 0.8, 0.8, 0.1], [1, 0, 1, 0])
    assert abs(auc.eval() - 3.5 / 4) < 1e-9
    auc.reset()
    auc.update([0.2, 0.7], [0, 1])
    assert auc.eval() == 1.0
    rng = np.random.default_rng(3)
    j, t = pt.evaluator.Auc(), tpt.evaluator.Auc()
    for trial in range(4):
        s = rng.random(50)
        if trial % 2:
            s = np.round(s, 1)
        lab = rng.integers(0, 2, 50)
        j.update(s, lab)
        t.update(torch.tensor(s), torch.tensor(lab))
    assert abs(t.eval() - j.eval()) < 1e-12


def _det_case(m):
    m.update(detections=[[1, 0.9, 0, 0, 10, 10], [1, 0.6, 50, 50, 60, 60]],
             gt_boxes=[[0, 0, 10, 10]], gt_labels=[1])
    m.update(detections=[], gt_boxes=[[0, 0, 5, 5]], gt_labels=[2])
    m.update(detections=[[1, 0.9, 100, 100, 110, 110],
                         [1, 0.8, 0, 0, 10, 10],
                         [1, 0.7, 300, 300, 310, 310],
                         [2, 0.5, 1, 1, 5, 5]],
             gt_boxes=[[0, 0, 10, 10], [100, 100, 110, 110]],
             gt_labels=[1, 1], gt_difficult=[False, True])
    return m


@pytest.mark.parametrize("ap", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [False, True])
def test_detection_map_is_the_references(ap, difficult):
    """``test_aux.py``'s images, with a difficult box and a second
    class, under both AP versions and both difficult rules."""
    kw = dict(overlap_threshold=0.5, ap_version=ap,
              evaluate_difficult=difficult)
    j = _det_case(pt.evaluator.DetectionMAP(**kw))
    t = _det_case(tpt.evaluator.DetectionMAP(**kw))
    assert abs(t.eval() - j.eval()) < 1e-12
    with pytest.raises(ValueError, match="ap_version"):
        tpt.evaluator.DetectionMAP(ap_version="voc")


def test_detection_map_hand_cases():
    m = tpt.evaluator.DetectionMAP(overlap_threshold=0.5,
                                   ap_version="integral")
    m.update(detections=[[1, 0.9, 0, 0, 10, 10], [1, 0.6, 50, 50, 60, 60]],
             gt_boxes=[[0, 0, 10, 10]], gt_labels=[1])
    assert abs(m.eval() - 1.0) < 1e-9
    m.update(detections=[], gt_boxes=[[0, 0, 5, 5]], gt_labels=[2])
    assert abs(m.eval() - 0.5) < 1e-9
    m = tpt.evaluator.DetectionMAP(evaluate_difficult=False)
    m.update(detections=[[7, 0.9, 0, 0, 10, 10]], gt_boxes=[[0, 0, 10, 10]],
             gt_labels=[7], gt_difficult=[True])
    assert m.eval() == 0.0


def test_metrics_are_the_references():
    """``Accuracy``, ``EditDistance`` and ``CompositeMetric`` over the
    same updates (the port's also take tensors)."""
    for pkg, wrap in ((pt, np.asarray), (tpt, torch.tensor)):
        acc = pkg.metrics.Accuracy()
        for v, w in ((0.5, 2.0), (1.0, 1.0), (0.25, 4.0)):
            acc.update(wrap(np.array([v], np.float32)), weight=w)
        ed = pkg.metrics.EditDistance()
        ed.update(wrap(np.array([1.0, 2.0, 0.0], np.float32)), 3)
        comp = pkg.metrics.CompositeMetric()
        comp.add_metric(pkg.metrics.Accuracy())
        comp.update(value=np.array([0.75]))
        if pkg is pt:
            want = (acc.eval(), ed.eval(), comp.eval())
        else:
            assert (acc.eval(), ed.eval(), comp.eval()) == want
    assert want == (3.0 / 7.0, 1.0, [0.75])

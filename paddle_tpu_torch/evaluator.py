"""Evaluators — metrics with accumulator state in the program
(``paddle_tpu/evaluator.py``; the reference's ``fluid/evaluator.py``).

``Accuracy``, ``ChunkEvaluator`` and ``EditDistance`` keep their states
in persistable variables that ops of the step update (a ``sum`` into the
state), so the counts accumulate on the device across ``Executor.run``
calls; ``eval()`` reads them from the scope and ``reset()`` zeros them
there.  ``Auc`` and ``DetectionMAP`` rank over the whole evaluation
set, which fixed-size state cannot hold: they collect fetched batches on
the host.
"""

import numpy as np
import torch

from .layers.layer_helper import LayerHelper
from . import layers
from . import initializer as init_mod
from .core.dtypes import torch_dtype
from .core.scope import global_scope
from .metrics import _host


def _first(scope, name):
    return float(scope.numpy(name).reshape(-1)[0])


class Evaluator:
    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []
        self.metrics = []

    def _create_state(self, suffix, dtype, shape):
        var = self.helper.create_global_variable(
            shape=shape, dtype=dtype,
            name=f"{self.helper.name}.{suffix}",
            initializer=init_mod.Constant(0.0),
        )
        self.states.append(var)
        return var

    def reset(self, executor=None):
        """Zero every state in the scope, on the device it lives on (the
        executor's, or the CPU, for a state the startup program has not
        made yet)."""
        scope = global_scope()
        for state in self.states:
            cur = scope.find_var(state.name)
            if isinstance(cur, torch.Tensor):
                scope.set(state.name, torch.zeros_like(cur))
                continue
            dev = executor.device if executor is not None else "cpu"
            scope.set(state.name, torch.zeros(
                [s if s > 0 else 1 for s in state.shape],
                dtype=torch_dtype(state.dtype), device=dev))

    def eval(self, executor=None):
        raise NotImplementedError


class Accuracy(Evaluator):
    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy_eval", **kwargs)
        self.total = self._create_state("total", "int32", [1])
        self.correct = self._create_state("correct", "int32", [1])
        batch_correct = self.helper.create_tmp_variable("int32", [1], stop_gradient=True)
        batch_total = self.helper.create_tmp_variable("int32", [1], stop_gradient=True)
        acc = layers.accuracy(input, label, k=k, correct=batch_correct, total=batch_total)
        # accumulate
        self.helper.append_op(
            type="sum",
            inputs={"X": [self.total.name, batch_total.name]},
            outputs={"Out": [self.total.name]},
        )
        self.helper.append_op(
            type="sum",
            inputs={"X": [self.correct.name, batch_correct.name]},
            outputs={"Out": [self.correct.name]},
        )
        self.metrics.append(acc)

    def eval(self, executor=None):
        scope = global_scope()
        total = _first(scope, self.total.name)
        correct = _first(scope, self.correct.name)
        return correct / max(total, 1.0)


class ChunkEvaluator(Evaluator):
    def __init__(self, input, label, chunk_scheme="IOB", num_chunk_types=1, **kwargs):
        super().__init__("chunk_eval", **kwargs)
        self.num_infer = self._create_state("num_infer", "int64", [1])
        self.num_label = self._create_state("num_label", "int64", [1])
        self.num_correct = self._create_state("num_correct", "int64", [1])
        (
            precision, recall, f1, num_infer, num_label, num_correct,
        ) = layers.chunk_eval(
            input, label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
        )
        for state, batch in [
            (self.num_infer, num_infer),
            (self.num_label, num_label),
            (self.num_correct, num_correct),
        ]:
            self.helper.append_op(
                type="sum",
                inputs={"X": [state.name, batch.name]},
                outputs={"Out": [state.name]},
            )
        self.metrics += [precision, recall, f1]

    def eval(self, executor=None):
        scope = global_scope()
        infer = _first(scope, self.num_infer.name)
        label = _first(scope, self.num_label.name)
        correct = _first(scope, self.num_correct.name)
        precision = correct / max(infer, 1e-12)
        recall = correct / max(label, 1e-12)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return precision, recall, f1


class EditDistance(Evaluator):
    """Sequence error evaluator (reference CTCErrorEvaluator.cpp):
    accumulates total edit distance and sequence counts in program state;
    eval() returns (avg_distance, instance_error_rate)."""

    def __init__(self, input, label, normalized=False, ignored_tokens=None,
                 **kwargs):
        super().__init__("edit_distance_eval", **kwargs)
        self.total_distance = self._create_state("total_dist", "float32", [1])
        self.seq_num = self._create_state("seq_num", "int64", [1])
        self.errors = self._create_state("errors", "int64", [1])
        dist, seq_num = layers.edit_distance(
            input, label, normalized=normalized,
            ignored_tokens=ignored_tokens)
        batch_sum = layers.reduce_sum(dist)
        wrong = layers.cast(
            layers.greater_than(dist, layers.fill_constant(
                shape=[1], dtype=dist.dtype, value=0.0)), "int64")
        batch_err = layers.reduce_sum(wrong)
        for state, batch in [(self.total_distance, batch_sum),
                             (self.seq_num, seq_num),
                             (self.errors, batch_err)]:
            self.helper.append_op(
                type="sum", inputs={"X": [state.name, batch.name]},
                outputs={"Out": [state.name]},
            )
        self.metrics.append(dist)

    def eval(self, executor=None):
        scope = global_scope()
        dist = _first(scope, self.total_distance.name)
        n = _first(scope, self.seq_num.name)
        err = _first(scope, self.errors.name)
        return dist / max(n, 1.0), err / max(n, 1.0)


class Auc:
    """Exact ROC-AUC over the whole evaluation set (reference
    Evaluator.cpp AucEvaluator).  Dataset-level rank statistics cannot
    accumulate in fixed-size program state, so this evaluator collects
    fetched (score, label) batches host-side: call update() per batch,
    eval() for the area."""

    def __init__(self):
        self.reset()

    def reset(self, executor=None):
        self._scores = []
        self._labels = []

    def update(self, scores, labels):
        s = _host(scores).astype(np.float64).reshape(-1)
        l = _host(labels).reshape(-1)
        self._scores.append(s)
        self._labels.append(l)

    def eval(self, executor=None):
        if not self._scores:
            return 0.0
        s = np.concatenate(self._scores)
        l = np.concatenate(self._labels).astype(bool)
        pos, neg = int(l.sum()), int((~l).sum())
        if pos == 0 or neg == 0:
            return 0.0
        # rank-sum (Mann-Whitney U) with tie correction via average ranks
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty(len(s), np.float64)
        sorted_s = s[order]
        i = 0
        while i < len(s):
            j = i
            while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        return float((ranks[l].sum() - pos * (pos + 1) / 2.0) / (pos * neg))


class DetectionMAP:
    """VOC-style detection mAP (reference DetectionMAPEvaluator.cpp:
    11point or integral AP, overlap threshold, per-class matching of
    ranked detections to ground truth).  Host-side like Auc: call
    update() per batch with fetched arrays, eval() for mAP.

    update(detections, gt_boxes, gt_labels):
      detections  [[label, score, x1, y1, x2, y2], ...] for ONE image
      gt_boxes    [[x1, y1, x2, y2], ...]
      gt_labels   [g] ints
    """

    def __init__(self, overlap_threshold=0.5, ap_version="integral",
                 evaluate_difficult=False):
        if ap_version not in ("integral", "11point"):
            raise ValueError(f"unknown ap_version {ap_version!r}")
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self.reset()

    def reset(self, executor=None):
        self._images = []  # (dets, gt_boxes, gt_labels, gt_difficult)

    def update(self, detections, gt_boxes, gt_labels, gt_difficult=None):
        """gt_difficult: optional [g] bools — VOC "difficult" flags.  With
        evaluate_difficult=False (reference default,
        DetectionMAPEvaluator.cpp:106-116,184-198) difficult GT count
        neither toward the positives nor as matches: a detection whose
        best-overlap GT is difficult is skipped (neither tp nor fp)."""
        gl = _host(gt_labels).reshape(-1).astype(int)
        self._images.append((
            _host(detections).astype(np.float64).reshape(-1, 6),
            _host(gt_boxes).astype(np.float64).reshape(-1, 4),
            gl,
            (np.zeros(len(gl), bool) if gt_difficult is None
             else _host(gt_difficult).reshape(-1).astype(bool)),
        ))

    @staticmethod
    def _iou(box, boxes):
        x1 = np.maximum(box[0], boxes[:, 0])
        y1 = np.maximum(box[1], boxes[:, 1])
        x2 = np.minimum(box[2], boxes[:, 2])
        y2 = np.minimum(box[3], boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        a = (box[2] - box[0]) * (box[3] - box[1])
        b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / np.maximum(a + b - inter, 1e-12)

    def _average_precision(self, tp, fp, n_gt):
        tp, fp = np.cumsum(tp), np.cumsum(fp)
        recall = tp / max(n_gt, 1)
        precision = tp / np.maximum(tp + fp, 1e-12)
        if self.ap_version == "11point":
            return float(np.mean([
                precision[recall >= r].max() if (recall >= r).any() else 0.0
                for r in np.linspace(0, 1, 11)
            ]))
        # integral: area under monotone precision envelope
        mp = np.concatenate([[0.0], precision, [0.0]])
        mr = np.concatenate([[0.0], recall, [1.0]])
        for i in range(len(mp) - 2, -1, -1):
            mp[i] = max(mp[i], mp[i + 1])
        idx = np.where(mr[1:] != mr[:-1])[0]
        return float(np.sum((mr[idx + 1] - mr[idx]) * mp[idx + 1]))

    def eval(self, executor=None):
        classes = sorted({c for _, _, gl, _ in self._images for c in gl})
        aps = []
        for c in classes:
            records = []  # (score, image_idx, box)
            n_gt = 0
            for i, (dets, gb, gl, gd) in enumerate(self._images):
                cls = gl == c
                n_gt += int((cls if self.evaluate_difficult
                             else np.logical_and(cls, ~gd)).sum())
                for d in dets[dets[:, 0] == c]:
                    records.append((d[1], i, d[2:6]))
            if n_gt == 0:
                continue
            records.sort(key=lambda r: -r[0])
            matched = {i: np.zeros(int((gl == c).sum()), bool)
                       for i, (_, _, gl, _) in enumerate(self._images)}
            tp = np.zeros(len(records))
            fp = np.zeros(len(records))
            for k, (_score, i, box) in enumerate(records):
                _, gb, gl, gd = self._images[i]
                cls_boxes = gb[gl == c]
                cls_diff = gd[gl == c]
                if len(cls_boxes) == 0:
                    fp[k] = 1
                    continue
                ious = self._iou(box, cls_boxes)
                best = int(np.argmax(ious))
                if ious[best] >= self.overlap_threshold:
                    if not self.evaluate_difficult and cls_diff[best]:
                        continue  # neither tp nor fp (cpp:184-198)
                    if not matched[i][best]:
                        tp[k] = 1
                        matched[i][best] = True
                    else:
                        fp[k] = 1
                else:
                    fp[k] = 1
            aps.append(self._average_precision(tp, fp, n_gt))
        return float(np.mean(aps)) if aps else 0.0

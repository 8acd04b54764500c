"""Metric ops (``paddle_tpu/ops/metric_ops.py``): ``accuracy``, ``auc``,
``precision_recall``, ``positive_negative_pair`` and ``chunk_eval``.
The counts are integer and boolean logic on the device, equal to the
reference's, not near."""

import torch

from ..core.registry import register_op


@register_op("accuracy", nondiff=True)
def accuracy(Out, Indices, Label, **_):
    """Top-k accuracy: a row is correct when any of its ``Indices``
    ``[b, k]`` (from ``top_k``) equals its label ``[b, 1]``.  ``Accuracy``
    is f32 ``[1]``; ``Correct`` and ``Total`` are int32 ``[1]``."""
    lbl = Label.reshape(-1, 1).to(Indices.dtype)
    correct = torch.any(Indices == lbl, dim=1)
    num_correct = torch.sum(correct.float())
    total = float(Indices.shape[0])
    return {"Accuracy": (num_correct / total).reshape(1),
            "Correct": num_correct.to(torch.int32).reshape(1),
            "Total": torch.full((1,), Indices.shape[0], dtype=torch.int32,
                                device=Indices.device)}


def _thresholds(n, device):
    """``jnp.linspace(0, 1, n)`` as the reference computes it on the CPU:
    ``i * f32(1 / (n - 1))``, the last one exactly 1 (a probability equal
    to a threshold counts as above it, so the bits matter)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=torch.float32)
    t[-1:].fill_(1.0)
    return t


@register_op("auc", nondiff=True)
def auc(Out, Indices=None, Label=None, curve="ROC", num_thresholds=200, **_):
    """The batch's ROC AUC over ``num_thresholds`` buckets (the
    reference's ``auc_op``): the positive-class probability (``Out[:, 1]``
    of a two-column ``Out``, else ``Out`` itself) against each threshold,
    true and false positive rates (each count over at least 1), and the
    trapezoid under the curve, ``[1]``."""
    pos_prob = (Out[:, 1] if Out.dim() == 2 and Out.shape[1] >= 2
                else Out.reshape(-1))
    lbl = Label.reshape(-1).to(torch.bool)
    pred_pos = pos_prob[None, :] >= _thresholds(int(num_thresholds),
                                                Out.device)[:, None]
    tp = torch.sum(pred_pos & lbl[None, :], dim=1).to(torch.float32)
    fp = torch.sum(pred_pos & ~lbl[None, :], dim=1).to(torch.float32)
    pos = torch.clamp(torch.sum(lbl.to(torch.float32)), min=1.0)
    neg = torch.clamp(torch.sum((~lbl).to(torch.float32)), min=1.0)
    # the thresholds rise, so fpr falls: the area is minus the trapezoid
    return {"AUC": (-torch.trapezoid(tp / pos, fp / neg)).reshape(1)}


@register_op("precision_recall", nondiff=True)
def precision_recall(MaxProbs=None, Indices=None, Labels=None, Weights=None,
                     StatesInfo=None, class_number=2, **_):
    """Per-class ``[TP, FP, TN, FN]`` weighted counts ``[C, 4]`` of the
    batch (``precision_recall_op.cc``), plus ``StatesInfo`` for the
    accumulated ones; each set's metrics are the macro precision, recall
    and F1 then the micro ones, ``[6]`` f32."""
    pred = Indices.reshape(-1).long()
    lbl = Labels.reshape(-1).long()
    w = (Weights.reshape(-1).float() if Weights is not None
         else torch.ones(pred.shape, dtype=torch.float32, device=pred.device))
    classes = torch.arange(class_number, device=pred.device)
    is_pred = pred[None, :] == classes[:, None]
    is_lbl = lbl[None, :] == classes[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)

    def count(mask):
        return torch.where(mask, w[None, :], zero).sum(dim=1)

    batch = torch.stack([count(is_pred & is_lbl), count(is_pred & ~is_lbl),
                         count(~is_pred & ~is_lbl), count(~is_pred & is_lbl)],
                        dim=1)
    acc = batch + StatesInfo if StatesInfo is not None else batch

    def metrics(st):
        tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
        prec = tp / torch.clamp_min(tp + fp, 1e-12)
        rec = tp / torch.clamp_min(tp + fn, 1e-12)
        f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-12)
        mp = tp.sum() / torch.clamp_min((tp + fp).sum(), 1e-12)
        mr = tp.sum() / torch.clamp_min((tp + fn).sum(), 1e-12)
        mf = 2 * mp * mr / torch.clamp_min(mp + mr, 1e-12)
        return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])

    return {"BatchMetrics": metrics(batch), "AccumMetrics": metrics(acc),
            "AccumStatesInfo": acc}


@register_op("positive_negative_pair", nondiff=True)
def positive_negative_pair(Score, Label, QueryID, AccumulatePositivePair=None,
                           AccumulateNegativePair=None,
                           AccumulateNeutralPair=None, **_):
    """Ranking pairs within each query (``positive_negative_pair_op.cc``):
    over pairs ``i < j`` of one query with different labels, positive
    where the scores order as the labels, negative where they order
    against them, neutral where the scores tie; ``[1]`` f32 each, plus the
    accumulated counts."""
    s = Score.reshape(-1).float()
    lab = Label.reshape(-1).float()
    q = QueryID.reshape(-1)
    n = s.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    ds = s[:, None] - s[None, :]
    dl = lab[:, None] - lab[None, :]
    informative = (q[:, None] == q[None, :]) & upper & (dl != 0)
    pos = (informative & (ds * dl > 0)).sum().float()
    neg = (informative & (ds * dl < 0)).sum().float()
    neu = (informative & (ds == 0)).sum().float()
    if AccumulatePositivePair is not None:
        pos = pos + AccumulatePositivePair.reshape(())
        neg = neg + AccumulateNegativePair.reshape(())
        neu = neu + AccumulateNeutralPair.reshape(())
    return {"PositivePair": pos.reshape(1), "NegativePair": neg.reshape(1),
            "NeutralPair": neu.reshape(1)}


# chunk_eval's scheme tables (chunk_eval_op.h:108-141): (num_tag_types,
# tag_begin, tag_inside, tag_end, tag_single); -1 = unused.
_CHUNK_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _tag_is(tag, *tags):
    """``tag`` equal to any of ``tags`` that the scheme uses (>= 0)."""
    out = torch.zeros_like(tag, dtype=torch.bool)
    for t in tags:
        if t >= 0:
            out = out | (tag == t)
    return out


@register_op("chunk_eval", nondiff=True)
def chunk_eval(Inference, Label, Length=None, num_chunk_types=1,
               chunk_scheme="IOB", excluded_chunk_types=(), **_):
    """Chunk-level precision, recall and F1 (``chunk_eval_op.h``) under
    the IOB, IOE, IOBES and plain schemes, with ``excluded_chunk_types``.
    ``tag = label % num_tag_types``, ``type = label // num_tag_types``;
    positions past ``Length`` are outside.  A chunk begins and ends by the
    reference's ChunkBegin / ChunkEnd tables, evaluated at every position
    at once (the reference walks each row); two chunks match when their
    begin, end and type agree.  The counts are int32 ``[1]``."""
    if chunk_scheme not in _CHUNK_SCHEMES:
        raise ValueError(f"unknown chunk scheme {chunk_scheme!r}")
    n_tags, t_beg, t_in, t_end, t_sin = _CHUNK_SCHEMES[chunk_scheme]
    other = num_chunk_types
    b, t = Inference.shape
    dev = Inference.device
    steps = torch.arange(t, device=dev)
    mask = (steps[None, :] < Length.reshape(-1, 1) if Length is not None
            else torch.ones((b, t), dtype=torch.bool, device=dev))

    def analyze(labels):
        labels = labels.long()
        tag = labels % n_tags
        ctype = torch.where(mask, labels // n_tags,
                            torch.full_like(labels, other))
        prev_tag = torch.cat([torch.full_like(tag[:, :1], -2), tag[:, :-1]],
                             dim=1)
        prev_type = torch.cat([torch.full_like(ctype[:, :1], other),
                               ctype[:, :-1]], dim=1)
        cur_out, prev_out = ctype == other, prev_type == other
        diff_type = ctype != prev_type
        prev_closed = _tag_is(prev_tag, t_end, t_sin)
        begin_tag = (_tag_is(tag, t_beg, t_sin)
                     | (_tag_is(tag, t_in) & prev_closed)
                     | (_tag_is(tag, t_end) & prev_closed))
        begins = torch.where(prev_out, ~cur_out,
                             ~cur_out & (diff_type | begin_tag))
        restart = _tag_is(tag, t_beg, t_sin)
        end_tag = ((_tag_is(prev_tag, t_beg, t_in) & restart)
                   | _tag_is(prev_tag, t_end, t_sin))
        closes = ~prev_out & (cur_out | diff_type | end_tag)
        nxt_closes = torch.cat(
            [closes[:, 1:], torch.ones_like(closes[:, :1])], dim=1)
        return begins, ~cur_out & nxt_closes, ctype

    def chunk_end(ends):
        # each position's nearest chunk end at or after it
        end_pos = torch.where(ends, steps[None, :].expand(b, t),
                              torch.full((b, t), t + 1, device=dev))
        return torch.flip(torch.cummin(torch.flip(end_pos, [1]), dim=1)[0],
                          [1])

    inf_s, inf_e, inf_t = analyze(Inference)
    lab_s, lab_e, lab_t = analyze(Label)
    inf_ok, lab_ok = inf_s, lab_s
    for ex in excluded_chunk_types or ():
        inf_ok = inf_ok & (inf_t != ex)
        lab_ok = lab_ok & (lab_t != ex)
    match = (inf_ok & lab_ok & (chunk_end(inf_e) == chunk_end(lab_e))
             & (inf_t == lab_t))
    num_inf = inf_ok.sum().float()
    num_lab = lab_ok.sum().float()
    num_correct = match.sum().float()
    zero = torch.zeros((), device=dev)
    precision = torch.where(num_inf > 0,
                            num_correct / torch.clamp_min(num_inf, 1.0), zero)
    recall = torch.where(num_lab > 0,
                         num_correct / torch.clamp_min(num_lab, 1.0), zero)
    f1 = torch.where(num_correct > 0,
                     2 * precision * recall
                     / torch.clamp_min(precision + recall, 1e-12), zero)
    return {"Precision": precision.reshape(1), "Recall": recall.reshape(1),
            "F1-Score": f1.reshape(1),
            "NumInferChunks": num_inf.to(torch.int32).reshape(1),
            "NumLabelChunks": num_lab.to(torch.int32).reshape(1),
            "NumCorrectChunks": num_correct.to(torch.int32).reshape(1)}

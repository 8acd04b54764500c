"""Linear-chain CRF ops (``paddle_tpu/ops/crf_ops.py``): the reference's
``linear_chain_crf`` (forward algorithm; its log-likelihood gradient
from autograd) and ``crf_decoding`` (Viterbi).

The transition parameter is ``[num_tags + 2, num_tags]``: row 0 the start
weights, row 1 the end weights, rows 2.. ``transition[i][j]`` from tag i
to tag j.  Emissions are padded dense ``[b, T, num_tags]`` with lengths;
both recursions are Python loops over time (the reference's
``lax.scan``s), and a row past its length keeps its state.
"""

import torch

from ..core.registry import register_op


def _mask(lengths, t):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def _lengths(Length, b, t, dev):
    return (Length.to(torch.int32) if Length is not None
            else torch.full((b,), t, dtype=torch.int32, device=dev))


def crf_log_norm(emission, transition, lengths):
    """``log Z`` of each row: a logsumexp over the previous tag a step."""
    t = emission.shape[1]
    start, end, trans = transition[0], transition[1], transition[2:]
    alpha = start[None, :] + emission[:, 0, :]
    for tt in range(1, t):
        scores = (alpha[:, :, None] + trans[None, :, :]
                  + emission[:, tt, None, :])
        new_alpha = torch.logsumexp(scores, dim=1)
        alpha = torch.where((tt < lengths)[:, None], new_alpha, alpha)
    return torch.logsumexp(alpha + end[None, :], dim=1)


def crf_path_score(emission, transition, labels, lengths):
    """The score of each row's gold tag path."""
    b, t, _ = emission.shape
    start, end, trans = transition[0], transition[1], transition[2:]
    lbl = labels.long()
    m = _mask(lengths, t).to(torch.float32)
    emit = torch.gather(emission, 2, lbl[..., None]).reshape(b, t)
    score = start[lbl[:, 0]] + emit[:, 0]
    tr = trans[lbl[:, :-1], lbl[:, 1:]]
    score = score + torch.sum((tr + emit[:, 1:]) * m[:, 1:], dim=1)
    last = torch.clamp_min(lengths.long() - 1, 0)
    last_lbl = torch.gather(lbl, 1, last[:, None]).reshape(-1)
    return score + end[last_lbl]


@register_op("linear_chain_crf")
def linear_chain_crf(Emission, Transition, Label, Length=None, _live=None,
                     **_):
    """``LogLikelihood`` is the negative log-likelihood ``log Z - gold``
    ``[b, 1]``.  ``EmissionExps``, ``TransitionExps`` (max-shifted
    exponentials) and ``Alpha`` (zeros) are filled as the reference fills
    them, without a gradient, and only when something reads them."""
    b, t, _ = Emission.shape
    lengths = _lengths(Length, b, t, Emission.device)
    lbl = Label.reshape(b, t) if Label.dim() == 3 else Label
    em = Emission.float()
    tr = Transition.float()
    nll = crf_log_norm(em, tr, lengths) - crf_path_score(em, tr, lbl, lengths)
    out = {"LogLikelihood": nll[:, None].to(Emission.dtype)}
    with torch.no_grad():
        if _live is None or "EmissionExps" in _live:
            out["EmissionExps"] = torch.exp(
                em - torch.amax(em, dim=-1, keepdim=True))
        if _live is None or "TransitionExps" in _live:
            out["TransitionExps"] = torch.exp(tr - torch.amax(tr))
        if _live is None or "Alpha" in _live:
            out["Alpha"] = torch.zeros_like(em)
    return out


@register_op("crf_decoding", nondiff=True)
def crf_decoding(Emission, Transition, Label=None, Length=None, **_):
    """Viterbi decode: the best tag path ``[b, T]`` int32, zeros past a
    row's length; ties go to the first index (``argmax``), as in the
    reference.  With ``Label``, the per-token correctness mask instead."""
    b, t, n = Emission.shape
    dev = Emission.device
    lengths = _lengths(Length, b, t, dev)
    em = Emission.float()
    start, end, trans = Transition[0], Transition[1], Transition[2:]
    delta = start[None, :] + em[:, 0, :]
    keep = torch.arange(n, device=dev)[None, :].expand(b, n)
    backptrs = []
    for tt in range(1, t):
        scores = delta[:, :, None] + trans[None, :, :] + em[:, tt, None, :]
        best_prev = torch.argmax(scores, dim=1)
        new_delta = torch.gather(scores, 1, best_prev[:, None, :])[:, 0]
        active = (tt < lengths)[:, None]
        delta = torch.where(active, new_delta, delta)
        backptrs.append(torch.where(active, best_prev, keep))
    tag = torch.argmax(delta + end[None, :], dim=1)
    tags = [tag]
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)
    valid = _mask(lengths, t)
    path = torch.where(valid, path, torch.zeros_like(path))
    if Label is not None:
        lbl = Label.reshape(b, t) if Label.dim() == 3 else Label
        correct = (path == lbl.to(path.dtype)) & valid
        return {"ViterbiPath": correct.to(torch.int32)}
    return {"ViterbiPath": path.to(torch.int32)}

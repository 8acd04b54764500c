"""Beam search ops (``paddle_tpu/ops/beam_search_ops.py``).

The reference's fixed-width masked beam: each sample keeps ``k`` beams
at every step; a finished beam (its last id ``end_id``) is frozen by
masking, so its score stops changing and it expands only with
``end_id``.  ``beam_search_decode`` backtracks the parent pointers
stored per step.  Every op works on the tensors' device: nothing is
read on the host.

Ties: ``jax.lax.top_k`` returns equal values lowest index first;
``torch.topk`` promises no order among them.  The decode meets ties on
every first expansion (all ``k`` beams start identical, so the best
token comes ``k`` times, once a beam, and the reference's parents there
are ``0..k-1``) and among finished beams (their other candidates all
sit at ``-1e38``), so ``beam_search`` takes the first ``k`` of a stable
descending sort: among equal values the lower flat index first.
"""

import torch

from ..core.registry import register_op

# a finished beam's score for every continuation but end_id (the
# reference's constant, finite in f32)
_DEAD = -1e38


def beam_totals(PreIds, PreScores, Scores, end_id=1):
    """The candidates' accumulated scores ``[b, k * V]`` (flat index
    ``beam * V + token``): ``PreScores`` plus the step's log-prob, a
    finished beam's continuations frozen (``end_id`` at +0, every other
    token at ``-1e38``)."""
    b, k, v = Scores.shape
    finished = (PreIds == end_id)[..., None]
    frozen = torch.full((v,), _DEAD, dtype=Scores.dtype,
                        device=Scores.device)
    # a fill, not ``frozen[end_id] = 0.0``: item assignment copies the
    # value from the host and synchronizes
    frozen[end_id:end_id + 1].fill_(0.0)
    step_scores = torch.where(finished, frozen, Scores)
    return (PreScores[..., None] + step_scores).reshape(b, k * v)


@register_op("beam_search", nondiff=True)
def beam_search(PreIds, PreScores, Scores, beam_size=4, end_id=1, **_):
    """One expansion step.

    ``PreIds [b, k]`` int, ``PreScores [b, k]`` accumulated log-probs,
    ``Scores [b, k, V]`` the step's log-probs.  Returns ``SelectedIds``
    ``[b, k]`` int32, ``SelectedScores [b, k]`` and ``ParentIdx [b, k]``
    int32 (the beam each selected hypothesis extends): the ``k`` best of
    the ``k * V`` totals, best first, ties lowest flat index first."""
    k, v = Scores.shape[1], Scores.shape[2]
    top, idx = torch.sort(beam_totals(PreIds, PreScores, Scores, end_id),
                          dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    return {"SelectedIds": (idx % v).to(torch.int32),
            "SelectedScores": top,
            "ParentIdx": torch.div(idx, v, rounding_mode="floor").to(
                torch.int32)}


@register_op("beam_search_decode", nondiff=True)
def beam_search_decode(Ids, ParentIdx, Scores=None, end_id=1, **_):
    """Backtrack stored beams into sentences.

    ``Ids`` / ``ParentIdx [T, b, k]`` (``beam_search``'s outputs stacked
    by step).  Returns ``SentenceIds [b, k, T]`` — final beam j's tokens,
    every position after its first ``end_id`` set to ``end_id`` — and,
    given ``Scores`` (``[T, b, k]`` or ``[b, k]``), ``SentenceScores [b,
    k]``: the last step's."""
    t, b, k = Ids.shape
    beam = torch.arange(k, device=Ids.device).expand(b, k)
    toks = []
    for s in range(t - 1, -1, -1):
        toks.append(torch.gather(Ids[s], 1, beam))
        beam = torch.gather(ParentIdx[s].long(), 1, beam)
    sent = torch.stack(toks[::-1], dim=-1)                  # [b, k, T]
    is_end = (sent == end_id).to(torch.int32)
    seen_end = torch.cumsum(is_end, dim=-1) - is_end
    sent = torch.where(seen_end > 0, int(end_id), sent)
    out = {"SentenceIds": sent}
    if Scores is not None:
        out["SentenceScores"] = Scores[-1] if Scores.dim() == 3 else Scores
    return out


@register_op("beam_init", nondiff=True)
def beam_init(Ref, beam_size=4, bos_id=0, **_):
    """The first beam state of a decode over ``Ref``'s batch: ``Ids [b,
    k]`` all ``bos_id``, ``Scores [b, k]`` ``[0, -1e38, ...]``, so the
    first expansion draws ``k`` distinct tokens from beam 0 alone."""
    b, k = Ref.shape[0], int(beam_size)
    ids = torch.full((b, k), int(bos_id), dtype=torch.int32,
                     device=Ref.device)
    scores = torch.full((b, k), _DEAD, dtype=torch.float32,
                        device=Ref.device)
    scores[:, 0].fill_(0.0)
    return {"Ids": ids, "Scores": scores}


@register_op("beam_expand", nondiff=True)
def beam_expand(X, beam_size=4, **_):
    """Each row ``beam_size`` times in a row: ``[b, ...] -> [b * k, ...]``."""
    return {"Out": torch.repeat_interleave(X, int(beam_size), dim=0)}


@register_op("beam_gather", nondiff=True)
def beam_gather(X, Parent, **_):
    """Per-beam state rows regrouped by this step's parents: ``X [b * k,
    ...]``, ``Parent [b, k]``; row ``i * k + j`` becomes ``X[i * k +
    Parent[i, j]]``."""
    b, k = Parent.shape
    rows = (torch.arange(b, device=X.device)[:, None] * k
            + Parent.long()).reshape(-1)
    return {"Out": X.index_select(0, rows)}

"""Beam-level training: ``cross_entropy_over_beam``
(``paddle_tpu/ops/beam_ce_ops.py``; the reference's
``CrossEntropyOverBeam.cpp``, the learning-to-search cost).

Per sequence, a beam search made E expansions.  Expansion ``e`` holds
the candidate scores of every surviving prefix (``Scores[e] [b, R_e,
L_e]``), the top-k candidate ids a row (``Ids[e] [b, R_e, B_e]``, -1
padded) and the gold id (``Gold[e] [b]``); the rows of expansion e+1 are
the valid candidates of expansion e in row-major order.  The cost sums
the selected scores along every complete path, softmaxes over the paths
and takes the NLL of the gold path; when the gold falls off the beam at
step t, the cost is over the beam at t with the gold path appended as one
more candidate.

The reference picks the fall-off step with ``lax.switch`` a sample.  The
port computes the cost at every step for the whole batch, each step all
gathers and masks, and selects each sample's step by a gather: no host
read, one autograd graph.  A step a sample does not select may hold no
valid path, so an invalid path scores ``-1e30`` rather than ``-inf``:
the selected step's value is the same (its softmax weight is 0 either
way), and the unselected steps' zero cotangents meet no ``0 * nan``."""

import torch

from ..core.registry import register_op

_NO_PATH = -1e30


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _pick(scores, row, col):
    """``scores [b, R, L]`` at ``(row, col)``, each ``[b, n]`` long."""
    b, _r, ln = scores.shape
    return torch.gather(scores.reshape(b, -1), 1, row * ln + col)


def _gold_track(ids, gold):
    """The gold prefix's row and column in each expansion (column -1 once
    it fell off) and how many expansions count (the fall-off step
    included)."""
    b = gold[0].shape[0]
    dev = gold[0].device
    rows, cols = [], []
    gold_row = torch.zeros(b, dtype=torch.long, device=dev)
    all_found = torch.ones(b, dtype=torch.bool, device=dev)
    valid_cnt = torch.zeros(b, dtype=torch.long, device=dev)
    for e in range(len(ids)):
        if e:
            prev = ids[e - 1].reshape(b, -1)
            upto = rows[e - 1] * ids[e - 1].shape[2] + cols[e - 1]
            pos = torch.arange(prev.shape[1], device=dev)
            gold_row = ((prev != -1) & (pos[None, :] < upto[:, None])).sum(1)
        r = torch.clamp(gold_row, 0, ids[e].shape[1] - 1)
        row_vals = torch.gather(
            ids[e], 1, r[:, None, None].expand(-1, 1, ids[e].shape[2]))[:, 0]
        match = row_vals == gold[e][:, None]
        found = match.any(dim=1)
        col = torch.where(found, match.int().argmax(dim=1),
                          torch.full_like(gold_row, -1))
        rows.append(gold_row)
        cols.append(col)
        valid_cnt = torch.where(all_found, torch.full_like(valid_cnt, e + 1),
                                valid_cnt)
        all_found = all_found & found
    return rows, cols, valid_cnt


def _step_cost(t, scores, ids, gold, rows, cols):
    """``[b]`` cost over the beam at expansion ``t``."""
    b, r_t, b_t = ids[t].shape
    n = r_t * b_t
    dev = scores[0].device
    flat = ids[t].reshape(b, n)
    valid = flat != -1
    parent = (torch.arange(n, device=dev) // b_t)[None, :].expand(b, n)
    path = _pick(scores[t], parent,
                 torch.clamp(flat, 0, scores[t].shape[2] - 1))
    path = torch.where(valid, path, torch.zeros_like(path))
    # backtrack: row r of expansion e+1 is the r-th valid candidate of e
    for e in range(t - 1, -1, -1):
        r_e, b_e = ids[e].shape[1:]
        flat_e = ids[e].reshape(b, r_e * b_e)
        vm_e = flat_e != -1
        rank = torch.cumsum(vm_e.long(), dim=1) - 1
        rows_next = ids[e + 1].shape[1]
        slot_of = torch.where(vm_e & (rank < rows_next), rank,
                              torch.full_like(rank, rows_next))
        origin = torch.zeros((b, rows_next + 1), dtype=torch.long,
                             device=dev)
        origin.scatter_(1, slot_of, torch.arange(
            r_e * b_e, device=dev)[None, :].expand(b, -1).contiguous())
        slot = torch.gather(origin[:, :rows_next], 1,
                            torch.clamp(parent, 0, rows_next - 1))
        row_e = slot // b_e
        id_e = torch.gather(flat_e, 1, slot)
        step = _pick(scores[e], row_e,
                     torch.clamp(id_e, 0, scores[e].shape[2] - 1))
        path = path + torch.where(valid, step, torch.zeros_like(step))
        parent = row_e
    fell = cols[t] == -1
    gold_extra = sum(
        _pick(scores[e], torch.clamp(rows[e], 0, scores[e].shape[1] - 1)[:, None],
              torch.clamp(gold[e], 0, scores[e].shape[2] - 1)[:, None])[:, 0]
        for e in range(t + 1))
    no_path = torch.full((), _NO_PATH, dtype=path.dtype, device=dev)
    total = torch.cat([torch.where(valid, path, no_path),
                       torch.where(fell, gold_extra, no_path)[:, None]], dim=1)
    gold_pos = torch.where(fell, torch.full_like(rows[t], n),
                           rows[t] * b_t + cols[t])
    picked = torch.gather(total, 1, gold_pos[:, None])[:, 0]
    return torch.logsumexp(total, dim=1) - picked


def cross_entropy_over_beam_fn(scores, ids, gold):
    """Scores: E tensors ``[b, R_e, L_e]``; ids: E int tensors ``[b, R_e,
    B_e]`` (or ``[b, B_e]``); gold: E int tensors ``[b]``.  ``[b]`` f32
    costs."""
    scores = [s.float() for s in _as_list(scores)]
    ids = [(i[:, None, :] if i.dim() == 2 else i).long()
           for i in _as_list(ids)]
    gold = [g.reshape(g.shape[0]).long() for g in _as_list(gold)]
    rows, cols, valid_cnt = _gold_track(ids, gold)
    costs = torch.stack([_step_cost(t, scores, ids, gold, rows, cols)
                         for t in range(len(ids))], dim=1)
    t_idx = torch.clamp(valid_cnt - 1, 0, len(ids) - 1)
    return torch.gather(costs, 1, t_idx[:, None])[:, 0]


@register_op("cross_entropy_over_beam")
def cross_entropy_over_beam_op(Scores, Ids, Gold, **_):
    """A 2-D score or id input is a one-row expansion.  ``Out [b, 1]``."""
    scores = [s[:, None, :] if s.dim() == 2 else s for s in _as_list(Scores)]
    loss = cross_entropy_over_beam_fn(scores, _as_list(Ids), _as_list(Gold))
    return {"Out": loss[:, None]}

"""Recurrent ops — the LSTM and GRU families (``paddle_tpu/ops/rnn_ops.py``).

A sequence batch is padded dense ``[b, t, ...]`` with lengths, as in the
reference: a Python loop over time runs the cell on ``[b, ...]`` slices
(the reference's ``lax.scan``), and autograd differentiates the loop.
Gate order i, f, c (candidate), o; a step past a sample's length keeps
its state, ``h = m * h_new + (1 - m) * h``.  The hidden-to-gates product
is ``torch.matmul``, as the reference's ``jnp.dot`` (a bf16 product
accumulates in f32 inside the library).  Neither ``torch.nn.LSTM`` /
``GRU`` nor cuDNN's RNN computes this function: their gate order, bias
layout and peepholes differ and they take no other activations.

Ported: ``lstm_cell``, ``gru_cell``, ``lstm`` (peepholes, the three
activations), ``lstmp``, ``gru`` (``H0``, ``is_reverse``, lengths),
``lstm_unit``, ``gru_unit`` and ``nested_rnn`` (the two-level GRU over
a nested batch).
"""

import torch

from ..core.registry import register_op
from .sequence_ops import time_mask

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
    "linear": lambda x: x,
}


def lstm_cell(x_gates, h, c, weight_hh, bias=None, peephole=None,
              gate_act="sigmoid", cell_act="tanh", cand_act="tanh"):
    """One LSTM step.  ``x_gates [b, 4d]`` (the input already projected),
    ``h``/``c [b, d]``, ``weight_hh [d, 4d]``; ``peephole`` (wi, wf, wo)
    each ``[d]`` or None."""
    gates = x_gates + torch.matmul(h, weight_hh.to(h.dtype))
    if bias is not None:
        gates = gates + bias.to(h.dtype)
    gi, gf, gc, go = torch.chunk(gates, 4, dim=-1)
    ga, ca = _ACTS[gate_act], _ACTS[cand_act]
    if peephole is not None:
        wi, wf, wo = peephole
        i = ga(gi + wi * c)
        f = ga(gf + wf * c)
    else:
        i = ga(gi)
        f = ga(gf)
    c_new = f * c + i * ca(gc)
    if peephole is not None:
        o = ga(go + wo * c_new)
    else:
        o = ga(go)
    h_new = o * _ACTS[cell_act](c_new)
    return h_new, c_new


def gru_cell(x_gates, h, weight_hh, bias=None, gate_act="sigmoid",
             cand_act="tanh"):
    """One GRU step.  ``x_gates [b, 3d]`` (order u, r, c),
    ``weight_hh [d, 3d]``: the u and r parts, then the candidate's ``[d,
    d]``, which multiplies ``r * h``."""
    d = h.shape[-1]
    w_ur = weight_hh[:, :2 * d].to(h.dtype)
    w_c = weight_hh[:, 2 * d:].to(h.dtype)
    g = x_gates
    if bias is not None:
        g = g + bias.to(h.dtype)
    g_ur = g[..., :2 * d] + torch.matmul(h, w_ur)
    ga, ca = _ACTS[gate_act], _ACTS[cand_act]
    u = ga(g_ur[..., :d])
    r = ga(g_ur[..., d:])
    c = ca(g[..., 2 * d:] + torch.matmul(r * h, w_c))
    return u * h + (1 - u) * c


def _steps(Input, Length, is_reverse):
    """The time indices in the order the loop takes them, and the
    ``[b, t, 1]`` mask (None without lengths: every step counts, and
    ``1 * h_new + 0 * h`` is ``h_new``)."""
    t = Input.shape[1]
    order = range(t - 1, -1, -1) if is_reverse else range(t)
    mask = None
    if Length is not None:
        mask = time_mask(Length, t, Input.dtype)[..., None]
    return order, mask


def _keep(m, new, old):
    return new if m is None else m * new + (1 - m) * old


def _stack(seq, is_reverse):
    """Per-step ``[b, ...]`` values in loop order -> ``[b, t, ...]`` in
    time order."""
    if is_reverse:
        seq = seq[::-1]
    return torch.stack(seq, dim=1)


def _rnn_flops(hidden_w):
    """``2 b t * |W|`` for each recurrent product, and the backward's
    two (dh and dW) where the step's values take a gradient."""
    def flops(op, shape, grad, train):
        b, t = shape(op.inputs["Input"][0])[:2]
        total = 0
        for slot in hidden_w:
            w = op.inputs[slot][0]
            one = 2 * b * t * shape(w)[0] * shape(w)[1]
            total += one * (1 + grad(w) + grad(op.inputs["Input"][0]))
        return total

    return flops


@register_op("lstm", flops=_rnn_flops(("Weight",)))
def lstm(Input, Weight, Bias=None, H0=None, C0=None, Length=None,
         use_peepholes=False, is_reverse=False, gate_activation="sigmoid",
         cell_activation="tanh", candidate_activation="tanh", **_):
    """Full-sequence LSTM: ``Input [b, t, 4d]`` (pre-projected: the input
    product is a separate fc), ``Weight [d, 4d]``, ``Bias [4d]``, or
    ``[7d]`` with peepholes (wi, wf, wo at its tail)."""
    b, t, d4 = Input.shape
    d = d4 // 4
    h = H0 if H0 is not None else Input.new_zeros((b, d))
    c = C0 if C0 is not None else Input.new_zeros((b, d))
    peep = bias = None
    if Bias is not None:
        if use_peepholes and Bias.shape[-1] == 7 * d:
            bias = Bias[..., :4 * d].reshape(4 * d)
            peep = (Bias[..., 4 * d:5 * d].reshape(d),
                    Bias[..., 5 * d:6 * d].reshape(d),
                    Bias[..., 6 * d:].reshape(d))
        else:
            bias = Bias.reshape(-1)
    order, mask = _steps(Input, Length, is_reverse)
    hs, cs = [], []
    for i in order:
        h_new, c_new = lstm_cell(Input[:, i], h, c, Weight, bias, peep,
                                 gate_activation, cell_activation,
                                 candidate_activation)
        m = None if mask is None else mask[:, i]
        h, c = _keep(m, h_new, h), _keep(m, c_new, c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": _stack(hs, is_reverse), "Cell": _stack(cs, is_reverse)}


@register_op("lstmp", flops=_rnn_flops(("Weight", "ProjWeight")))
def lstmp(Input, Weight, ProjWeight, Bias=None, H0=None, C0=None,
          Length=None, use_peepholes=False, is_reverse=False,
          gate_activation="sigmoid", cell_activation="tanh",
          candidate_activation="tanh", proj_activation="identity", **_):
    """LSTM with a recurrent projection: the hidden state is projected
    to ``p`` dims before it recurs.  ``Weight [p, 4d]``, ``ProjWeight
    [d, p]``."""
    b, t, d4 = Input.shape
    d = d4 // 4
    p = ProjWeight.shape[1]
    r = H0 if H0 is not None else Input.new_zeros((b, p))
    c = C0 if C0 is not None else Input.new_zeros((b, d))
    bias = Bias.reshape(-1)[:4 * d] if Bias is not None else None
    peep = None
    if (Bias is not None and use_peepholes
            and Bias.reshape(-1).shape[0] == 7 * d):
        fb = Bias.reshape(-1)
        peep = (fb[4 * d:5 * d], fb[5 * d:6 * d], fb[6 * d:])
    pact = _ACTS[proj_activation]
    order, mask = _steps(Input, Length, is_reverse)
    rs = []
    for i in order:
        h_new, c_new = lstm_cell(Input[:, i], r, c, Weight, bias, peep,
                                 gate_activation, cell_activation,
                                 candidate_activation)
        r_new = pact(torch.matmul(h_new, ProjWeight.to(h_new.dtype)))
        m = None if mask is None else mask[:, i]
        r, c = _keep(m, r_new, r), _keep(m, c_new, c)
        rs.append(r)
    return {"Projection": _stack(rs, is_reverse)}


@register_op("gru", flops=_rnn_flops(("Weight",)))
def gru(Input, Weight, Bias=None, H0=None, Length=None, is_reverse=False,
        gate_activation="sigmoid", activation="tanh", **_):
    """Full-sequence GRU: ``Input [b, t, 3d]``, ``Weight [d, 3d]``."""
    b, t, d3 = Input.shape
    d = d3 // 3
    h = H0 if H0 is not None else Input.new_zeros((b, d))
    bias = Bias.reshape(-1) if Bias is not None else None
    order, mask = _steps(Input, Length, is_reverse)
    hs = []
    for i in order:
        h_new = gru_cell(Input[:, i], h, Weight, bias, gate_activation,
                         activation)
        h = _keep(None if mask is None else mask[:, i], h_new, h)
        hs.append(h)
    return {"Hidden": _stack(hs, is_reverse)}


@register_op("lstm_unit")
def lstm_unit(X, C_prev, forget_bias=0.0, **_):
    """One LSTM step on packed gates ``X [b, 4d]`` (i, f, c, o), sigmoid
    gates and tanh."""
    gi, gf, gc, go = torch.chunk(X, 4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + forget_bias)
    c = f * C_prev + i * torch.tanh(gc)
    h = torch.sigmoid(go) * torch.tanh(c)
    return {"C": c, "H": h}


def _gru_unit_flops(op, shape, grad, train):
    w = op.inputs["Weight"][0]
    b = shape(op.inputs["Input"][0])[0]
    one = 2 * b * shape(w)[0] * shape(w)[1]
    return one * (1 + grad(w) + grad(op.inputs["HiddenPrev"][0]))


@register_op("gru_unit", flops=_gru_unit_flops)
def gru_unit(Input, HiddenPrev, Weight, Bias=None,
             gate_activation="sigmoid", activation="tanh", **_):
    """One GRU step."""
    return {"Hidden": gru_cell(Input, HiddenPrev, Weight, Bias,
                               gate_activation, activation)}


@register_op("nested_rnn")
def nested_rnn(Input, Weight, Bias=None, H0=None, Length=None,
               SubLength=None, gate_activation="sigmoid", activation="tanh",
               **_):
    """Hierarchical GRU over a nested batch ``Input [b, s, t, 3d]``
    (pre-projected gates), ``Weight [d, 3d]``: an inner GRU runs each
    sub-sequence's items booted from the outer state, and the outer state
    moves to the inner state after the sub-sequence's last item (a slot
    past ``Length`` holds it).  So a nested run over a split sequence
    equals a flat GRU over its concatenation.  ``Hidden [b, s, t, d]``
    (padded items hold the carried state), ``OuterHidden [b, s, d]``."""
    b, s, t, d3 = Input.shape
    h = H0 if H0 is not None else Input.new_zeros((b, d3 // 3))
    bias = Bias.reshape(-1) if Bias is not None else None
    dev = Input.device
    if Length is None:
        Length = torch.full((b,), s, dtype=torch.int32, device=dev)
    if SubLength is None:
        SubLength = torch.full((b, s), t, dtype=torch.int32, device=dev)
    outer = torch.arange(s, device=dev)[None, :] < Length[:, None]
    sub = torch.where(outer, SubLength, torch.zeros_like(SubLength))
    inner_hs, outer_hs = [], []
    for j in range(s):
        m = time_mask(sub[:, j], t, Input.dtype)[..., None]
        hs = []
        for i in range(t):
            h_new = gru_cell(Input[:, j, i], h, Weight, bias,
                             gate_activation, activation)
            h = m[:, i] * h_new + (1 - m[:, i]) * h
            hs.append(h)
        inner_hs.append(torch.stack(hs, dim=1))
        outer_hs.append(h)
    return {"Hidden": torch.stack(inner_hs, dim=1),
            "OuterHidden": torch.stack(outer_hs, dim=1)}

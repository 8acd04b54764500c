"""The port's sequence ops against the JAX package's, on the CPU.

Every op of ``paddle_tpu_torch/ops/sequence_ops.py`` on the same seeded
ragged batch in both packages (lengths 5, 1, 3 and 0 of 5 steps, so
padded steps and an empty sequence are compared too): each output
within ORACLE_TOL f32's forward bound (2e-4 of its largest magnitude;
integer outputs equal), and for the differentiable ops the gradient of
every float input under one seeded cotangent within the gradient bound
(1e-3 of its largest magnitude).  The padded steps hold what the
reference writes there, and the LAST pool of an empty row is its first
step, as the reference's clamped index gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from paddle_tpu_torch.ops.sequence_ops import time_mask

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3
B, T, D = 4, 5, 3
LENGTHS = np.array([5, 1, 3, 0], np.int32)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / max(scale, 1e-30))


def _check(op, floats, fixed, attrs, outs, seed=0, diff=True):
    """``op`` in both packages.  ``floats``: ``{slot: array or list of
    arrays}`` (differentiated), ``fixed``: ``{slot: array or list}``."""
    rng = np.random.default_rng(seed + 100)
    slots = sorted(floats)
    leaves = [(s, i) for s in slots for i in range(
        len(floats[s]) if isinstance(floats[s], list) else 1)]

    def pack(vals):
        out, it = {}, iter(vals)
        for s in slots:
            if isinstance(floats[s], list):
                out[s] = [next(it) for _ in floats[s]]
            else:
                out[s] = next(it)
        return out

    def flat(d):
        return [v for s in slots for v in (
            d[s] if isinstance(d[s], list) else [d[s]])]

    def conv_fixed(fn):
        return {k: [fn(x) for x in v] if isinstance(v, list) else fn(v)
                for k, v in fixed.items()}

    fixed_j = conv_fixed(jnp.asarray)

    def jfn(*vals):
        res = jax_op(op).fn(**pack(vals), **fixed_j, **attrs)
        return tuple(res[o] for o in outs)

    jvals = [jnp.asarray(v) for v in flat(floats)]
    if diff:
        want, vjp = jax.vjp(jfn, *jvals)
    else:
        want = jfn(*jvals)
    tvals = [torch.tensor(v, requires_grad=diff and v.dtype.kind == "f")
             for v in flat(floats)]
    res = torch_op(op).fn(**pack(tvals),
                          **conv_fixed(torch.tensor), **attrs)
    got = [res[o] for o in outs]
    for o, g, w in zip(outs, got, want):
        w = np.asarray(w)
        if w.dtype.kind in "iub":
            assert np.array_equal(g.numpy(), w), (op, o)
        else:
            assert _rel(g, w) <= FWD_TOL, (op, o, _rel(g, w))
    if not diff:
        return got
    fouts = [i for i, w in enumerate(want)
             if np.asarray(w).dtype.kind == "f"]
    cots = [rng.standard_normal(np.shape(w)).astype(np.float32)
            if i in fouts else np.zeros(np.shape(w), jax.dtypes.float0)
            for i, w in enumerate(want)]
    want_grads = vjp(tuple(cots))
    total = sum((got[i] * torch.tensor(cots[i])).sum() for i in fouts)
    grads = torch.autograd.grad(total, tvals, allow_unused=True)
    for (s, i), g, w, t in zip(leaves, grads, want_grads, tvals):
        g = torch.zeros_like(t) if g is None else g
        assert _rel(g, w) <= GRAD_TOL, (op, s, i, _rel(g, w))
    return got


def _x(seed, shape=(B, T, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_time_mask():
    m = time_mask(torch.tensor(LENGTHS), T)
    assert m.dtype == torch.float32
    assert m.sum(dim=1).tolist() == LENGTHS.tolist()
    assert time_mask(torch.tensor(LENGTHS), T, torch.bool)[0].all()


@pytest.mark.parametrize("pooltype",
                         ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"])
def test_sequence_pool(pooltype):
    _check("sequence_pool", {"X": _x(1)}, {"Length": LENGTHS},
           {"pooltype": pooltype}, ("Out",), 1)


def test_sequence_pool_without_lengths():
    _check("sequence_pool", {"X": _x(2)}, {}, {"pooltype": "MAX"}, ("Out",))


def test_sequence_pool_max_of_an_empty_row_is_the_floor():
    out = torch_op("sequence_pool").fn(
        X=torch.tensor(_x(3)), Length=torch.tensor(LENGTHS),
        pooltype="MAX")["Out"]
    assert torch.all(out[3] == -1e38)


@pytest.mark.parametrize("lengths", [True, False])
def test_sequence_softmax(lengths):
    got = _check("sequence_softmax", {"X": _x(4, (B, T))},
                 {"Length": LENGTHS} if lengths else {}, {}, ("Out",), 4)
    if lengths:
        pad = ~time_mask(torch.tensor(LENGTHS), T, torch.bool)
        assert torch.all(got[0][pad] == 0)


@pytest.mark.parametrize("ctx_len,ctx_start,lengths", [
    (3, None, True), (3, -2, True), (2, 0, False), (4, None, True)],
    ids=["centered", "start-2", "start0_full", "four"])
def test_sequence_conv(ctx_len, ctx_start, lengths):
    filt = _x(5, (ctx_len * D, 2))
    attrs = {"contextLength": ctx_len}
    if ctx_start is not None:
        attrs["contextStart"] = ctx_start
    _check("sequence_conv", {"X": _x(6), "Filter": filt},
           {"Length": LENGTHS} if lengths else {}, attrs, ("Out",), 5)


def test_sequence_concat():
    ln2 = np.array([2, 3, 0, 1], np.int32)
    _check("sequence_concat", {"X": [_x(7), _x(8, (B, 3, D))]},
           {"Length": [LENGTHS, ln2]}, {}, ("Out", "OutLength"), 7)


def test_sequence_concat_without_lengths_is_a_plain_concat():
    _check("sequence_concat", {"X": [_x(9), _x(10)]}, {}, {"axis": 1},
           ("Out",), 9)


@pytest.mark.parametrize("three_d", [False, True])
def test_sequence_expand(three_d):
    x = _x(11, (B, 1, 2) if three_d else (B, 2))
    _check("sequence_expand", {"X": x},
           {"Y": _x(12), "YLength": LENGTHS}, {}, ("Out",), 11)


def test_sequence_slice():
    _check("sequence_slice", {"X": _x(13)},
           {"Offset": np.array([[1], [0], [2], [4]], np.int64),
            "SeqLength": np.array([[3], [1], [2], [1]], np.int64)},
           {}, ("Out", "OutLength"), 13)


@pytest.mark.parametrize("lengths", [True, False])
def test_sequence_reverse(lengths):
    _check("sequence_reverse", {"X": _x(14)},
           {"Length": LENGTHS} if lengths else {}, {}, ("Out",), 14)


def test_sequence_reverse_of_int_sub_lengths():
    sub = np.random.default_rng(15).integers(0, 5, (B, T)).astype(np.int32)
    _check("sequence_reverse", {}, {"X": sub, "Length": LENGTHS}, {},
           ("Out",), diff=False)


@pytest.mark.parametrize("lengths", [True, False])
def test_sequence_erase(lengths):
    x = np.random.default_rng(16).integers(0, 4, (B, T)).astype(np.int64)
    _check("sequence_erase", {}, dict({"X": x}, **(
        {"Length": LENGTHS} if lengths else {})), {"tokens": (0, 2)},
        ("Out", "OutLength"), diff=False)


@pytest.mark.parametrize("new_dim,lengths", [(1, True), (15, True),
                                             (5, False)])
def test_sequence_reshape(new_dim, lengths):
    _check("sequence_reshape", {"X": _x(17)},
           {"Length": LENGTHS} if lengths else {}, {"new_dim": new_dim},
           ("Out", "OutLength"), 17)


def test_sequence_scale():
    _check("sequence_scale", {"X": _x(18), "Scales": _x(19, (B,))},
           {"Length": LENGTHS}, {}, ("Out",), 18)

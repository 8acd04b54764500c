"""The port's recurrent ops against the JAX package's, on the CPU.

``lstm`` (peepholes on and off, ``is_reverse``, ``H0``/``C0``, ragged
lengths, other activations), ``lstmp``, ``gru`` (``H0``, ``is_reverse``,
lengths), ``lstm_unit`` and ``gru_unit`` run on the same seeded numpy
inputs in both packages: every output within ORACLE_TOL f32's forward
bound (2e-4 of its largest magnitude), and the gradient of every input
and weight under one seeded cotangent within the gradient bound (1e-3 of
the gradient's largest magnitude).  A sample's steps past its length
keep its state, so those rows are compared too.
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
B, T, D = 3, 6, 4
LENGTHS = np.array([6, 2, 4], np.int32)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / max(scale, 1e-30))


def _check(op, floats, fixed, attrs, outs, seed):
    """``op`` in both packages on the float inputs ``floats`` (differen-
    tiated) and ``fixed`` (lengths): each output of ``outs`` forward,
    then the gradient of every float input under seeded cotangents."""
    rng = np.random.default_rng(seed + 100)
    names = sorted(floats)

    def jfn(*vals):
        res = jax_op(op).fn(**dict(zip(names, vals)), **fixed_j, **attrs)
        return tuple(res[o] for o in outs)

    fixed_j = {k: jnp.asarray(v) for k, v in fixed.items()}
    want, vjp = jax.vjp(jfn, *[jnp.asarray(floats[n]) for n in names])
    cots = [rng.standard_normal(np.shape(w)).astype(np.float32)
            for w in want]
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))

    ts = {n: torch.tensor(floats[n], requires_grad=True) for n in names}
    res = torch_op(op).fn(**ts, **{k: torch.tensor(v)
                                   for k, v in fixed.items()}, **attrs)
    got = [res[o] for o in outs]
    for o, g, w in zip(outs, got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= FWD_TOL, (op, o, _rel(g, w))
    total = sum((g * torch.tensor(c)).sum() for g, c in zip(got, cots))
    grads = torch.autograd.grad(total, [ts[n] for n in names],
                                allow_unused=True)
    for n, g, w in zip(names, grads, want_grads):
        g = torch.zeros_like(ts[n]) if g is None else g
        assert _rel(g, w) <= GRAD_TOL, (op, n, _rel(g, w))


def _inputs(seed, width, h0=(), bias=None, extra=()):
    rng = np.random.default_rng(seed)
    out = {"Input": rng.standard_normal((B, T, width)).astype(np.float32),
           "Weight": (0.5 * rng.standard_normal((D, width))
                      ).astype(np.float32)}
    for n in h0:
        out[n] = rng.standard_normal((B, D)).astype(np.float32)
    if bias is not None:
        out["Bias"] = (0.3 * rng.standard_normal((1, bias))
                       ).astype(np.float32)
    for n, shape in extra:
        out[n] = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return out


LSTM_CASES = {
    "plain_ragged": dict(peep=False, reverse=False, lengths=True, h0=False),
    "peep_reverse_h0_ragged": dict(peep=True, reverse=True, lengths=True,
                                   h0=True),
    "peep_full": dict(peep=True, reverse=False, lengths=False, h0=False),
    "reverse_h0_full": dict(peep=False, reverse=True, lengths=False,
                            h0=True),
    "other_activations": dict(peep=True, reverse=False, lengths=True,
                              h0=True, acts=dict(
                                  gate_activation="sigmoid",
                                  cell_activation="relu",
                                  candidate_activation="identity")),
}


@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_op(case):
    c = LSTM_CASES[case]
    floats = _inputs(1, 4 * D, h0=("H0", "C0") if c["h0"] else (),
                     bias=7 * D if c["peep"] else 4 * D)
    fixed = {"Length": LENGTHS} if c["lengths"] else {}
    attrs = dict(use_peepholes=c["peep"], is_reverse=c["reverse"],
                 **c.get("acts", {}))
    _check("lstm", floats, fixed, attrs, ("Hidden", "Cell"), 1)


@pytest.mark.parametrize("peep,reverse,proj_act", [
    (False, False, "identity"), (True, True, "tanh")],
    ids=["plain", "peep_reverse_tanh"])
def test_lstmp_op(peep, reverse, proj_act):
    p = 3
    rng_floats = _inputs(2, 4 * D, bias=7 * D if peep else 4 * D,
                         extra=(("ProjWeight", (D, p)), ("H0", (B, p)),
                                ("C0", (B, D))))
    rng_floats["Weight"] = (0.5 * np.random.default_rng(3).standard_normal(
        (p, 4 * D))).astype(np.float32)
    _check("lstmp", rng_floats, {"Length": LENGTHS},
           dict(use_peepholes=peep, is_reverse=reverse,
                proj_activation=proj_act), ("Projection",), 2)


@pytest.mark.parametrize("h0,reverse,lengths", [
    (False, False, True), (True, True, True), (True, False, False),
    (False, True, False)],
    ids=["ragged", "h0_reverse_ragged", "h0_full", "reverse_full"])
def test_gru_op(h0, reverse, lengths):
    floats = _inputs(4, 3 * D, h0=("H0",) if h0 else (), bias=3 * D)
    fixed = {"Length": LENGTHS} if lengths else {}
    _check("gru", floats, fixed, dict(is_reverse=reverse), ("Hidden",), 4)


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_op(forget_bias):
    rng = np.random.default_rng(5)
    floats = {"X": rng.standard_normal((B, 4 * D)).astype(np.float32),
              "C_prev": rng.standard_normal((B, D)).astype(np.float32)}
    _check("lstm_unit", floats, {}, dict(forget_bias=forget_bias),
           ("C", "H"), 5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_gru_unit_op(bias):
    rng = np.random.default_rng(6)
    floats = {"Input": rng.standard_normal((B, 3 * D)).astype(np.float32),
              "HiddenPrev": rng.standard_normal((B, D)).astype(np.float32),
              "Weight": (0.5 * rng.standard_normal((D, 3 * D))
                         ).astype(np.float32)}
    if bias:
        floats["Bias"] = (0.3 * rng.standard_normal((1, 3 * D))
                          ).astype(np.float32)
    _check("gru_unit", floats, {}, {}, ("Hidden",), 6)


def test_padded_steps_keep_the_state():
    """Past a sample's length the hidden state repeats the last valid
    step's (forward), and before the first valid one it stays at H0
    (reversed)."""
    floats = _inputs(7, 3 * D, h0=("H0",), bias=3 * D)
    ts = {k: torch.tensor(v) for k, v in floats.items()}
    ln = torch.tensor(LENGTHS)
    fwd = torch_op("gru").fn(**ts, Length=ln)["Hidden"]
    rev = torch_op("gru").fn(**ts, Length=ln, is_reverse=True)["Hidden"]
    for b, n in enumerate(LENGTHS):
        assert torch.equal(fwd[b, n:], fwd[b, n - 1:n].expand(T - n, D))
        assert torch.equal(rev[b, n:], ts["H0"][b].expand(T - n, D))


def test_recurrent_ops_count_their_products():
    """The flops hooks: 2 b t |W| a recurrent product, three times in a
    training step where the weight and the input take gradients."""
    from paddle_tpu_torch.core.program import OpDesc

    shapes = {"x": [B, T, 4 * D], "w": [D, 4 * D], "g": [B, T, 3 * D],
              "u": [D, 3 * D], "p": [D, 2], "wp": [2, 4 * D],
              "xu": [B, 3 * D], "h": [B, D]}

    def count(op_type, ins):
        op = OpDesc(op_type, ins, {}, {})
        return torch_op(op_type).flops(op, lambda n: shapes[n],
                                       lambda n: True, True)

    assert count("lstm", {"Input": ["x"], "Weight": ["w"]}) == (
        3 * 2 * B * T * D * 4 * D)
    assert count("gru", {"Input": ["g"], "Weight": ["u"]}) == (
        3 * 2 * B * T * D * 3 * D)
    assert count("lstmp", {"Input": ["x"], "Weight": ["wp"],
                           "ProjWeight": ["p"]}) == (
        3 * 2 * B * T * (2 * 4 * D + D * 2))
    assert count("gru_unit", {"Input": ["xu"], "HiddenPrev": ["h"],
                              "Weight": ["u"]}) == 3 * 2 * B * D * 3 * D

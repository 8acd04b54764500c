"""Registered op types that no model test reaches directly, each alone in
the port against the JAX package's op on the CPU: ``assign``,
``elementwise_min`` / ``elementwise_pow`` (with the ``axis`` broadcast),
the six compares, ``exp``, ``floor``, ``reciprocal``, ``reshape`` (with
``0`` and ``-1`` dims), ``sqrt``; and the plain ops of the beam decode
and the book models: ``log``, ``square``, the ``reduce_*`` family,
``logical_*``, ``expand``, ``one_hot``, ``fill_constant_batch_size_like``
and ``matmul`` (transposes, ``alpha``, batched and broadcast operands).

Inputs are random f32 (or bool / int) arrays from a numpy seed.  Each
case's outputs have the reference's shapes and dtypes; ints and bools
are equal, floats within ORACLE_TOL f32's forward bound (2e-4 of the
largest), and the gradient of every float input a float output depends
on, under one seeded cotangent, within the gradient bound (1e-3 of the
largest).
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

_COMPARES = ["less_than", "less_equal", "greater_than", "greater_equal",
             "equal", "not_equal"]


def _case(name, rng):
    """``(op type, inputs, attrs)`` of one case."""
    def f(*shape, lo=None):
        x = rng.normal(size=shape).astype(np.float32)
        return np.abs(x) + lo if lo is not None else x

    if name == "assign":
        return "assign", {"X": f(3, 4)}, {}
    if name == "elementwise_min":
        return name, {"X": f(2, 3, 4), "Y": f(3)}, {"axis": 1}
    if name == "elementwise_pow":
        return name, {"X": f(3, 4, lo=0.5), "Y": f(4)}, {}
    if name in _COMPARES:
        x = np.round(f(4, 5), 1)
        y = x.copy()
        y[::2] = np.round(f(2, 5), 1)              # equal and unequal entries
        return name, {"X": x, "Y": y}, {}
    if name in ("exp", "floor", "square"):
        return name, {"X": f(3, 5) * 2}, {}
    if name in ("reciprocal", "sqrt", "log"):
        return name, {"X": f(3, 5, lo=0.2)}, {}
    if name.startswith("reshape"):
        shape = {"reshape_zero": [0, -1], "reshape_minus1": [-1, 4, 3],
                 "reshape_zero_minus1": [0, 3, -1]}[name]
        return "reshape", {"X": f(2, 6, 2)}, {"shape": shape}
    if name.startswith("reduce_"):
        op, how = name.rsplit("_", 1) if name.count("_") > 1 else (name, "")
        attrs = {"all": {"reduce_all": True},
                 "keep": {"dim": [0, 2], "keep_dim": True},
                 "neg": {"dim": -1}}.get(how, {"dim": 1})
        x = f(3, 4, 2, lo=0.5) if op == "reduce_prod" else f(3, 4, 2)
        return op, {"X": x}, attrs
    if name.startswith("logical_"):
        x, y = rng.random((3, 4)) < 0.5, rng.random((3, 4)) < 0.5
        return name, ({"X": x} if name == "logical_not" else
                      {"X": x, "Y": y}), {}
    if name == "expand":
        return "expand", {"X": f(2, 1, 3)}, {"expand_times": [2, 3, 1]}
    if name.startswith("one_hot"):
        ids = rng.integers(-1, 6, (4, 1) if name == "one_hot_trailing1"
                           else (2, 3)).astype(np.int32)  # -1, 5: zero rows
        return "one_hot", {"X": ids}, {"depth": 5}
    if name.startswith("fill_constant_batch_size_like"):
        dtype = name.rsplit("_", 1)[1]
        return ("fill_constant_batch_size_like", {"Input": f(7, 3)},
                {"shape": [4, 1, 2], "dtype": dtype, "value": 3.0,
                 "input_dim_idx": 0, "output_dim_idx": 1})
    if name.startswith("matmul"):
        xs, ys, attrs = {
            "matmul": ([3, 4], [4, 5], {}),
            "matmul_transpose_x": ([4, 3], [4, 5], {"transpose_X": True}),
            "matmul_transpose_y_alpha": ([3, 4], [5, 4],
                                         {"transpose_Y": True,
                                          "alpha": 0.25}),
            "matmul_batched_both": ([2, 4, 3], [2, 5, 4],
                                    {"transpose_X": True,
                                     "transpose_Y": True, "alpha": -2.0}),
            "matmul_broadcast": ([2, 3, 4], [4, 5], {}),
        }[name]
        return "matmul", {"X": f(*xs), "Y": f(*ys)}, attrs
    raise KeyError(name)


CASES = (["assign", "elementwise_min", "elementwise_pow"] + _COMPARES
         + ["exp", "floor", "reciprocal", "reshape_zero", "reshape_minus1",
            "reshape_zero_minus1", "sqrt", "log", "square"]
         + [f"reduce_{op}{how}" for op in ("sum", "mean", "max", "min",
                                           "prod")
            for how in ("", "_all", "_keep", "_neg")]
         + ["logical_and", "logical_or", "logical_xor", "logical_not",
            "expand", "one_hot", "one_hot_trailing1",
            "fill_constant_batch_size_like_float32",
            "fill_constant_batch_size_like_int64",
            "fill_constant_batch_size_like_bool",
            "matmul", "matmul_transpose_x", "matmul_transpose_y_alpha",
            "matmul_batched_both", "matmul_broadcast"])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", CASES)
def test_op_matches_the_reference(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    op, ins, attrs = _case(name, rng)
    floats = sorted(n for n, v in ins.items() if v.dtype == np.float32)
    others = {n: v for n, v in ins.items() if n not in floats}
    out_slot = "Out"

    def jfn(*vals):
        res = jax_op(op).fn(**dict(zip(floats, vals)),
                            **{k: jnp.asarray(v) for k, v in others.items()},
                            **attrs)
        return res[out_slot]

    jins = [jnp.asarray(ins[n]) for n in floats]
    want = jfn(*jins)
    tins = {n: torch.tensor(ins[n]).requires_grad_() for n in floats}
    got = torch_op(op).fn(**tins, **{k: torch.tensor(v)
                                     for k, v in others.items()},
                          **attrs)[out_slot]
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype,
                                                             want.dtype)
    if not got.is_floating_point():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    assert _rel(got.detach().numpy(), want) <= FWD_TOL
    if not got.requires_grad:      # an output no float input reaches
        return
    cot = np.random.default_rng(7).standard_normal(want.shape).astype(
        np.float32)
    _, vjp = jax.vjp(jfn, *jins)
    want_grads = vjp(jnp.asarray(cot))
    grads = torch.autograd.grad((got * torch.tensor(cot)).sum(),
                                [tins[n] for n in floats], allow_unused=True)
    for n, g, w in zip(floats, grads, want_grads):
        g = torch.zeros_like(tins[n]) if g is None else g
        assert _rel(g.numpy(), w) <= GRAD_TOL, n

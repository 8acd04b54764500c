"""The tensor and activation ops of the op long tail, each alone in the
port against the JAX package's op on the CPU.

* The 15 tensor ops: ``fill_zeros_like``, ``assign_value``, ``shape``,
  ``transpose``, ``split`` (a list under ``Out``: equal pieces, sized
  sections, and a piece nobody reads, whose cotangent is zeros),
  ``gather`` (a repeated index adds its rows' gradients), ``scatter``
  (overwrite with duplicate ids: the last id wins, and only it gets a
  gradient; add), ``pad``, ``crop`` (``-1`` extents, ``Y``'s shape),
  ``multiplex``, ``embedding_grad_rows``, ``arg_min`` (a tie),
  ``is_empty``, ``isfinite`` (a list, an ``inf``) and
  ``scale_sub_region``.
* The 20 activations, each on random inputs with its kinks among them:
  ``abs`` at 0, the clips (``relu6``, ``brelu``, ``hard_sigmoid``,
  ``soft_relu``) at their edges, ``hard_shrink`` / ``softshrink`` /
  ``thresholded_relu`` at their thresholds, ``round`` at halves,
  ``ceil`` at integers, ``leaky_relu``, ``elu`` and ``prelu`` at 0,
  ``softplus`` where ``F.softplus`` would turn linear.

Inputs come from a numpy seed.  Each output has the reference's shape
and dtype; ints and bools are equal, floats within ORACLE_TOL f32's
forward bound (2e-4 of the largest), and the gradient of every float
input, under one seeded cotangent an output, within the gradient bound
(1e-3 of the largest).  At a kink the two gradients differ by half or
all of the cotangent, so the bound tells them apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.executor import LoweringCtx
from paddle_tpu_torch.core.registry import get_op_impl as torch_op

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3

# activation -> (attrs, the kinks put among its random inputs, the scale
# of those inputs)
ACTIVATIONS = {
    "abs": ({}, [0.0], 1.0),
    "brelu": ({"t_min": 1.0, "t_max": 5.0}, [1.0, 5.0], 4.0),
    "ceil": ({}, [1.0, -2.0, 0.0], 3.0),
    "elu": ({"alpha": 0.7}, [0.0], 1.0),
    "hard_shrink": ({"threshold": 0.5}, [0.5, -0.5], 1.0),
    "hard_sigmoid": ({}, [-2.5, 2.5], 3.0),
    "leaky_relu": ({"alpha": 0.1}, [0.0], 1.0),
    "log_softmax": ({}, [], 2.0),
    "logsigmoid": ({}, [0.0], 3.0),
    "relu6": ({}, [0.0, 6.0], 5.0),
    "round": ({}, [0.5, 1.5, 2.5, -0.5, -1.5], 3.0),
    "soft_relu": ({"threshold": 4.0}, [4.0, -4.0], 5.0),
    "softplus": ({}, [0.0, 30.0, -30.0], 3.0),
    "softshrink": ({"lambda": 0.25}, [0.25, -0.25], 1.0),
    "softsign": ({}, [0.0], 2.0),
    "stanh": ({"scale_a": 0.5, "scale_b": 1.5}, [0.0], 2.0),
    "swish": ({"beta": 1.5}, [0.0], 2.0),
    "tanh_shrink": ({}, [0.0], 2.0),
    "thresholded_relu": ({"threshold": 1.0}, [1.0], 2.0),
}


def _case(name, rng):
    """``(op type, float inputs, other inputs, attrs, output slot)``; a
    float input may be a list of arrays (a slot of several vars)."""
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def ints(hi, *shape):
        return rng.integers(0, hi, shape).astype(np.int32)

    if name in ACTIVATIONS:
        attrs, kinks, scale = ACTIVATIONS[name]
        x = scale * f(4, 6)
        x.reshape(-1)[:len(kinks)] = kinks
        return name, {"X": x}, {}, attrs, "Out"
    if name == "prelu":
        x = f(3, 5)
        x[0, :2] = 0.0
        return "prelu", {"X": x, "Alpha": np.array([0.3], np.float32)}, {}, \
            {}, "Out"
    if name == "fill_zeros_like":
        return name, {"X": f(3, 4)}, {}, {}, "Out"
    if name.startswith("assign_value"):
        dtype = name.rsplit("_", 1)[1]
        return "assign_value", {}, {}, {
            "shape": [2, 3], "dtype": dtype,
            "values": [1.5, -2.0, 3.25, 0.0, 7.0, -1.0]
            if dtype == "float32" else [1, -2, 3, 0, 7, -1]}, "Out"
    if name == "shape":
        return "shape", {"Input": f(2, 3, 4)}, {}, {}, "Out"
    if name == "transpose":
        return name, {"X": f(2, 3, 4)}, {}, {"axis": [2, 0, 1]}, "Out"
    if name.startswith("split"):
        attrs = ({"sections": [1, 3, 2], "axis": 1}
                 if name == "split_sections" else {"num": 3, "axis": 1})
        return "split", {"X": f(2, 6, 4)}, {}, attrs, "Out"
    if name == "gather":
        return name, {"X": f(5, 3)}, {"Index": np.array([3, 0, 3, 4],
                                                        np.int32)}, {}, "Out"
    if name.startswith("scatter"):
        ids = np.array([1, 3, 1, 0, 1], np.int32)    # id 1 three times
        return "scatter", {"X": f(5, 3), "Updates": f(5, 3)}, {"Ids": ids}, \
            {"overwrite": name == "scatter"}, "Out"
    if name == "pad":
        return name, {"X": f(2, 3)}, {}, {"paddings": [1, 0, 2, 1],
                                          "pad_value": 0.5}, "Out"
    if name == "crop":
        return name, {"X": f(4, 5, 6)}, {}, {"offsets": [1, 2, 0],
                                             "shape": [2, -1, 3]}, "Out"
    if name == "crop_like_y":
        return "crop", {"X": f(4, 5, 6), "Y": f(3, 2, 6)}, {}, \
            {"offsets": [1, 1, 0]}, "Out"
    if name == "multiplex":
        return name, {"X": [f(4, 5), f(4, 5), f(4, 5)]}, {
            "Ids": np.array([[1], [0], [2], [1]], np.int32)}, {}, "Out"
    if name == "embedding_grad_rows":
        return name, {"Grad": f(6, 3)}, {"Ids": np.array(
            [[4], [0], [4], [2], [4], [1]], np.int32)}, {"table_height": 5}, \
            "Out"
    if name == "arg_min":
        x = f(3, 5)
        x[0, 1] = x[0, 3] = x[0].min() - 1.0             # a tie: first wins
        return name, {"X": x}, {}, {"axis": 1}, "Out"
    if name.startswith("is_empty"):
        return "is_empty", {"X": f(0, 3) if name == "is_empty" else
                            f(2, 3)}, {}, {}, "Out"
    if name.startswith("isfinite"):
        xs = [f(2, 3), f(4)]
        if name == "isfinite_inf":
            xs[1][2] = np.inf
        return "isfinite", {"X": xs}, {}, {}, "Out"
    if name == "scale_sub_region":
        return name, {"X": f(2, 3, 4, 5)}, {"Indices": np.array(
            [[1, 2, 2, 3, 1, 5], [2, 3, 1, 1, 2, 4]], np.int32)}, \
            {"value": 2.5}, "Out"
    raise KeyError(name)


TENSOR_CASES = [
    "fill_zeros_like", "assign_value_float32", "assign_value_int32", "shape",
    "transpose", "split", "split_sections", "split_unused", "gather",
    "scatter", "scatter_add", "pad", "crop", "crop_like_y", "multiplex",
    "embedding_grad_rows", "arg_min", "is_empty", "is_empty_not",
    "isfinite", "isfinite_inf", "scale_sub_region",
]
CASES = TENSOR_CASES + sorted(ACTIVATIONS) + ["prelu"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(floats):
    """``[(slot, index or None, array)]`` of the float inputs."""
    out = []
    for slot in sorted(floats):
        v = floats[slot]
        if isinstance(v, list):
            out += [(slot, i, a) for i, a in enumerate(v)]
        else:
            out.append((slot, None, v))
    return out


def _assemble(leaves, vals):
    ins = {}
    for (slot, i, _), v in zip(leaves, vals):
        if i is None:
            ins[slot] = v
        else:
            ins.setdefault(slot, []).append(v)
    return ins


@pytest.mark.parametrize("name", CASES)
def test_op_matches_the_reference(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    op, floats, others, attrs, slot = _case(name, rng)
    leaves = _leaves(floats)
    # split_unused: the middle piece takes no cotangent
    used = (lambda outs: [outs[0], outs[2]]) if name == "split_unused" \
        else (lambda outs: outs)

    def jfn(*vals):
        res = jax_op(op).fn(**_assemble(leaves, vals),
                            **{k: jnp.asarray(v) for k, v in others.items()},
                            **attrs)[slot]
        return used(res) if isinstance(res, list) else res

    jins = [jnp.asarray(a) for _, _, a in leaves]
    want = jfn(*jins)
    tins = [torch.tensor(a).requires_grad_() for _, _, a in leaves]
    extra = ({"_ctx": LoweringCtx(torch.device("cpu"), None)}
             if "_ctx" in torch_op(op).params else {})
    got = torch_op(op).fn(**_assemble(leaves, tins),
                          **{k: torch.tensor(v) for k, v in others.items()},
                          **attrs, **extra)[slot]
    got = used(got) if isinstance(got, list) else got
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        assert tuple(g.shape) == tuple(w.shape), (g.shape, w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype,
                                                             w.dtype)
        if not g.is_floating_point():
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif g.numel():
            assert _rel(g.detach().numpy(), w) <= FWD_TOL
    diff = [g for g in gots if g.is_floating_point() and g.requires_grad]
    if not diff:                   # no float input reaches an output
        return
    cots = [np.random.default_rng(7 + i).standard_normal(w.shape).astype(
        np.float32) for i, w in enumerate(wants)]
    _, vjp = jax.vjp(jfn, *jins)
    want_grads = vjp([jnp.asarray(c) for c in cots]
                     if isinstance(want, list) else jnp.asarray(cots[0]))
    total = sum((g * torch.tensor(c)).sum() for g, c in zip(gots, cots)
                if g.requires_grad)
    grads = torch.autograd.grad(total, tins, allow_unused=True)
    for (s, i, _), t, g, w in zip(leaves, tins, grads, want_grads):
        g = torch.zeros_like(t) if g is None else g
        assert _rel(g.numpy(), w) <= GRAD_TOL, (s, i, _rel(g.numpy(), w))


def test_scatter_last_duplicate_wins_and_takes_the_gradient():
    x = torch.zeros(4, 2, requires_grad=True)
    upd = torch.arange(10.0).reshape(5, 2).requires_grad_()
    out = torch_op("scatter").fn(X=x, Ids=torch.tensor([1, 3, 1, 1, 0]),
                                 Updates=upd)["Out"]
    np.testing.assert_array_equal(out.detach().numpy(),
                                  [[8, 9], [6, 7], [0, 0], [2, 3]])
    gx, gu = torch.autograd.grad(out.sum(), [x, upd])
    np.testing.assert_array_equal(gx.numpy(), [[0, 0], [0, 0], [1, 1],
                                               [0, 0]])
    np.testing.assert_array_equal(gu.numpy(), [[0, 0], [1, 1], [0, 0],
                                               [1, 1], [1, 1]])


def test_prelu_refuses_a_channel_wise_alpha():
    with pytest.raises(ValueError, match="single scalar"):
        torch_op("prelu").fn(X=torch.zeros(2, 3), Alpha=torch.ones(3))


def test_split_refuses_an_uneven_num():
    with pytest.raises(ValueError, match="equal pieces"):
        torch_op("split").fn(X=torch.zeros(2, 5), num=2, axis=1)


@pytest.mark.parametrize("name", ["abs", "relu6", "brelu", "hard_sigmoid"])
def test_kink_gradient_is_the_references(name):
    """At a kink JAX's gradient is not autograd's of the obvious spelling:
    ``abs`` passes the cotangent at 0, a clip half of it at an edge."""
    attrs, kinks, _ = ACTIVATIONS[name]
    x = torch.tensor(kinks, requires_grad=True)
    out = torch_op(name).fn(X=x, **attrs)["Out"]
    (g,) = torch.autograd.grad(out.sum(), [x])
    want = {"abs": [1.0], "relu6": [0.5, 0.5], "brelu": [0.5, 0.5],
            "hard_sigmoid": [0.1, 0.1]}[name]
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)

"""The 27 op types the v1 layer DSL reaches, each alone in the port
against the JAX package's op on the CPU: ``conv3d``, ``conv_shift``,
``pool3d``, ``spp``, ``im2sequence``, ``bilinear_interp``; the losses
``sigmoid_cross_entropy_with_logits``, ``smooth_l1_loss``, ``huber_loss``,
``modified_huber_loss``, ``nce``, ``hierarchical_sigmoid``;
``bilinear_tensor_product``, ``dot``, ``maxout``, ``selective_fc``; the
metrics ``precision_recall``, ``positive_negative_pair``, ``chunk_eval``;
``sampling_id``; ``print``; ``cross_entropy_over_beam``; the nested
sequences ``nested_sequence_pool`` / ``_expand`` / ``_slice``,
``sub_nested_seq`` and ``nested_rnn``.  Plus the registry's count: the
port registers every type of the reference but the 20 still to port.

Inputs come from a numpy seed.  Every output slot of the reference's op
has the reference's shape and dtype; ints and bools are equal, floats
within ORACLE_TOL f32's forward bound (2e-4 of the largest), and the
gradient of every float input, under one seeded cotangent on each float
output, within the gradient bound (1e-3 of the largest).

``nce`` and ``sampling_id`` draw inside the op, with threefry in the
reference and the step's ``torch.Generator`` in the port.  ``nce``'s
cost and logits are held as a function of the port's drawn ids: the
reference's op runs with its ``randint`` returning them.  The draws
themselves are held by distribution tests in ``test_torch_sampling.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.core.registry import registered_ops as jax_ops
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from paddle_tpu_torch.core.registry import registered_ops as torch_ops
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3

# the reference's op types the port does not register yet (ROADMAP A9)
NOT_PORTED = {
    "conv2d_transpose", "conv3d_transpose", "depthwise_conv2d",
    "max_pool2d_with_index", "unpool",
    "hinge_loss", "log_loss", "margin_rank_loss", "rank_loss",
    "l1_norm", "minus", "norm", "squared_l2_distance",
    "conditional_block", "feed", "fetch",
    "random_crop", "truncated_gaussian_random",
    "load", "save",
}


def _f(rng, *shape, lo=None):
    x = rng.normal(size=shape).astype(np.float32)
    return np.abs(x) + lo if lo is not None else x


def _labels(rng, b, t, n_types, n_tags, lens):
    """Chunk tags: mostly inside some chunk, some outside (the label
    ``n_types * n_tags``), padding past each row's length."""
    lab = rng.integers(0, n_types * n_tags + 1, (b, t))
    for i, ln in enumerate(lens):
        lab[i, ln:] = rng.integers(0, n_types * n_tags + 1, t - ln)
    return lab.astype(np.int64)


def _beam(rng, fall_at, b=3):
    """Three expansions: scores [b, R, L], ids [b, R, B] (-1 padded, the
    rows of e+1 = the valid candidates of e), gold [b]; the gold stays
    on the beam to the end, or falls off at expansion ``fall_at``."""
    shapes = [(1, 6, 3), (3, 5, 2), (6, 4, 2)]
    scores, ids, gold = [], [], []
    for e, (r, ln, k) in enumerate(shapes):
        scores.append(_f(rng, b, r, ln))
        sel = np.stack([np.stack([rng.permutation(ln)[:k] for _ in range(r)])
                        for _ in range(b)]).astype(np.int64)
        if e == 1:
            sel[:, 2, 1] = -1                       # a padded slot
        ids.append(sel)
        g = sel[:, 0, 0].copy()
        if e == fall_at:
            g = np.array([next(c for c in range(ln) if c not in sel[i, 0])
                          for i in range(b)])
        gold.append(g.astype(np.int64))
    return scores, ids, gold


def _nested(rng, feat=(3,)):
    b, s, t = 3, 4, 5
    x = _f(rng, b, s, t, *feat)
    length = np.array([4, 2, 3], np.int32)
    sub = np.array([[5, 2, 1, 3], [3, 5, 0, 0], [1, 4, 2, 0]], np.int32)
    return x, length, sub


def _case(name, rng):
    """``(op type, inputs, attrs, float inputs that take no gradient)``.
    A list value is a duplicable slot."""
    f = lambda *s, lo=None: _f(rng, *s, lo=lo)  # noqa: E731
    if name.startswith("conv3d"):
        stride, pad, dil, groups = {
            "conv3d": (1, 0, 1, 1), "conv3d_strided": (2, 1, 1, 1),
            "conv3d_dilated_groups": (1, 1, 2, 2)}[name]
        return "conv3d", {"Input": f(2, 4, 5, 6, 5),
                          "Filter": f(3 * groups, 4 // groups, 3, 2, 3)}, \
            {"strides": [stride] * 3, "paddings": [pad] * 3,
             "dilations": [dil] * 3, "groups": groups}, ()
    if name == "conv_shift":
        return name, {"X": f(3, 7), "Y": f(3, 5)}, {}, ()
    if name.startswith("pool3d"):
        how = name[len("pool3d_"):]
        attrs = {"ksize": [2, 3, 2], "strides": [2, 2, 1],
                 "paddings": [1, 1, 0], "pooling_type": how.split("_")[0]}
        if how.endswith("ceil"):
            attrs["ceil_mode"] = True
        if how.endswith("incl"):
            attrs["exclusive"] = False
        if how.endswith("global"):
            attrs["global_pooling"] = True
        return "pool3d", {"X": f(2, 3, 5, 7, 6)}, attrs, ()
    if name.startswith("spp"):
        kind, h, w = {"spp_max": ("max", 8, 8), "spp_avg": ("avg", 8, 8),
                      "spp_max_odd": ("max", 7, 5),
                      "spp_avg_odd": ("avg", 5, 11)}[name]
        return "spp", {"X": f(2, 3, h, w)}, {"pyramid_height": 3,
                                             "pooling_type": kind}, ()
    if name.startswith("im2sequence"):
        attrs = {"im2sequence": {"kernels": [2, 2], "strides": [2, 2]},
                 "im2sequence_padded": {"kernels": [2, 3], "strides": [1, 2],
                                        "paddings": [1, 0, 2, 1]},
                 "im2sequence_pad2": {"kernels": [3, 3], "strides": [2, 1],
                                      "paddings": [1, 1]}}[name]
        return "im2sequence", {"X": f(2, 3, 6, 7)}, attrs, ()
    if name.startswith("bilinear_interp"):
        (h, w), (oh, ow) = {
            "bilinear_interp": ((4, 6), (8, 12)),
            "bilinear_interp_odd": ((5, 3), (7, 4)),
            "bilinear_interp_out1": ((5, 5), (1, 3)),
            "bilinear_interp_in1": ((1, 4), (3, 6))}[name]
        return "bilinear_interp", {"X": f(2, 3, h, w)}, \
            {"out_h": oh, "out_w": ow}, ()
    if name == "sigmoid_cross_entropy_with_logits":
        return name, {"X": f(4, 5) * 3,
                      "Label": rng.random((4, 5)).astype(np.float32)}, {}, \
            ("Label",)
    if name.startswith("smooth_l1_loss"):
        ins = {"X": f(4, 6), "Y": f(4, 6)}
        if name.endswith("weighted"):
            ins["InsideWeight"] = f(4, 6, lo=0.1)
            ins["OutsideWeight"] = f(4, 6, lo=0.1)
        return "smooth_l1_loss", ins, {"sigma": 1.5}, \
            ("InsideWeight", "OutsideWeight")
    if name == "huber_loss":
        return name, {"X": f(5, 1) * 2, "Y": f(5, 1) * 2}, {"delta": 0.8}, ()
    if name == "modified_huber_loss":
        x = np.array([[-2.5], [-0.5], [0.3], [1.7], [-1.4], [0.9]],
                     np.float32)
        return name, {"X": x, "Y": rng.integers(0, 2, (6, 1)).astype(
            np.float32)}, {}, ("Y",)
    if name.startswith("nce"):
        ins = {"Input": f(4, 6), "Label": rng.integers(0, 12, (4, 1)),
               "Weight": f(12, 6), "Bias": f(12)}
        if name.endswith("weighted"):
            ins["SampleWeight"] = f(4, 1, lo=0.5)
        return "nce", ins, {"num_neg_samples": 5, "num_total_classes": 12}, \
            ("SampleWeight",)
    if name.startswith("hierarchical_sigmoid"):
        c = 6 if name.endswith("6") else 13
        return "hierarchical_sigmoid", {
            "X": f(5, 4), "W": f(c - 1, 4),
            "Label": rng.integers(0, c, (5, 1)), "Bias": f(c - 1)}, \
            {"num_classes": c}, ()
    if name == "bilinear_tensor_product":
        return name, {"X": f(3, 4), "Y": f(3, 5), "Weight": f(6, 4, 5),
                      "Bias": f(6)}, {}, ()
    if name == "dot":
        return name, {"X": f(4, 7), "Y": f(4, 7)}, {}, ()
    if name == "maxout":
        return name, {"X": f(2, 6, 3, 4)}, {"groups": 3}, ()
    if name.startswith("selective_fc"):
        ins = {"X": f(4, 5), "W": f(9, 5), "Bias": f(9)}
        if name.endswith("select"):
            sel = rng.integers(0, 9, (4, 3))
            sel[1, 2] = sel[3, 0] = -1
            ins["Select"] = sel
        return "selective_fc", ins, {}, ()
    if name.startswith("precision_recall"):
        ins = {"Indices": rng.integers(0, 4, (20, 1)),
               "Labels": rng.integers(0, 4, (20, 1))}
        if name.endswith("weighted"):
            ins["Weights"] = rng.integers(1, 4, (20, 1)).astype(np.float32)
            ins["StatesInfo"] = rng.integers(0, 9, (4, 4)).astype(np.float32)
        return "precision_recall", ins, {"class_number": 4}, \
            ("Weights", "StatesInfo")
    if name.startswith("positive_negative_pair"):
        ins = {"Score": np.round(f(24, 1), 1),       # ties: neutral pairs
               "Label": rng.integers(0, 3, (24, 1)).astype(np.float32),
               "QueryID": rng.integers(0, 4, (24, 1))}
        if name.endswith("accum"):
            for k, v in (("Positive", 3.0), ("Negative", 2.0),
                         ("Neutral", 1.0)):
                ins[f"Accumulate{k}Pair"] = np.array([v], np.float32)
        return "positive_negative_pair", ins, {}, tuple(ins)
    if name.startswith("chunk_eval"):
        scheme = name.split("_")[2]
        n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
        lens = np.array([12, 7, 10, 1])
        inf = _labels(rng, 4, 12, 3, n_tags, lens)
        lab = inf.copy()
        flip = rng.random(lab.shape) < 0.3
        lab[flip] = _labels(rng, 4, 12, 3, n_tags, lens)[flip]
        attrs = {"num_chunk_types": 3, "chunk_scheme": scheme}
        if name.endswith("excluded"):
            attrs["excluded_chunk_types"] = (1,)
        return "chunk_eval", {"Inference": inf, "Label": lab,
                              "Length": lens}, attrs, ()
    if name.startswith("cross_entropy_over_beam"):
        fall = {"": None, "_fall0": 0, "_fall1": 1, "_fall2": 2}[
            name[len("cross_entropy_over_beam"):]]
        scores, ids, gold = _beam(rng, fall)
        return "cross_entropy_over_beam", {"Scores": scores, "Ids": ids,
                                           "Gold": gold}, {}, ()
    if name.startswith("nested_sequence_pool"):
        x, length, sub = _nested(rng)
        return "nested_sequence_pool", {"X": x, "Length": length,
                                        "SubLength": sub}, \
            {"pooltype": name.rsplit("_", 1)[1].upper()}, ()
    if name == "nested_sequence_expand":
        y, length, sub = _nested(rng)
        return name, {"X": f(3, 4, 2), "Y": y, "Length": length,
                      "SubLength": sub}, {}, ("Y",)
    if name == "nested_sequence_slice":
        x, length, sub = _nested(rng)
        return name, {"X": x, "Offset": np.array([1, 0, 2]),
                      "Size": np.array([2, 3, 2]), "Length": length,
                      "SubLength": sub}, {}, ()
    if name == "sub_nested_seq":
        x, length, sub = _nested(rng)
        idx = np.array([[2, 0, -1], [1, 3, 0], [0, 2, 1]])
        return name, {"X": x, "Indices": idx, "Length": length,
                      "SubLength": sub}, {}, ()
    if name == "nested_rnn":
        x, length, sub = _nested(rng, feat=(6,))
        return name, {"Input": x, "Weight": f(2, 6) * 0.5, "Bias": f(1, 6),
                      "H0": f(3, 2), "Length": length, "SubLength": sub}, \
            {}, ()
    raise KeyError(name)


CASES = (["conv3d", "conv3d_strided", "conv3d_dilated_groups", "conv_shift",
          "pool3d_max", "pool3d_avg", "pool3d_max_ceil", "pool3d_avg_ceil",
          "pool3d_avg_incl", "pool3d_max_global",
          "spp_max", "spp_avg", "spp_max_odd", "spp_avg_odd",
          "im2sequence", "im2sequence_padded", "im2sequence_pad2",
          "bilinear_interp", "bilinear_interp_odd", "bilinear_interp_out1",
          "bilinear_interp_in1",
          "sigmoid_cross_entropy_with_logits", "smooth_l1_loss",
          "smooth_l1_loss_weighted", "huber_loss", "modified_huber_loss",
          "nce", "nce_weighted", "hierarchical_sigmoid_6",
          "hierarchical_sigmoid_13", "bilinear_tensor_product", "dot",
          "maxout", "selective_fc", "selective_fc_select",
          "precision_recall", "precision_recall_weighted",
          "positive_negative_pair", "positive_negative_pair_accum"]
         + [f"chunk_eval_{s}" for s in ("IOB", "IOE", "IOBES", "plain")]
         + ["chunk_eval_IOB_excluded",
            "cross_entropy_over_beam", "cross_entropy_over_beam_fall0",
            "cross_entropy_over_beam_fall1", "cross_entropy_over_beam_fall2"]
         + [f"nested_sequence_pool_{p}" for p in
            ("sum", "average", "sqrt", "max", "last", "first")]
         + ["nested_sequence_expand", "nested_sequence_slice",
            "sub_nested_seq", "nested_rnn"])


def _rel(got, want):
    """The largest difference over the largest magnitude, over the finite
    entries; a non-finite entry (a max-pool window wholly in the padding
    is ``-inf``) must be the same on both sides."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if not fin.any():
        return 0.0
    got, want = got[fin], want[fin]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _items(ins):
    """``[(slot, index or None, array)]`` of the inputs, list slots
    unrolled."""
    out = []
    for k, v in ins.items():
        if isinstance(v, list):
            out += [(k, i, a) for i, a in enumerate(v)]
        else:
            out.append((k, None, v))
    return out


def _pack(items, vals):
    ins = {}
    for (k, i, _), v in zip(items, vals):
        if i is None:
            ins[k] = v
        else:
            ins.setdefault(k, []).append(v)
    return ins


def _run_both(op, ins, attrs, frozen):
    """The two ops on the same inputs: ``(want, got, jax vjp, torch
    leaves, float input keys, float output slots)``."""
    items = _items(ins)
    diff = [j for j, (k, _, a) in enumerate(items)
            if a.dtype == np.float32 and k not in frozen]
    extra_j, extra_t = {}, {}
    if jax_op(op).stateful_rng:
        extra_j["_key"] = jax.random.PRNGKey(0)
        extra_t["_gen"] = torch.Generator().manual_seed(0)
    t_leaves = [torch.tensor(a).requires_grad_(j in diff)
                for j, (_, _, a) in enumerate(items)]
    got = torch_op(op).fn(**_pack(items, t_leaves), **attrs, **extra_t)
    if op == "nce":                      # the reference on the port's draws
        drawn = jnp.asarray(got["SampleLabels"][:, 1:].numpy())
        real = jax.random.randint
        jax.random.randint = lambda *a, **k: drawn
    try:
        def jfn(*vals):
            jv = [jnp.asarray(a) for (_, _, a) in items]
            for j, v in zip(diff, vals):
                jv[j] = v
            return jax_op(op).fn(**_pack(items, jv), **attrs, **extra_j)

        jfn = jax.jit(jfn)      # one compile, not one a primitive
        if diff:
            want, vjp = jax.vjp(jfn, *[jnp.asarray(items[j][2])
                                       for j in diff])
        else:
            want, vjp = jfn(), None
    finally:
        if op == "nce":
            jax.random.randint = real
    return want, got, vjp, t_leaves, diff


@pytest.mark.parametrize("name", CASES)
def test_op_matches_the_reference(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    op, ins, attrs, frozen = _case(name, rng)
    want, got, vjp, leaves, diff = _run_both(op, ins, attrs, frozen)
    assert set(got) == set(want), (sorted(got), sorted(want))
    float_outs = []
    for slot, w in want.items():
        g = got[slot]
        assert tuple(g.shape) == tuple(w.shape), (slot, g.shape, w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (slot, g.dtype,
                                                            w.dtype)
        if not g.is_floating_point():
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=slot)
            continue
        assert _rel(g.detach().numpy(), w) <= FWD_TOL, slot
        if g.requires_grad:
            float_outs.append(slot)
    if not diff or not float_outs:
        return
    crng = np.random.default_rng(7)
    cots = {s: crng.standard_normal(want[s].shape).astype(np.float32)
            for s in want}
    jcot = {s: (jnp.asarray(cots[s]) if s in float_outs
                else jnp.zeros_like(want[s])
                if jnp.issubdtype(want[s].dtype, jnp.floating)
                else np.zeros(want[s].shape, jax.dtypes.float0))
            for s in want}
    want_grads = vjp(jcot)
    total = sum((got[s] * torch.tensor(cots[s])).sum() for s in float_outs)
    grads = torch.autograd.grad(total, [leaves[j] for j in diff],
                                allow_unused=True)
    for j, g, w in zip(diff, grads, want_grads):
        g = torch.zeros_like(leaves[j]) if g is None else g
        assert _rel(g.numpy(), w) <= GRAD_TOL, (j, _rel(g.numpy(), w))


def test_print_op_prints_and_passes_through(capsys):
    """``print`` in a Program: the value reaches standard output with its
    message and name in both packages, and ``Out`` is the input."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = []
    for pkg, place in ((pt, pt.CPUPlace()), (tpt, tpt.CPUPlace())):
        pkg.core.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            xv = pkg.layers.data("x", shape=[3])
            out = main.global_block().create_var(
                name="x_printed", shape=[-1, 3], dtype="float32")
            main.global_block().append_op(
                type="print", inputs={"In": ["x"]},
                outputs={"Out": [out.name]}, attrs={"message": "probe"})
            y = pkg.layers.scale(out, scale=2.0)
        exe = pkg.Executor(place)
        exe.run(startup)
        (got,) = exe.run(main, feed={"x": x}, fetch_list=[y])
        outs.append(np.asarray(got))
        assert xv is not None
    jax.effects_barrier()
    printed = capsys.readouterr().out
    assert printed.count("probe x =") == 2, printed
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], 2 * x)


def test_the_port_registers_all_but_the_twenty_left():
    """184 of the reference's 204 op types: the difference is exactly the
    20 still to port (ROADMAP A9), and the port has no type of its own."""
    ref, port = set(jax_ops()), set(torch_ops())
    assert ref - port == NOT_PORTED
    assert port <= ref
    assert len(port) == len(ref) - len(NOT_PORTED)


def test_every_new_type_is_named_by_a_case():
    """Each of the 27 op types this file covers has a case here."""
    named = {_case(n, np.random.default_rng(0))[0] for n in CASES}
    named.add("print")
    named.add("sampling_id")            # test_torch_sampling.py
    new = {"conv3d", "conv_shift", "pool3d", "spp", "im2sequence",
           "bilinear_interp", "sigmoid_cross_entropy_with_logits",
           "smooth_l1_loss", "huber_loss", "modified_huber_loss", "nce",
           "hierarchical_sigmoid", "bilinear_tensor_product", "dot",
           "maxout", "selective_fc", "precision_recall",
           "positive_negative_pair", "chunk_eval", "sampling_id", "print",
           "cross_entropy_over_beam", "nested_sequence_pool",
           "nested_sequence_expand", "nested_sequence_slice",
           "sub_nested_seq", "nested_rnn"}
    assert len(new) == 27 and new <= named

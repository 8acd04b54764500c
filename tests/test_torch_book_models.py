"""The book's four small models in the port against the JAX package, on
the CPU, at ``tests/test_book.py``'s sizes: ``fit_a_line`` (fc, the
squared error, SGD), ``word2vec`` (a shared embedding over four words,
SGD), ``recommender`` (two towers, ``cos_sim``, SGD) and ``ctr_dnn``
(``build``: id embeddings, ``auc``, Adam; ``build_sparse_slots``: the
``sparse_data`` slots through ``sparse_fc``, duplicate ids included).

* Both packages build the same main and startup programs, and every op
  is registered in the port.
* From the reference's startup state (``load_numpy_state``), three steps
  on seeded batches: each step's loss within ORACLE_TOL f32's forward
  bound (2e-4 relative), ``ctr_dnn``'s ``auc`` within it too, each
  step's gradient of every parameter and every parameter after the
  third step within the gradient bound (1e-3 of the tensor's largest
  magnitude).  Under Adam (``ctr_dnn``) an entry whose gradient is
  roundoff in some step (nonzero, under 1e-5 of the tensor's largest:
  an embedding row the batch reaches only through a near-cancelling
  sum) moves by up to ``lr`` either way in both packages, so the
  parameters are compared without those entries.
* The new differentiable ops alone (``cos_sim`` with and without the
  batch-1 ``Y``, ``sparse_fc`` with duplicate ids and padding,
  ``square``, ``log``): outputs within 2e-4 and gradients under one
  seeded cotangent within 1e-3; ``auc`` on fixed inputs, a probability
  exactly on a threshold among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3

# tests/test_book.py's sizes
CFGS = {
    "fit_a_line": ("fit_a_line", "build", dict(learning_rate=0.05)),
    "word2vec": ("word2vec", "build",
                 dict(dict_size=50, embed_size=8, hidden_size=16,
                      learning_rate=0.1)),
    "recommender": ("recommender", "build",
                    dict(learning_rate=0.05, max_title_len=4,
                         max_cat_len=3)),
    "ctr_dnn": ("ctr_dnn", "build",
                dict(sparse_feature_dim=100, num_slots=3, embedding_size=4,
                     dense_dim=5, hidden=(8, 4), learning_rate=0.05)),
    "ctr_dnn_sparse_slots": ("ctr_dnn", "build_sparse_slots",
                             dict(sparse_feature_dim=100, num_slots=3,
                                  embedding_size=4, dense_dim=5,
                                  hidden=(8, 4), learning_rate=0.05)),
}


def _build(pkg, name):
    module, fn, cfg = CFGS[name]
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = getattr(getattr(pkg.models, module), fn)(**cfg)
    return main, startup, out


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, v.lod_level,
                  type(v).__name__)
                 for v in program.list_vars()]
    return ops, variables


def _ragged(rng, b, max_len, high):
    lens = rng.integers(2, max_len + 1, size=b)
    data = np.zeros((b, max_len), np.int64)
    for i, n in enumerate(lens):
        data[i, :n] = rng.integers(0, high, size=n)
    return data, lens.astype(np.int32)


def _feed(name, seed):
    """One batch as tests/test_book.py makes it."""
    rng = np.random.default_rng(seed)
    if name == "fit_a_line":
        x = rng.normal(size=(16, 13)).astype(np.float32)
        w = rng.normal(size=(13, 1)).astype(np.float32)
        return {"x": x, "y": x @ w}
    if name == "word2vec":
        feed = {f"word_{i}": rng.integers(0, 50, (16, 1)).astype(np.int64)
                for i in range(4)}
        feed["next_word"] = rng.integers(0, 50, (16, 1)).astype(np.int64)
        return feed
    if name == "recommender":
        b = 4
        cat, cat_len = _ragged(rng, b, 3, 10)
        title, title_len = _ragged(rng, b, 4, 50)
        return {
            "user_id": rng.integers(0, 100, (b, 1)).astype(np.int64),
            "gender_id": rng.integers(0, 2, (b, 1)).astype(np.int64),
            "age_id": rng.integers(0, 7, (b, 1)).astype(np.int64),
            "job_id": rng.integers(0, 10, (b, 1)).astype(np.int64),
            "movie_id": rng.integers(0, 100, (b, 1)).astype(np.int64),
            "category_id": cat, "category_id@LENGTH": cat_len,
            "movie_title": title, "movie_title@LENGTH": title_len,
            "score": rng.uniform(1, 5, (b, 1)).astype(np.float32),
        }
    b = 8
    feed = {"dense_feature": rng.normal(size=(b, 5)).astype(np.float32),
            "click": rng.integers(0, 2, (b, 1)).astype(np.int64)}
    for i in range(3):
        if name == "ctr_dnn":
            feed[f"slot_{i}"] = rng.integers(0, 100, (b, 1)).astype(np.int64)
            continue
        # multi-hot bags of 1-4 ids, 0-padded to 4, a duplicate in row 0
        ids = rng.integers(0, 100, (b, 4)).astype(np.int64)
        vals = rng.uniform(0.5, 2.0, (b, 4)).astype(np.float32)
        nnz = rng.integers(1, 5, size=b)
        for r, n in enumerate(nnz):
            ids[r, n:] = 0
            vals[r, n:] = 0.0
        ids[0, :2] = ids[0, 0]
        vals[0, :2] = (1.0, 1.5)
        feed[f"slot_{i}@IDS"] = ids
        feed[f"slot_{i}@VALS"] = vals
    return feed


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


@pytest.mark.parametrize("name", list(CFGS))
def test_build_gives_the_same_programs(name):
    jmain, jstart, _ = _build(pt, name)
    tmain, tstart, _ = _build(tpt, name)
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    for prog in (tmain, tstart):
        for blk in prog.blocks:
            for op in blk.ops:
                torch_op(op.type)               # every op is registered


@pytest.mark.parametrize("name", list(CFGS))
def test_three_steps_match_the_reference(name):
    jmain, jstart, jout = _build(pt, name)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(jstart, scope=scope)
    init = {v.name: np.asarray(scope.get(v.name))
            for v in jmain.persistable_vars()
            if scope.find_var(v.name) is not None}
    tmain, _, tout = _build(tpt, name)
    tscope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    texe = tpt.Executor(tpt.CPUPlace())
    keys = ["avg_cost"] + (["auc"] if "auc" in jout else [])
    params = [p.name for p in jmain.all_parameters()]
    roundoff = {p: np.zeros(init[p].shape, bool) for p in params}
    losses = []
    for step in range(3):
        feed = _feed(name, step)
        fetch = keys + [p + "@GRAD" for p in params]
        want = exe.run(jmain, feed=feed,
                       fetch_list=[jout[k] for k in keys] + fetch[len(keys):],
                       scope=scope)
        got = texe.run(tmain, feed=feed,
                       fetch_list=[tout[k] for k in keys] + fetch[len(keys):],
                       scope=tscope)
        for k, g, w in zip(fetch, got, want):
            bound = GRAD_TOL if k.endswith("@GRAD") else FWD_TOL
            assert _rel(g, w) <= bound, (step, k, _rel(g, w))
        for p, w in zip(params, want[len(keys):]):
            w = np.abs(np.asarray(w))
            roundoff[p] |= (w > 0) & (w < 1e-5 * w.max())
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
    assert np.isfinite(losses).all()
    adam = any(op.type == "adam" for op in tmain.global_block().ops)
    for p in params:
        keep = ~roundoff[p] if adam else np.ones(init[p].shape, bool)
        err = _rel(tscope.numpy(p)[keep], np.asarray(scope.get(p))[keep])
        assert err <= GRAD_TOL, (p, err)


# -- the ops alone -----------------------------------------------------------

def _vjp_both(op, floats, fixed, attrs, out, seed):
    """``op`` in both packages on the float inputs ``floats`` (f32,
    differentiated) and ``fixed``: the output ``out`` and the float
    inputs' gradients under one seeded cotangent, ``(got, want)``."""
    names = sorted(floats)
    fixed_j = {k: jnp.asarray(v) for k, v in fixed.items()}

    def jfn(*vals):
        return jax_op(op).fn(**dict(zip(names, vals)), **fixed_j,
                             **attrs)[out]

    want, vjp = jax.vjp(jfn, *[jnp.asarray(floats[n]) for n in names])
    cot = np.random.default_rng(seed).standard_normal(
        np.shape(want)).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = {n: torch.tensor(floats[n]).requires_grad_() for n in names}
    got = torch_op(op).fn(**ts, **{k: torch.tensor(v)
                                   for k, v in fixed.items()}, **attrs)[out]
    grads = torch.autograd.grad((got * torch.tensor(cot)).sum(),
                                [ts[n] for n in names])
    return ((got.detach().numpy(), [g.numpy() for g in grads]),
            (np.asarray(want), [np.asarray(g) for g in want_grads]))


def _op_case(name):
    rng = np.random.default_rng(11)
    if name.startswith("cos_sim"):
        y_rows = 1 if name == "cos_sim_batch1_y" else 5
        return ("cos_sim", {"X": rng.normal(size=(5, 7)).astype(np.float32),
                            "Y": rng.normal(size=(y_rows, 7)).astype(
                                np.float32)}, {}, "Out")
    if name == "sparse_fc":
        ids = rng.integers(0, 9, (4, 5)).astype(np.int32)
        vals = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
        ids[0, :3] = 4                  # a duplicate id, added thrice
        ids[1, 3:], vals[1, 3:] = 0, 0.0  # padding adds nothing
        return ("sparse_fc", {"W": rng.normal(size=(9, 6)).astype(
            np.float32), "Vals": vals}, {"Ids": ids}, "Out")
    x = rng.normal(size=(4, 6)).astype(np.float32)
    return (name, {"X": np.abs(x) + 0.1 if name == "log" else x}, {}, "Out")


@pytest.mark.parametrize("name", ["cos_sim", "cos_sim_batch1_y",
                                  "sparse_fc", "square", "log"])
def test_op_and_its_gradient_match_the_reference(name):
    op, floats, fixed, out = _op_case(name)
    (got, ggrads), (want, wgrads) = _vjp_both(op, floats, fixed, {}, out, 3)
    assert got.shape == want.shape
    assert _rel(got, want) <= FWD_TOL
    for g, w in zip(ggrads, wgrads):
        assert g.shape == w.shape
        assert _rel(g, w) <= GRAD_TOL


def test_sparse_fc_gradient_adds_duplicate_rows():
    w = torch.zeros(5, 2, requires_grad=True)
    ids = torch.tensor([[3, 3, 0]])
    vals = torch.tensor([[1.0, 2.0, 0.0]])
    out = torch_op("sparse_fc").fn(Ids=ids, Vals=vals, W=w)["Out"]
    (g,) = torch.autograd.grad(out.sum(), [w])
    np.testing.assert_array_equal(g.numpy(), [[0, 0], [0, 0], [0, 0],
                                              [3, 3], [0, 0]])


@pytest.mark.parametrize("thresholds", [200, 7])
def test_auc_matches_the_reference_on_fixed_inputs(thresholds):
    probs = np.array([0.1, 0.9, 0.4, 0.35, 0.8, 0.5, 0.65, 0.05, 0.7, 0.3],
                     np.float32)
    # one probability exactly on a threshold (1/2 of linspace(0, 1, 7)'s)
    probs[3] = np.float32(np.asarray(jnp.linspace(0.0, 1.0, 7))[3])
    out = np.stack([1 - probs, probs], axis=1)
    label = np.array([0, 1, 0, 1, 1, 0, 1, 0, 1, 0], np.int64)[:, None]
    want = jax_op("auc").fn(Out=jnp.asarray(out), Label=jnp.asarray(label),
                            num_thresholds=thresholds)["AUC"]
    got = torch_op("auc").fn(Out=torch.tensor(out), Label=torch.tensor(label),
                             num_thresholds=thresholds)["AUC"]
    assert got.shape == (1,) and got.dtype == torch.float32
    assert abs(float(got[0]) - float(want[0])) <= 1e-6, (got, want)

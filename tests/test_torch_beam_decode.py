"""The seq2seq beam decode in the port against the JAX package, on the
CPU: ``While`` and the tensor arrays (the ``while``, ``array_write``,
``array_read``, ``array_length`` ops; ``max_sequence_len``), the beam
ops (``beam_search``, ``beam_search_decode``, ``beam_init``,
``beam_expand``, ``beam_gather``), and ``seq2seq.build_decode`` /
``decode_sentences`` at ``tests/test_book.py``'s decode size (dicts 40,
word 8, hidden 16, beam 3, ``max_out_len`` 5, two ragged sources).

* Both packages build the same decode program (every block), and every
  op of it is registered in the port.
* From the reference's startup state (``load_numpy_state``) the two
  decodes give equal ids, parents, steps and sentences, and scores
  within ORACLE_TOL f32's forward bound (2e-4 of the largest): once
  over the full ``max_out_len`` (the first source ends on the first
  trip, so its beams stay frozen on ``end_id`` for four trips while the
  other's run on), and once with ``decode_out``'s bias leaning to
  ``end_id``, so that every beam ends and the loop stops early.
* The beam ops alone match, ties included: identical beams (every
  candidate comes ``k`` times; the reference takes the lowest flat index
  first, ``torch.topk`` would not), finished beams (their candidates at
  ``-1e38``) and ties inside a row.
* ``while`` over a counter and over a loop that carries tensor arrays
  matches; names first written in the loop stay local to it; the
  executor's ``flops`` count the sub-block once per trip run.
"""

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

# tests/test_book.py:115-131's decode size
CFG = dict(src_dict_size=40, trg_dict_size=40, word_dim=8, hidden_dim=16,
           max_len=6, beam_size=3, max_out_len=5, end_id=1)
# added to decode_out's bias for end_id in the case that stops early:
# every beam ends on the first trip (at random init the decoder barely
# moves between trips, so no bias ends them later)
EARLY_BIAS = 2.0


def _build(pkg, build_fn, **kw):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = build_fn(pkg, **kw)
    return main, startup, out


def _decode(pkg, **kw):
    return pkg.models.seq2seq.build_decode(**dict(CFG, **kw))


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, v.lod_level,
                  type(v).__name__)
                 for v in program.list_vars()]
    return ops, variables


def _feed(seed=6):
    """Two ragged sources, padded as tests/test_book.py pads them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, CFG["max_len"] + 1, size=2)
    src = np.zeros((2, CFG["max_len"]), np.int64)
    for i, n in enumerate(lens):
        src[i, :n] = rng.integers(0, CFG["src_dict_size"], size=n)
    return {"src_word_id": src, "src_word_id@LENGTH": lens.astype(np.int32)}


def _reference_state(main, startup):
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    names = [v.name for v in main.persistable_vars()
             if scope.find_var(v.name) is not None]
    return {n: np.asarray(scope.get(n)).copy() for n in names}


def _run_both(state, feed, **kw):
    """The decode in both packages from ``state``: ``(want, got)``, each
    ``[ids, parents, steps, scores]``."""
    jmain, _, jout = _build(pt, _decode, **kw)
    tmain, _, tout = _build(tpt, _decode, **kw)
    keys = ("ids_array", "parents_array", "steps", "scores")
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    want = exe.run(jmain, feed=feed, fetch_list=[jout[k] for k in keys],
                   scope=scope)
    got = tpt.Executor(tpt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout[k] for k in keys],
        scope=tpt.load_numpy_state(tpt.Scope(), state, device="cpu"))
    return want, got


def test_build_decode_gives_the_same_programs():
    jmain, jstart, _ = _build(pt, _decode)
    tmain, tstart, _ = _build(tpt, _decode)
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    types = set()
    for blk in tmain.blocks:
        for op in blk.ops:
            torch_op(op.type)                     # every op is registered
            types.add(op.type)
    assert {"while", "array_write", "beam_search", "one_hot", "matmul",
            "expand", "fill_constant_batch_size_like", "log", "reduce_min",
            "logical_and"} <= types


@pytest.mark.parametrize("early", [False, True], ids=["full", "early_stop"])
def test_decode_matches_the_reference(early):
    jmain, jstart, _ = _build(pt, _decode)
    state = _reference_state(jmain, jstart)
    if early:
        state["decode_out.b"][CFG["end_id"]] += EARLY_BIAS
    feed = _feed()
    want, got = _run_both(state, feed)
    steps = int(want[2].reshape(-1)[0])
    if early:
        assert steps < CFG["max_out_len"], steps
    else:
        assert steps == CFG["max_out_len"], steps
        assert (want[0][:, 0] == CFG["end_id"]).all()  # frozen beams
    for w, g in zip(want[:3], got[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    scale = np.abs(want[3]).max()
    assert np.abs(got[3] - want[3]).max() <= FWD_TOL * scale
    sent_want = pt.models.seq2seq.decode_sentences(*want[:3], end_id=1)
    sent_got = tpt.models.seq2seq.decode_sentences(*got[:3], end_id=1)
    np.testing.assert_array_equal(sent_got, sent_want)
    assert sent_got.shape == (2, CFG["beam_size"], steps)


def test_decode_flops_count_each_trip():
    """``last_step_cost["flops"]`` counts the loop's sub-block once per
    trip run: five trips add five times what the one trip of a decode
    that ends at once adds."""
    jmain, jstart, _ = _build(pt, _decode)
    state = _reference_state(jmain, jstart)
    early = dict(state, **{"decode_out.b": state["decode_out.b"].copy()})
    early["decode_out.b"][CFG["end_id"]] += 1e3
    tmain, _, tout = _build(tpt, _decode)
    static = tpt.core.executor.step_flops(tmain, 2)
    added = {}
    for name, st in (("full", state), ("early", early)):
        texe = tpt.Executor(tpt.CPUPlace())
        steps, = texe.run(tmain, feed=_feed(), fetch_list=[tout["steps"]],
                          scope=tpt.load_numpy_state(tpt.Scope(), st,
                                                     device="cpu"))
        added[name] = (int(steps[0]), texe.last_step_cost["flops"] - static)
    assert added["full"][0] == CFG["max_out_len"] and added["early"][0] == 1
    assert added["early"][1] > 0
    assert added["full"][1] == CFG["max_out_len"] * added["early"][1]


def test_decode_sentences_backtracks_and_pads_after_the_end():
    ids = np.array([[[4, 5]], [[1, 6]], [[7, 1]]], np.int32)     # [T, b, k]
    parents = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], np.int32)
    want = pt.models.seq2seq.decode_sentences(ids, parents, np.array([3]))
    got = tpt.models.seq2seq.decode_sentences(ids, parents, np.array([3]))
    np.testing.assert_array_equal(got, want)
    got_t = tpt.models.seq2seq.decode_sentences(
        torch.as_tensor(ids), torch.as_tensor(parents), torch.tensor([2]))
    np.testing.assert_array_equal(got_t, np.asarray(
        pt.models.seq2seq.decode_sentences(ids, parents, np.array([2]))))


# -- the beam ops alone ------------------------------------------------------

def _beam_case(name):
    """``(pre_ids, pre_scores, scores)`` for b=2, k=3, V=6."""
    rng = np.random.default_rng(3)
    b, k, v = 2, 3, 6
    scores = np.log(rng.dirichlet(np.ones(v), size=(b, k))).astype(
        np.float32)
    pre_scores = rng.normal(size=(b, k)).astype(np.float32)
    pre_ids = rng.integers(2, v, (b, k)).astype(np.int32)
    if name == "identical_beams":
        scores[:] = scores[:, :1]
        pre_scores[:] = 0.0
        pre_ids[:] = 0
    elif name == "finished_beams":
        pre_ids[0, 1] = pre_ids[1, :] = 1           # end_id
    elif name == "ties_in_a_row":
        scores[:] = np.log(np.array([1, 3, 3, 2, 3, 0.5]) / 12.5)
        pre_scores[:] = 0.0
    return pre_ids, pre_scores, scores


@pytest.mark.parametrize("name", ["random", "identical_beams",
                                  "finished_beams", "ties_in_a_row"])
def test_beam_search_matches_the_reference(name):
    pre_ids, pre_scores, scores = _beam_case(name)
    want = jax_op("beam_search").fn(
        PreIds=jnp.asarray(pre_ids), PreScores=jnp.asarray(pre_scores),
        Scores=jnp.asarray(scores), beam_size=3, end_id=1)
    got = torch_op("beam_search").fn(
        PreIds=torch.tensor(pre_ids), PreScores=torch.tensor(pre_scores),
        Scores=torch.tensor(scores), beam_size=3, end_id=1)
    for slot in ("SelectedIds", "ParentIdx"):
        assert got[slot].dtype == torch.int32
        np.testing.assert_array_equal(got[slot].numpy(),
                                      np.asarray(want[slot]))
    np.testing.assert_array_equal(got["SelectedScores"].numpy(),
                                  np.asarray(want["SelectedScores"]))
    if name == "identical_beams":
        # the best token from each beam, beams in order
        np.testing.assert_array_equal(got["ParentIdx"].numpy(),
                                      [[0, 1, 2], [0, 1, 2]])


def test_beam_search_decode_and_the_beam_helpers_match_the_reference():
    rng = np.random.default_rng(5)
    t, b, k = 4, 2, 3
    ids = rng.integers(0, 4, (t, b, k)).astype(np.int32)
    parents = rng.integers(0, k, (t, b, k)).astype(np.int32)
    scores = rng.normal(size=(t, b, k)).astype(np.float32)
    want = jax_op("beam_search_decode").fn(
        Ids=jnp.asarray(ids), ParentIdx=jnp.asarray(parents),
        Scores=jnp.asarray(scores), end_id=1)
    got = torch_op("beam_search_decode").fn(
        Ids=torch.tensor(ids), ParentIdx=torch.tensor(parents),
        Scores=torch.tensor(scores), end_id=1)
    np.testing.assert_array_equal(got["SentenceIds"].numpy(),
                                  np.asarray(want["SentenceIds"]))
    np.testing.assert_array_equal(got["SentenceScores"].numpy(),
                                  np.asarray(want["SentenceScores"]))
    ref = rng.normal(size=(b, 5)).astype(np.float32)
    x = rng.normal(size=(b * k, 5)).astype(np.float32)
    for op, jin, tin, attrs in [
            ("beam_init", {"Ref": jnp.asarray(ref)},
             {"Ref": torch.tensor(ref)}, {"beam_size": k, "bos_id": 2}),
            ("beam_expand", {"X": jnp.asarray(ref)},
             {"X": torch.tensor(ref)}, {"beam_size": k}),
            ("beam_gather",
             {"X": jnp.asarray(x), "Parent": jnp.asarray(parents[0])},
             {"X": torch.tensor(x), "Parent": torch.tensor(parents[0])}, {})]:
        want = jax_op(op).fn(**jin, **attrs)
        got = torch_op(op).fn(**tin, **attrs)
        assert set(got) == set(want)
        for slot in want:
            np.testing.assert_array_equal(got[slot].numpy(),
                                          np.asarray(want[slot]))
            assert str(got[slot].dtype).split(".")[-1] == str(
                want[slot].dtype)


# -- while and the tensor arrays ----------------------------------------------

def _counter_loop(pkg, n=5, width=3):
    """``i = 0; s = 0; while i < n: arr[i] = s * i; s = s + x; i += 1``,
    with a name (``tmp``) first written inside the loop."""
    L = pkg.layers
    x = L.data("x", shape=[width], dtype="float32", append_batch_size=False)
    i = L.zeros([1], "int64")
    s = L.zeros([width], "float32")
    arr = L.create_array("float32", n, [width])
    limit = L.fill_constant([1], "int64", float(n))
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        tmp = L.elementwise_mul(s, L.cast(i, "float32"))
        L.array_write(tmp, i, arr)
        L.assign(L.elementwise_add(s, x), s)
        L.increment(i, 1.0)
        L.assign(L.less_than(i, limit), cond)
    last = L.array_read(arr, L.fill_constant([1], "int64", float(n - 1)))
    return {"i": i, "s": s, "arr": arr, "last": last,
            "length": L.array_length(arr), "tmp": tmp}


@pytest.mark.parametrize("n", [0, 1, 5])
def test_while_counter_loop_with_arrays_matches_the_reference(n):
    feed = {"x": np.array([0.5, -1.0, 2.0], np.float32)}
    keys = ("i", "s", "arr", "last", "length")
    jmain, _, jout = _build(pt, _counter_loop, n=max(n, 1))
    tmain, _, tout = _build(tpt, _counter_loop, n=max(n, 1))
    if n == 0:      # a condition false from the start: no trip
        for prog in (jmain, tmain):
            (lt,) = [op for op in prog.global_block().ops
                     if op.type == "less_than"]
            lt.inputs["Y"] = [lt.inputs["X"][0]]
    want = pt.Executor(pt.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jout[k] for k in keys],
        scope=pt.Scope())
    texe = tpt.Executor(tpt.CPUPlace())
    got = texe.run(tmain, feed=feed, fetch_list=[tout[k] for k in keys],
                   scope=tpt.Scope())
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the name first written in the loop stays local to it
    with pytest.raises(KeyError, match=tout["tmp"].name):
        texe.run(tmain, feed=feed, fetch_list=[tout["tmp"]],
                 scope=tpt.Scope())


def test_while_counts_its_trips_into_the_step_cost():
    """A loop of ``mul`` products: ``flops`` counts the sub-block once
    per trip (the trips known only once it has run)."""
    def build(pkg, n):
        L = pkg.layers
        x = L.data("x", shape=[4], dtype="float32")
        w = L.create_parameter([4, 4], "float32", name="w")
        i = L.zeros([1], "int64")
        limit = L.fill_constant([1], "int64", float(n))
        cond = L.less_than(i, limit)
        loop = L.While(cond)
        with loop.block():
            y = L.matmul(x, w)
            L.assign(y, x)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, limit), cond)
        return x

    costs = {}
    for n in (1, 3):
        tmain, tstart, x = _build(tpt, build, n=n)
        exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        exe.run(tstart, scope=scope)
        exe.run(tmain, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[x], scope=scope)
        costs[n] = exe.last_step_cost["flops"]
    assert costs[1] == 2 * 2 * 4 * 4
    assert costs[3] == 3 * costs[1]


def test_while_flops_take_the_shapes_the_loop_ran():
    """A -1 dim inside a loop need not be the batch (``x [6, 4]`` as
    ``[-1, 8]`` has 3 rows): the count takes the shapes the sub-block's
    values had."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[4], dtype="float32")
        w = L.create_parameter([8, 8], "float32", name="w")
        i = L.zeros([1], "int64")
        limit = L.fill_constant([1], "int64", 2.0)
        cond = L.less_than(i, limit)
        loop = L.While(cond)
        with loop.block():
            y = L.matmul(L.reshape(x, [-1, 8]), w)    # [b / 2, 8] rows
            L.assign(L.reshape(y, [-1, 4]), x)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, limit), cond)
        return x

    tmain, tstart, x = _build(tpt, build)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(tstart, scope=scope)
    exe.run(tmain, feed={"x": np.ones((6, 4), np.float32)},
            fetch_list=[x], scope=scope)
    assert exe.last_step_cost["flops"] == 2 * (2 * 3 * 8 * 8)


def test_max_sequence_len_matches_the_reference():
    def build(pkg):
        x = pkg.layers.data("x", shape=[6], dtype="int64", lod_level=1)
        return pkg.layers.control_flow.max_sequence_len(x)

    feed = {"x": np.zeros((3, 6), np.int64),
            "x@LENGTH": np.array([2, 5, 3], np.int32)}
    jmain, _, jout = _build(pt, build)
    tmain, _, tout = _build(tpt, build)
    want = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed,
                                          fetch_list=[jout],
                                          scope=pt.Scope())[0]
    got = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=[tout],
                                           scope=tpt.Scope())[0]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [5])


@pytest.mark.parametrize("index", [2, -1, 4, -5, 7])
def test_tensor_arrays_match_the_reference_at_any_index(index):
    """A negative index counts from the end; a write outside the array
    is dropped and a read clamped, as in the reference."""
    arr = np.arange(8, dtype=np.float32).reshape(4, 2)
    x = np.array([-1.0, -2.0], np.float32)
    i = np.array([index], np.int32)
    want_w = jax_op("array_write").fn(X=jnp.asarray(x), I=jnp.asarray(i),
                                      Array=jnp.asarray(arr))["Out"]
    want_r = jax_op("array_read").fn(Array=jnp.asarray(arr),
                                     I=jnp.asarray(i))["Out"]
    got_w = torch_op("array_write").fn(X=torch.tensor(x), I=torch.tensor(i),
                                       Array=torch.tensor(arr))["Out"]
    got_r = torch_op("array_read").fn(Array=torch.tensor(arr),
                                      I=torch.tensor(i))["Out"]
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def test_array_write_is_out_of_place_and_stays_on_the_device_index():
    arr = torch.zeros(4, 2)
    i = torch.tensor([2], dtype=torch.int32)
    out = torch_op("array_write").fn(X=torch.ones(2), I=i, Array=arr)["Out"]
    assert arr.abs().sum() == 0 and out.data_ptr() != arr.data_ptr()
    np.testing.assert_array_equal(out.numpy(), [[0, 0], [0, 0], [1, 1],
                                                [0, 0]])
    got = torch_op("array_read").fn(Array=out, I=i)["Out"]
    np.testing.assert_array_equal(got.numpy(), [1, 1])


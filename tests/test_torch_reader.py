"""The port's input pipeline (``paddle_tpu_torch.reader``,
``DataFeeder``) against the JAX package's, on the CPU: the same rows
through both feeders give the same arrays (dense, sequence, nested and
sparse slots), every decorator yields the same items in the same order
(``ResumableReader``'s state included), the ``@provider`` shim converts
alike, and the creators the port has not ported raise.
``prefetch_to_device`` hands over CPU tensors on the CPU; its side-stream
copy on the card is a ``cuda`` case in ``tests/test_torch_trainer.py``."""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu import data_feeder as jdf
from paddle_tpu import reader as jreader
from paddle_tpu.reader import provider as jprov
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.reader import provider as tprov


def _vars(pkg):
    """The same feed variables declared in both packages: dense [3] f32,
    an int label [1], a sequence, a nested sequence, and sparse slots
    (dense and sequence)."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        dense = pkg.layers.data("dense", [3], dtype="float32")
        label = pkg.layers.data("label", [1], dtype="int64")
        seq = pkg.layers.data("seq", [2], dtype="float32", lod_level=1)
        nest = pkg.layers.data("nest", [], dtype="int64", lod_level=2)
        block = main.global_block()
        sparse = []
        for name, lod in (("sp", 0), ("spseq", 1)):
            var = block.create_var(name=name, shape=[-1, 50],
                                   dtype="float32", lod_level=lod,
                                   is_data=True, stop_gradient=True)
            var.sparse_slot = True
            sparse.append(var)
    return [dense, label, seq, nest] + sparse


def _rows(prov):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        rows.append((
            rng.standard_normal(3).astype(np.float32),
            [i % 3],
            rng.standard_normal((1 + i % 4, 2)).astype(np.float32),
            [list(range(j + 1)) for j in range(1 + i % 3)],
            prov.SparseRow([i, 7, 7], [0.5, 1.0, 2.0], 50),
            [prov.SparseRow([j], None, 50) for j in range(i % 3)],
        ))
    return rows


def test_data_feeder_matches_the_reference():
    jfeed = jdf.DataFeeder(_vars(pt)).feed(_rows(jprov))
    tfeed = tpt.DataFeeder(_vars(tpt), tpt.CPUPlace()).feed(_rows(tprov))
    assert sorted(tfeed) == sorted(jfeed)
    for k, want in jfeed.items():
        assert tfeed[k].dtype == np.asarray(want).dtype, k
        assert np.array_equal(tfeed[k], np.asarray(want)), k


def test_sparse_column_feeding_a_dense_var_densifies_alike():
    rows = [(jprov.SparseRow([1, 1, 4], [1.0, 2.0, 3.0], 6),),
            (jprov.SparseRow([0], None, 6),)]
    trows = [(tprov.SparseRow(r[0].ids, r[0].vals, 6),) for r in rows]
    jvar = _vars(pt)[0]
    tvar = _vars(tpt)[0]
    for v in (jvar, tvar):
        v.shape = (-1, 6)
    want = jdf.DataFeeder([jvar]).feed(rows)["dense"]
    got = tpt.DataFeeder([tvar], tpt.CPUPlace()).feed(trows)["dense"]
    assert np.array_equal(got, want)


def test_bf16_columns_are_built_in_f32():
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = tpt.layers.data("x", [2], dtype="bfloat16")
    out = tpt.DataFeeder([x], tpt.CPUPlace()).feed([([1.5, -2.0],)])
    assert out["x"].dtype == np.float32


def _nums(n=11):
    def reader():
        yield from range(n)
    return reader


def _pairs(n=11):
    def reader():
        for i in range(n):
            yield (i, -i)
    return reader


DECORATORS = {
    "map_readers": lambda r: r.map_readers(lambda a, b: a * 10 + b,
                                           _nums(), _nums(7)),
    "buffered": lambda r: r.buffered(_nums(), 3),
    "compose": lambda r: r.compose(_nums(), _pairs()),
    "chain": lambda r: r.chain(_nums(3), _nums(4)),
    "firstn": lambda r: r.firstn(_nums(), 4),
    "xmap_ordered": lambda r: r.xmap_readers(lambda x: x * x, _nums(), 3, 4,
                                             order=True),
    "batch": lambda r: r.batch(_nums(), 4),
    "batch_ragged": lambda r: r.batch(_nums(), 4, drop_last=False),
    "np_array": lambda r: r.creator.np_array(np.arange(6).reshape(3, 2)),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorators_yield_what_the_reference_yields(name):
    got = [np.asarray(x).tolist() for x in DECORATORS[name](treader)()]
    want = [np.asarray(x).tolist() for x in DECORATORS[name](jreader)()]
    assert got == want and got


def test_shuffle_and_xmap_keep_the_items():
    import random

    for r in (treader, jreader):
        random.seed(5)
        got = list(r.shuffle(_nums(20), 6)())
        assert sorted(got) == list(range(20))
    random.seed(5)
    a = list(treader.shuffle(_nums(20), 6)())
    random.seed(5)
    b = list(jreader.shuffle(_nums(20), 6)())
    assert a == b
    assert sorted(treader.xmap_readers(lambda x: -x, _nums(), 2, 3)()) == \
        sorted(jreader.xmap_readers(lambda x: -x, _nums(), 2, 3)())


def test_compose_refuses_unaligned_readers():
    with pytest.raises(treader.decorator.ComposeNotAligned):
        list(treader.compose(_nums(3), _nums(4))())


def test_resumable_reader_matches_the_reference():
    runs = []
    for r in (treader, jreader):
        rr = r.resumable(r.batch(_nums(20), 3))
        first = list(itertools.islice(rr(), 2))
        state = rr.state()
        fresh = r.resumable(r.batch(_nums(20), 3))
        fresh.set_state(state)
        rest = list(fresh())
        runs.append((first, state, rest, fresh.state()))
    assert runs[0] == runs[1]
    assert runs[0][2][0] == [6, 7, 8]


def test_provider_converts_alike():
    def make(prov):
        @prov.provider(input_types={"x": prov.dense_vector(2),
                                    "ids": prov.integer_value_sequence(9),
                                    "sp": prov.sparse_float_vector(9)},
                       cache=prov.CacheType.CACHE_PASS_IN_MEM)
        def process(settings, filename):
            for i in range(3):
                yield {"x": [i, -i], "ids": [i, i + 1],
                       "sp": [(i, 0.5), (8, 1.0)]}
        return process(["f"])

    got = list(make(tprov)())
    want = list(make(jprov)())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
        assert np.array_equal(g[2].ids, w[2].ids)
        assert np.array_equal(g[2].vals, w[2].vals)


def test_creators_not_ported_raise_naming_the_roadmap(tmp_path):
    for fn in (treader.creator.recordio, treader.creator.cloud_reader):
        with pytest.raises(NotImplementedError, match="A9"):
            fn(["x"])
    path = tmp_path / "t.txt"
    path.write_text("a\nb\n")
    assert list(treader.creator.text_file(str(path))()) == ["a", "b"]


def test_prefetch_on_the_cpu_hands_over_cpu_tensors():
    feeder = tpt.DataFeeder(_vars(tpt)[:2], tpt.CPUPlace())
    rows = [(np.full(3, i, np.float32), [i]) for i in range(6)]
    batches = treader.batch(lambda: iter(rows), 2)
    got = list(treader.prefetch_to_device(batches, 2, feeder.feed,
                                          device="cpu")())
    assert len(got) == 3
    for i, b in enumerate(got):
        assert isinstance(b["dense"], torch.Tensor)
        assert b["dense"].device.type == "cpu"
        assert np.array_equal(b["label"].numpy(), [[2 * i], [2 * i + 1]])


def test_prefetch_reraises_a_producer_error():
    def bad():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(treader.prefetch_to_device(bad, 2, device="cpu")())

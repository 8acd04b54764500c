"""The reference's two recurrent configurations in the port against the
JAX package, on the CPU, at ``tests/test_book.py``'s sizes:
``text_classification.build`` (embedding, two stacked ``dynamic_lstm``
layers, the second reversed, a max pool, a softmax classifier) and
``seq2seq.build`` (a GRU encoder, a ``StaticRNN`` attention decoder
whose sub-block reads the encoder's outputs and lengths, a masked
token-level loss).

* Both packages build the same main and startup programs (ops, slots,
  attrs, variables, every block), and every op is registered in the
  port.
* From the reference's startup state (``load_numpy_state``), three Adam
  steps on seeded ragged batches at ``build``'s own learning rate (the
  benchmark sweep's): the loss of each step within ORACLE_TOL f32's
  forward bound (2e-4 relative), the first step's gradient of every
  parameter and every parameter after the third step within the
  gradient bound (1e-3 of the tensor's largest magnitude).  At the
  book's rate of 0.05 the classifier's bias steps 0.05, 0.028, -0.00018
  in both packages: three Adam steps of opposite sign cancel to 1/300
  of one, so that bias's error relative to itself is the steps'
  roundoff (2e-7) magnified 300 times, which says nothing of the port.
* The book's own check on the port: the loss finite and falling over
  four steps of one batch, fed as ragged rows through ``DataFeeder``.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3

# tests/test_book.py's sizes
CFGS = {
    "text_classification": dict(dict_dim=40, class_dim=2, emb_dim=8,
                                hid_dim=8, stacked_num=2, learning_rate=0.05,
                                max_len=8),
    "seq2seq": dict(src_dict_size=40, trg_dict_size=40, word_dim=8,
                    hidden_dim=16, max_len=6, learning_rate=0.01),
}
BATCH = 4


def _build(pkg, name, **over):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = getattr(pkg.models, name).build(**dict(CFGS[name], **over))
    return main, startup, out


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, v.lod_level,
                  type(v).__name__)
                 for v in program.list_vars()]
    return ops, variables


def _rows(name, seed):
    """One batch of ragged rows, one tuple per sample in feed order."""
    rng = np.random.default_rng(seed)
    t = CFGS[name]["max_len"]

    def seq(high):
        return rng.integers(0, high, rng.integers(2, t + 1)).tolist()

    if name == "text_classification":
        return [(seq(40), [int(rng.integers(0, 2))]) for _ in range(BATCH)]
    rows = []
    for _ in range(BATCH):
        trg = seq(40)
        rows.append((seq(40), trg, trg[1:] + [0]))
    return rows


def _feed(name, seed):
    """The rows padded as ``tests/test_book.py`` pads them: int64
    ``[b, max_len]`` and int32 lengths."""
    out = {}
    t = CFGS[name]["max_len"]
    rows = _rows(name, seed)
    names = (("words", "label") if name == "text_classification" else
             ("src_word_id", "target_language_word",
              "target_language_next_word"))
    for i, n in enumerate(names):
        col = [r[i] for r in rows]
        if n == "label":
            out[n] = np.asarray(col, np.int64)
            continue
        arr = np.zeros((BATCH, t), np.int64)
        for j, s in enumerate(col):
            arr[j, :len(s)] = s
        out[n] = arr
        out[n + "@LENGTH"] = np.asarray([len(s) for s in col], np.int32)
    return out


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
    types = {op.type for blk in tmain.blocks for op in blk.ops}
    want = ({"lstm", "sequence_pool", "softmax", "adam"}
            if name == "text_classification" else
            {"gru", "scan_block", "gru_unit", "sequence_expand",
             "sequence_softmax", "sequence_pool", "tanh", "adam"})
    assert want <= types


@pytest.mark.parametrize("name", list(CFGS))
def test_three_adam_steps_match_the_reference(name):
    default_lr = {"learning_rate": inspect.signature(
        getattr(tpt.models, name).build).parameters["learning_rate"].default}
    jmain, jstart, jout = _build(pt, name, **default_lr)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(jstart, scope=scope)
    names = [v.name for v in jmain.persistable_vars()
             if scope.find_var(v.name) is not None]
    params = [p.name for p in jmain.all_parameters()]
    init = {n: np.asarray(scope.get(n)) for n in names}
    tmain, _, tout = _build(tpt, name, **default_lr)
    tscope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    texe = tpt.Executor(tpt.CPUPlace())
    fetch = [jout["avg_cost"].name] + [p + "@GRAD" for p in params]
    for step in range(3):
        feed = _feed(name, step)
        want = exe.run(jmain, feed=feed, fetch_list=fetch, scope=scope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        assert np.isfinite(got[0]).all()
        assert _rel(got[0], want[0]) <= FWD_TOL, (step, got[0], want[0])
        if step == 0:
            for p, g, w in zip(params, got[1:], want[1:]):
                assert _rel(g, w) <= GRAD_TOL, (p, _rel(g, w))
    for p in params:
        assert _rel(tscope.numpy(p), scope.get(p)) <= GRAD_TOL, (
            p, _rel(tscope.numpy(p), scope.get(p)))


@pytest.mark.parametrize("name", list(CFGS))
def test_the_book_check_through_the_data_feeder(name):
    """tests/test_book.py's check on the port: four steps of one ragged
    batch, the loss finite and below the first step's at the end."""
    main, startup, out = _build(tpt, name)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    torch.manual_seed(0)
    exe.run(startup, scope=scope)
    feed = tpt.DataFeeder(out["feed"], tpt.CPUPlace()).feed(_rows(name, 7))
    assert feed[out["feed"][0].name].shape == (BATCH,
                                               CFGS[name]["max_len"])
    losses = [float(np.ravel(exe.run(main, feed=feed,
                                     fetch_list=[out["avg_cost"]],
                                     scope=scope)[0])[0])
              for _ in range(4)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert exe.last_step_cost["flops"] > 0


def test_decode_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        tpt.models.seq2seq.build_decode()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        tpt.models.seq2seq.decode_sentences(None, None, 1)

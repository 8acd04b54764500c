"""The rest of the reference's benchmark rows in the port against the JAX
package, on the CPU: DeepSpeech2 with CTC, the image zoo (LeNet,
SmallNet, AlexNet with LRN, GoogLeNet with its aux heads, VGG-19 with
batch norm) and the CRF tagger (``label_semantic_roles``).

* Both packages build the same main and startup programs (ops, slots,
  attrs, variables), and every op is registered in the port.
* From the reference's startup state (``load_numpy_state``), three steps
  of each model's own optimizer on seeded batches: the loss of each step
  within ORACLE_TOL f32's forward bound (2e-4 relative), the first step's
  gradient of every parameter and every parameter after the third step
  within the gradient bound (1e-3 of the tensor's largest magnitude).
* DS2 at ``tests/test_book.py``'s size with audio lengths [12, 9]:
  ``row_conv``'s lookahead reads the BiGRU's frames past the short row's
  end, and the last four valid frames agree; the greedy decodes are
  equal.  SRL at the book test's size: the Viterbi decodes are equal, and
  ``crfw``'s first SGD update is its ``ParamAttr`` rate (``10 *
  learning_rate``) times the plain one, in both packages.
* The image models at ``tests/test_benchmark_models.py``'s and the book
  test's sizes, f32, with the ``dropout_prob`` attrs set to 0 in both
  built programs (a test-side edit; the model files keep their dropout):
  LeNet, SmallNet and AlexNet here, VGG-19 in ``test_torch_vgg.py`` and
  GoogLeNet in ``test_torch_googlenet.py`` (each a file of its own: the
  reference's startup program and step take seconds to compile).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3

CFGS = {
    # tests/test_book.py:200
    "deep_speech2": dict(feat_dim=8, max_audio_len=12, max_label_len=6,
                         rnn_size=8, num_rnn_layers=1, vocab_size=5,
                         learning_rate=0.01),
    # tests/test_book.py:134
    "label_semantic_roles": dict(word_dict_len=30, label_dict_len=5,
                                 pred_dict_len=8, max_len=6, word_dim=4,
                                 hidden_dim=8, depth=2, learning_rate=0.02),
    # tests/test_book.py:60 and tests/test_benchmark_models.py
    "lenet": dict(learning_rate=0.001),
    "smallnet": dict(class_dim=10, learning_rate=0.002),
    "alexnet": dict(class_dim=4, image_shape=(3, 96, 96),
                    learning_rate=0.01, dtype="float32"),
    "googlenet": dict(class_dim=4, image_shape=(3, 128, 128),
                      learning_rate=0.001, dtype="float32"),
    "vgg": dict(depth=19, class_dim=4, image_shape=(3, 32, 32),
                learning_rate=0.01, dtype="float32"),
}
IMAGES = {"lenet": ((1, 28, 28), 10, 4), "smallnet": ((3, 32, 32), 10, 4),
          "alexnet": ((3, 96, 96), 4, 2), "googlenet": ((3, 128, 128), 4, 2),
          "vgg": ((3, 32, 32), 4, 4)}


def _build(pkg, name):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = getattr(pkg.models, name).build(**CFGS[name])
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    return main, startup, out


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, v.lod_level,
                  type(v).__name__)
                 for v in program.list_vars()]
    return ops, variables


def _ragged_int(rng, batch, max_len, high):
    """tests/test_book.py's ``ragged_int``."""
    lens = rng.integers(2, max_len + 1, size=batch)
    data = np.zeros((batch, max_len), np.int64)
    for i, ln in enumerate(lens):
        data[i, :ln] = rng.integers(0, high, size=ln)
    return data, lens.astype(np.int32)


def _feed(name, seed):
    rng = np.random.default_rng(seed)
    if name == "deep_speech2":
        label, label_len = _ragged_int(rng, 2, 6, 5)
        return {"audio": rng.normal(size=(2, 12, 8)).astype(np.float32),
                "audio@LENGTH": np.array([12, 9], np.int32),
                "transcript": label, "transcript@LENGTH": label_len}
    if name == "label_semantic_roles":
        feed = {}
        _, lens = _ragged_int(rng, 3, 6, 30)
        for n, high in [("word", 30), ("ctx_n2", 30), ("ctx_n1", 30),
                        ("ctx_0", 30), ("ctx_p1", 30), ("ctx_p2", 30),
                        ("verb", 8), ("mark", 2), ("target", 5)]:
            feed[n], _ = _ragged_int(rng, 3, 6, high)
            feed[n + "@LENGTH"] = lens
        return feed
    shape, classes, b = IMAGES[name]
    return {"img": rng.normal(size=(b,) + shape).astype(np.float32),
            "label": rng.integers(0, classes, (b, 1)).astype(np.int64)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


def _op_out(main, op_type, slot):
    return next(op.outputs[slot][0] for op in main.global_block().ops
                if op.type == op_type)


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


def _dead_biases(main):
    """Biases added just before a batch norm: the norm subtracts the
    batch mean, so their gradient is zero analytically and roundoff in
    practice, and Momentum moves them by roundoff (VGG's conv biases)."""
    bn_inputs = {op.inputs["X"][0] for op in main.global_block().ops
                 if op.type == "batch_norm"}
    return {op.inputs["Y"][0] for op in main.global_block().ops
            if op.type == "elementwise_add"
            and op.outputs["Out"][0] in bn_inputs}


def _runs(name, extra_fetch=(), bumps=(0,)):
    """Three steps from the reference's startup state, in the JAX package
    once per ``bumps`` entry (0: as made; 1 / -1: every parameter moved
    one ulp up / down) and in the port from the unmoved state.  Each run:
    ``{"steps": [fetched a step], "init": ..., "state": ...}``, fetching
    the loss, every parameter's gradient, then ``extra_fetch``."""
    jmain, jstart, jout = _build(pt, name)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(jstart, scope=scope)
    names = [v.name for v in jmain.persistable_vars()
             if scope.find_var(v.name) is not None]
    params = [p.name for p in jmain.all_parameters()]
    init = {n: np.array(scope.get(n)) for n in names}
    fetch = ([jout["avg_cost"].name] + [p + "@GRAD" for p in params]
             + [f(jmain, jout) for f in extra_fetch])

    def run(ex, prog, sc, get, start):
        rec = {"init": start, "steps": []}
        for step in range(3):
            outs = ex.run(prog, feed=_feed(name, step), fetch_list=fetch,
                          scope=sc)
            rec["steps"].append([np.array(o) for o in outs])
        rec["state"] = {p: np.array(get(sc, p)) for p in params}
        return rec

    refs = []
    for bump in bumps:
        start = {n: (np.nextafter(v, bump * np.inf).astype(v.dtype)
                     if bump and n in params else v)
                 for n, v in init.items()}
        sc = pt.Scope()
        for n, v in start.items():
            sc.set(n, jnp.asarray(v))
        refs.append(run(exe, jmain, sc, pt.Scope.get, start))
    tmain, _, _ = _build(tpt, name)
    got = run(tpt.Executor(tpt.CPUPlace()), tmain,
              tpt.load_numpy_state(tpt.Scope(), init, device="cpu"),
              tpt.Scope.numpy, init)
    for step in got["steps"]:
        assert np.isfinite(step[0]).all()
    return got, refs, params, _dead_biases(jmain)


def _hold_dead(got, ref, params, dead):
    """A dead bias is roundoff in both packages: its gradient within 1e-5
    of the step's largest gradient, its value within 1e-6 of zero."""
    for g_step, w_step in zip(got["steps"], ref["steps"]):
        top = max(np.abs(w).max() for w in w_step[1:1 + len(params)])
        for i, p in enumerate(params):
            if p in dead:
                assert max(np.abs(g_step[1 + i]).max(),
                           np.abs(w_step[1 + i]).max()) <= 1e-5 * top, p
    for p in dead:
        assert max(np.abs(got["state"][p]).max(),
                   np.abs(ref["state"][p]).max()) <= 1e-6, p


def _three_steps(name, extra_fetch=()):
    """Each step's loss within 2e-4, the first step's gradient of every
    parameter and every parameter after the third step within 1e-3 of the
    reference's (dead biases: ``_hold_dead``)."""
    got, (ref,), params, dead = _runs(name, extra_fetch)
    for step, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
        assert _rel(g[0], w[0]) <= FWD_TOL, (step, g[0], w[0])
    for i, p in enumerate(params):
        if p in dead:
            continue
        g, w = got["steps"][0][1 + i], ref["steps"][0][1 + i]
        assert _rel(g, w) <= GRAD_TOL, (p, _rel(g, w))
        assert _rel(got["state"][p], ref["state"][p]) <= GRAD_TOL, (
            p, _rel(got["state"][p], ref["state"][p]))
    _hold_dead(got, ref, params, dead)
    return got, ref, params


def test_deep_speech2_three_adam_steps():
    """The short row (9 of 12 frames): ``row_conv`` reads the BiGRU's
    frames 9..11 of it, which are not zero (the forward GRU repeats its
    last state there, the reversed one holds H0), so the last four valid
    frames' outputs depend on them; they agree, as do the decodes."""
    got, ref, params = _three_steps("deep_speech2", extra_fetch=(
        lambda m, o: _op_out(m, "row_conv", "Out"),
        lambda m, o: _op_out(m, "concat", "Out"),
        lambda m, o: o["decoded"].name))
    n = 1 + len(params)
    for g, w in zip(got["steps"], ref["steps"]):
        rc, bigru, decoded = g[n:]
        rc_ref, _, decoded_ref = w[n:]
        assert np.abs(bigru[1, 9:]).max() > 0
        assert not rc[1, 9:].any()
        assert _rel(rc[1, 5:9], rc_ref[1, 5:9]) <= FWD_TOL
        assert np.array_equal(decoded, decoded_ref)


def test_srl_three_sgd_steps_and_crfw_rate():
    got, ref, params = _three_steps("label_semantic_roles", extra_fetch=(
        lambda m, o: o["crf_decode"].name,))
    n = 1 + len(params)
    for g, w in zip(got["steps"], ref["steps"]):
        assert np.array_equal(g[n], w[n])
    # SGD: a parameter moves by its rate times the sum of its three
    # gradients; crfw's rate is the plain one times ParamAttr's
    # learning_rate (10 * learning_rate: a multiplier of the optimizer's)
    lr = CFGS["label_semantic_roles"]["learning_rate"]
    plain = next(p for p in params if p != "crfw")
    for run in (got, ref):
        for p, rate in (("crfw", 10.0 * lr * lr), (plain, lr)):
            moved = run["init"][p] - run["state"][p]
            grads = sum(s[1 + params.index(p)] for s in run["steps"])
            assert np.abs(grads).max() > 0
            assert _rel(moved, rate * grads) <= 1e-4, p


@pytest.mark.parametrize("name", ["lenet", "smallnet", "alexnet"])
def test_image_model_three_steps(name):
    _three_steps(name)

"""Gaps in the port's public surface closed against the JAX package's
(ROADMAP.md A10), on the CPU.

* ``layers.mul``, ``clip``, ``clip_by_norm``, ``multiplex``,
  ``l2_normalize`` and ``create_tensor``: the same program in both
  packages, the same feed, the same outputs within ORACLE_TOL f32 (2e-4
  relative to the largest entry; the products reassociate), and the same
  op types.
* ``paddle_tpu_torch.FLAGS`` is the flags module's object, as
  ``paddle_tpu.FLAGS`` is the reference's, with the reference's flags.
* ``PADDLE_TPU_GRADNORM=0``: no ``@GRAD_NORM@`` in the scope and the
  trainer's ``grad_norm`` None; on, the norm is there.
* ``Executor(donate_state=)`` is accepted and changes no bit;
  ``ServingEngine(registry=)`` sends ``serving.*`` to that registry;
  ``generate(key=)`` is accepted and ignored when greedy.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.scope import GRAD_NORM_VAR
from paddle_tpu_torch.observability import metrics as tobs
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

TOL = 2e-4


@pytest.fixture(autouse=True)
def _tmp_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "t.json"))
    tpt.tune.reset_cache()


def _mul(pkg):
    x = pkg.layers.data("x", shape=[3, 4], dtype="float32")
    y = pkg.layers.data("y", shape=[12, 5], dtype="float32",
                        append_batch_size=False)
    return [pkg.layers.mul(x, y, x_num_col_dims=1, y_num_col_dims=1)]


def _clip(pkg):
    x = pkg.layers.data("x", shape=[3, 4], dtype="float32")
    return [pkg.layers.clip(x, -0.5, 0.7)]


def _clip_by_norm(pkg):
    x = pkg.layers.data("x", shape=[3, 4], dtype="float32")
    return [pkg.layers.clip_by_norm(x, 1.5)]


def _multiplex(pkg):
    a = pkg.layers.data("a", shape=[4], dtype="float32")
    b = pkg.layers.data("b", shape=[4], dtype="float32")
    c = pkg.layers.data("c", shape=[4], dtype="float32")
    ids = pkg.layers.data("ids", shape=[1], dtype="int32")
    return [pkg.layers.multiplex([a, b, c], ids)]


def _l2_normalize(pkg):
    x = pkg.layers.data("x", shape=[3, 4], dtype="float32")
    return [pkg.layers.l2_normalize(x, axis=1),
            pkg.layers.l2_normalize(x, axis=-1, epsilon=1e-3)]


def _create_tensor(pkg):
    x = pkg.layers.data("x", shape=[3, 4], dtype="float32")
    t = pkg.layers.create_tensor("float32", name="made")
    pkg.layers.assign(x, t)
    return [t]


CASES = {"mul": _mul, "clip": _clip, "clip_by_norm": _clip_by_norm,
         "multiplex": _multiplex, "l2_normalize": _l2_normalize,
         "create_tensor": _create_tensor}


def _feed(name):
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    if name == "mul":
        return {"x": x, "y": rng.standard_normal((12, 5)).astype(np.float32)}
    if name == "multiplex":
        return {k: rng.standard_normal((5, 4)).astype(np.float32)
                for k in "abc"} | {
            "ids": np.array([[2], [0], [1], [1], [0]], np.int32)}
    return {"x": x}


def _run(pkg, place, name):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        outs = CASES[name](pkg)
    exe = pkg.Executor(place)
    scope = pkg.Scope() if hasattr(pkg, "Scope") else pkg.core.scope.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main, feed=_feed(name), fetch_list=outs, scope=scope)
    return [np.asarray(g) for g in got], [op.type for op in
                                           main.global_block().ops]


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_wrapper_computes_what_the_reference_computes(name):
    want, jops = _run(pt, pt.CPUPlace(), name)
    got, tops = _run(tpt, "cpu", name)
    assert tops == jops
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL, (name, err)


def test_flags_exported_at_the_top_level():
    from paddle_tpu_torch import flags

    assert tpt.FLAGS is flags.FLAGS and "FLAGS" in tpt.__all__
    for name in ("check_nan_inf", "do_memory_benchmark"):
        assert getattr(tpt.FLAGS, name) == getattr(pt.FLAGS, name)


def _regression():
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    main.random_seed = 3
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[13], dtype="float32")
        y = tpt.layers.data("y", shape=[1], dtype="float32")
        pred = tpt.layers.fc(x, size=1)
        cost = tpt.layers.mean(tpt.layers.square_error_cost(pred, y))
        tpt.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return main, startup, cost, x, y


def _reader():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 13)).astype(np.float32)
    Y = X[:, :1] * 2.0
    yield list(zip(X, Y))


@pytest.mark.parametrize("switch", ["0", "1"])
def test_gradnorm_kill_switch(switch, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_GRADNORM", switch)
    main, startup, cost, x, y = _regression()
    norms = []
    scope = tpt.Scope()
    with tpt.scope_guard(scope):
        tr = tpt.Trainer(cost, [x, y], place="cpu", main_program=main,
                         startup_program=startup)
        tr.train(_reader, num_passes=1, event_handler=lambda e: norms.append(
            e.grad_norm) if isinstance(e, tpt.EndIteration) else None)
    if switch == "0":
        assert norms == [None] and scope.find_var(GRAD_NORM_VAR) is None
    else:
        assert norms[0] > 0 and scope.find_var(GRAD_NORM_VAR) is not None


def test_donate_state_is_accepted_and_changes_nothing():
    bits = []
    for donate in (True, False):
        main, startup, cost, x, y = _regression()
        exe, scope = tpt.Executor("cpu", donate_state=donate), tpt.Scope()
        assert exe.donate_state is donate
        exe.run(startup, scope=scope)
        feed = tpt.DataFeeder([x, y], "cpu").feed(next(_reader()))
        for _ in range(2):
            bits.append(exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scope)[0].tobytes())
    assert bits[:2] == bits[2:]


@pytest.fixture(scope="module")
def params():
    from paddle_tpu_torch.models import transformer

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        transformer.build(vocab_size=40, n_layer=1, n_head=2, d_model=16,
                          max_len=16, dropout_rate=0.0, dtype="float32")
    scope = tpt.Scope()
    tpt.Executor("cpu").run(startup, scope=scope)
    return transformer.extract_params(scope=scope, program=main)


def test_serving_engine_registry(params):
    reg = tobs.MetricsRegistry()
    glob = tobs.get_registry()
    glob.clear(prefix="serving.")
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(params, 1, 2, 16, max_len=16, max_slots=2,
                        device="cpu", registry=reg)
    eng.generate_many([np.array([1, 2, 3], np.int32)], max_new_tokens=4)
    assert reg.value("serving.completed") == 1
    assert eng.stats()["serving.completed"] == 1
    assert glob.value("serving.completed") == 0
    assert not glob.snapshot(prefix="serving.tokens")


def test_generate_accepts_a_key_and_ignores_it_when_greedy(params):
    from paddle_tpu_torch.models import transformer

    prompt = np.array([[3, 5, 7]], np.int64)
    kw = dict(max_len=10, n_layer=1, n_head=2, d_model=16,
              return_logits=False, device="cpu")
    a, _ = transformer.generate(params, prompt, **kw)
    b, _ = transformer.generate(params, prompt, key=np.uint32([0, 42]),
                                **kw)
    assert torch.equal(a, b)
    # with a temperature the key drives the draws: the same seed, the same
    # tokens, the prompt kept
    c, _ = transformer.generate(params, prompt, temperature=0.7, key=1, **kw)
    d, _ = transformer.generate(params, prompt, temperature=0.7, key=1, **kw)
    assert torch.equal(c, d)
    np.testing.assert_array_equal(c.numpy()[:, :3], prompt)

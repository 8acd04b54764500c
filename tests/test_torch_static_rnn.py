"""``scan_block`` through ``StaticRNN`` in the port against the JAX
package, on the CPU.

A small recurrent program is built the same way in both packages: a
sequence input ``x [b, t, d]`` with lengths; an outer activation ``enc
= fc(c)`` and an outer parameter ``gain`` that only the step's sub-block
reads (no op of the global block reads either after it is made: the
liveness trap of a plan that counts only an op's own slots); a memory
started from ``fc(c)``; per step ``h = tanh(fc([x_t, h]) + enc) *
gain``.  With ``set_sequence_length`` and in reverse (the op's
``reverse`` attr set in both programs), from one startup state, two
SGD steps: the losses within ORACLE_TOL f32's forward bound, the
fetched gradients of every parameter (``gain`` and ``enc``'s weight
among them, and not zero) within the gradient bound, the parameters
after the steps within the gradient bound.  Besides: the liveness plan
keeps ``enc`` until the scan, ``step_flops`` counts the sub-block's
products once a step, ``memory_optimize`` leaves the step's bits, and
the layers the slice leaves out raise naming their ROADMAP item.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3
B, T, D, C = 3, 5, 4, 6
LENGTHS = np.array([5, 2, 3], np.int32)


def _build(pkg, lengths=True, reverse=False):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[T, D], dtype="float32", lod_level=1)
        c = L.data("c", shape=[C], dtype="float32")
        enc = L.fc(input=c, size=D)
        h0 = L.fc(input=c, size=D, act="tanh")
        gain = L.create_parameter([D], "float32", name="gain",
                                  default_initializer=pkg.initializer
                                  .Constant(1.5))
        rnn = L.StaticRNN()
        with rnn.step():
            if lengths:
                rnn.set_sequence_length(x.length_var())
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            pre = L.fc(input=[x_t, h], size=D, bias_attr=False)
            new = L.elementwise_mul(L.tanh(L.elementwise_add(pre, enc)),
                                    gain)
            rnn.update_memory(h, new)
            rnn.step_output(new)
        out = rnn()
        L.link_sequence(out, x)
        pooled = L.sequence_pool(out, "sum")
        loss = L.mean(pooled)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    if reverse:
        for op in main.global_block().ops:
            if op.type == "scan_block":
                op.attrs["reverse"] = True
    return main, startup, loss, out


def _feed(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, T, D)).astype(np.float32),
            "x@LENGTH": LENGTHS,
            "c": rng.standard_normal((B, C)).astype(np.float32)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


def _pair(lengths=True, reverse=False, steps=2):
    jm, js, jl, jo = _build(pt, lengths, reverse)
    tm, ts, tl, to = _build(tpt, lengths, reverse)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(js, scope=scope)
    names = [v.name for v in jm.persistable_vars()
             if scope.find_var(v.name) is not None]
    init = {n: np.asarray(scope.get(n)) for n in names}
    tscope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    texe = tpt.Executor(tpt.CPUPlace())
    params = [p.name for p in jm.all_parameters()]
    fetch = [jl.name, jo.name] + [p + "@GRAD" for p in params]
    runs = []
    for i in range(steps):
        feed = _feed(i)
        want = exe.run(jm, feed=feed, fetch_list=fetch, scope=scope)
        got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        runs.append((want, got))
    return params, runs, scope, tscope


@pytest.mark.parametrize("lengths,reverse", [(True, False), (True, True),
                                             (False, False)],
                         ids=["frozen", "frozen_reverse", "unfrozen"])
def test_static_rnn_matches_the_reference(lengths, reverse):
    params, runs, scope, tscope = _pair(lengths, reverse)
    assert {"gain.w", "fc_0.w", "fc_0.b"} <= set(params)
    for want, got in runs:
        assert _rel(got[0], want[0]) <= FWD_TOL
        assert _rel(got[1], want[1]) <= FWD_TOL
        for name, g, w in zip(params, got[2:], want[2:]):
            assert np.abs(w).max() > 0, name       # every one is trained
            assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))
    for name in params:
        assert _rel(tscope.numpy(name), scope.get(name)) <= GRAD_TOL, name
    assert not np.allclose(tscope.numpy("gain.w"), 1.5)  # it was updated


@pytest.mark.parametrize("lengths", [True, False], ids=["frozen",
                                                        "unfrozen"])
def test_padded_steps_freeze_the_memory(lengths):
    """With ``set_sequence_length`` a padded step does not advance the
    memory: changing sample 1's input at its padded step 2 changes the
    output there, and not at step 3 (which starts from the state after
    step 1); without it, step 3 sees the change."""
    tm, ts, tl, to = _build(tpt, lengths=lengths)
    test = tm.clone(for_test=True)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(ts, scope=scope)
    feed = _feed(0)
    base = exe.run(test, feed=feed, fetch_list=[to.name], scope=scope)[0]
    feed["x"] = feed["x"].copy()
    feed["x"][1, 2] += 5.0                        # past sample 1's length
    moved = exe.run(test, feed=feed, fetch_list=[to.name], scope=scope)[0]
    np.testing.assert_array_equal(moved[1, :2], base[1, :2])
    assert not np.array_equal(moved[1, 2], base[1, 2])
    assert np.array_equal(moved[1, 3:], base[1, 3:]) == lengths


def test_the_plan_keeps_what_only_the_sub_block_reads():
    from paddle_tpu_torch.core.executor import _Plan, op_reads

    tm, _, tl, _ = _build(tpt)
    ops = tm.global_block().ops
    scan = next(i for i, op in enumerate(ops) if op.type == "scan_block")
    enc = ops[0].outputs["Out"][0]                # fc(c)'s product
    reads = op_reads(tm, ops[scan])
    assert "gain.w" in reads and "fc_0.b" not in reads
    assert "gain.w" not in ops[scan].input_names()
    plan = _Plan(tm, ops[:tm.global_block().backward_index], {tl.name})
    dropped = {n: i for i, names in enumerate(plan.drop) for n in names}
    enc_sum = next(op.outputs["Out"][0] for op in ops
                   if op.type == "elementwise_add"
                   and enc in op.input_names())
    assert dropped[enc_sum] == scan
    assert dropped["gain.w"] == scan              # read in the sub-block


def test_step_flops_count_the_sub_block_once_a_step():
    from paddle_tpu_torch.core.executor import step_flops

    tm, _, _, _ = _build(tpt)
    b = 7
    # global block: fc(c) twice, [b, C] x [C, D], weights and (for h0,
    # into the memory) outputs differentiated: 3 products each (the
    # input c is data: no dx)
    outer = 2 * (2 * 2 * b * C * D)
    # sub-block, each step: fc([x_t, h]) is two products [b, D] x [D, D],
    # each with dW and dx
    inner = 2 * (3 * 2 * b * D * D)
    assert step_flops(tm, b) == outer + T * inner


@pytest.mark.parametrize("policy", ["compact", "full"])
def test_memory_optimize_keeps_the_steps_bits(policy):
    runs = []
    for remat in (False, True):
        tm, ts, tl, to = _build(tpt)
        if remat:
            tpt.memory_optimize(tm, policy=policy)
        scope = tpt.Scope()
        exe = tpt.Executor(tpt.CPUPlace())
        torch.manual_seed(0)
        exe.run(ts, scope=scope)
        losses = [exe.run(tm, feed=_feed(i), fetch_list=[tl],
                          scope=scope)[0] for i in range(2)]
        runs.append((losses, {p.name: scope.numpy(p.name).copy()
                              for p in tm.all_parameters()}))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_array_equal(np.asarray(l0), np.asarray(l1))
    for n in p0:
        np.testing.assert_array_equal(p0[n], p1[n])


@pytest.mark.parametrize("make", [lambda L: L.ParallelDo()],
                         ids=["ParallelDo"])
def test_unported_control_flow_raises_naming_its_item(make):
    """``ParallelDo`` records its block and a ``parallel_do`` op that runs
    the block inline (the reference's lowering): it builds and runs, and
    gives the JAX package's output on the same feed."""
    feed = {"x": np.random.default_rng(3).standard_normal(
        (2, 3)).astype(np.float32)}
    outs = []
    for pkg in (pt, tpt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[3], dtype="float32")
            pd = make(pkg.layers)
            with pd.do():
                y = pkg.layers.scale(pd.read_input(x), scale=3.0)
        assert [op.type for op in main.global_block().ops] == [
            "parallel_do"]
        got, = pkg.Executor(pkg.CPUPlace()).run(main, feed=feed,
                                                fetch_list=[y])
        outs.append(np.asarray(got))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], 3.0 * feed["x"])


def test_dynamic_rnn_is_static_rnn():
    assert tpt.layers.DynamicRNN is tpt.layers.StaticRNN

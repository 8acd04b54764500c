"""The port's static-analysis engine (``paddle_tpu_torch/analysis``)
against the JAX package's ``paddle_tpu.analysis``, on the CPU.

Held against the reference (the same Programs built in both packages):
the registered check ids and levels; every planted Program-level defect
gives the reference's findings (id, severity, level, location and
message); the clean GPT program lints clean at the Program level in both
under every policy; ``spec-conflict`` on a dp mesh; ``report_json``
output loads in the other package's ``report_from_json`` both ways; the
pure ``preflight_hbm`` / ``donation_findings`` helpers; the Executor's
fold-in counts the same findings on the same program, and both kill
switches leave out the reference's keys.

The port's own: the step- and run-level planted defects give the
reference's check ids (an ungrouped layer stack, a bf16 carried
accumulator, tanh in a checkpointed region, degraded offload, plain
kernels in a timed run, an over-budget step, an in-loop reduction), a
declared ``shard_activation`` stays silent, the clean GPT gives zero
findings at every level under every policy, strict mode raises.  The
card's cases (``cuda``) are in ``tests/test_torch_cuda_analysis.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu import analysis as janalysis
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import analysis
from paddle_tpu_torch.__main__ import _ragged_gpt
from paddle_tpu_torch.analysis.comm.plan import CommOp, CommPlan
from paddle_tpu_torch.analysis.jaxpr_checks import timed_run
from paddle_tpu_torch.models import transformer as ttr
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

N_LAYER, T, D = 5, 12, 32


def _gpt(pkg, tr, policy=None, n_layer=N_LAYER, fused_head=False):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 7
    with pkg.program_guard(main, startup):
        outs = tr.build(vocab_size=29, n_layer=n_layer, n_head=2,
                        d_model=D, max_len=T, dropout_rate=0.0,
                        dtype="float32", fused_head=fused_head)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    return main, startup, outs["avg_cost"]


def _planted(pkg):
    """The reference's planted Program: a dead fc chain, an orphan
    declaration, an add of two undefined operands of conflicting
    shapes, and a fetched var written twice."""
    layers = pkg.layers
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        y = layers.fc(x, 2, name="live")
        layers.fc(x, 3, name="deadfc")
        blk = main.global_block()
        blk.create_var(name="orphan", shape=(3,), dtype="float32")
        a = blk.create_var(name="a", shape=(-1, 4), dtype="float32")
        b = blk.create_var(name="b", shape=(-1, 8), dtype="float32")
        c = blk.create_var(name="c", shape=(-1, 4), dtype="float32")
        blk.append_op("elementwise_add", {"X": [a.name], "Y": [b.name]},
                      {"Out": [c.name]})
        blk.append_op("relu", {"X": [x.name]}, {"Out": [y.name]})
    return main, y


def _rows(report):
    return sorted((f.check, f.severity, f.level, f.location, f.message)
                  for f in report)


def test_registered_checks_are_the_references():
    got = sorted((s.id, s.level) for s in analysis.registered_checks())
    want = sorted((s.id, s.level) for s in janalysis.registered_checks())
    assert got == want and len(got) == 18
    assert analysis.LEVELS == janalysis.LEVELS
    assert analysis.SEVERITIES == janalysis.SEVERITIES
    assert analysis.LINT_JSON_SCHEMA_VERSION == \
        janalysis.LINT_JSON_SCHEMA_VERSION == 1


def test_planted_program_defects_give_the_reference_findings():
    tmain, ty = _planted(tpt)
    jmain, jy = _planted(pt)
    got = analysis.lint(tmain, fetch_list=[ty], levels=("program",))
    want = janalysis.lint(jmain, fetch_list=[jy], levels=("program",))
    assert _rows(got) == _rows(want)
    assert set(got.ids()) == {
        "program.dead-code", "program.shape-dtype",
        "program.read-before-write", "program.fetch-overwritten"}
    with pytest.raises(analysis.AnalysisError,
                       match="program.read-before-write"):
        analysis.lint(tmain, fetch_list=[ty], levels=("program",),
                      strict=True)


@pytest.mark.parametrize("policy",
                         [None, "selective", "compact", "full", "offload"])
def test_clean_gpt_lints_clean(policy):
    """Zero findings at the Program level in both packages, and at every
    level in the port (the lowered step and the run on the CPU)."""
    tmain, _ts, tloss = _gpt(tpt, ttr, policy)
    jmain, _js, jloss = _gpt(pt, jtr, policy)
    assert len(janalysis.lint(jmain, fetch_list=[jloss],
                              levels=("program",))) == 0
    rep = analysis.lint(tmain, fetch_list=[tloss], layer_count=N_LAYER,
                        device="cpu")
    assert len(rep) == 0, rep.ids()


def test_spec_conflict_on_a_dp_mesh_is_the_references():
    """A weight annotated P(None, 'dp') on an odd dim cannot hold on a dp
    mesh of 2: the same finding in both packages."""
    from paddle_tpu.parallel.mesh import make_mesh as jmesh
    from paddle_tpu.parallel.api import P as JP
    from paddle_tpu_torch.parallel.api import P as TP
    from paddle_tpu_torch.parallel.mesh import make_mesh as tmesh

    reps = []
    import jax

    for pkg, mesh, P in ((tpt, tmesh({"dp": 2}), TP),
                         (pt, jmesh({"dp": 2}, jax.devices()[:2]), JP)):
        pkg.core.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[4])
            y = pkg.layers.fc(x, 3, name="odd")
        w, = [v for v in main.all_parameters() if len(v.shape) == 2]
        w.partition_spec = P(None, "dp")
        reps.append(analysis.lint(main, fetch_list=[y], levels=("program",),
                                  mesh=mesh) if pkg is tpt else
                    janalysis.lint(main, fetch_list=[y],
                                   levels=("program",), mesh=mesh))
    assert _rows(reps[0]) == _rows(reps[1])
    assert reps[0].ids() == ["program.spec-conflict"]


def test_report_json_round_trips_across_packages():
    tmain, ty = _planted(tpt)
    rep = analysis.lint(tmain, fetch_list=[ty], levels=("program",))
    obj = analysis.report_json(rep, levels=("program",))
    back = janalysis.report_from_json(obj)
    assert janalysis.report_json(back, levels=("program",)) == obj
    assert back.counts() == rep.counts() and back.ok == rep.ok
    jmain, jy = _planted(pt)
    jobj = janalysis.report_json(janalysis.lint(
        jmain, fetch_list=[jy], levels=("program",)), levels=("program",))
    assert jobj == obj
    assert analysis.report_json(analysis.report_from_json(jobj),
                                levels=("program",)) == obj
    with pytest.raises(ValueError, match="schema_version"):
        analysis.report_from_json(dict(obj, schema_version=2))


def test_pure_helpers_are_the_references():
    """``preflight_hbm`` and ``donation_findings`` give the reference's
    findings (the port's messages name a step where the reference's name
    a compiled one)."""
    for args in ((5 << 30, 4 << 30, "step"), (1 << 30, 4 << 30, ""),
                 (None, 4 << 30, ""), (5 << 30, None, "")):
        got = analysis.preflight_hbm(*args)
        want = janalysis.preflight_hbm(*args)
        assert [(f.check, f.severity, f.level, f.location, f.data)
                for f in got] == [
            (f.check, f.severity, f.level, f.location, f.data)
            for f in want]
    for mem in ({"argument_bytes": 5 << 20, "alias_bytes": 0},
                {"argument_bytes": 5 << 20, "alias_bytes": 4 << 20},
                {"argument_bytes": 1 << 10, "alias_bytes": 0}, {}):
        got = analysis.donation_findings(mem, True)
        want = janalysis.donation_findings(mem, True)
        assert [(f.check, f.severity, f.data) for f in got] == [
            (f.check, f.severity, f.data) for f in want]


def _step_ids(main, fetch, **kw):
    return analysis.lint(main, fetch_list=fetch, levels=("jaxpr",),
                         device="cpu", **kw).ids()


def test_planted_step_level_defects():
    """The reference's step-level planted cases give its check ids."""
    layers = tpt.layers
    from paddle_tpu_torch.core.executor import remat_plan

    ragged, _s, rloss = _ragged_gpt(tpt, "selective", n_layer=N_LAYER,
                                    t=T, d=D)
    assert _step_ids(ragged, [rloss], layer_count=N_LAYER) == [
        "jaxpr.scan-locality"]
    # no two layers of the ragged stack group: the transpiler's segments
    # run as they are
    plan = remat_plan(ragged, torch.device("cpu"))
    assert plan["groups"] == [] and plan["regions"] == [
        tuple(r) for r in ragged._remat_segments]
    main, _s, loss = _gpt(tpt, ttr, "selective")
    assert len(remat_plan(main, torch.device("cpu"))["groups"]) == 1
    assert _step_ids(main, [loss], layer_count=N_LAYER) == []
    with timed_run():
        assert _step_ids(main, [loss]) == ["jaxpr.kernel-backend"]

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        xb = layers.data("xb", shape=[16, 8], dtype="bfloat16")
        init = layers.reduce_mean(xb, dim=1)
        rnn = layers.StaticRNN(name="acc")
        with rnn.step():
            xt = rnn.step_input(xb)
            acc = rnn.memory(init)
            new = acc + xt
            rnn.update_memory(acc, new)
            rnn.step_output(new)
        tot = layers.reduce_sum(rnn())
    assert _step_ids(main, [tot]) == ["jaxpr.bf16-accum"]

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        h = layers.data("x", shape=[16])
        for i in range(4):
            h = layers.fc(h, 16, act="tanh", name=f"l{i}")
        loss = layers.reduce_mean(layers.fc(h, 1, name="head"))
        tpt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    tpt.memory_optimize(main, policy="full")
    assert _step_ids(main, [loss]) == ["jaxpr.tanh-gelu"]

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        h = layers.fc(layers.data("x", shape=[16]), 12, act="relu",
                      name="a1")
        h = layers.fc(h, 6, act="sigmoid", name="b1")
        loss = layers.reduce_mean(layers.fc(h, 1, name="c1"))
        tpt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    tpt.memory_optimize(main, policy="offload")
    assert _step_ids(main, [loss]) == ["jaxpr.kernel-residual"]


def test_declared_shard_activation_stays_silent():
    from paddle_tpu_torch.parallel import api as papi

    main, _s, loss = _gpt(tpt, ttr, "selective")
    blk = main.global_block()
    flash = [op for op in blk.ops if op.type.startswith("flash_attention")]
    papi.shard_activation(blk._find_var(flash[2].outputs["Out"][0]),
                          papi.P(None, "sp", None))
    from paddle_tpu_torch.analysis.framework import CheckContext

    ctx = CheckContext(main, fetch_list=[loss], device="cpu")
    assert ctx.walk["sharding_constraints"]          # the record is read
    assert _step_ids(main, [loss]) == []


def test_run_level_planted_defects():
    main, _s, loss = _gpt(tpt, ttr)
    rep = analysis.lint(main, fetch_list=[loss], levels=("hlo",),
                        hbm_budget=1, device="cpu")
    assert rep.ids() == ["hlo.hbm-preflight"]
    assert rep.errors[0].data["budget_bytes"] == 1
    with pytest.raises(analysis.AnalysisError):
        analysis.lint(main, fetch_list=[loss], levels=("hlo",),
                      hbm_budget=1, device="cpu", strict=True)
    plan = CommPlan([CommOp("all-reduce", 4096, ("dp",), True, "bwd-scan"),
                     CommOp("all-gather", 1024, ("fsdp",), True,
                            "fwd-scan")], {"dp": 2, "fsdp": 2})
    found = analysis.compile_findings(memstats={}, comm=plan.comm_report(),
                                      comm_plan=plan)
    assert sorted((f.check, f.severity) for f in found) == [
        ("hlo.inloop-collective", "error"),
        ("hlo.inloop-collective", "info")]
    assert analysis.compile_findings(
        memstats={}, comm=plan.comm_report(), comm_plan=plan,
        in_loop_expected=True)[0].severity == "info"


def test_audit_program_reports_grouped_flash_ops():
    main, startup, loss = _gpt(tpt, ttr, "selective")
    scope = tpt.Scope()
    tpt.Executor("cpu").run(startup, scope=scope)
    rep = analysis.audit_program(main, None, [loss], scope=scope,
                                 layer_count=N_LAYER, device="cpu",
                                 absent_shapes=[(N_LAYER, T, D)])
    assert rep["pallas_total"] == N_LAYER and rep["pallas_outside_scan"] \
        <= 1
    assert rep["absent_shape_hits"] == {(N_LAYER, T, D): 0}
    assert rep["scan_remat_plan"][0]["count"] >= N_LAYER - 1
    assert rep["memory_source"] == "estimate" and \
        rep["hbm_high_water_bytes"] > 0


def _fc_program(pkg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.fc(x, 2, name="live")
        pkg.layers.fc(x, 3, name="deadfc")  # dead, but lowerable
    return main, startup, y


_LINT_KEYS = ("lint_findings", "lint_errors", "lint_checks")


def _fold(pkg, place, monkeypatch, off=()):
    """The fc program's first run in ``pkg`` with the kill switches
    ``off`` set: ``(exe, run)``, ``run()`` another step."""
    for k in ("PADDLE_TPU_LINT", "PADDLE_TPU_ATTR"):
        if k in off:
            monkeypatch.setenv(k, "0")
        else:
            monkeypatch.delenv(k, raising=False)
    main, startup, y = _fc_program(pkg)
    scope = pkg.Scope()
    exe = pkg.Executor(place)
    exe.run(startup, scope=scope)

    def run():
        exe.run(main, feed={"x": np.zeros((2, 4), np.float32)},
                fetch_list=[y], scope=scope)

    run()
    return exe, run


def test_fold_in_counts_the_references_findings(monkeypatch):
    texe, trun = _fold(tpt, "cpu", monkeypatch)
    jexe, _ = _fold(pt, None, monkeypatch)
    got = {k: texe.last_step_cost.get(k) for k in _LINT_KEYS}
    assert got == {k: jexe.last_step_cost.get(k) for k in _LINT_KEYS}
    assert got["lint_errors"] == 0 and got["lint_findings"] >= 1
    assert "program.dead-code" in got["lint_checks"]
    trun()      # a cache hit carries the first run's fold-in
    assert texe.last_step_cost["cache_hit"] is True
    assert {k: texe.last_step_cost.get(k) for k in _LINT_KEYS} == got


@pytest.mark.parametrize("off", ["PADDLE_TPU_LINT", "PADDLE_TPU_ATTR"])
def test_kill_switches_leave_out_the_references_keys(off, monkeypatch):
    texe, _ = _fold(tpt, "cpu", monkeypatch, off=(off,))
    jexe, _ = _fold(pt, None, monkeypatch, off=(off,))
    keys = (_LINT_KEYS if off == "PADDLE_TPU_LINT" else ("attribution",))
    for k in keys:
        assert (k in texe.last_step_cost) == (k in jexe.last_step_cost) \
            is False
    if off == "PADDLE_TPU_ATTR":
        assert texe.last_attribution is None
        assert texe.last_step_cost["bytes_accessed"] is None
        assert "lint_findings" in texe.last_step_cost
    else:
        assert texe.last_step_cost["attribution"]["coverage"] == 1.0


def test_lints_fold_in_once_a_step_and_the_table_once_a_batch(monkeypatch):
    """The program- and run-level lints run at a lowered step's first
    run only (the Program they read does not change with the batch); the
    attribution table runs at each new batch; the hook's seconds are
    recorded; a fold-in part that raises never blocks the run."""
    from paddle_tpu_torch.analysis import hlo_tools
    from paddle_tpu_torch.observability import attribution as tattr
    from paddle_tpu_torch.observability import get_registry

    for k in ("PADDLE_TPU_LINT", "PADDLE_TPU_ATTR"):
        monkeypatch.delenv(k, raising=False)
    calls = {"lint": 0, "table": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(analysis, "compile_findings",
                        spy("lint", analysis.compile_findings))
    monkeypatch.setattr(tattr, "attribute_step",
                        spy("table", tattr.attribute_step))
    reg = get_registry()
    hist = reg.histogram("executor.fold_in_seconds")
    errs = reg.counter("executor.fold_in_errors")
    main, startup, y = _fc_program(tpt)
    scope = tpt.Scope()
    exe = tpt.Executor("cpu")
    exe.run(startup, scope=scope)
    calls.update(lint=0, table=0)     # the startup program's own fold-in
    n0, e0 = hist.count, errs.value

    def run(b):
        return exe.run(main, feed={"x": np.zeros((b, 4), np.float32)},
                       fetch_list=[y], scope=scope)

    run(2)
    first = {k: exe.last_step_cost.get(k) for k in _LINT_KEYS}
    assert calls == {"lint": 1, "table": 1}
    assert first["lint_findings"] >= 1
    bytes2 = exe.last_attribution["bytes_total"]
    run(3)
    assert calls == {"lint": 1, "table": 2}
    assert {k: exe.last_step_cost.get(k) for k in _LINT_KEYS} == first
    assert exe.last_attribution["bytes_total"] > bytes2
    run(2)
    assert calls == {"lint": 1, "table": 2}
    assert hist.count == n0 + 2 and hist.max > 0

    def boom(*_a, **_k):
        raise RuntimeError("planted")

    monkeypatch.setattr(hlo_tools, "kernel_backends", boom)
    out = run(5)
    assert out[0].shape == (5, 2) and errs.value == e0 + 1
    assert exe.last_step_cost["lint_findings"] == first["lint_findings"]

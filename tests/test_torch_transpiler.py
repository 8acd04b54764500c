"""The port's ``DistributeTranspiler`` / ``DistributedTrainer`` against the
JAX package's, on the CPU, on a small CTR-DNN (vocab 16, 2 slots,
embedding 4: BASELINE config 5's model cut down): the embedding tables
on the sparse path (prefetch, touched-row gradients, lazy sparse Adam),
the tower on the dense path (blockwise sends, the delta fetch), four
in-process servers.

* From the reference's startup state and the same seeded feeds, serial
  and pipelined, each step's loss within ORACLE_TOL f32's forward bound
  (2e-4) and every parameter on the servers after the steps within the
  gradient bound (1e-3 of its largest entry).
* With every vocabulary row in every batch, the port's distributed run
  equals its own local Adam run (lazy sparse Adam is dense Adam there).
* The ``-1``-padded ``@ROWIDS`` gather wraps to the last row, as
  ``jnp.take`` does, and that row is dropped server-side.
* The tables and the dense parameters keep their storage across steps:
  rows and parameters are written in place.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.distributed import pserver as jps
from paddle_tpu.distributed import transpiler as jtr
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.distributed import pserver as tps
from paddle_tpu_torch.distributed import transpiler as ttr
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3

VOCAB, EMB, SLOTS = 16, 4, 2
CFG = dict(sparse_feature_dim=VOCAB, num_slots=SLOTS, embedding_size=EMB,
           dense_dim=3, hidden=(8,), learning_rate=1e-2)


def _build(pkg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = pkg.models.ctr_dnn.build(**CFG)
    return main, startup, out


def _feeds(batch, steps=4, every_row=False, seed=0):
    rng = np.random.default_rng(seed)
    feeds = []
    for _ in range(steps):
        feed = {"dense_feature": rng.normal(size=(batch, 3)).astype(
            np.float32),
            "click": rng.integers(0, 2, (batch, 1)).astype(np.int64)}
        for s in range(SLOTS):
            if every_row:
                ids = rng.permutation(VOCAB)
            else:
                ids = rng.integers(0, VOCAB, batch)
            feed[f"slot_{s}"] = ids.reshape(-1, 1).astype(np.int64)
        feeds.append(feed)
    return feeds


def _reference_state():
    main, startup, _ = _build(pt)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    return {v.name: np.array(scope.get(v.name))
            for v in main.persistable_vars()
            if scope.find_var(v.name) is not None}


class _Applied:
    """The sparse updates the servers of one run have applied, counted
    across them.  In pipelined mode step k's prefetch otherwise races the
    previous round trip's sparse sends on the worker thread, so two runs
    of one package may read the rows before or after them; waiting, before
    step k, for the updates of every earlier step fixes the order (after
    them) for both packages.  Serial mode never waits."""

    def __init__(self):
        self.n, self.cv = 0, threading.Condition()

    def server(self, server_cls, **kwargs):
        applied = self

        class Counted(server_cls):
            def send_sparse_grad(self, name, rows, values):
                out = super().send_sparse_grad(name, rows, values)
                with applied.cv:
                    applied.n += 1
                    applied.cv.notify_all()
                return out

        return Counted(**kwargs)

    def step(self, dt, k, feed, loss):
        with self.cv:
            if not self.cv.wait_for(lambda: self.n >= k * SLOTS, 30):
                raise TimeoutError(f"{self.n} sparse updates before step {k}")
        out, = dt.train_step(feed, extra_fetch=[loss])
        return float(np.asarray(out).ravel()[0])


def _tables(main):
    return [p.name for p in main.all_parameters()
            if tuple(p.shape) == (VOCAB, EMB)]


def _run_reference(state, feeds, mode):
    main, _, out = _build(pt)
    scope = pt.Scope()
    for n, v in state.items():
        scope.set(n, v.copy())
    pt.core.scope._scope_stack.append(scope)
    try:
        t = jtr.DistributeTranspiler().transpile(main, pservers=4)
        applied = _Applied()
        servers = [applied.server(jps.ParameterServer, index=i)
                   for i in range(4)]
        dt = jtr.DistributedTrainer(
            t, pt.Executor(), servers, learning_rate=CFG["learning_rate"],
            mode=mode, sparse_params={p: f"slot_{i}" for i, p in
                                      enumerate(_tables(main))})
        dt.init_params_on_pservers()
        losses = [applied.step(dt, k, f, out["avg_cost"])
                  for k, f in enumerate(feeds)]
        dt.flush()
        params = dt.client.get_params(dt.param_names)
        dt.close()
    finally:
        pt.core.scope._scope_stack.pop()
    return losses, params


def _run_port(state, feeds, mode, check_storage=False):
    main, _, out = _build(tpt)
    scope = tpt.load_numpy_state(tpt.Scope(), state, device="cpu")
    with tpt.scope_guard(scope):
        t = ttr.DistributeTranspiler().transpile(main, pservers=4)
        applied = _Applied()
        servers = [applied.server(tps.ParameterServer, index=i)
                   for i in range(4)]
        dt = ttr.DistributedTrainer(
            t, tpt.Executor(tpt.CPUPlace()), servers,
            learning_rate=CFG["learning_rate"], mode=mode,
            sparse_params={p: f"slot_{i}" for i, p in
                           enumerate(_tables(main))})
        dt.init_params_on_pservers()
        ptrs = {p: scope.get(p).data_ptr() for p in dt.param_names}
        losses = []
        for k, f in enumerate(feeds):
            losses.append(applied.step(dt, k, f, out["avg_cost"]))
            if check_storage:
                assert {p: scope.get(p).data_ptr()
                        for p in dt.param_names} == ptrs
            parts = dt.last_step_seconds
            assert sorted(parts) == ["compute", "exchange", "install",
                                     "rows"]
            assert min(parts.values()) >= 0.0
        dt.flush()
        params = dt.client.get_params(dt.param_names)
        local = {p: scope.numpy(p).copy() for p in dt.param_names}
        dt.close()
    return losses, params, local


@pytest.mark.parametrize("mode", ["serial", "pipelined"])
def test_distributed_trainer_matches_the_reference(mode):
    state = _reference_state()
    feeds = _feeds(batch=8)
    want_losses, want = _run_reference(state, feeds, mode)
    got_losses, got, local = _run_port(state, feeds, mode,
                                       check_storage=True)
    np.testing.assert_allclose(got_losses, want_losses, rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert sorted(got) == sorted(want)
    for n in want:
        scale = max(1e-6, float(np.abs(want[n]).max()))
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= GRAD_TOL * scale, f"{n}: {err:.3e} of {scale:.3e}"
    if mode == "serial":
        # the scope holds what the servers hold (dense installs; the
        # tables hold the rows fetched before the last step)
        for n in want:
            if n not in _tables(_build(tpt)[0]):
                np.testing.assert_array_equal(local[n], got[n])


def test_distributed_sparse_adam_matches_local_adam_when_every_row_is_touched():
    main, startup, out = _build(tpt)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: scope.numpy(v.name).copy()
             for v in main.persistable_vars()
             if scope.find_var(v.name) is not None}
    feeds = _feeds(batch=VOCAB, every_row=True)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[out["avg_cost"]], scope=scope)
    local = {p.name: scope.numpy(p.name).copy()
             for p in main.all_parameters()}
    _, dist, _ = _run_port(state, feeds, "serial")
    for n, v in local.items():
        np.testing.assert_allclose(dist[n], v, rtol=2e-4, atol=2e-5,
                                   err_msg=n)


def test_padded_rowids_gather_wraps_to_the_last_row_and_is_dropped():
    main, startup, out = _build(tpt)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    t = ttr.DistributeTranspiler().transpile(main, pservers=2)
    table = _tables(main)[0]
    with tpt.scope_guard(scope):
        dt = ttr.DistributedTrainer(
            t, exe, [tps.ParameterServer(index=i) for i in range(2)],
            learning_rate=0.1, sparse_params={table: "slot_0"})
    feed = _feeds(batch=4)[0]
    feed["slot_0"] = np.array([[2], [5], [2], [9]], np.int64)
    rows = np.array([2, 5, 9, -1], np.int64)
    grad, rowgrad = exe.run(
        dt.trainer_program, scope=scope,
        feed=dict(feed, **{f"{table}@ROWIDS": rows}),
        fetch_list=[table + "@GRAD", table + "@GRADROWS"])
    np.testing.assert_array_equal(rowgrad[:3], grad[[2, 5, 9]])
    np.testing.assert_array_equal(rowgrad[3], grad[-1])   # -1 wraps
    assert np.abs(grad[[2, 5, 9]]).max() > 0
    # the server drops the padded row: the last row does not move
    with tpt.scope_guard(scope):
        dt.init_params_on_pservers()
        before = dt.client.get_params([table])[table]
        dt.train_step(feed)
        after = dt.client.get_params([table])[table]
    moved = np.abs(after - before).max(axis=1) > 0
    assert moved.tolist() == [i in (2, 5, 9) for i in range(VOCAB)]
    dt.close()


def test_numpy_feeds_on_a_cpu_trainer_stay_host_values():
    main, startup, _ = _build(tpt)
    exe = tpt.Executor(tpt.CPUPlace())
    t = ttr.DistributeTranspiler().transpile(main, pservers=1)
    dt = ttr.DistributedTrainer(t, exe, [tps.ParameterServer()])
    feed = _feeds(batch=2)[0]
    assert dt._device_feed(feed) is feed
    ids = dt._batch_rows({"x": torch.tensor([[3], [-1], [3], [1]])}, "x")
    assert ids.tolist() == [1, 3]
    dt.close()

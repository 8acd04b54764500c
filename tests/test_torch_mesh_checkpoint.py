"""Sharded checkpoints, ``Trainer(mesh=...)``, ``distributed.launch``
and Momentum on a mesh — one spawn of 4 ranks joined by
``launch.init_multihost`` through a file store in a temporary directory.

* Momentum on dp4, three steps from the JAX package's startup state,
  against the JAX package's unsharded run and the port's: losses within
  2e-4, parameters within 1e-3 of their largest entry (the key biases
  apart, as in ``test_torch_mesh_training.py``);
* a sharded checkpoint saved from dp2 x tp2 (``.shard<p>.npz`` files with
  CRC sidecars, the JAX package's layout) loads on dp2 x fsdp2 (another
  mesh of 4), into one process of the port, and into the JAX package's
  loader, equal in f32; the JAX package's checkpoint loads on dp2 x tp2;
* ``Trainer(mesh=...)`` with CPU prefetch on dp4 gives the losses and
  parameters of the JAX package's unsharded Trainer (and the port's);
* ``ParallelDo`` over ``get_places`` gives the JAX package's output.
"""

import contextlib
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr

import torch_mesh_workers as W
from test_torch_mesh_training import _feeds, _port_unsharded, _reference
from torch_ref_gauges import restore_reference_gauges  # noqa: F401


@contextlib.contextmanager
def _jax_scope(scope):
    pt.core.scope._scope_stack.append(scope)
    try:
        yield scope
    finally:
        pt.core.scope._scope_stack.pop()


def _trainer_rows():
    out = []
    for f in _feeds():
        out.append([(t, l) for t, l in zip(f["tokens"], f["labels"])])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the JAX package's runs on its xla_ref kernels; the port's (which
    # reads the same variable, naming its own backends) on auto
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_KERNEL_BACKEND", "xla_ref")
        jax_runs = _jax_runs(tmp)
    return _runs(tmp, *jax_runs)


def _jax_runs(tmp):
    refs = {o: _reference(o) for o in ("adam", "momentum")}
    state = {o: r[0] for o, r in refs.items()}
    # the JAX package's checkpoint of its startup state
    main, startup, _ = W.build_gpt(pt, jtr)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with _jax_scope(scope):
        exe.run(startup)
        pt.io.save_persistables(exe, str(tmp / "jax_ckpt"), main)
    jax_state = {v.name: np.asarray(scope.get(v.name))
                 for v in main.persistable_vars()}
    return refs, jax_state, _jax_trainer(state["adam"])


def _runs(tmp, refs, jax_state, jax_trainer):
    state = {o: r[0] for o, r in refs.items()}
    ranks = W.spawn(4, W.checkpoint_and_trainer, str(tmp / "store"),
                    state, _feeds(), str(tmp / "jax_ckpt"),
                    str(tmp / "port_ckpt"), _trainer_rows(), init=False)
    port = {"momentum": _port_unsharded(state["momentum"], "momentum")}
    return {"refs": refs, "port": port, "ranks": ranks, "tmp": tmp,
            "jax_state": jax_state, "jax_trainer": jax_trainer}


def _jax_trainer(state):
    """The JAX package's unsharded Trainer on the same batches from
    ``state``: its losses and parameters."""
    main, startup, outs = W.build_gpt(pt, jtr)
    scope, losses = pt.Scope(), []

    def on_event(e):
        if isinstance(e, pt.trainer.EndIteration):
            losses.append(float(np.asarray(e.cost).reshape(-1)[0]))

    rows = _trainer_rows()
    with _jax_scope(scope):
        tr = pt.trainer.Trainer(outs["avg_cost"], outs["feed"],
                                place=pt.CPUPlace(), main_program=main,
                                startup_program=startup)
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        tr._initialized = True
        tr.train(lambda: iter([[tuple(r) for r in b] for b in rows]),
                 num_passes=1, event_handler=on_event)
    return losses, {p.name: np.asarray(scope.get(p.name))
                    for p in main.all_parameters()}


def test_launch_joins_the_ranks(runs):
    for r in runs["ranks"]:
        assert r["allreduce"] == 10.0
        assert r["mesh"] == {"dp": 2, "tp": 2}


def test_momentum_on_dp4_matches_unsharded(runs):
    _state, ref_losses, ref_params = runs["refs"]["momentum"]
    port_losses, port_params = runs["port"]["momentum"]
    got = runs["ranks"][0]["momentum"]
    for a, b, c in zip(got["losses"], ref_losses, port_losses):
        assert abs(a - b) / abs(b) < 2e-4 and abs(a - c) / abs(c) < 2e-4
    for k, want in ref_params.items():
        if "_att_k.b" in k:
            continue
        err = np.abs(got["params"][k] - want).max() / np.abs(want).max()
        assert err < 1e-3, k
    for r in runs["ranks"]:
        assert r["momentum"]["viol"] == []


def test_sharded_checkpoint_files_and_reload_on_another_mesh(runs):
    tmp = runs["tmp"]
    ck = runs["ranks"][0]["ckpt"]
    names = os.listdir(tmp / "port_ckpt")
    assert {f"__done{p}__" for p in range(4)} <= set(names)
    assert {f"__shards{p}__.pkl" for p in range(4)} <= set(names)
    assert {f"block0_ffn1.w.shard{p}.npz" for p in range(4)} <= set(names)
    with open(tmp / "port_ckpt" / "__manifest__.pkl", "rb") as f:
        manifest = pickle.load(f)
    assert manifest["__nprocs__"] == 4
    assert manifest["block0_ffn1.w"]["sharded"]
    assert not manifest["tok_emb.w"].get("sharded")
    assert ck["tp_block"] == (64, 128)          # dp2 x tp2: columns
    assert ck["fsdp_block"] == (32, 256)        # dp2 x fsdp2: rows
    for r in runs["ranks"]:
        assert r["ckpt"]["loaded_max_err"] == 0.0


def test_sharded_checkpoint_loads_in_one_process_of_both_packages(runs):
    tmp = runs["tmp"]
    saved = runs["ranks"][0]["ckpt"]["saved"]
    main, _startup, _ = W.build_gpt(tpt, ttr)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    with tpt.scope_guard(scope):
        tpt.io.load_persistables(exe, str(tmp / "port_ckpt"), main)
    for n, want in saved.items():
        np.testing.assert_array_equal(scope.get(n).numpy(), want)
    jmain, _jstartup, _ = W.build_gpt(pt, jtr)
    jexe, jscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with _jax_scope(jscope):
        pt.io.load_persistables(jexe, str(tmp / "port_ckpt"), jmain)
    for n, want in saved.items():
        np.testing.assert_array_equal(np.asarray(jscope.get(n)), want)


def test_jax_checkpoint_loads_on_a_mesh(runs):
    got = runs["ranks"][0]["ckpt"]["from_jax"]
    for n, want in runs["jax_state"].items():
        np.testing.assert_array_equal(got[n], want)


def test_trainer_on_a_mesh_with_cpu_prefetch(runs):
    want_losses, want_params = runs["jax_trainer"]
    main, startup, outs = W.build_gpt(tpt, ttr)
    scope = tpt.Scope()
    losses = []

    def on_event(e):
        if isinstance(e, tpt.EndIteration):
            losses.append(float(np.asarray(e.cost).reshape(-1)[0]))

    rows = _trainer_rows()
    with tpt.scope_guard(scope):
        tr = tpt.Trainer(outs["avg_cost"], outs["feed"],
                         place=tpt.CPUPlace(), main_program=main,
                         startup_program=startup)
        tpt.load_numpy_state(scope, runs["refs"]["adam"][0], device="cpu")
        tr._initialized = True
        tr.train(lambda: iter([[tuple(r) for r in b] for b in rows]),
                 num_passes=1, event_handler=on_event, prefetch=2)
    assert len(want_losses) == 3
    for r in runs["ranks"]:
        got = r["trainer"]["losses"]
        assert len(got) == len(losses) == 3
        for a, b, c in zip(got, want_losses, losses):
            assert abs(a - b) / abs(b) < 2e-4
            assert abs(a - c) / abs(c) < 2e-4
    got = runs["ranks"][0]["trainer"]["params"]
    for k, want in want_params.items():
        if "_att_k.b" in k:         # zero gradient analytically (above)
            continue
        err = np.abs(got[k] - want).max() / np.abs(want).max()
        assert err < 1e-3, k


def test_parallel_do_and_get_places():
    """``ParallelDo`` over ``get_places`` runs its block inline, as the
    JAX package's does: the same output on the same feed and weights."""
    places = tpt.layers.get_places(device_type="CPU")
    assert [p.device for p in places] == ["cpu"]
    feed = {"x": np.random.default_rng(4).standard_normal(
        (3, 4)).astype(np.float32)}
    outs, init = [], None
    for pkg in (pt, tpt):
        pkg.core.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            pd = pkg.layers.ParallelDo(
                pkg.layers.get_places(device_type="CPU"))
            with pd.do():
                xi = pd.read_input(x)
                y = pkg.layers.scale(pkg.layers.fc(xi, size=5, act="tanh"),
                                     scale=2.0)
                pd.write_output(y)
        assert [op.type for op in main.global_block().ops][-1] == \
            "parallel_do"
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is pt:
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            init = {v.name: np.asarray(scope.get(v.name))
                    for v in main.persistable_vars()}
        else:
            scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
        got, = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
        outs.append(np.asarray(got))
    assert outs[0].shape == (3, 5)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)

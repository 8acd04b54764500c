"""``python -m paddle_tpu_torch`` on the CPU: the ``pserver`` and
``master`` commands as subprocesses serving a trainer in this process;
``train --device cpu`` on a small CTR-DNN config whose ``train_reader`` is
``cloud_reader`` over a ``master`` subprocess (every record once in the
pass, finite costs); ``train --job=checkgrad --device cpu`` passing;
``train`` without ``--device`` refusing on this host, which has no card;
``version``; the flags from ``PADDLE_TPU_*`` and from argv, and
``check_nan_inf`` in the Executor; ``check_gradients`` in process (it
passes, leaves the state alone and catches a wrong backward).

The subprocesses start together (a module fixture) and the servers are
found through a FileStore; servers bind to port 0; nothing sleeps a
fixed time.
"""

import os
import pickle
import queue
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu import flags as jflags
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed.pserver import PServerClient
from paddle_tpu_torch.distributed.store import FileStore, discover_services
from paddle_tpu_torch.native import recordio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CTR_CONFIG = '''
import os
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.store import FileStore, discover_services

def build():
    return pt.models.ctr_dnn.build(sparse_feature_dim=50, num_slots=2,
        embedding_size=4, dense_dim=3, hidden=(8,), learning_rate=1e-2)

def train_reader():
    master, = discover_services(FileStore(os.environ["CTR_STORE"]), "master")
    with open(os.environ["CTR_SEEN"], "a") as seen:
        for rec in pt.reader.creator.cloud_reader(
                [], etcd_endpoints=master)():
            seen.write(f"{rec[0]}\\n")
            yield rec[1:]
'''

CHECKGRAD_CONFIG = '''
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch import layers

def build():
    x = layers.data("x", shape=[4])
    y = layers.data("y", shape=[1])
    h = layers.fc(input=x, size=6, act="tanh")
    loss = layers.mean(layers.square_error_cost(layers.fc(input=h, size=1),
                                                y))
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"feed": [x, y], "avg_cost": loss}

def train_reader():
    rng = np.random.default_rng(0)
    for _ in range(8):
        x = rng.normal(size=(4,)).astype(np.float32)
        yield x, x.sum(keepdims=True)
'''

N_RECORDS = 48


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _cli(*args, **env):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(**env))


def _serving(proc, timeout=60):
    """Wait (bounded: stdout drains on a helper thread) for a server's
    ``serving on <endpoint>`` line."""
    q = queue.Queue()

    def drain():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=drain, daemon=True).start()
    deadline, lines = time.time() + timeout, []
    while time.time() < deadline:
        try:
            line = q.get(timeout=max(0.1, deadline - time.time()))
        except queue.Empty:
            break
        if line is None:
            break
        lines.append(line)
        if m := re.search(r"serving on (\S+)", line):
            return m.group(1)
    raise AssertionError(f"no endpoint: {lines!r} {proc.stderr.read()}")


def _reap(procs):
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the file, started together: two pservers, a
    master serving a recordio dataset, three ``train`` runs, ``version``
    and a flag reader; the finished runs' ``(rc, stdout, stderr)``."""
    root = tmp_path_factory.mktemp("cli")
    store = root / "store"
    rng = np.random.default_rng(0)
    samples = [(i, rng.normal(size=3).astype(np.float32),
                [int(rng.integers(0, 50))], [int(rng.integers(0, 50))],
                [int(rng.integers(0, 2))]) for i in range(N_RECORDS)]
    paths = tpt.dataset.common.convert(str(root), lambda: iter(samples),
                                       16, "ctr")
    (root / "ctr.py").write_text(CTR_CONFIG)
    (root / "grad.py").write_text(CHECKGRAD_CONFIG)
    servers = [_cli("pserver", "--index", i, "--store", store)
               for i in range(2)]
    servers.append(_cli("master", "--dataset", *paths, "--store", store,
                        "--chunks-per-task", 1))
    procs = []
    try:
        endpoints = [_serving(p) for p in servers]
        seen = root / "seen.txt"
        jobs = {
            "train": _cli("train", root / "ctr.py", "--device", "cpu",
                          "--batch-size", 8, "--log-period", 1,
                          CTR_STORE=str(store), CTR_SEEN=str(seen)),
            "checkgrad": _cli("train", "--job=checkgrad", root / "grad.py",
                              "--device", "cpu", "--batch-size", 4),
            "no_card": _cli("train", root / "grad.py"),
            "version": _cli("version"),
            "flags": subprocess.Popen(
                [sys.executable, "-c",
                 "from paddle_tpu_torch.flags import FLAGS; "
                 "print(FLAGS.check_nan_inf, FLAGS.do_memory_benchmark)"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env(PADDLE_TPU_CHECK_NAN_INF="1",
                         PADDLE_TPU_DO_MEMORY_BENCHMARK="yes")),
        }
        procs = list(jobs.values())
        done = {k: p.communicate(timeout=120) for k, p in jobs.items()}
        out = {k: (jobs[k].returncode,) + done[k] for k in jobs}
        out.update(endpoints=endpoints, store=store, servers=servers,
                   seen=seen.read_text().split() if seen.exists() else [])
        yield out
    finally:
        _reap(servers + procs)


def test_pserver_subprocesses_serve_a_trainer(runs):
    endpoints = sorted(discover_services(FileStore(str(runs["store"])),
                                         "pserver"))
    assert endpoints == sorted(runs["endpoints"][:2])
    client = PServerClient(endpoints)
    rng = np.random.default_rng(0)
    w = {"w_a": rng.normal(size=(4,)).astype(np.float32),
         "w_b": rng.normal(size=(3, 2)).astype(np.float32)}
    client.init_params(w, optimizer="sgd", lr=0.1)
    for _ in range(3):
        client.send_grads({k: torch.ones(v.shape) for k, v in w.items()})
    fresh = client.get_params(list(w))
    for k in w:
        np.testing.assert_allclose(fresh[k], w[k] - 0.3, rtol=1e-6)
    client.close()


def test_train_from_a_master_subprocess_on_the_cpu(runs):
    rc, out, err = runs["train"]
    assert rc == 0, err
    costs = [float(c) for c in re.findall(r"cost (\S+)", out)]
    assert len(costs) == N_RECORDS // 8 and np.isfinite(costs).all(), out
    assert "pass 0 done" in out
    # every record of the dataset read exactly once in the pass
    assert sorted(map(int, runs["seen"])) == list(range(N_RECORDS))


def test_train_checkgrad_passes_on_the_cpu(runs):
    rc, out, err = runs["checkgrad"]
    assert rc == 0, f"{out}\n{err}"
    assert "checkgrad PASSED" in out
    assert re.search(r"fc_0\.w: max_rel_err=\S+ \(checked 6 elements\)", out)


def test_train_without_a_device_refuses_on_a_host_without_a_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = runs["no_card"]
    assert rc != 0 and "no CUDA device" in err
    assert "cost" not in out


def test_version(runs):
    rc, out, _ = runs["version"]
    assert rc == 0
    assert f"torch {torch.__version__}" in out
    assert "native: available" in out
    if not torch.cuda.is_available():
        assert "card: none" in out


def test_flags_from_the_environment_and_argv(runs, monkeypatch):
    rc, out, err = runs["flags"]
    assert rc == 0, err
    assert out.split() == ["True", "True"]
    assert set(tflags._DEFS) == {"check_nan_inf", "do_memory_benchmark"}
    assert set(tflags._DEFS) <= set(jflags._DEFS)
    assert tflags.FLAGS.check_nan_inf is False
    # a non-bool flag takes the next token as its value, as in gflags
    monkeypatch.setitem(tflags._DEFS, "depth", {
        "value": 1, "type": int, "help": "", "default": 1})
    rest = tflags.init_flags(["--check_nan_inf=true", "--depth", "3",
                              "--unknown", "pos"])
    try:
        assert tflags.FLAGS.check_nan_inf is True
        assert tflags.FLAGS.depth == 3
        assert rest == ["--unknown", "pos"]
    finally:
        tflags.FLAGS.check_nan_inf = False


def _tanh_program():
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[3])
        y = tpt.layers.data("y", shape=[1])
        h = tpt.layers.fc(input=x, size=6, act="tanh")
        h = tpt.layers.dropout(h, 0.3)   # masks must be pinned
        loss = tpt.layers.mean(tpt.layers.square_error_cost(
            tpt.layers.fc(input=h, size=1), y))
        tpt.optimizer.Adam(learning_rate=0.1).minimize(loss)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(2)
    feed = {"x": rng.normal(size=(8, 3)).astype(np.float32),
            "y": rng.normal(size=(8, 1)).astype(np.float32)}
    return main, exe, scope, feed, loss


def test_check_nan_inf_in_the_executor():
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[2])
        out = tpt.layers.log(x)
    exe = tpt.Executor(tpt.CPUPlace())
    feed = {"x": np.array([[-1.0, 2.0]], np.float32)}
    assert np.isnan(exe.run(main, feed=feed, fetch_list=[out],
                            scope=tpt.Scope())[0]).any()
    tflags.FLAGS.check_nan_inf = True
    try:
        with pytest.raises(FloatingPointError, match="NaN/Inf.*after"):
            exe.run(main, feed=feed, fetch_list=[out], scope=tpt.Scope())
    finally:
        tflags.FLAGS.check_nan_inf = False


def test_check_gradients_passes_and_leaves_the_state_alone():
    main, exe, scope, feed, loss = _tanh_program()
    before = {n: scope.get(n).clone() for n in scope.var_names()}
    ok, report = tpt.check_gradients(feed, loss, program=main, scope=scope,
                                     executor=exe)
    assert ok, report
    assert sorted(report) == ["fc_0.b", "fc_0.w", "fc_1.b", "fc_1.w"]
    for n, v in before.items():
        assert torch.equal(scope.get(n), v), n


def test_check_gradients_catches_a_wrong_backward(monkeypatch):
    from paddle_tpu_torch.core.registry import get_op_impl

    class BadTanh(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return torch.tanh(x)

        @staticmethod
        def backward(ctx, g):
            return g * 0.37          # a wrong derivative

    monkeypatch.setattr(get_op_impl("tanh"), "fn",
                        lambda X, **_: {"Out": BadTanh.apply(X)})
    main, exe, scope, feed, loss = _tanh_program()
    ok, report = tpt.check_gradients(feed, loss, program=main, scope=scope,
                                     executor=exe)
    assert not ok
    assert report["fc_0.w"]["max_rel_err"] > 3e-2


def test_recordio_of_the_dataset_is_readable(runs):
    # the master's dataset, written by dataset.common.convert
    files = sorted(p for p in os.listdir(runs["store"].parent)
                   if p.startswith("ctr-"))
    recs = [pickle.loads(r) for f in files
            for r in recordio.reader(runs["store"].parent / f)]
    assert [r[0] for r in recs] == list(range(N_RECORDS))

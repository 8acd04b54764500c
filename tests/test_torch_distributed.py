"""The port's parameter-server generation against the JAX package's, on the
CPU: the RPC (round trip, remote errors, a large payload, the wire bytes,
the refusal of tensors), the discovery store (TTL, ``cas``, discovery, a
FileStore directory shared by both packages), the block plans, every
optimizer of ``_OptimizerState._STATE_SLOTS`` on the port's server
against the reference's (dense, and row-sparse with duplicate rows and
``-1`` padding), the sync barrier, async mode, checkpoint and recovery,
the delta fetch, and the two packages' clients and servers against each
other over TCP, checkpoints included.

Servers bind to port 0 on 127.0.0.1; no test sleeps a fixed time (a
TTL's expiry is polled against a deadline).
"""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import pserver as jps
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.distributed import store as jstore
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.distributed import pserver as tps
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.distributed import store as tstore

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4


def _until(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            return False
        time.sleep(0.01)
    return True


def _close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= FWD_TOL * scale, f"{what}: max err {err:.3e}"


# ------------------------------------------------------------------ rpc
class _Echo:
    def echo(self, x):
        return x

    def add(self, a, b=0):
        return a + b

    def boom(self):
        raise ValueError("boom")

    def tensor(self):
        return torch.zeros(2)


def test_rpc_roundtrip_errors_and_large_payload():
    server = trpc.Server(_Echo()).start()
    try:
        c = trpc.Client(server.endpoint)
        assert c.call("echo", {"a": np.arange(3)})["a"].tolist() == [0, 1, 2]
        assert c.call("add", 2, b=3) == 5
        with pytest.raises(RuntimeError, match="boom"):
            c.call("boom")
        assert c.call("add", 1, b=1) == 2   # usable after a remote error
        big = np.random.default_rng(0).random(1 << 20)   # 8 MB
        np.testing.assert_array_equal(c.call("echo", big), big)
        # a tensor result is refused on the server's side of the wire
        with pytest.raises(RuntimeError, match="numpy arrays only"):
            c.call("tensor")
        c.close()
    finally:
        server.stop()


def test_rpc_wire_bytes_are_the_references_and_refuse_tensors():
    msg = ("send_grad", ("w#blk1", np.arange(6, dtype=np.float32)),
           {"k": [1, 2.5, "x", None]})
    assert trpc._dumps(msg) == pickle.dumps(msg,
                                            protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(TypeError, match="numpy arrays only"):
        trpc._dumps(("send_grad", ("w", torch.ones(3)), {}))
    with pytest.raises(TypeError, match="paddle_tpu_torch"):
        trpc._dumps({"store": tstore.InMemStore()})


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_rpc_port_and_reference_talk(server_pkg):
    srv_mod, cli_mod = (trpc, jrpc) if server_pkg == "port" else (jrpc, trpc)
    server = srv_mod.Server(_Echo()).start()
    try:
        c = cli_mod.Client(server.endpoint)
        x = np.linspace(0, 1, 7, dtype=np.float32)
        np.testing.assert_array_equal(c.call("echo", x), x)
        with pytest.raises(RuntimeError, match="boom"):
            c.call("boom")
        c.close()
    finally:
        server.stop()


# ---------------------------------------------------------------- store
def test_inmem_store_ttl_cas_and_discovery():
    s = tstore.InMemStore()
    s.put("a", 1)
    s.put("b", 2, ttl=0.05)
    assert s.get("a") == 1 and s.get("b") == 2
    assert _until(lambda: s.get("b") is None)
    assert s.cas("a", 1, 10)
    assert not s.cas("a", 1, 20)
    assert s.get("a") == 10 and s.keys() == ["a"]
    stop = tstore.register_service(s, "pserver", "127.0.0.1:9000", ttl=0.3)
    assert _until(lambda: tstore.discover_services(s, "pserver")
                  == ["127.0.0.1:9000"])
    stop()
    assert _until(lambda: tstore.discover_services(s, "pserver") == [])


def test_file_store_is_shared_with_the_reference(tmp_path):
    mine, theirs = tstore.FileStore(str(tmp_path)), jstore.FileStore(
        str(tmp_path))
    mine.put("x/y", {"v": 1})
    theirs.put("services/pserver/127.0.0.1:1", {"endpoint": "e"}, ttl=30)
    assert theirs.get("x/y") == {"v": 1}
    assert tstore.discover_services(mine, "pserver") == ["127.0.0.1:1"]
    assert mine.keys("x/") == theirs.keys("x/") == ["x/y"]
    assert theirs.cas("x/y", {"v": 1}, {"v": 2}) and mine.get("x/y") == {
        "v": 2}
    mine.delete("x/y")
    assert theirs.get("x/y") is None


# ---------------------------------------------------------------- plans
def test_split_param_and_assign_server_equal_the_references():
    rng = np.random.default_rng(0)
    names = [f"fc_{i}.w" for i in range(12)] + ["embedding_0.w", "w", ""]
    shapes = [(), (1,), (7,), (100_000, 16), (13, 64), (8192,), (16385, 1),
              (3, 3, 64, 64), (2, 8192)]
    for name in names:
        for n in (1, 2, 3, 4, 7):
            assert tps.assign_server(name, n) == jps.assign_server(name, n)
            for shape in shapes:
                mb = int(rng.choice([1, 64, 8192]))
                assert (tps.split_param(name, shape, n, mb)
                        == jps.split_param(name, shape, n, mb))


# ----------------------------------------------------------- optimizers
OPTIMIZERS = {
    "sgd": {},
    "momentum": {"mu": 0.9, "use_nesterov": True},
    "adagrad": {"epsilon": 1e-6},
    "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "adamax": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "adadelta": {"rho": 0.95, "epsilon": 1e-6},
    "rmsprop": {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5},
    "ftrl": {"l1": 0.01, "l2": 0.01, "lr_power": -0.5},
    "decayed_adagrad": {"decay": 0.95, "epsilon": 1e-6},
    "proximal_gd": {"l1": 0.01, "l2": 0.01},
    "proximal_adagrad": {"l1": 0.01, "l2": 0.01},
}


def test_every_state_slot_optimizer_is_covered():
    assert set(OPTIMIZERS) == set(tps._OptimizerState._STATE_SLOTS) == set(
        jps._OptimizerState._STATE_SLOTS)
    assert (tps._OptimizerState._STATE_SLOTS
            == jps._OptimizerState._STATE_SLOTS)


def _drive(pkg, op, sparse, steps=3):
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(10, 4)).astype(np.float32)
    ps = pkg.ParameterServer(num_trainers=1, sync=True)
    ps.init_param("w", p0, optimizer=op, lr=0.05, attrs=OPTIMIZERS[op])
    ps.finish_init_params()
    for _ in range(steps):
        if sparse:
            # duplicate rows merge-add; -1 is padding and dropped
            rows = np.array([3, 1, 3, -1, 8, -1], np.int64)
            vals = rng.normal(size=(rows.size, 4)).astype(np.float32)
            ps.send_sparse_grad("w", rows, vals)
        else:
            ps.send_grad("w", rng.normal(size=p0.shape).astype(np.float32))
    return ps.get_param("w"), ps.opt["w"].acc


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rows"])
@pytest.mark.parametrize("op", sorted(OPTIMIZERS))
def test_server_optimizer_matches_the_reference(op, sparse):
    got, got_acc = _drive(tps, op, sparse)
    want, want_acc = _drive(jps, op, sparse)
    assert got.dtype == want.dtype == np.float32
    _close(got, want, f"{op} param")
    assert sorted(got_acc) == sorted(want_acc)
    for k in want_acc:
        _close(got_acc[k], want_acc[k], f"{op} {k}")
    if sparse:   # untouched rows stay where they were
        p0 = np.random.default_rng(7).normal(size=(10, 4)).astype(np.float32)
        np.testing.assert_array_equal(got[[0, 2, 4, 5, 6, 7, 9]],
                                      p0[[0, 2, 4, 5, 6, 7, 9]])


def test_dense_and_sparse_updates_do_not_mix():
    ps = tps.ParameterServer(num_trainers=1)
    ps.init_param("w", np.ones((4, 2), np.float32), optimizer="adam", lr=0.1)
    ps.finish_init_params()
    ps.send_sparse_grad("w", np.array([1]), np.ones((1, 2), np.float32))
    with pytest.raises(ValueError, match="sparse path"):
        ps.send_grad("w", np.ones((4, 2), np.float32))


# --------------------------------------------------------------- server
def test_sync_barrier_with_two_trainers_and_async_mode():
    ps = tps.ParameterServer(num_trainers=2, sync=True)
    ps.init_param("w", np.zeros(4, np.float32), optimizer="sgd", lr=0.5)
    ps.finish_init_params()
    ts = [threading.Thread(target=ps.send_grad,
                           args=("w", np.full(4, g, np.float32)))
          for g in (1.0, 3.0)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # the averaged grad 2.0 at lr 0.5, applied once
    np.testing.assert_allclose(ps.get_param("w"), -np.ones(4))
    assert ps.metrics()["updates_applied"] == 1
    ps = tps.ParameterServer(num_trainers=2, sync=False)
    ps.init_param("w", np.zeros(4, np.float32), optimizer="sgd", lr=0.5)
    ps.finish_init_params()
    ps.send_grad("w", np.ones(4, np.float32))   # applied at once
    np.testing.assert_allclose(ps.get_param("w"), -0.5 * np.ones(4))


def test_checkpoint_and_recover(tmp_path):
    store = tstore.InMemStore()
    ps = tps.ParameterServer(index=0, num_trainers=1, sync=False,
                             store=store, checkpoint_dir=str(tmp_path),
                             checkpoint_every_n_updates=1)
    ps.init_param("w", np.zeros(2, np.float32), optimizer="momentum",
                  lr=0.1, attrs={"mu": 0.9})
    ps.finish_init_params()
    ps.send_grad("w", np.ones(2, np.float32))
    after = ps.get_param("w").copy()
    meta = store.get("pserver/0/checkpoint")
    assert meta["updates"] == 1 and meta["crc32"] > 0
    ps2 = tps.ParameterServer(index=0, num_trainers=1, sync=False,
                              store=store, checkpoint_dir=str(tmp_path))
    assert ps2.ready()
    np.testing.assert_array_equal(ps2.get_param("w"), after)
    ps2.send_grad("w", np.ones(2, np.float32))
    # the velocity survived: the second step is larger than the first
    assert np.all(np.abs(ps2.get_param("w") - after) > np.abs(after) * 1.5)
    with open(meta["path"], "r+b") as f:      # a flipped byte
        f.seek(-3, 2)
        b = f.read(1)
        f.seek(-3, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="CRC"):
        tps.ParameterServer(index=0, store=store,
                            checkpoint_dir=str(tmp_path))


def test_delta_fetch_moves_zero_bytes_when_idle_and_keeps_dtype():
    servers = [tps.ParameterServer(index=i) for i in range(2)]
    client = tps.PServerClient(servers, min_block_elems=8)
    w = np.arange(64, dtype=np.float32).reshape(16, 4)
    h = np.ones((4, 4), np.float16)
    client.init_params({"w": w, "h": h}, optimizer="adam", lr=0.01)
    first = client.get_params_delta(["w", "h"])
    np.testing.assert_array_equal(first["w"], w)
    assert client.last_delta_bytes == w.nbytes + h.nbytes
    assert client.get_params_delta(["w", "h"]) == {}
    assert client.last_delta_bytes == 0
    client.send_grads({"h": torch.ones(4, 4)})   # a tensor at the boundary
    out = client.get_params_delta(["w", "h"])
    assert list(out) == ["h"] and out["h"].dtype == np.float16
    assert client.last_delta_bytes == h.nbytes
    client.close()


# ---------------------------------------------------- the two packages
def _exercise(client_mod, endpoints):
    """One client session: init, dense and sparse sends, fetches."""
    rng = np.random.default_rng(3)
    params = {"emb": rng.normal(size=(64, 4)).astype(np.float32),
              "fc.w": rng.normal(size=(13, 8)).astype(np.float32),
              "fc.b": np.zeros(8, np.float32)}
    client = client_mod.PServerClient(endpoints, min_block_elems=16)
    client.init_params(params, optimizer="adam", lr=0.01,
                       attrs=OPTIMIZERS["adam"])
    out = []
    for _ in range(3):
        client.send_grads({n: rng.normal(size=params[n].shape).astype(
            np.float32) for n in ("fc.w", "fc.b")})
        rows = np.array([5, 40, 5, 63, -1], np.int64)
        client.send_sparse_grad("emb", rows, rng.normal(
            size=(5, 4)).astype(np.float32))
        out.append(client.get_params_delta(["fc.w", "fc.b"]))
        out.append({"rows": client.get_param_rows("emb",
                                                  np.array([63, 5, 0]))})
    out.append(client.get_params(["emb", "fc.w", "fc.b"]))
    client.close()
    return out


def _serve(pkg_ps, pkg_rpc, n=3):
    servers = [pkg_ps.ParameterServer(index=i) for i in range(n)]
    return servers, [pkg_rpc.Server(s).start() for s in servers]


@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_clients_and_servers_of_both_packages_interoperate(client_pkg):
    cli, (srv_ps, srv_rpc) = ((tps, (jps, jrpc)) if client_pkg == "port"
                              else (jps, (tps, trpc)))
    _, rpcs = _serve(srv_ps, srv_rpc)
    try:
        got = _exercise(cli, [r.endpoint for r in rpcs])
    finally:
        for r in rpcs:
            r.stop()
    _, rpcs = _serve(tps, trpc)
    try:
        want = _exercise(tps, [r.endpoint for r in rpcs])
    finally:
        for r in rpcs:
            r.stop()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    (wps, wst), (rps, rst) = (((tps, tstore), (jps, jstore))
                              if writer == "port" else
                              ((jps, jstore), (tps, tstore)))
    ps = wps.ParameterServer(index=1, sync=False,
                             store=wst.FileStore(str(tmp_path / "store")),
                             checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every_n_updates=2)
    rng = np.random.default_rng(5)
    ps.init_param("w", rng.normal(size=(6, 3)).astype(np.float32),
                  optimizer="adam", lr=0.01)
    ps.init_param("e", rng.normal(size=(9, 3)).astype(np.float32),
                  optimizer="adagrad", lr=0.1)
    ps.set_param_meta("w", (6, 3), 8)
    ps.finish_init_params()
    for _ in range(2):
        ps.send_grad("w", rng.normal(size=(6, 3)).astype(np.float32))
        ps.send_sparse_grad("e", np.array([2, 7, 2]),
                            rng.normal(size=(3, 3)).astype(np.float32))
    back = rps.ParameterServer(index=1, sync=False,
                               store=rst.FileStore(str(tmp_path / "store")),
                               checkpoint_dir=str(tmp_path / "ck"))
    assert back.ready() and back.param_names() == ["e", "w"]
    assert back.get_param_meta("w") == ps.get_param_meta("w")
    g = rng.normal(size=(6, 3)).astype(np.float32)
    for srv in (ps, back):
        srv.send_grad("w", g)
        srv.send_sparse_grad("e", np.array([7]), np.ones((1, 3), np.float32))
    # "e"'s adagrad rows run each package's registered op: ORACLE_TOL
    for n in ("w", "e"):
        _close(back.get_param(n), ps.get_param(n), n)
        assert sorted(back.opt[n].acc) == sorted(ps.opt[n].acc)
        for k, v in ps.opt[n].acc.items():
            _close(back.opt[n].acc[k], v, f"{n} {k}")

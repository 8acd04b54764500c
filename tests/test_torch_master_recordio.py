"""The port's elastic master, recordio format and native loader against
the JAX package's, on the CPU.

* The master: chunk partition into tasks and two passes of every record,
  the poison drop after ``failure_max`` failures, the timeout requeue
  (one pass of the watcher at a given clock), snapshot and recovery
  through the store, the save-model election; a port client against a
  reference master over TCP and the reverse.
* recordio: files written by the reference and read by the port, and the
  reverse, through both codecs (native and pure Python), plain and zlib;
  the chunk index; a flipped byte caught by the CRC check in both codecs;
  the native ``Loader``'s deterministic shuffle (the reference's order
  for a seed) and its batch assembly.
* ``reader.creator.recordio`` and ``cloud_reader`` yield every record once
  a pass; ``dataset.common.convert`` writes what they read.
"""

import pickle

import numpy as np
import pytest

from paddle_tpu import native as jnative
from paddle_tpu.distributed import master as jmaster
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.native import recordio as jrio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.distributed import master as tmaster
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.distributed.store import InMemStore
from paddle_tpu_torch.native import recordio as trio
from paddle_tpu_torch.reader import creator


def _write_dataset(tmp_path, n_files=2, recs_per_file=40, rio=trio):
    paths, recs = [], []
    for i in range(n_files):
        p = tmp_path / f"data-{i:05d}"
        with rio.Writer(p, max_chunk_bytes=256) as w:
            for j in range(recs_per_file):
                rec = pickle.dumps((i, j))
                w.write(rec)
                recs.append(rec)
        paths.append(str(p))
    return paths, recs


def _drain(client):
    got = []
    while (rec := client.next_record()) is not None:
        got.append(rec)
    return got


# --------------------------------------------------------------- master
def test_master_partition_and_two_passes(tmp_path):
    paths, recs = _write_dataset(tmp_path)
    svc = tmaster.MasterService(timeout_sec=60)
    svc.set_dataset(paths)
    n_tasks = len(svc.todo)
    assert n_tasks == sum(len(trio.index(p)) for p in paths) > 2
    client = tmaster.MasterClient(svc)
    client.set_dataset(paths)              # a second call is a no-op
    assert sorted(_drain(client)) == sorted(recs)
    assert sorted(_drain(client)) == sorted(recs)
    assert svc.num_passes_finished() >= 1
    # the counters are the process registry's, shared with other tests
    assert svc.metrics()["tasks_finished"] >= 2 * n_tasks


def test_master_poison_drop_and_timeout_requeue(tmp_path):
    paths, _ = _write_dataset(tmp_path, n_files=1, recs_per_file=4)
    svc = tmaster.MasterService(timeout_sec=60, failure_max=2)
    svc.set_dataset(paths)
    t1 = svc.get_task()
    assert svc.task_failed(t1["id"])
    t2 = svc.get_task()
    assert t2["id"] == t1["id"]               # requeued once
    assert svc.task_failed(t2["id"])
    assert all(t.id != t1["id"] for t in svc.todo)
    assert any(t.id == t1["id"] for t in svc.failed)    # dropped
    assert svc.metrics()["poisoned_tasks"] == 1
    # a lease past its deadline goes back to todo on the watcher's pass
    svc = tmaster.MasterService(timeout_sec=30, failure_max=5)
    svc.set_dataset(paths)
    t = svc.get_task()
    assert svc.requeue_expired() == 0               # not yet due
    assert svc.requeue_expired(now=1e18) == 1   # far past the lease
    assert any(x.id == t["id"] and x.failures == 1 for x in svc.todo)
    assert not svc.pending


def test_master_snapshot_recover_and_election(tmp_path):
    paths, _ = _write_dataset(tmp_path, n_files=1, recs_per_file=40)
    store = InMemStore()
    svc = tmaster.MasterService(store=store, timeout_sec=60)
    svc.set_dataset(paths)
    leased = svc.get_task()
    done = svc.get_task()
    svc.task_finished(done["id"])
    # the master dies; a new one recovers: pending -> todo, done kept
    svc2 = tmaster.MasterService(store=store, timeout_sec=60)
    assert leased["id"] in {t.id for t in svc2.todo}
    assert [t.id for t in svc2.done] == [done["id"]]
    assert svc2.set_dataset(paths) == 0     # first caller already won
    assert svc.request_save_model("t0", block_sec=5)
    assert not svc.request_save_model("t1", block_sec=5)
    assert svc.request_save_model("t0", block_sec=5)


@pytest.mark.parametrize("master_pkg", ["port", "reference"])
def test_master_and_client_of_both_packages(tmp_path, master_pkg):
    paths, recs = _write_dataset(tmp_path, recs_per_file=25)
    svc_mod, rpc_mod, cli_mod = (
        (tmaster, trpc, jmaster) if master_pkg == "port"
        else (jmaster, jrpc, tmaster))
    server = rpc_mod.Server(svc_mod.MasterService(timeout_sec=60)).start()
    try:
        client = cli_mod.MasterClient(server.endpoint)
        client.set_dataset(paths)
        assert sorted(_drain(client)) == sorted(recs)
    finally:
        server.stop()


# ------------------------------------------------------------- recordio
@pytest.mark.parametrize("compressor", [0, 1])
@pytest.mark.parametrize("reader_native", [True, False])
@pytest.mark.parametrize("writer_native", [True, False])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_recordio_files_cross_between_the_packages(
        tmp_path, direction, writer_native, reader_native, compressor):
    wmod, rmod = ((jrio, trio) if direction == "reference_to_port"
                  else (trio, jrio))
    rng = np.random.default_rng(compressor)
    recs = [rng.bytes(int(n)) for n in rng.integers(0, 300, 50)] + [b""]
    p = tmp_path / "x.rio"
    with wmod.Writer(p, compressor=compressor, max_chunk_bytes=512,
                     use_native=writer_native) as w:
        for r in recs:
            w.write(r)
    if rmod is trio:
        assert list(trio.reader(p, use_native=reader_native)) == recs
        idx = trio.index(p, use_native=reader_native)
    else:
        assert list(jrio.reader(p, use_native=reader_native)) == recs
        idx = jrio.index(p)
    assert idx == trio.index(p, use_native=not reader_native)
    assert sum(n for _, n in idx) == len(recs) and len(idx) > 3
    chunks = [r for off, _ in idx
              for r in trio.read_chunk(p, off, use_native=reader_native)]
    assert chunks == recs


@pytest.mark.parametrize("use_native", [True, False])
def test_recordio_crc_detects_corruption(tmp_path, use_native):
    p = tmp_path / "c.rio"
    with trio.Writer(p, use_native=use_native) as w:
        for i in range(20):
            w.write(b"record-%d" % i)
    data = bytearray(p.read_bytes())
    data[40] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(IOError, match="crc"):
        list(trio.reader(p, use_native=use_native))
    with pytest.raises(IOError):
        list(trio.read_chunk(p, 0, use_native=use_native))


def test_native_library_is_the_ports_own_build():
    assert tnative.available()
    from paddle_tpu_torch.native import build

    assert build.lib_path().startswith(build.BUILD_DIR)
    assert "paddle_tpu_torch" in build.BUILD_DIR
    assert [p.rsplit("/", 1)[1] for p in build.sources()] == [
        "loader.cc", "recordio.cc"]


def test_loader_shuffle_is_deterministic_and_the_references(tmp_path):
    paths, recs = _write_dataset(tmp_path, n_files=3, recs_per_file=30)
    orders = []
    for mod in (tnative, tnative, jnative):
        with mod.Loader(paths, num_threads=1, shuffle_seed=7) as loader:
            orders.append(list(loader))
    assert orders[0] == orders[1] == orders[2]
    assert sorted(orders[0]) == sorted(recs) and orders[0] != recs
    with tnative.Loader(paths, num_threads=4, queue_cap=16) as loader:
        assert sorted(loader) == sorted(recs)


def test_loader_assembles_fixed_size_batches(tmp_path):
    p = tmp_path / "fixed.rio"
    labels = np.arange(10, dtype=np.int32)
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    with trio.Writer(p, max_chunk_bytes=64) as w:
        for lab, row in zip(labels, rows):
            w.write(lab.tobytes() + row.tobytes())
    got_l, got_r = [], []
    with tnative.Loader([p], num_threads=1) as loader:
        while (b := loader.next_batch(4, 4, 16, "int32", "float32")):
            got_l.append(b[0].ravel())
            got_r.append(b[1])
    np.testing.assert_array_equal(np.concatenate(got_l), labels)
    np.testing.assert_array_equal(np.concatenate(got_r), rows)
    assert [len(x) for x in got_l] == [4, 4, 2]


# -------------------------------------------------------------- readers
def test_recordio_creator_reads_what_convert_wrote(tmp_path):
    samples = [(np.arange(3, dtype=np.float32) + i, [i]) for i in range(25)]
    paths = tcommon.convert(str(tmp_path), lambda: iter(samples), 10, "ctr")
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "ctr-00000", "ctr-00001", "ctr-00002"]
    for threads in (0, 2):
        got = list(creator.recordio(",".join(paths),
                                    num_threads=threads)())
        got.sort(key=lambda s: s[1])
        assert len(got) == 25
        for g, w in zip(got, samples):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1]
    # the reference reads the port's files
    assert len(list(jrio.reader(paths[0]))) == 10


def test_cloud_reader_yields_every_record_once_a_pass(tmp_path):
    paths, recs = _write_dataset(tmp_path, n_files=2, recs_per_file=12)
    svc = tmaster.MasterService(timeout_sec=60)
    server = trpc.Server(svc).start()
    try:
        got = list(creator.cloud_reader(paths,
                                        etcd_endpoints=server.endpoint)())
    finally:
        server.stop()
    assert sorted(got) == sorted(pickle.loads(r) for r in recs)
    assert len(got) == len(set(got))

"""Model persistence — the port's counterpart of ``paddle_tpu/io.py``,
writing and reading the JAX package's on-disk format byte for byte.

Reference: fluid/io.py — save_vars:63 / save_persistables:112 emit save_op
per var; load_persistables:174; save_inference_model:237 (prune to
feed/fetch + write __model__ ProgramDesc); C++ loader inference/inference.cc.
Go-pserver checkpointing (go/pserver/service.go:342) adds CRC-checked files.

A checkpoint directory holds one ``.npy`` per variable (``/`` in a name
written as ``__``), ``__manifest__.pkl`` (``{"__nprocs__": 1, name:
{"file", "crc32", "shape", "dtype"}}``, the CRC over the whole ``.npy``
file) and, written last, the completion marker ``__done0__``; a full-state
checkpoint adds the ``resilience.checkpoint`` sidecar before the data.
``AsyncCheckpointer`` publishes through ``<dir>.tmp`` and ``<dir>.old``
(the ``ckpt.write`` and ``ckpt.publish`` fault points), so some complete
checkpoint is always reachable.

bfloat16: numpy has no such type, and the JAX package writes its bf16
arrays (the ``ml_dtypes`` type) as ``.npy`` files whose header says
``'<V2'`` — 16-bit words — under manifest dtype ``"bfloat16"``.  The port
writes the same header over the tensor's raw words, and reads a file's
raw words by the MANIFEST's dtype (``np.load`` gives back ``|V2`` void
words, which nothing else would recognise).  It never widens bf16 to f32
on the way.

The port's scope is updated in place by the Executor, so a snapshot must
be a copy: ``AsyncCheckpointer.save`` finishes the device-to-host copy of
every persistable — into pinned host buffers, on a side stream, behind an
event the step stream waits on — before it returns; a queued reference
to a live tensor would write a later step's weights.

Sharded checkpoints (the JAX package's layout, ``paddle_tpu/io.py:56-160``):
on an Executor with a mesh, ``save_vars`` writes each variable that rests
sharded as one ``<name>.shard<p>.npz`` a process — the blocks that
process is the lowest rank to hold, each with its index — with a CRC
sidecar ``__shards<p>__.pkl``; process 0 writes the replicated variables'
``.npy`` files and the manifest, and every process its ``__done<p>__``
marker last, then all wait for each other.  ``load_vars`` assembles the
shards densely, whoever wrote them; the mesh Executor cuts what it loads
to its own blocks at the next run, so a checkpoint loads into a mesh of
another size, or into one process.  ``AsyncCheckpointer`` writes
single-process checkpoints only.

``__model__`` (``save_inference_model``) is the pickled ``Program`` of the
package that wrote it: a port-written ``__model__`` loads into the port,
and the JAX package's into the JAX package.  Across the two packages only
the tensor files and the manifests are shared.
"""

import copy
import io
import os
import pickle
import shutil
import time
import zlib

import numpy as np
import torch

from .core.program import Parameter, default_main_program
from .core.scope import global_scope

__all__ = [
    "save_vars", "save_params", "save_persistables", "save_checkpoint",
    "load_vars", "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program", "AsyncCheckpointer",
]

BF16 = "bfloat16"
# the .npy header the JAX package's bf16 arrays carry (ml_dtypes' descr)
_BF16_DESCR = "<V2"


def _is_persistable(var):
    return var.persistable


def _host_copies(tensors):
    """``{name: tensor}`` -> ``{name: (ndarray, dtype name)}``, a copy
    that is complete when this returns: later in-place updates of the
    tensors do not reach it.  bf16 arrives as its raw uint16 words.

    CUDA tensors are copied into ONE pinned host buffer (carved into the
    tensors' shapes; the caching host allocator keeps it for the next
    save once the writer has let go of it) on a side stream that first
    waits for the step stream; the step stream then waits on the copies'
    event before its next update, and the host waits on it before
    returning."""
    host = {}
    on_card = {n: t for n, t in tensors.items() if t.is_cuda}
    if on_card:
        offsets, total = {}, 0
        for n, t in on_card.items():
            offsets[n] = total
            total += -(-t.numel() * t.element_size() // 256) * 256
        block = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        dev = next(iter(on_card.values())).device
        step_stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(step_stream)
        with torch.cuda.stream(side):
            for n, t in on_card.items():
                nbytes = t.numel() * t.element_size()
                buf = block[offsets[n]:offsets[n] + nbytes].view(
                    t.dtype).view(t.shape)
                buf.copy_(t.detach(), non_blocking=True)
                host[n] = buf
        done = torch.cuda.Event()
        done.record(side)
        step_stream.wait_event(done)
        done.synchronize()
    out = {}
    for n, t in tensors.items():
        h = host[n] if n in host else t.detach().clone(
            memory_format=torch.contiguous_format)
        if h.dtype == torch.bfloat16:
            out[n] = (h.view(torch.int16).numpy().view(np.uint16), BF16)
        else:
            arr = h.numpy()
            out[n] = (arr, str(arr.dtype))
    return out


def _snapshot(scope, vars):
    """Host copies of the ``vars`` the scope holds (in program order)."""
    return _host_copies({var.name: scope.find_var(var.name) for var in vars
                         if scope.find_var(var.name) is not None})


def _save_npy(path, arr, dtype):
    """Write ``arr`` as the ``.npy`` file ``np.save`` writes — but bf16
    words under the JAX package's ``'<V2'`` header — and return the
    file's CRC32, computed from the bytes as they go out (no read
    back)."""
    arr = np.ascontiguousarray(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    if dtype == BF16:
        header["descr"] = _BF16_DESCR
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, header)
    head = head.getvalue()
    data = memoryview(arr.reshape(-1).view(np.uint8))
    with open(path, "wb") as f:
        f.write(head)
        f.write(data)
    return zlib.crc32(data, zlib.crc32(head))


def _tensor(arr, dtype, device):
    """A file's array -> a tensor of the manifest's ``dtype``: bf16 from
    its raw 16-bit words (void or uint16), the rest as numpy has it."""
    if dtype == BF16:
        words = np.ascontiguousarray(arr).view(np.uint16)
        t = torch.from_numpy(np.array(words, copy=True)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _mesh_shards(executor, program, snap):
    """Split ``snap`` on a mesh Executor: ``(dense, shards, proc,
    nprocs)`` — ``shards`` maps each sharded variable to ``(key, arr,
    dtype, shape)`` (``key`` None where a lower rank holds the same
    block)."""
    from .parallel.api import spec_axes
    from .parallel.spmd import shard_index

    mesh, comm = executor.mesh, executor.comm
    dense, shards = {}, {}
    block = program.global_block()
    for name, (arr, dtype) in snap.items():
        spec = executor.shard_spec(program, name)
        if not spec or not any(comm.size(a) > 1 for a in spec_axes(spec)):
            dense[name] = (arr, dtype)
            continue
        shape = tuple(int(d) for d in block._find_var(name).shape)
        key = shard_index(shape, spec, mesh, comm.coords)
        owner = min(r for r in range(mesh.size) if shard_index(
            shape, spec, mesh, mesh.coords(r)) == key)
        shards[name] = (key if owner == comm.rank else None, arr, dtype,
                        shape)
    return dense, shards, comm.rank, mesh.size


def _write_shards(dirname, shards, proc, nprocs, manifest):
    """This process's ``.shard<p>.npz`` files and CRC sidecar; the
    manifest entries of the sharded variables."""
    sidecar = {}
    for name, (key, arr, dtype, shape) in shards.items():
        fname = name.replace("/", "__")
        sfile = f"{fname}.shard{proc}.npz"
        payload = {}
        if key is not None:
            payload = {"data0": arr, "index0": np.asarray(key, np.int64)}
        np.savez(os.path.join(dirname, sfile), **payload)
        with open(os.path.join(dirname, sfile), "rb") as f:
            sidecar[name] = {"file": sfile, "crc32": zlib.crc32(f.read())}
        manifest[name] = {"sharded": True,
                          "file_pattern": fname + ".shard{p}.npz",
                          "nprocs": nprocs, "shape": list(shape),
                          "dtype": dtype}
    with open(os.path.join(dirname, f"__shards{proc}__.pkl"), "wb") as f:
        pickle.dump(sidecar, f)


def _write_snapshot(dirname, snap, extra_state=None, shards=None, proc=0,
                    nprocs=1):
    """Write a ``{name: (ndarray, dtype)}`` snapshot as one .npy per
    tensor with a CRC manifest — THE on-disk checkpoint format (shared by
    ``save_vars`` and ``AsyncCheckpointer``).  ``extra_state`` (a dict)
    upgrades it to a FULL-state checkpoint: it is written as the
    ``resilience.checkpoint`` train-state sidecar BEFORE the data files
    and the completion marker, so a complete checkpoint always carries
    it.  The marker ``__done0__`` goes last (an old one is removed
    first): ``load_vars`` refuses a directory without it, so a crash
    mid-overwrite is never read as a valid torn state."""
    os.makedirs(dirname, exist_ok=True)
    marker = os.path.join(dirname, f"__done{proc}__")
    if os.path.exists(marker):
        os.remove(marker)
    if extra_state is not None and proc == 0:
        from .resilience import checkpoint as _resil_ckpt

        _resil_ckpt.save_train_state(dirname, extra_state)
    manifest = {"__nprocs__": nprocs}
    if shards:
        _write_shards(dirname, shards, proc, nprocs, manifest)
    if proc == 0:
        for name, (arr, dtype) in snap.items():
            fname = name.replace("/", "__") + ".npy"
            path = os.path.join(dirname, fname)
            crc = _save_npy(path, arr, dtype)
            manifest[name] = {"file": fname, "crc32": crc,
                              "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(dirname, "__manifest__.pkl"), "wb") as f:
            pickle.dump(manifest, f)
    with open(marker, "w") as f:
        f.write("ok")


def _load_sharded(dirname, name, meta):
    """A var the JAX package wrote partitioned across processes, read
    from every process's ``.shard<p>.npz`` (CRC-checked against its
    ``__shards<p>__.pkl`` sidecar) and assembled into one dense
    ndarray (bf16 as uint16 words)."""
    shape = tuple(meta["shape"])
    dtype = np.uint16 if meta["dtype"] == BF16 else np.dtype(meta["dtype"])

    def proc_crc(p):
        sidecar_path = os.path.join(dirname, f"__shards{p}__.pkl")
        if not os.path.exists(sidecar_path):
            return None
        with open(sidecar_path, "rb") as f:
            sc = pickle.load(f)
        return sc.get(name, {}).get("crc32")

    out = np.zeros(shape, dtype)
    for p in range(meta["nprocs"]):
        path = os.path.join(dirname,
                            meta["file_pattern"].replace("{p}", str(p)))
        with open(path, "rb") as f:
            data = f.read()
        crc = proc_crc(p)
        if crc is not None and zlib.crc32(data) != crc:
            raise IOError(f"checksum mismatch for shard of {name}: {path}")
        npz = np.load(path, allow_pickle=False)
        for i in range(len(npz.files) // 2):
            key = tuple(map(tuple, npz[f"index{i}"]))
            part = npz[f"data{i}"]
            if dtype == np.uint16:
                part = part.view(np.uint16)
            out[tuple(slice(a, b) for a, b in key)] = part
    return out


def _record_ckpt_telemetry(dirname, t0):
    """checkpoint.save_ms / checkpoint.bytes histograms (+ last-value
    gauges the trainer JSONL reads) for one finished checkpoint write.
    Best-effort: telemetry must never fail a save."""
    try:
        from .observability import metrics as _obs
        from .observability import trace as _trace

        ms = (time.perf_counter() - t0) * 1e3
        nbytes = 0
        for root, _dirs, files in os.walk(dirname):
            for f in files:
                try:
                    nbytes += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        reg = _obs.get_registry()
        reg.counter("checkpoint.saves",
                    help="checkpoints written to disk").inc()
        reg.histogram("checkpoint.save_ms",
                      help="wall ms per checkpoint write (worker thread "
                           "for async saves)").observe(ms)
        reg.histogram("checkpoint.bytes",
                      help="bytes per checkpoint on disk").observe(nbytes)
        reg.gauge("checkpoint.last_save_ms").set(ms)
        reg.gauge("checkpoint.last_bytes").set(nbytes)
        _trace.get_tracer().instant(
            "checkpoint.saved", cat="resilience", dir=dirname,
            ms=round(ms, 2), bytes=nbytes)
    except Exception:
        pass


def _record_snapshot_telemetry(t0):
    """checkpoint.snapshot_ms: what ``AsyncCheckpointer.save`` blocked the
    step loop for (the device-to-host copy).  Best-effort."""
    try:
        from .observability import metrics as _obs

        ms = (time.perf_counter() - t0) * 1e3
        reg = _obs.get_registry()
        reg.histogram("checkpoint.snapshot_ms",
                      help="ms save() blocks the step loop for the "
                           "device-to-host copy").observe(ms)
        reg.gauge("checkpoint.last_snapshot_ms").set(ms)
    except Exception:
        pass


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              extra_state=None):
    program = main_program or default_main_program()
    scope = global_scope()
    if vars is None:
        vars = [v for v in program.global_block().vars.values() if predicate(v)]
    snap = _snapshot(scope, vars)
    t0 = time.perf_counter()
    if getattr(executor, "mesh", None) is None:
        _write_snapshot(dirname, snap, extra_state=extra_state)
    else:
        import torch.distributed as dist

        dense, shards, proc, nprocs = _mesh_shards(executor, program, snap)
        _write_snapshot(dirname, dense, extra_state, shards, proc, nprocs)
        if nprocs > 1:
            dist.barrier()
    _record_ckpt_telemetry(dirname, t0)


def save_params(executor, dirname, main_program=None):
    return save_vars(
        executor, dirname, main_program,
        predicate=lambda v: isinstance(v, Parameter),
    )


def save_persistables(executor, dirname, main_program=None):
    return save_vars(executor, dirname, main_program, predicate=_is_persistable)


def save_checkpoint(executor, dirname, main_program=None, train_state=None):
    """Synchronous FULL-state checkpoint: the persistables snapshot plus
    the ``resilience.checkpoint`` train-state sidecar (RNG state, reader
    cursor, pass/step counters) in one crash-detectable directory.
    ``load_persistables`` + ``resilience.load_train_state`` restore it.
    The async analog is ``AsyncCheckpointer.save(..., extra_state=...)``."""
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, extra_state=train_state)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None):
    """Put the checkpoint's tensors into the current scope on
    ``executor``'s device, under the manifest's dtypes.  Raises on a
    missing completion marker and on a CRC mismatch."""
    program = main_program or default_main_program()
    scope = global_scope()
    device = executor.device
    if vars is None:
        vars = [v for v in program.global_block().vars.values() if predicate(v)]
    if not os.path.exists(os.path.join(dirname, "__manifest__.pkl")) and \
            os.path.exists(os.path.join(dirname + ".old", "__manifest__.pkl")):
        # a crash between AsyncCheckpointer's two publish renames leaves
        # the last good checkpoint at <dirname>.old — recover it
        dirname = dirname + ".old"
    with open(os.path.join(dirname, "__manifest__.pkl"), "rb") as f:
        manifest = pickle.load(f)
    if "__nprocs__" in manifest:  # marker-protocol checkpoints
        missing = [
            p for p in range(manifest["__nprocs__"])
            if not os.path.exists(os.path.join(dirname, f"__done{p}__"))
        ]
        if missing:
            raise IOError(
                f"incomplete checkpoint {dirname}: completion markers "
                f"missing for process(es) {missing} — a writer crashed "
                f"mid-save; restore from an older checkpoint")
    for var in vars:
        meta = manifest.get(var.name)
        if meta is None:
            continue
        if meta.get("sharded"):
            scope.set(var.name, _tensor(_load_sharded(dirname, var.name, meta),
                                        meta["dtype"], device))
            continue
        path = os.path.join(dirname, meta["file"])
        with open(path, "rb") as f:
            data = f.read()
        if zlib.crc32(data) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {var.name} in {dirname}")
        arr = np.load(path, allow_pickle=False)
        scope.set(var.name, _tensor(arr, meta["dtype"], device))


def load_params(executor, dirname, main_program=None):
    return load_vars(
        executor, dirname, main_program,
        predicate=lambda v: isinstance(v, Parameter),
    )


def load_persistables(executor, dirname, main_program=None):
    return load_vars(executor, dirname, main_program, predicate=_is_persistable)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None):
    """Prune to the inference subgraph, save program + persistables
    (reference save_inference_model fluid/io.py:237).  ``__model__`` is
    the port's pickled ``Program``."""
    program = main_program or default_main_program()
    pruned = program.clone(for_test=True)
    pruned = pruned.prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": pruned,
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name for v in target_vars],
    }
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        pickle.dump(meta, f)
    save_vars(
        executor, dirname, program,
        vars=[v for v in pruned.global_block().vars.values() if v.persistable],
    )


def load_inference_model(dirname, executor):
    with open(os.path.join(dirname, "__model__"), "rb") as f:
        meta = pickle.load(f)
    program = meta["program"]
    load_vars(
        executor, dirname, program,
        vars=[v for v in program.global_block().vars.values() if v.persistable],
    )
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def get_inference_program(target_vars, main_program=None):
    program = main_program or default_main_program()
    return program.clone(for_test=True).prune(target_vars)


class AsyncCheckpointer:
    """Background-thread checkpointing (the reference's synchronous
    per-pass save, trainer/ParamUtil.cpp and the Go pserver's periodic
    checkpoint, go/pserver/service.go:342, moved off the step loop).

    ``save()`` copies the persistable state to host memory before it
    returns — the one point that must block training, because the
    Executor updates that state in place — and hands serialization +
    disk IO + CRC to a worker thread.  Files match ``save_persistables``
    exactly, so ``load_persistables`` restores them.  A failed write
    raises on the next ``save()`` or ``close()``.

        ckpt = io.AsyncCheckpointer()
        for pass_id in range(passes):
            train_one_pass()
            ckpt.save(f"ckpt/pass_{pass_id}")   # returns after the copy
        ckpt.close()                             # drain pending writes
    """

    def __init__(self, max_pending=2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max_pending)
        self._errors = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except Exception as e:  # surfaced on next save()/close()
                self._errors.append(e)
            finally:
                # drop the snapshot now, not at the next get(): its pinned
                # block goes back to the caching host allocator for the
                # next save to reuse
                del item
                self._q.task_done()

    @staticmethod
    def _write(dirname, snap, extra_state=None):
        from .resilience import faults as _faults
        from .resilience import retry as _retry

        def write_to(target):
            # transient-IO injection point lives INSIDE the retried call,
            # so an injected (or real) flaky write is absorbed by the
            # jittered backoff instead of failing the checkpoint
            _faults.maybe_fault("ckpt.write")
            _write_snapshot(target, snap, extra_state=extra_state)

        t0 = time.perf_counter()
        tmp = dirname + ".tmp"
        if os.path.exists(tmp):  # leftovers from a crashed prior run
            shutil.rmtree(tmp)
        old = dirname + ".old"
        if os.path.exists(old) and not os.path.exists(dirname):
            # crashed between the two publish renames last run: the .old
            # copy is the only good checkpoint — restore it first
            os.replace(old, dirname)

        def write_tmp():
            if os.path.exists(tmp):  # partial files from a failed try
                shutil.rmtree(tmp)
            write_to(tmp)

        _retry.retry_call(write_tmp, retries=3, retry_on=(OSError,))
        # crash-safe publish: some valid checkpoint is always reachable —
        # dirname, or (between the two renames) dirname + ".old", which
        # load_vars falls back to.
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(dirname):
            os.replace(dirname, old)
        # the torn window the ckpt_crash fault targets: dirname is gone,
        # tmp holds the new snapshot, .old holds the last good one
        _faults.maybe_fault("ckpt.publish")
        os.replace(tmp, dirname)
        if os.path.exists(old):
            shutil.rmtree(old)
        _record_ckpt_telemetry(dirname, t0)

    def _raise_pending(self):
        if self._errors:
            err, self._errors = self._errors, []  # atomic swap, no lost errors
            raise RuntimeError(f"async checkpoint write(s) failed: {err}")

    def save(self, dirname, main_program=None, scope=None,
             extra_state=None):
        """Copy now, write in the background.  Blocks for the copy, and
        when ``max_pending`` earlier checkpoints are still being
        written.

        ``extra_state`` (a dict, e.g. the trainer's RNG/reader/step
        state) is copied to host numpy HERE, so it is consistent with
        the persistables, and written as the full-state train-state
        sidecar by the worker."""
        self._raise_pending()
        program = main_program or default_main_program()
        scope = scope or global_scope()
        t0 = time.perf_counter()
        snap = _snapshot(scope, [v for v in program.global_block().vars.values()
                                 if v.persistable])
        _record_snapshot_telemetry(t0)
        if extra_state is not None:
            # tensors -> host numpy, then a DEEP copy: the worker pickles
            # the sidecar later, and a nested live reference (a reader's
            # cursor dict) mutated by further training would capture a
            # FUTURE state
            extra_state = copy.deepcopy({
                k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else v)
                for k, v in extra_state.items()
            })
        self._q.put((dirname, snap, extra_state))

    def wait(self):
        """Block until all queued checkpoints are on disk."""
        self._q.join()
        self._raise_pending()

    def close(self):
        try:
            self.wait()
        finally:
            # always shut the worker down, even when wait() raises
            self._q.put(None)
            self._thread.join()

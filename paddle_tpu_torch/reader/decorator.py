"""Reader decorators — the port's own copy of
``paddle_tpu/reader/decorator.py`` (reference:
python/paddle/v2/reader/decorator.py).  Everything but
``prefetch_to_device`` is the reference's pure-Python code as it is; that
one moves batches to the card on a side CUDA stream instead of
``jax.device_put``."""

import itertools
import random
import queue as queue_mod
import threading

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "batch", "prefetch_to_device", "resumable",
    "ResumableReader",
]


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned"
                    )
                yield sum(map(make_tuple, outputs), ())

    return reader


class _End:
    pass


def _pipeline(reader, size, transform=None):
    """Shared producer-thread machinery for buffered/prefetch_to_device:
    bounded queue, optional per-item transform on the producer thread,
    producer errors re-raised on the consumer side, and early consumer
    exit (break/close) releases the producer instead of leaking it."""

    def data_reader():
        r = reader()
        q = queue_mod.Queue(maxsize=size)
        err = []
        stop = threading.Event()

        def offer(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def fill():
            try:
                for d in r:
                    if transform is not None:
                        d = transform(d)
                    if not offer(d):
                        return
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                offer(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                e = q.get()
                if e is _End:
                    break
                yield e
        finally:
            stop.set()  # unblock the producer if we exit early
        if err:
            raise err[0]

    return data_reader


def buffered(reader, size):
    """Prefetch into a bounded queue on a daemon thread — the analog of the
    reference's double-buffered PyDataProvider2 pool."""
    return _pipeline(reader, size)


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (decorator.py
    xmap_readers)."""

    end = object()

    def data_reader():
        in_q = queue_mod.Queue(buffer_size)
        out_q = queue_mod.Queue(buffer_size)

        def read_worker():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(end)

        def map_worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, d = item
                out_q.put((i, mapper(d)))

        threading.Thread(target=read_worker, daemon=True).start()
        workers = [
            threading.Thread(target=map_worker, daemon=True)
            for _ in range(process_num)
        ]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if order:
            for i in sorted(pending):
                yield pending[i]

    return data_reader


class ResumableReader:
    """Position-tracking reader wrapper — the input-pipeline half of a
    full-state checkpoint (``resilience.checkpoint``).

    Wraps a reader *factory* (a callable returning an iterable, the v2
    convention).  Each iteration counts the items it hands out
    (``items``) and completed iterations (``epochs``); ``state()``
    snapshots the cursor and ``set_state()`` arms the NEXT iteration to
    resume from it.

    Two resume strategies, picked automatically:

    * if the underlying factory object carries its own
      ``state()``/``set_state()`` pair (e.g. a file reader snapshotting
      a byte offset), it is delegated to — O(1) resume;
    * otherwise the next iteration FAST-FORWARDS by re-drawing and
      discarding ``items`` leading items — correct for any
      deterministic reader, O(position) in reader work but zero
      training compute.

        r = resumable(my_batched_reader)
        for b in r():
            train(b)                 # killed here...
        ckpt["reader_state"] = r.state()
        # ...later, a fresh process:
        r = resumable(my_batched_reader)
        r.set_state(ckpt["reader_state"])
        for b in r():                # continues at the next unseen batch
            train(b)
    """

    def __init__(self, reader):
        self._factory = reader
        self._skip = 0   # items the next iteration fast-forwards past
        self._base = 0   # position already restored inside the factory
        self.items = 0   # current-epoch position (incl. restored items)
        self.epochs = 0  # completed iterations

    def state(self):
        """Snapshot the cursor: the position count, plus the underlying
        factory's own ``state()`` when it has one."""
        out = {"items": self.items, "epochs": self.epochs}
        if hasattr(self._factory, "state"):
            out["underlying"] = self._factory.state()
        return out

    def set_state(self, state):
        """Arm the next iteration to resume from ``state`` (a dict from
        ``state()``, or any mapping with an ``items`` count)."""
        if "underlying" in state and hasattr(self._factory, "set_state"):
            self._factory.set_state(state["underlying"])
            self._skip, self._base = 0, int(state.get("items", 0))
        else:
            self._skip, self._base = int(state.get("items", 0)), 0
        self.epochs = int(state.get("epochs", 0))

    def __call__(self):
        skip, self._skip = self._skip, 0
        base, self._base = self._base, 0

        def gen():
            it = iter(self._factory())
            self.items = base
            for _ in range(skip):
                try:
                    next(it)
                except StopIteration:
                    return
                self.items += 1
            for item in it:
                self.items += 1
                yield item
            self.epochs += 1

        return gen()


def resumable(reader):
    """Wrap a reader factory so its position can be checkpointed and
    restored (see ``ResumableReader``)."""
    return ResumableReader(reader)


def batch(reader, batch_size, drop_last=True):
    """Group samples into minibatches (reference: paddle/v2/minibatch.py).
    ``drop_last`` defaults True for TPU: a ragged final batch would trigger
    a recompile for one step."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def prefetch_to_device(reader, size=2, feed_converter=None, device=None,
                       sharding=None):
    """Overlap host->device transfer with compute: batches are converted
    (optionally via ``feed_converter``, e.g. ``DataFeeder.feed``) and
    copied to the card AHEAD of consumption on a daemon thread, so the
    training loop finds the next batch already on the card (the
    reference's GPU double-buffering in MultiGradientMachine's data
    pipeline).

    On the card (``device`` None or a CUDA device): each array goes to a
    pinned host tensor, then by a non-blocking copy on a side CUDA stream
    to the card; the copy's event is recorded on the side stream, and
    the consumer's current stream waits on it (and the tensor is marked
    with ``record_stream``) when the batch is handed over — without that
    wait a step could read a half-copied batch.  With ``device="cpu"``
    the batches are handed over as CPU tensors.  With no card and no
    ``device="cpu"`` it raises.

    ``sharding`` (``fn(name, tensor)``, e.g. ``Executor.feed_slicer``)
    cuts each value of a dict batch to this rank's rows before the copy,
    so a mesh rank moves only its part of the batch to the card.

        feeder = pt.DataFeeder(model["feed"])
        for feed in prefetch_to_device(batched_reader, 2, feeder.feed)():
            exe.run(feed=feed, fetch_list=[cost])   # no h2d stall
    """
    import numpy as np
    import torch

    from ..core.place import resolve_device
    from ..core.scope import tensor_from_numpy

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def tensors(item):
        if isinstance(item, dict):
            return list(item.values())
        if isinstance(item, (list, tuple)):
            return list(item)
        return [item]

    def data_reader():
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def put(v):
            t = (v if isinstance(v, torch.Tensor)
                 else tensor_from_numpy(np.asarray(v)))
            if side is None:
                return t
            with torch.cuda.stream(side):
                return t.pin_memory().to(dev, non_blocking=True)

        def put_on_device(item):
            if feed_converter is not None:
                item = feed_converter(item)
            if isinstance(item, dict) and sharding is not None:
                out = {}
                for k, v in item.items():
                    t = v if isinstance(v, torch.Tensor) else \
                        tensor_from_numpy(np.asarray(v))
                    cut = sharding(k, t)
                    out[k] = put(cut)
                    if getattr(cut, "_pt_local_shard", False):
                        out[k]._pt_local_shard = True
            elif isinstance(item, dict):
                out = {k: put(v) for k, v in item.items()}
            elif isinstance(item, tuple) and hasattr(item, "_fields"):
                out = type(item)(*(put(v) for v in item))
            elif isinstance(item, (list, tuple)):
                out = type(item)(put(v) for v in item)
            else:
                out = put(item)
            done = None
            if side is not None:
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        for item, done in _pipeline(reader, size,
                                    transform=put_on_device)():
            if done is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                for t in tensors(item):
                    t.record_stream(stream)
            yield item

    return data_reader

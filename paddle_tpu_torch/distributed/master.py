"""Elastic dataset task dispatcher — the go/master rebuild (the port's
counterpart of ``paddle_tpu/distributed/master.py``; host code, no torch).

Reference: go/master/service.go — partition record chunks into tasks (:106),
per-pass todo/pending/done queues, GetTask (:368), TaskFinished (:411),
TaskFailed (:455) with failureMax poison-drop (:313), timeout watcher
re-queueing (:341), queue snapshot to etcd (:207) / recover (:166); client
NextRecord (go/master/client.go:244); C API consumed by
v2/reader/creator.py:91 cloud_reader.

Same design: trainers are stateless record consumers; any trainer death just
re-queues its leased tasks after the timeout, giving elastic fault tolerance
without checkpointing trainer state.  Tasks cross the wire and the store as
``Task.to_dict()`` dicts, never as objects, so a master and a client of the
two packages serve each other; records are read through the port's
recordio (``native/recordio.py``)."""

import threading
import time
import uuid

from . import rpc
from .store import InMemStore
from ..observability import metrics as _obs

SNAPSHOT_KEY = "master/taskqueues"


class Task:
    def __init__(self, task_id, paths):
        self.id = task_id
        self.paths = list(paths)
        self.failures = 0
        self.deadline = None

    def to_dict(self):
        return {"id": self.id, "paths": self.paths, "failures": self.failures}

    @staticmethod
    def from_dict(d):
        t = Task(d["id"], d["paths"])
        t.failures = d["failures"]
        return t


class MasterService:
    def __init__(self, store=None, chunks_per_task=1, timeout_sec=20,
                 failure_max=3, registry=None):
        self.store = store or InMemStore()
        self.chunks_per_task = chunks_per_task
        self.timeout_sec = timeout_sec
        self.failure_max = failure_max
        self._lock = threading.Lock()
        self.todo, self.pending, self.done, self.failed = [], {}, [], []
        self._pass_id = 0
        self._dataset_set = False
        self._reg = registry or _obs.get_registry()
        self._last_contact = time.time()  # any trainer RPC (heartbeat age)
        self._recover()
        self._update_queue_gauges()
        self._watcher = threading.Thread(target=self._check_timeouts, daemon=True)
        self._watcher.start()

    # -- telemetry ---------------------------------------------------------
    def _update_queue_gauges(self):
        """Queue-depth gauges; called under the lock after transitions."""
        self._reg.gauge("master.todo_depth").set(len(self.todo))
        self._reg.gauge("master.pending_depth").set(len(self.pending))
        self._reg.gauge("master.done_depth").set(len(self.done))
        self._reg.gauge("master.failed_depth").set(len(self.failed))

    def metrics(self):
        """RPC surface for scraping: queue depths, lifetime counters and
        the age of the last trainer contact (a dead fleet shows up as a
        growing heartbeat age long before timeouts drain pending)."""
        with self._lock:
            return {
                "todo_depth": len(self.todo),
                "pending_depth": len(self.pending),
                "done_depth": len(self.done),
                "failed_depth": len(self.failed),
                "pass_id": self._pass_id,
                "tasks_dispatched": self._reg.value(
                    "master.tasks_dispatched"),
                "tasks_finished": self._reg.value("master.tasks_finished"),
                "tasks_failed": self._reg.value("master.tasks_failed"),
                "timeout_requeues": self._reg.value(
                    "master.timeout_requeues"),
                "poisoned_tasks": self._reg.value("master.poisoned_tasks"),
                "last_contact_age_sec": time.time() - self._last_contact,
            }

    # -- persistence (service.go snapshot:207 / recover:166) ---------------
    def _snapshot(self):
        state = {
            "todo": [t.to_dict() for t in self.todo],
            "pending": [t.to_dict() for t in self.pending.values()],
            "done": [t.to_dict() for t in self.done],
            "failed": [t.to_dict() for t in self.failed],
            "pass_id": self._pass_id,
        }
        self.store.put(SNAPSHOT_KEY, state)

    def _recover(self):
        state = self.store.get(SNAPSHOT_KEY)
        if not state:
            return
        # pending tasks from a dead master go back to todo
        self.todo = [Task.from_dict(d) for d in state["todo"]] + [
            Task.from_dict(d) for d in state["pending"]
        ]
        self.done = [Task.from_dict(d) for d in state["done"]]
        self.failed = [Task.from_dict(d) for d in state["failed"]]
        self._pass_id = state["pass_id"]
        self._dataset_set = bool(self.todo or self.done or self.failed)

    # -- RPC surface -------------------------------------------------------
    def set_dataset(self, chunk_paths):
        """Partition recordio files into chunk-granular tasks
        (service.go partition:106 — one task = chunks_per_task chunks).
        First caller wins; later calls are no-ops (matching the reference)."""
        from ..native import recordio

        with self._lock:
            if self._dataset_set:
                return self._pass_id
            chunks = []
            for p in sorted(chunk_paths):
                try:
                    for off, _cnt in recordio.index(p):
                        chunks.append([p, int(off)])
                except IOError as e:
                    # fail fast at registration: a bad file would otherwise
                    # become a poison task crashing every trainer that
                    # leases it
                    raise IOError(f"set_dataset: cannot index {p}: {e}")
            for i in range(0, len(chunks), self.chunks_per_task):
                self.todo.append(
                    Task(str(uuid.uuid4()), chunks[i : i + self.chunks_per_task])
                )
            self._dataset_set = True
            self._update_queue_gauges()
            self._snapshot()
            return self._pass_id

    def get_task(self):
        self._last_contact = time.time()
        with self._lock:
            if not self.todo:
                if not self.pending and (self.done or self.failed):
                    # pass finished: start next pass (per-pass queues,
                    # service.go GetTask pass rollover)
                    self.todo = self.done + self.failed
                    self.done, self.failed = [], []
                    self._pass_id += 1
                if not self.todo:
                    return None  # caller retries while pending drains
            task = self.todo.pop(0)
            task.deadline = time.time() + self.timeout_sec
            self.pending[task.id] = task
            self._reg.counter("master.tasks_dispatched").inc()
            self._update_queue_gauges()
            self._snapshot()
            return {"id": task.id, "paths": task.paths, "pass_id": self._pass_id}

    def task_finished(self, task_id):
        self._last_contact = time.time()
        with self._lock:
            task = self.pending.pop(task_id, None)
            if task is None:
                return False
            task.failures = 0
            self.done.append(task)
            self._reg.counter("master.tasks_finished").inc()
            self._update_queue_gauges()
            self._snapshot()
            return True

    def task_failed(self, task_id):
        self._last_contact = time.time()
        with self._lock:
            task = self.pending.pop(task_id, None)
            if task is None:
                return False
            self._process_failed(task)
            self._reg.counter("master.tasks_failed").inc()
            self._update_queue_gauges()
            self._snapshot()
            return True

    def _process_failed(self, task):
        # processFailedTask (service.go:313): drop poison tasks
        task.failures += 1
        if task.failures >= self.failure_max:
            self.failed.append(task)
            self._reg.counter("master.poisoned_tasks").inc()
        else:
            self.todo.append(task)

    def _check_timeouts(self):
        # checkTimeoutFunc (service.go:341)
        while True:
            time.sleep(self.timeout_sec / 4)
            self.requeue_expired()

    def requeue_expired(self, now=None):
        """Fail every leased task whose deadline passed by ``now`` (default:
        the clock) — the watcher's one pass; returns how many."""
        with self._lock:
            now = time.time() if now is None else now
            expired = [t for t in self.pending.values()
                       if t.deadline and t.deadline < now]
            for t in expired:
                del self.pending[t.id]
                self._process_failed(t)
            if expired:
                self._reg.counter("master.timeout_requeues").inc(
                    len(expired))
                self._update_queue_gauges()
                self._snapshot()
            return len(expired)

    # -- exactly-one-saver election (service.go:481 RequestSaveModel) ------
    def request_save_model(self, trainer_id, block_sec=60):
        key = "master/save_model_lock"
        now = time.time()
        holder = self.store.get(key)
        if holder and holder["expires"] > now:
            return holder["trainer"] == trainer_id
        self.store.put(key, {"trainer": trainer_id, "expires": now + block_sec})
        return True

    def num_passes_finished(self):
        return self._pass_id


class MasterClient:
    """go/master/client.go analog: task lease + record iteration."""

    def __init__(self, endpoint_or_service=None, timeout_sec=5, local=None):
        if local is not None or endpoint_or_service is None:
            self._svc = local or MasterService()
            self._call = lambda m, *a, **k: getattr(self._svc, m)(*a, **k)
        elif isinstance(endpoint_or_service, MasterService):
            self._svc = endpoint_or_service
            self._call = lambda m, *a, **k: getattr(self._svc, m)(*a, **k)
        else:
            self._client = rpc.Client(endpoint_or_service, timeout=timeout_sec)
            self._call = self._client.call
        self._task = None
        self._records = iter(())
        self._pass_id = 0
        self._pending_task = None  # task leased across a pass boundary
        self._signaled_boundary = False

    def set_dataset(self, chunk_paths):
        self._call("set_dataset", list(chunk_paths))

    def _next_task(self):
        for _ in range(200):
            task = self._call("get_task")
            if task is not None:
                return task
            time.sleep(0.05)
        return None

    def next_record(self):
        """One record, leasing tasks as needed (client.go:244 NextRecord).
        Returns None when the current pass is exhausted; subsequent calls
        continue into the next pass (per-pass queues, service.go GetTask)."""
        while True:
            try:
                rec = next(self._records)
                self._signaled_boundary = False
                return rec
            except StopIteration:
                pass
            if self._task is not None:
                self._call("task_finished", self._task["id"])
                self._task = None
            if self._pending_task is not None:
                task, self._pending_task = self._pending_task, None
            else:
                task = self._next_task()
            if task is None:
                self._signaled_boundary = True
                return None
            if task.get("pass_id", 0) != self._pass_id:
                self._pass_id = task.get("pass_id", 0)
                if not self._signaled_boundary:
                    # pass boundary: hold the lease, signal end-of-pass ONCE
                    # (a timeout-None may already have signaled this boundary
                    # — don't produce a phantom empty pass)
                    self._pending_task = task
                    self._signaled_boundary = True
                    return None
                # boundary already reported via a timeout-None: continue

            def gen(paths):
                from ..native import recordio

                for p, off in paths:
                    yield from recordio.read_chunk(p, off)

            self._task = task
            self._records = gen(task["paths"])

    def task_failed(self):
        if self._task is not None:
            self._call("task_failed", self._task["id"])
            self._task = None
            self._records = iter(())

"""Crash flight recorder — "what was the system doing in the 30 steps
before it died", as one loadable post-mortem JSON bundle.  The port's own
copy of ``paddle_tpu/observability/flight.py`` (standard library and
numpy only, over the port's ``metrics`` registry).

The telemetry stack measures everything while the process is healthy;
when it dies — a watchdog trip, a NaN loss, an allocator OOM, a dead
serving thread, an uncaught trainer exception — the JSONL may be
unflushed, the spans live only in memory, and the operator gets a stack
trace with no history.  The flight recorder keeps a bounded ring of the
last N step records (phase durations, loss, grad norm, HBM high-water,
collective bytes, the compile's ``comm_plan`` bucket summary, the
``costmodel`` fitted/analytic status, lint/tune counters — whatever the
caller records) and on a trip dumps ONE bundle::

    {"schema_version": 1, "reason": "nan_trip", "ts": ..., "pid": ...,
     "context": {...},            # trip-specific (loss, error, age_s)
     "steps": [...],              # the ring, oldest -> newest
     "grad_norm_window": [...],   # the ring's grad-norm trail
     "spans": [...],              # most recent tracer events
     "metrics": {...}}            # scalar registry snapshot

Dump triggers in the port (each also drops a ``flight_dump`` trace
instant and counts ``flight.dumps``):

* ``Trainer`` — a NaN step cost (incl. the ``nan_grad`` injected
  fault), any exception escaping the train loop (classified ``oom`` /
  ``nan_trip`` / ``trainer_exception`` by ``classify_exception``);
* ``resilience.Watchdog`` — a deadline trip (``watchdog``);
* ``ServingEngine._abort`` — a device error or a dead serving thread
  (``serving_abort``).

``PADDLE_TPU_FLIGHT=0`` is the kill switch (recording AND dumping
become no-ops); ``PADDLE_TPU_FLIGHT_STEPS`` sizes the ring (default
30); ``PADDLE_TPU_FLIGHT_DIR`` picks the bundle directory (default: a
``paddle_tpu_flight`` dir under the system temp dir).  Dumps are capped
per process (``max_dumps``, default 8) so a flapping watchdog cannot
fill a disk.
"""

import collections
import json
import os
import tempfile
import threading
import time

from . import metrics as _obs

__all__ = [
    "SCHEMA_VERSION", "FlightRecorder", "get_recorder", "set_recorder",
    "flight_enabled", "record_step", "dump", "load_bundle",
    "classify_exception",
]

SCHEMA_VERSION = 1
DEFAULT_STEPS = 30
DEFAULT_SPANS = 200


_ALLOC_MARKS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Failed to allocate", "failed to allocate",
                "exceeds the memory", "Allocation of ")


def flight_enabled():
    """``PADDLE_TPU_FLIGHT=0`` kills recording and dumping entirely."""
    return os.environ.get("PADDLE_TPU_FLIGHT", "1").lower() not in (
        "0", "", "false", "off", "no")


def classify_exception(e):
    """The dump reason for an exception escaping a supervised loop:
    ``"oom"`` for allocator failures anywhere in the cause chain (torch's
    ``CUDA out of memory`` among the spellings), ``"nan_trip"`` for the
    nan-guard's FloatingPointError, else ``"trainer_exception"``."""
    seen = set()
    exc = e
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, MemoryError):
            return "oom"
        if isinstance(exc, FloatingPointError):
            return "nan_trip"
        s = f"{type(exc).__name__}: {exc}"
        if any(m in s for m in _ALLOC_MARKS):
            return "oom"
        exc = exc.__cause__ or (
            None if exc.__suppress_context__ else exc.__context__)
    return "trainer_exception"


def _jsonable(v):
    """Best-effort scalar coercion so numpy values never kill a
    dump (the recorder runs on the crash path — it must not raise)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        import numpy as np

        a = np.asarray(v)
        if a.ndim == 0:
            return a.item()
        if a.size <= 64:
            return a.tolist()
        return f"<array {a.shape} {a.dtype}>"
    except Exception:
        return str(v)[:200]


class FlightRecorder:
    """Bounded step-record ring + bundle dumper.

    capacity   ring size (default ``PADDLE_TPU_FLIGHT_STEPS`` or 30)
    out_dir    bundle directory (default ``PADDLE_TPU_FLIGHT_DIR`` or
               ``<tmp>/paddle_tpu_flight``)
    max_dumps  per-process dump cap (storm guard)
    """

    def __init__(self, capacity=None, out_dir=None, max_dumps=8,
                 registry=None):
        if capacity is None:
            capacity = int(os.environ.get(
                "PADDLE_TPU_FLIGHT_STEPS", str(DEFAULT_STEPS)))
        self.capacity = max(1, int(capacity))
        self._out_dir = out_dir
        self.max_dumps = int(max_dumps)
        self._steps = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._reg = registry or _obs.get_registry()
        self._seq = 0
        self.dumps = []           # paths written this process
        self.last_dump_path = None

    # -- recording ---------------------------------------------------------
    def record_step(self, **fields):
        """Append one step record to the ring (no-op when disabled).
        Values are coerced to JSON-able scalars at record time so the
        dump path never trips over a device array mid-crash."""
        if not flight_enabled():
            return
        rec = {"ts": time.time()}
        for k, v in fields.items():
            if v is not None:
                rec[k] = _jsonable(v)
        with self._lock:
            self._steps.append(rec)

    def steps(self):
        with self._lock:
            return list(self._steps)

    def clear(self):
        with self._lock:
            self._steps.clear()

    # -- dumping -----------------------------------------------------------
    def _dir(self):
        d = (self._out_dir
             or os.environ.get("PADDLE_TPU_FLIGHT_DIR")
             or os.path.join(tempfile.gettempdir(), "paddle_tpu_flight"))
        os.makedirs(d, exist_ok=True)
        return d

    def _recent_spans(self, n=DEFAULT_SPANS):
        try:
            from . import trace as _trace

            return _trace.get_tracer().events()[-n:]
        except Exception:
            return []

    def _metrics_snapshot(self):
        """Scalar counters/gauges of the subsystems a post-mortem reads
        first (histogram summaries included for the latency families)."""
        out = {}
        try:
            for prefix in ("executor.", "trainer.", "serving.",
                           "resilience.", "tune.", "device.",
                           "checkpoint.", "attribution."):
                out.update(self._reg.snapshot(prefix=prefix))
        except Exception:
            pass
        return out

    def dump(self, reason, path=None, **context):
        """Write the post-mortem bundle; returns its path (None when
        disabled or past ``max_dumps``).  Never raises — the recorder
        runs on crash paths where a second failure would mask the
        first."""
        if not flight_enabled():
            return None
        try:
            with self._lock:
                if len(self.dumps) >= self.max_dumps:
                    return None
                self._seq += 1
                seq = self._seq
                steps = list(self._steps)
            bundle = {
                "schema_version": SCHEMA_VERSION,
                "reason": str(reason),
                "ts": time.time(),
                "pid": os.getpid(),
                "context": {k: _jsonable(v) for k, v in context.items()},
                "steps": steps,
                "grad_norm_window": [s.get("grad_norm") for s in steps
                                     if s.get("grad_norm") is not None],
                "spans": self._recent_spans(),
                "metrics": self._metrics_snapshot(),
            }
            if path is None:
                path = os.path.join(
                    self._dir(),
                    f"flight_{reason}_{os.getpid()}_{seq}.json")
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, default=str)
            os.replace(tmp, path)
            with self._lock:
                self.dumps.append(path)
                self.last_dump_path = path
            self._reg.counter(
                "flight.dumps",
                help="flight-recorder post-mortem bundles written").inc()
            try:
                from . import trace as _trace

                _trace.get_tracer().instant(
                    "flight_dump", cat="flight", reason=str(reason),
                    path=path)
            except Exception:
                pass
            return path
        except Exception:  # noqa: BLE001 — never mask the original crash
            return None


def load_bundle(path):
    """Read a dumped bundle back (the test/postmortem entry point)."""
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


_global_recorder = None
_global_lock = threading.Lock()


def get_recorder():
    """The process-global flight recorder (created on first use)."""
    global _global_recorder
    if _global_recorder is None:
        with _global_lock:
            if _global_recorder is None:
                _global_recorder = FlightRecorder()
    return _global_recorder


def set_recorder(recorder):
    """Swap the global recorder; returns the previous one (tests install
    a private recorder pointed at tmp and restore on exit)."""
    global _global_recorder
    with _global_lock:
        prev, _global_recorder = _global_recorder, recorder
    return prev


# module-level conveniences over the global recorder ----------------------
def record_step(**fields):
    get_recorder().record_step(**fields)


def dump(reason, path=None, **context):
    return get_recorder().dump(reason, path=path, **context)

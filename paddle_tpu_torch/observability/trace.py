"""Span-based tracing runtime with Chrome-trace / Perfetto export — the
port's own copy of ``paddle_tpu/observability/trace.py`` (standard
library only, over the port's ``metrics`` registry).

The reference wraps every executor op in a ``platform/profiler``
RecordEvent and aggregates them with ParseEvents; ``host_timer.*``
histograms keep the aggregation, and this module adds the *timeline* —
where a step or a serving request actually spends its time:

* **Spans** — nested named intervals with a category and key/value
  attributes (``tracer.span("trainer.dispatch", cat="trainer",
  batch=3)``), thread-safe (per-thread nesting stacks, one locked
  bounded event buffer), recorded with ``time.perf_counter``.
* **Instants** — zero-duration markers (``tracer.instant(
  "nan_guard_trip", var="fc_0.w")``) for events like a debug_nans
  abort.
* **Retroactive spans** — ``tracer.add_span(name, t0, t1, lane=...)``
  emits an interval from timestamps recorded elsewhere; the serving
  engine uses this to lay each finished request's span tree
  (queue -> prefill -> decode chunks) on its own virtual timeline lane.
* **One aggregation path** — every finished span ALSO observes its
  duration into the global metrics registry as ``host_timer.<name>``,
  the same namespace ``profiler.timer`` uses, so ``print_profiler``
  tables, Prometheus exposition and the JSONL run log read the same
  numbers as the timeline.
* **Export** — ``tracer.save(path)`` (or module-level ``trace.save``)
  writes Chrome-trace JSON (``{"traceEvents": [...]}``): complete
  ``ph="X"`` events with ``ts``/``dur`` in microseconds plus
  ``thread_name`` metadata, viewable in ``chrome://tracing``,
  https://ui.perfetto.dev, or ``about:tracing``.

Disabled mode: ``PADDLE_TPU_TRACE=0`` (or ``Tracer(enabled=False)``)
makes ``span()`` return one shared reusable null context manager — no
allocation, no lock, no clock read — so production loops can leave the
call sites in place at near-zero overhead.

The event buffer is bounded (``PADDLE_TPU_TRACE_EVENTS``, default
100k); when full the oldest events drop and ``tracer.dropped`` counts
them — a flight recorder keeps the most recent window, not the warmup.
"""

import json
import os
import threading
import time

from . import metrics as _metrics

__all__ = [
    "Tracer", "get_tracer", "set_tracer", "tracing_enabled",
    "span", "instant", "add_span", "save", "clear",
]

# span durations aggregate under the SAME namespace as profiler.timer
TIMER_PREFIX = "host_timer."

class _NullSpan:
    """The disabled-mode span: one shared reusable context manager that
    yields ITSELF with a no-op ``set`` — so call sites written against
    the live-span API (``with tracer.span(...) as s: s.set(k=v)``) keep
    working verbatim when ``PADDLE_TPU_TRACE=0``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_CTX = _NullSpan()  # shared: the disabled-mode span


def _env_enabled():
    return os.environ.get("PADDLE_TPU_TRACE", "1").lower() not in (
        "0", "", "false", "off", "no")


class _Span:
    """A live span handle (the object ``with tracer.span(...)`` yields).
    ``set(**attrs)`` attaches attributes after entry."""

    __slots__ = ("_tracer", "name", "cat", "args", "_timer", "_t0")

    def __init__(self, tracer, name, cat, args, timer=True):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._timer = timer

    def set(self, **attrs):
        self.args.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._record(self.name, self.cat, self._t0, t1, self.args,
                             timer=self._timer)
        return False


class Tracer:
    """Thread-safe span recorder with Chrome-trace export.

    enabled     None (default) reads ``PADDLE_TPU_TRACE`` (on unless
                "0"); True/False pins it.
    registry    metrics registry receiving ``host_timer.<name>``
                duration histograms (default: the global one); None
                disables the fold-in.
    max_events  bounded buffer size (default ``PADDLE_TPU_TRACE_EVENTS``
                or 100000); oldest events drop when full.
    """

    def __init__(self, enabled=None, registry=0, max_events=None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        # sentinel 0 = "the global registry", None = "no fold-in"
        self._registry = (_metrics.get_registry() if registry == 0
                          else registry)
        if max_events is None:
            max_events = int(os.environ.get(
                "PADDLE_TPU_TRACE_EVENTS", "100000"))
        self._max_events = max(1, int(max_events))
        self._lock = threading.Lock()
        self._events = []
        self.dropped = 0
        self._t0 = time.perf_counter()  # export epoch: ts are relative
        self._pid = os.getpid()
        self._tids = {}       # lane label -> virtual tid
        self._tid_names = {}  # tid -> display name
        self._next_tid = 1
        # per-thread-OBJECT tid cache: threading.get_ident() values are
        # reused once a thread exits, which would merge a later thread
        # onto a dead thread's timeline lane under its stale name
        self._tls = threading.local()

    # -- recording --------------------------------------------------------
    def _tid(self):
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            with self._lock:
                tid = self._next_tid
                self._next_tid += 1
                self._tid_names[tid] = threading.current_thread().name
            self._tls.tid = tid
        return tid

    def lane(self, label):
        """A virtual timeline lane (Chrome tid) for events that don't
        belong to a host thread — e.g. one lane per serving request."""
        tid = self._tids.get(label)
        if tid is None:
            with self._lock:
                tid = self._tids.get(label)
                if tid is None:
                    tid = 10000 + len(self._tids)
                    self._tids[label] = tid
                    self._tid_names[tid] = str(label)
        return tid

    def _push(self, ev):
        with self._lock:
            if len(self._events) >= self._max_events:
                # drop the oldest half in one slice (amortized O(1)
                # per event) — a flight recorder keeps the recent window
                drop = self._max_events // 2 or 1
                del self._events[:drop]
                self.dropped += drop
            self._events.append(ev)

    def _record(self, name, cat, t0, t1, args, tid=None, timer=True):
        # nesting needs no explicit parent links: Chrome/Perfetto derive
        # it from ts/dur containment within a tid
        self._push({
            "ph": "X", "name": name, "cat": cat,
            "ts": (t0 - self._t0) * 1e6, "dur": (t1 - t0) * 1e6,
            "pid": self._pid, "tid": tid if tid is not None else self._tid(),
            "args": dict(args) if args else {},
        })
        if timer and self._registry is not None:
            self._registry.histogram(TIMER_PREFIX + name).observe(t1 - t0)

    # -- public API -------------------------------------------------------
    def span(self, name, cat="host", timer=True, **attrs):
        """Context manager recording a nested interval.  Disabled mode
        returns one shared null context: no allocation, no clock read.
        ``timer=False`` keeps the span timeline-only (no ``host_timer.``
        fold-in) — for spans that RE-present an interval other spans or
        timers already observe (e.g. a parent whose children cover the
        same window), which would otherwise multi-count the same wall
        seconds in the aggregate view."""
        if not self.enabled:
            return _NULL_CTX
        return _Span(self, name, cat, attrs, timer=timer)

    def instant(self, name, cat="host", **attrs):
        """Zero-duration marker (Chrome ``ph="i"``), e.g. a nan trip."""
        if not self.enabled:
            return
        self._push({
            "ph": "i", "name": name, "cat": cat, "s": "t",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": self._pid, "tid": self._tid(),
            "args": dict(attrs) if attrs else {},
        })

    def add_span(self, name, t0, t1, cat="host", lane=None, timer=True,
                 **attrs):
        """Record a span retroactively from ``time.perf_counter``
        timestamps captured elsewhere.  ``lane`` places it on a virtual
        timeline (see :meth:`lane`) instead of the calling thread.
        ``timer=False`` skips the ``host_timer.`` fold-in — for spans
        that RE-present an interval some other span or histogram
        already observed (e.g. a request's lane re-emitting the decode
        chunks it was live for), which would otherwise multi-count the
        same wall time in the aggregate view."""
        if not self.enabled:
            return
        tid = self.lane(lane) if lane is not None else None
        self._record(name, cat, t0, t1, attrs, tid=tid, timer=timer)

    def events(self, name=None, cat=None):
        """Snapshot of recorded events (dicts), optionally filtered."""
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        if cat is not None:
            evs = [e for e in evs if e.get("cat") == cat]
        return evs

    def clear(self):
        with self._lock:
            self._events = []
            self.dropped = 0

    # -- export -----------------------------------------------------------
    def to_chrome_trace(self):
        """The Chrome-trace object: metadata + events sorted by ts."""
        with self._lock:
            evs = sorted(self._events, key=lambda e: e["ts"])
            names = dict(self._tid_names)
        meta = [{"ph": "M", "name": "process_name", "pid": self._pid,
                 "tid": 0, "args": {"name": "paddle_tpu_torch"}}]
        for tid, label in sorted(names.items()):
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": label}})
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def save(self, path):
        """Write Chrome-trace JSON; returns the event count (metadata
        records excluded)."""
        obj = self.to_chrome_trace()
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(obj, fh)
        return sum(1 for e in obj["traceEvents"] if e["ph"] != "M")


_global_tracer = None
_global_lock = threading.Lock()


def get_tracer():
    """The process-global tracer (created on first use; enabled unless
    ``PADDLE_TPU_TRACE=0``)."""
    global _global_tracer
    if _global_tracer is None:
        with _global_lock:
            if _global_tracer is None:
                _global_tracer = Tracer()
    return _global_tracer


def set_tracer(tracer):
    """Swap the process-global tracer; returns the previous one (tests
    install a private tracer and restore the old on exit)."""
    global _global_tracer
    with _global_lock:
        prev, _global_tracer = _global_tracer, tracer
    return prev


def tracing_enabled():
    return get_tracer().enabled


# module-level conveniences over the global tracer ----------------------
def span(name, cat="host", timer=True, **attrs):
    return get_tracer().span(name, cat=cat, timer=timer, **attrs)


def instant(name, cat="host", **attrs):
    return get_tracer().instant(name, cat=cat, **attrs)


def add_span(name, t0, t1, cat="host", lane=None, timer=True, **attrs):
    return get_tracer().add_span(name, t0, t1, cat=cat, lane=lane,
                                 timer=timer, **attrs)


def save(path):
    return get_tracer().save(path)


def clear():
    return get_tracer().clear()

"""Metrics registry — counters, gauges, histograms with one global,
thread-safe instance.

The port's own copy of ``paddle_tpu/observability/metrics.py``
(standard library only): the serving engine reports its ``serving.*``
metrics here under the same names as the JAX engine.

Reference: the platform/profiler RecordEvent aggregation tables and
utils/Stat.h REGISTER_TIMER stat registry — here generalized into the
instrument panel the whole stack (executor, trainer, pserver/master,
inference) reports through, with two export paths:

* Prometheus-style text exposition (``MetricsRegistry.to_text`` /
  ``start_metrics_server``) for live scraping;
* structured snapshots (``MetricsRegistry.snapshot``), which
  ``ServingEngine.stats()`` returns.

Metric identity is ``(name, sorted labels)`` — e.g.
``registry.counter("pserver.updates_applied", shard="0")``.  Names use
dotted namespaces internally; exposition sanitizes them to
``pserver_updates_applied{shard="0"}``.
"""

import math
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "start_metrics_server",
]


class _Metric:
    kind = "untyped"

    def __init__(self, name, labels=(), help=""):
        self.name = name
        self.labels = tuple(labels)  # sorted (key, value) pairs
        self.help = help
        self._lock = threading.Lock()

    def full_name(self):
        if not self.labels:
            return self.name
        lab = ",".join(f"{k}={v}" for k, v in self.labels)
        return f"{self.name}{{{lab}}}"


class Counter(_Metric):
    """Monotonic accumulator (count of events, or summed seconds/bytes)."""

    kind = "counter"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class Gauge(_Metric):
    """Point-in-time value (queue depth, bytes in use, last stall time)."""

    kind = "gauge"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1.0):
        with self._lock:
            self._value += n

    def dec(self, n=1.0):
        self.inc(-n)

    def set_max(self, v):
        """High-water-mark update: keep the larger of current and ``v``."""
        v = float(v)
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class Histogram(_Metric):
    """Timer/size distribution: exact count/sum/min/max plus percentiles
    over a bounded sample reservoir (the most recent ``reservoir``
    observations — step timers care about the current regime, not the
    warmup)."""

    kind = "histogram"

    def __init__(self, name, labels=(), help="", reservoir=4096):
        super().__init__(name, labels, help)
        self._reservoir = int(reservoir)
        self._samples = []
        self._head = 0  # ring-buffer write index once full
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._samples) < self._reservoir:
                self._samples.append(v)
            else:
                self._samples[self._head] = v
                self._head = (self._head + 1) % self._reservoir

    def time(self):
        """Context manager observing the elapsed wall time."""
        return _HistogramTimer(self)

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    @staticmethod
    def _rank(s, p):
        """Nearest-rank value for percentile ``p`` over sorted ``s``."""
        idx = min(len(s) - 1, max(0, int(math.ceil(p / 100.0 * len(s))) - 1))
        return s[idx]

    def percentile(self, p):
        """p in [0, 100]; nearest-rank over the reservoir.  NaN when
        nothing has been observed."""
        with self._lock:
            s = sorted(self._samples)
        return self._rank(s, p) if s else math.nan

    def percentiles(self, ps=(50, 95, 99)):
        with self._lock:
            s = sorted(self._samples)
        if not s:
            return {p: math.nan for p in ps}
        return {p: self._rank(s, p) for p in ps}

    def snapshot(self):
        with self._lock:
            s = sorted(self._samples)
            count, total = self.count, self.total
            mn, mx = self.min, self.max
        out = {"count": count, "sum": total,
               "mean": total / count if count else 0.0}
        if count:
            out["min"], out["max"] = mn, mx
            for p in (50, 95, 99):
                out[f"p{p}"] = self._rank(s, p)
        return out

    def reset(self):
        with self._lock:
            self._samples = []
            self._head = 0
            self.count = 0
            self.total = 0.0
            self.min = math.inf
            self.max = -math.inf


class _HistogramTimer:
    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._hist.observe(time.perf_counter() - self._t0)
        return False


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESC = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


class MetricsRegistry:
    """Thread-safe get-or-create registry.  ``counter``/``gauge``/
    ``histogram`` return the SAME object for the same (name, labels), so
    call sites never need to cache handles."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    def _get(self, cls, name, labels, help, **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], help, **kw)
                self._metrics[key] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, help="", **labels):
        return self._get(Counter, name, labels, help)

    def gauge(self, name, help="", **labels):
        return self._get(Gauge, name, labels, help)

    def histogram(self, name, help="", reservoir=4096, **labels):
        return self._get(Histogram, name, labels, help, reservoir=reservoir)

    def get(self, name, kind=None, **labels):
        """Lookup without creating; None when absent (or when ``kind``
        is given and doesn't match)."""
        with self._lock:
            m = self._metrics.get((name, tuple(sorted(labels.items()))))
        if m is not None and kind is not None and m.kind != kind:
            return None
        return m

    def metrics(self, prefix=None):
        with self._lock:
            ms = list(self._metrics.values())
        if prefix is not None:
            ms = [m for m in ms if m.name.startswith(prefix)]
        return sorted(ms, key=lambda m: (m.name, m.labels))

    def value(self, name, default=0.0, **labels):
        m = self.get(name, **labels)
        return default if m is None else getattr(m, "value", default)

    def snapshot(self, prefix=None):
        """{full_name: value} (histograms expand to their summary dict)."""
        out = {}
        for m in self.metrics(prefix):
            if isinstance(m, Histogram):
                out[m.full_name()] = m.snapshot()
            else:
                out[m.full_name()] = m.value
        return out

    def reset(self, prefix=None):
        """Zero every metric (held handles stay valid)."""
        for m in self.metrics(prefix):
            m.reset()

    def clear(self, prefix=None):
        """Drop metric objects entirely (prefix-scoped when given)."""
        with self._lock:
            if prefix is None:
                self._metrics.clear()
            else:
                for k in [k for k, m in self._metrics.items()
                          if m.name.startswith(prefix)]:
                    del self._metrics[k]

    # -- exposition --------------------------------------------------------
    def to_text(self):
        """Prometheus text format; histograms render as summaries
        (quantile lines + _sum/_count)."""
        lines = []
        seen_header = set()
        for m in self.metrics():
            name = _NAME_RE.sub("_", m.name)
            if name not in seen_header:
                seen_header.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(
                    f"# TYPE {name} "
                    f"{'summary' if m.kind == 'histogram' else m.kind}")
            base_labels = [
                f'{_NAME_RE.sub("_", k)}="{str(v).translate(_LABEL_ESC)}"'
                for k, v in m.labels
            ]

            def fmt(extra=(), suffix=""):
                lab = ",".join(list(base_labels) + list(extra))
                return f"{name}{suffix}{{{lab}}}" if lab else f"{name}{suffix}"

            if m.kind == "histogram":
                pct = m.percentiles((50, 95, 99))
                for p, v in pct.items():
                    if not math.isnan(v):
                        q = f'quantile="{p / 100.0:g}"'
                        lines.append(f"{fmt([q])} {v:.9g}")
                lines.append(f"{fmt(suffix='_sum')} {m.total:.9g}")
                lines.append(f"{fmt(suffix='_count')} {m.count}")
            else:
                lines.append(f"{fmt()} {m.value:.9g}")
        return "\n".join(lines) + "\n"


_global_registry = MetricsRegistry()


def get_registry():
    """The process-global registry every subsystem reports into."""
    return _global_registry


def start_metrics_server(port=0, registry=None, host="127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text) from a daemon thread.
    Returns the HTTPServer; call ``.shutdown()`` to stop.  The bound port
    is ``server.server_address[1]`` (useful with port=0)."""
    import http.server

    reg = registry or get_registry()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = reg.to_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="pt-metrics-server")
    t.start()
    return server

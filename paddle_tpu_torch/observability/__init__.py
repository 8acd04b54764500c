"""Telemetry of the port: the stdlib-only metrics registry, span tracing
with Chrome-trace export (``trace``), the crash flight recorder
(``flight``), the JSONL run log (``runlog``), the card's peak table, MFU
and memory stats (``hardware``), and ``MetricsReporter``, the Trainer's
telemetry event handler (``reporter``)."""

from . import flight, hardware, metrics, reporter, runlog, trace
from .flight import FlightRecorder, get_recorder, set_recorder
from .hardware import (device_memory_stats, device_peak_flops, mfu,
                       sample_memory)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, start_metrics_server)
from .reporter import MetricsReporter
from .runlog import RunLog, read_jsonl
from .trace import Tracer, get_tracer, set_tracer

__all__ = [
    "metrics", "runlog", "hardware", "reporter", "trace", "flight",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "start_metrics_server", "RunLog", "read_jsonl", "MetricsReporter",
    "device_peak_flops", "mfu",
    "device_memory_stats", "sample_memory",
    "Tracer", "get_tracer", "set_tracer",
    "FlightRecorder", "get_recorder", "set_recorder",
]

"""Telemetry of the port: the stdlib-only metrics registry, span tracing
with Chrome-trace export (``trace``) and the crash flight recorder
(``flight``)."""

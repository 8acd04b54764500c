"""Telemetry of the port: the stdlib-only metrics registry."""

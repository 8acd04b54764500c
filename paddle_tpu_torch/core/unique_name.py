"""Unique name generator (the port's copy of
``paddle_tpu/core/unique_name.py``; same counters, same names)."""

import contextlib
import threading

_lock = threading.Lock()
_counters = {}
_prefix_stack = []


def generate(key):
    with _lock:
        idx = _counters.get(key, 0)
        _counters[key] = idx + 1
    prefix = "/".join(_prefix_stack)
    name = f"{key}_{idx}"
    return f"{prefix}/{name}" if prefix else name


@contextlib.contextmanager
def guard(prefix=None):
    """Scope generated names (and reset counters inside tests)."""
    global _counters
    if prefix is not None:
        _prefix_stack.append(prefix)
        try:
            yield
        finally:
            _prefix_stack.pop()
    else:
        saved = dict(_counters)
        try:
            yield
        finally:
            with _lock:
                _counters = saved


def reset():
    with _lock:
        _counters.clear()

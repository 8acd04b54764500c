"""RunLog — append-only JSONL structured event log for offline analysis.
The port's own copy of ``paddle_tpu/observability/runlog.py`` (standard
library only).

Every record is one JSON object per line with at least ``event`` (record
type) and ``ts`` (unix seconds).  The trainer's `MetricsReporter` writes
``step`` / ``pass`` / ``run_meta`` records here; anything downstream
(regression dashboards, MFU sweeps, bench history) parses it with
``read_jsonl``.  numpy scalars/arrays are coerced to plain JSON so
call sites can pass fetched values directly.
"""

import json
import os
import threading
import time

__all__ = ["RunLog", "read_jsonl"]


def _jsonable(v):
    """Best-effort coercion to a JSON-serializable value."""
    if v is None or isinstance(v, (bool, int, float, str)):
        # json turns inf/nan into non-standard tokens; stringify instead
        if isinstance(v, float) and (v != v or v in (float("inf"),
                                                     float("-inf"))):
            return repr(v)
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x) for x in v]
    # numpy scalars / 0-d and small arrays without importing numpy here
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        try:
            return _jsonable(item())
        except Exception:
            pass
    tolist = getattr(v, "tolist", None)
    if tolist is not None and getattr(v, "size", 1 << 30) <= 64:
        try:
            return _jsonable(tolist())
        except Exception:
            pass
    return str(v)


class RunLog:
    """Thread-safe JSONL writer.

        with RunLog("/tmp/run.jsonl") as log:
            log.log("step", batch=3, cost=0.12, wall_time=0.004)

    ``auto_flush`` (default True) flushes after every record so a crashed
    run keeps everything it measured — the whole point of a flight
    recorder."""

    def __init__(self, path, mode="a", auto_flush=True):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, mode, encoding="utf-8")
        self._lock = threading.Lock()
        self._auto_flush = auto_flush
        self.records_written = 0

    def log(self, event, **fields):
        rec = {"event": str(event), "ts": time.time()}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:
                raise ValueError(f"RunLog {self.path} is closed")
            self._fh.write(line + "\n")
            self.records_written += 1
            if self._auto_flush:
                self._fh.flush()

    def flush(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path, event=None):
    """Parse a JSONL file back into a list of dicts; ``event`` filters by
    record type.  Tolerates a truncated final line (crashed writer)."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail record from a crashed run
            if event is None or rec.get("event") == event:
                out.append(rec)
    return out

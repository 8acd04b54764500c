"""Jittered-exponential-backoff retry — the transient-failure absorber.
The port's own copy of ``paddle_tpu/resilience/retry.py`` (standard
library only; the retry counter goes to the port's ``metrics``).

Reference: go/connection/conn.go dials with retry; the etcd client
re-registers on lease loss.  Here one policy object serves every
transient surface; in the port that is checkpoint IO (a full NFS write
queue) — ``io.AsyncCheckpointer`` retries its writes through it.

Deterministic-friendly: jitter comes from a module-level ``random.Random``
— NOT the global ``random`` stream, so retry timing never perturbs a
seeded training run's shuffle order — seeded from the pid, so each
process of a fleet draws a DIFFERENT jitter sequence (identical
sequences would re-synchronize the herd the jitter exists to break).
"""

import os
import random
import time

__all__ = ["Backoff", "retry_call", "RetryError"]

_jitter_rng = random.Random(0x5EED ^ os.getpid())


class RetryError(RuntimeError):
    """All attempts exhausted; ``last`` is the final exception."""

    def __init__(self, attempts, last):
        super().__init__(
            f"gave up after {attempts} attempt(s): {last!r}")
        self.attempts = attempts
        self.last = last


class Backoff:
    """Iterator of sleep delays: ``base * factor**i`` capped at
    ``max_delay``, each multiplied by ``1 + U(-jitter, +jitter)`` so a
    fleet of retriers never thunders in lockstep.

        for delay in Backoff(base=0.05, attempts=5):
            if try_once():
                break
            time.sleep(delay)
    """

    def __init__(self, base=0.05, factor=2.0, max_delay=2.0, jitter=0.25,
                 attempts=None):
        if base < 0 or factor < 1 or max_delay < 0:
            raise ValueError(
                f"bad backoff (base={base}, factor={factor}, "
                f"max_delay={max_delay})")
        if not 0 <= jitter < 1:
            raise ValueError(f"jitter must be in [0, 1): {jitter}")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.attempts = attempts  # None = unbounded

    def delay(self, i):
        """The i-th (0-based) delay, jittered."""
        d = min(self.base * (self.factor ** i), self.max_delay)
        if self.jitter:
            d *= 1.0 + _jitter_rng.uniform(-self.jitter, self.jitter)
        return d

    def __iter__(self):
        i = 0
        while self.attempts is None or i < self.attempts:
            yield self.delay(i)
            i += 1


def retry_call(fn, *args, retries=4, retry_on=(OSError, ConnectionError),
               backoff=None, on_retry=None, sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception, back
    off (jittered exponential) and retry up to ``retries`` more times.
    Raises ``RetryError`` (with the last exception chained) once
    exhausted; any non-``retry_on`` exception propagates immediately.

    ``on_retry(attempt, exc, delay)`` is called before each sleep —
    the telemetry hook.  Every performed retry also increments the
    ``resilience.retries`` counter (best-effort)."""
    bo = backoff or Backoff()
    last = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            last = e
            if attempt >= retries:
                raise RetryError(attempt + 1, e) from e
            d = bo.delay(attempt)
            try:
                from ..observability import metrics as _obs

                _obs.get_registry().counter(
                    "resilience.retries",
                    help="transient-failure retries performed "
                         "(checkpoint IO, rpc, store)").inc()
            except Exception:
                pass
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)
    raise RetryError(retries + 1, last) from last  # unreachable

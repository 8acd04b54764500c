"""Step-deadline watchdog — hang detection for loops that must beat.
The port's own copy of ``paddle_tpu/resilience/watchdog.py`` (standard
library only, over the port's ``metrics``, ``trace`` and ``flight``).

A trainer step that deadlocks (a wedged collective, a dead input
producer, a stuck host sync) produces *no* signal: the process sits at
0% CPU forever and the only observer is a human.  The watchdog makes
the hang observable: the supervised loop calls ``beat()`` every
iteration; a monitor thread trips when no beat arrives within
``deadline`` seconds — incrementing ``resilience.watchdog_trips``,
setting the ``resilience.watchdog_stalled`` gauge, dropping a
``watchdog_trip`` trace instant on the span timeline, and invoking the
optional ``on_trip(age)`` callback (report-only by default: killing a
maybe-just-slow step is the supervisor's call, not the gauge's).

The trip re-arms after the next beat, so a recovered stall and a second
stall count twice.  ``resilience.watchdog_beat_age_seconds`` is a
continuously-updated gauge of the current beat age — the "how stuck are
we right now" signal dashboards alert on.
"""

import threading
import time

__all__ = ["Watchdog"]


class Watchdog:
    """Supervise a loop that promises to ``beat()`` every ``deadline``
    seconds.

        with Watchdog(deadline=30, label="trainer.step") as wd:
            for batch in reader():
                step(batch)
                wd.beat()
    """

    def __init__(self, deadline, label="loop", on_trip=None,
                 interval=None, registry=None):
        if deadline <= 0:
            raise ValueError(f"deadline must be > 0: {deadline}")
        from ..observability import metrics as _obs

        self.deadline = float(deadline)
        self.label = label
        self.on_trip = on_trip
        self.trips = 0
        self._interval = (min(self.deadline / 4.0, 1.0)
                          if interval is None else float(interval))
        self._reg = registry or _obs.get_registry()
        self._last_beat = time.monotonic()
        self._tripped = False   # armed-edge: one trip per stall
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._monitor, daemon=True,
            name=f"pt-watchdog-{label}")
        self._thread.start()

    def beat(self):
        """The supervised loop is alive; re-arm the trip edge."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._tripped = False

    @property
    def age(self):
        """Seconds since the last beat."""
        with self._lock:
            return time.monotonic() - self._last_beat

    def _monitor(self):
        from ..observability import trace as _trace

        while not self._stop.wait(self._interval):
            with self._lock:
                age = time.monotonic() - self._last_beat
                trip = age > self.deadline and not self._tripped
                if trip:
                    self._tripped = True
            self._reg.gauge(
                "resilience.watchdog_beat_age_seconds",
                label=self.label,
                help="seconds since the supervised loop last beat",
            ).set(age)
            self._reg.gauge(
                "resilience.watchdog_stalled", label=self.label,
                help="1 while the supervised loop is past its deadline",
            ).set(1.0 if age > self.deadline else 0.0)
            if trip:
                self.trips += 1
                self._reg.counter(
                    "resilience.watchdog_trips", label=self.label,
                    help="deadline expiries (re-armed per recovery)",
                ).inc()
                _trace.get_tracer().instant(
                    "watchdog_trip", cat="resilience", label=self.label,
                    age_s=round(age, 3), deadline_s=self.deadline)
                if self.on_trip is not None:
                    try:
                        self.on_trip(age)
                    except Exception:
                        pass  # a broken callback must not kill the monitor
                try:
                    # post-mortem: a stalled loop dumps the flight
                    # bundle (the last N step records + spans) so the
                    # hang has history, not just a gauge.  After
                    # on_trip: the dump does file IO, and callers
                    # watching `trips` must not observe the increment
                    # long before their callback runs.
                    from ..observability import flight as _flight

                    _flight.dump("watchdog", label=self.label,
                                 age_s=round(age, 3),
                                 deadline_s=self.deadline)
                except Exception:  # noqa: BLE001 — monitor must survive
                    pass

    def stop(self):
        self._stop.set()
        self._thread.join()
        self._reg.gauge("resilience.watchdog_stalled",
                        label=self.label).set(0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

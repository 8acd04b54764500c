"""Profiling & debugging hooks — the port's counterpart of
``paddle_tpu/profiler.py``.

Reference: platform/profiler.{h,cc} (RecordEvent around every op in the
Executor, aggregated table via ParseEvents/PrintProfiler), fluid/profiler.py
(cuda_profiler → nvprof), utils/Stat.h REGISTER_TIMER, and the
FLAGS_check_nan_inf per-op scan (executor.cc:131).

The equivalents here: (1) ``torch.profiler`` writing a Chrome trace of
the host and the card (``profiler('dir')``, ``start_trace`` /
``stop_trace``), and ``middle_call_kernels``, the card's kernels of one
call recorded whole; (2) named host-side timers for the train loop
(``timer`` / ``print_profiler``), and (3) ``nan_guard``, a check that
raises on a non-finite loss or gradient norm.

Host timers aggregate in the observability metrics registry (histograms
under the ``host_timer.`` namespace) — ONE aggregation path shared with
the rest of the telemetry subsystem, so `print_profiler` tables, the
Prometheus exposition and JSONL run logs all read the same numbers."""

import contextlib
import os
import tempfile
import time

from .core import executor as _executor
from .observability import metrics as _obs

# registry namespace for host-side phase timers
TIMER_PREFIX = "host_timer."


@contextlib.contextmanager
def timer(name):
    """REGISTER_TIMER analog for host-side phases; records into the
    global metrics registry as ``host_timer.<name>``."""
    hist = _obs.get_registry().histogram(TIMER_PREFIX + name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist.observe(time.perf_counter() - t0)


def reset_profiler():
    """Drop all host timers (registry entries under ``host_timer.``)."""
    _obs.get_registry().clear(prefix=TIMER_PREFIX)


def print_profiler(sorted_key="total", log=None):
    """PrintProfiler analog: aggregated host timer table with the share
    of total timed seconds per event.  ``sorted_key`` must be one of
    ``total`` / ``calls`` / ``ave`` / ``max`` — anything else raises.

    ``log=`` takes a ``RunLog`` (or anything with ``.log(event,
    **fields)``) and ALSO emits the aggregation as one structured
    ``profiler`` JSONL record — the same numbers as the printed table."""
    keys = {"total": 1, "calls": 2, "ave": 3, "max": 4}
    if sorted_key not in keys:
        raise ValueError(
            f"print_profiler: unknown sorted_key {sorted_key!r}; "
            f"expected one of {sorted(keys)}")
    hists = _obs.get_registry().metrics(prefix=TIMER_PREFIX)
    rows = [
        (h.name[len(TIMER_PREFIX):], h.total, h.count, h.mean,
         (h.max if h.count else 0.0))
        for h in hists if isinstance(h, _obs.Histogram)
    ]
    grand = sum(r[1] for r in rows) or 1.0
    rows.sort(key=lambda r: -r[keys[sorted_key]])
    out = [f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}{'Ave(s)':>12}"
           f"{'Max(s)':>12}{'%':>8}"]
    for name, total, calls, ave, mx in rows:
        out.append(
            f"{name:<40}{calls:>8}{total:>12.4f}{ave:>12.6f}{mx:>12.6f}"
            f"{100.0 * total / grand:>8.2f}")
    table = "\n".join(out)
    print(table)
    if log is not None:
        log.log("profiler", sorted_key=sorted_key,
                timers=[{"event": name, "total": total, "calls": calls,
                         "ave": ave, "max": mx,
                         "pct": round(100.0 * total / grand, 2)}
                        for name, total, calls, ave, mx in rows])
    return table


class _Capture:
    """A running ``torch.profiler`` capture and the directory its Chrome
    trace goes to."""

    def __init__(self, prof, log_dir):
        self.prof = prof
        self.log_dir = log_dir


def start_trace(log_dir):
    """Start a ``torch.profiler`` capture of the host and, where there
    is one, the card.  Returns the handle ``stop_trace`` takes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    return _Capture(prof, log_dir)


def stop_trace(capture):
    """End a capture and write its Chrome trace
    (``<log_dir>/trace_<pid>_<n>.json``, loadable in Perfetto or
    chrome://tracing).  Returns the path."""
    capture.prof.__exit__(None, None, None)
    prefix = f"trace_{os.getpid()}_"
    n = sum(f.startswith(prefix) for f in os.listdir(capture.log_dir))
    path = os.path.join(capture.log_dir, f"{prefix}{n}.json")
    capture.prof.export_chrome_trace(path)
    return path


# The card's least idle time between the calls ``middle_call_kernels``
# records: long beside any one kernel, and short beside a step.
_PAUSE_S = 0.1


def middle_call_kernels(run):
    """The card's kernels of one call of ``run`` as ``[(start_ns,
    duration_ns, name)]`` in time order, recorded by ``torch.profiler``'s
    CUDA activity.

    A recording can lose the device events at its edges: on an H100 a
    recorded training step of 5,331 kernels lost its first events in
    about one recording in ten and at times its last ones too, under the
    CPU and CUDA activities and the CUDA one alone alike
    (``benchmarks/profiler_loss.py``).  So this records three calls,
    ``run(0)``, ``run(1)``, ``run(2)``, which must launch the same
    kernels, the card idle between them for ``_PAUSE_S`` or the wall of
    the call before, whichever is longer (a gap inside a call is shorter
    than the call: a host-bound step can leave the card idle for longer
    than ``_PAUSE_S``), and returns the middle one's events: those between
    the two widest gaps of the recording.  It raises when the recording holds no device events,
    when either gap is under half the pause, and when the middle call
    shows fewer events than the first or the third: a loss at the edges
    shortens only those, so a short middle call lost events of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            t0 = time.perf_counter()
            run(i)
            torch.cuda.synchronize()
            if i < 2:
                time.sleep(max(_PAUSE_S, time.perf_counter() - t0))
    events = sorted((e.start_ns(), e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    if len(events) < 3:
        raise RuntimeError(f"middle_call_kernels: the recording holds "
                           f"{len(events)} device events")
    gaps = sorted(range(1, len(events)), key=lambda i: events[i][0] - (
        events[i - 1][0] + events[i - 1][1]))[-2:]
    lo, hi = sorted(gaps)
    for i in (lo, hi):
        if events[i][0] - events[i - 1][0] - events[i - 1][1] < (
                _PAUSE_S / 2e-9):
            raise RuntimeError("middle_call_kernels: the recording shows no "
                               "pause between the calls")
    first, third = lo, len(events) - hi
    if hi - lo < max(first, third):
        raise RuntimeError(
            f"middle_call_kernels: the profiler lost device events of the "
            f"counted call: it shows {hi - lo}, the first call {first}, "
            f"the third {third}")
    return events[lo:hi]


@contextlib.contextmanager
def profiler(log_dir=None, state=None):
    """Device-level tracing (fluid profiler.py analog): a Chrome trace
    of the host and the card under ``log_dir`` (default: a directory
    under the temporary directory)."""
    capture = start_trace(log_dir or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_profile"))
    try:
        yield capture.prof
    finally:
        stop_trace(capture)


@contextlib.contextmanager
def nan_guard():
    """FLAGS_check_nan_inf analog: inside the context, every training
    step checks its loss and its global gradient norm before the
    optimizer ops run, and raises ``FloatingPointError`` (after counting
    ``executor.nan_trips``, dropping a ``nan_guard_trip`` instant and a
    ``nan_trip`` flight bundle) when either is not finite — so the
    parameters, updated in place, never take the bad step.

    What it does not catch, where the reference's ``jax_debug_nans``
    does: a NaN or Inf in an intermediate value that neither reaches the
    loss nor a gradient (a masked-out score, an unused output), in a
    fetch other than the loss, in a forward-only program (no loss, no
    gradient), or in the optimizer's own arithmetic.  The check costs one
    host sync a step while the guard is on."""
    _executor.NAN_GUARD[0] += 1
    try:
        yield
    finally:
        _executor.NAN_GUARD[0] -= 1

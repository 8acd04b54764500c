"""Fault injection — failure as a tested code path.  The port's own copy
of ``paddle_tpu/resilience/faults.py`` (standard library only; the
telemetry goes to the port's ``metrics`` and ``trace``).  Of the
injection points below the port wires ``serving.decode`` (the serving
engine); the others wait for its trainer and checkpoint modules.

The reference's distributed generation was *designed around* process
churn (the Go master re-dispatches timed-out task leases,
go/master/service.go; the pserver checkpoint recovers a died shard,
go/pserver/service.go:342) but nothing in a test ever *made* a process
die.  This module turns faults into reproducible inputs: set

    PADDLE_TPU_FAULT=<kind>:<n>

and the ``n``-th arrival at that kind's injection point performs the
fault.  One fault spec per process (the crash kinds never return, and a
resumed process runs with the spec removed).

Catalog (``kind`` -> injection point -> effect):

=============  ==================  =======================================
kind           point               effect at the n-th arrival
=============  ==================  =======================================
``sigkill``    ``trainer.step``    ``SIGKILL`` own pid — a hard trainer
                                   death mid-pass (no atexit, no flush)
``ckpt_crash`` ``ckpt.publish``    ``os._exit(23)`` BETWEEN the two
                                   checkpoint publish renames — the torn
                                   window ``io.AsyncCheckpointer._write``
                                   must survive via the ``.old`` fallback
``io_error``   ``ckpt.write``      raise a TRANSIENT ``OSError`` once
                                   (only the n-th arrival) — exercised by
                                   the retry/backoff path, which must
                                   absorb it
``reader_err`` ``reader.next``     raise ``RuntimeError`` — an input
                                   pipeline exception surfacing mid-pass
``nan_grad``   ``trainer.step``    return ``"nan"`` so the caller poisons
                                   the step's loss — drives the nan-guard
                                   / bad-step telemetry path
``slot_death`` ``serving.decode``  return ``"slot_death"`` so the serving
                                   engine kills one active request
                                   mid-decode — its slot AND its paged KV
                                   blocks must be reclaimed (no block
                                   leak) and the engine must keep serving.  In
                                   speculative mode the decode point sits
                                   MID-VERIFY, so the victim also holds a
                                   draft scratch chain: both chains must
                                   come back (tests/test_speculative.py,
                                   tests/test_torch_speculative.py)
=============  ==================  =======================================

Arrival counters are per-process module state; ``reset()`` exists for
tests.  Every performed injection increments the
``resilience.fault_injected`` counter (best-effort for the crash kinds)
and drops a ``fault_injected`` trace instant.
"""

import os
import signal

__all__ = ["FaultSpec", "spec", "maybe_fault", "reset", "ENV_VAR"]

ENV_VAR = "PADDLE_TPU_FAULT"

# kind -> the injection point it arms
_POINT_OF = {
    "sigkill": "trainer.step",
    "ckpt_crash": "ckpt.publish",
    "io_error": "ckpt.write",
    "reader_err": "reader.next",
    "nan_grad": "trainer.step",
    "slot_death": "serving.decode",
}

_counts = {}  # point -> arrivals so far (per process)


class FaultSpec:
    """Parsed ``PADDLE_TPU_FAULT`` value: ``kind`` and the 1-based
    arrival index ``n`` at which it fires."""

    __slots__ = ("kind", "n")

    def __init__(self, kind, n):
        if kind not in _POINT_OF:
            raise ValueError(
                f"unknown fault kind {kind!r} (known: "
                f"{sorted(_POINT_OF)})")
        if n < 1:
            raise ValueError(f"fault arrival index must be >= 1: {n}")
        self.kind = kind
        self.n = n

    @property
    def point(self):
        return _POINT_OF[self.kind]

    def __repr__(self):
        return f"FaultSpec({self.kind}:{self.n})"


def spec():
    """The process's armed fault, or None.  Parsed per call so tests can
    flip the env var without re-importing."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    kind, _, n = raw.partition(":")
    try:
        return FaultSpec(kind.strip(), int(n) if n else 1)
    except ValueError as e:
        raise ValueError(f"bad {ENV_VAR}={raw!r}: {e}") from None


def reset():
    """Forget arrival counts (test isolation)."""
    _counts.clear()


def _record(sp):
    """Best-effort telemetry for a fault about to be performed."""
    try:
        from ..observability import metrics as _obs
        from ..observability import trace as _trace

        _obs.get_registry().counter(
            "resilience.fault_injected",
            help="faults performed by PADDLE_TPU_FAULT injection").inc()
        _trace.get_tracer().instant("fault_injected", cat="resilience",
                                    kind=sp.kind, n=sp.n)
    except Exception:  # a crash fault must still crash
        pass


def maybe_fault(point):
    """Injection point: call at every arrival of ``point``.  Counts the
    arrival and, when an armed fault targets this point and this is its
    n-th arrival, performs it.  Returns ``"nan"`` for the ``nan_grad``
    kind (the caller poisons its loss); returns None otherwise.  No-op
    (beyond counting) when no fault is armed."""
    sp = spec()
    if sp is None or sp.point != point:
        return None
    _counts[point] = _counts.get(point, 0) + 1
    if _counts[point] != sp.n:
        return None
    _record(sp)
    if sp.kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif sp.kind == "ckpt_crash":
        # simulate a hard crash mid-publish: no unwinding, no atexit —
        # the parent observes exit code 23 and a torn publish on disk
        os._exit(23)
    elif sp.kind == "io_error":
        raise OSError(f"injected transient IO error ({ENV_VAR})")
    elif sp.kind == "reader_err":
        raise RuntimeError(f"injected reader exception ({ENV_VAR})")
    elif sp.kind == "nan_grad":
        return "nan"
    elif sp.kind == "slot_death":
        # the serving engine evicts one live request and reclaims its
        # slot + KV blocks (engine._kill_one_slot)
        return "slot_death"
    return None

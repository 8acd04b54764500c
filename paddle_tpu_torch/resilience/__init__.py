"""Resilience of the port — failure as a tested code path.  The port's
counterpart of ``paddle_tpu.resilience``; so far it holds only
``faults`` (``PADDLE_TPU_FAULT`` injection), which the serving engine's
``slot_death`` point uses.  The checkpoint sidecar, retry and watchdog
are still to port."""

from . import faults

__all__ = ["faults"]

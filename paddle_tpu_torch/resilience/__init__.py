"""Resilience of the port — failure as a tested code path; the port's
counterpart of ``paddle_tpu.resilience``:

* ``checkpoint`` — the schema-versioned train-state sidecar (RNG state,
  reader cursor, pass/step counters) that upgrades the persistables
  snapshot to a FULL-state checkpoint, plus latest-valid discovery and
  retention;
* ``faults``     — ``PADDLE_TPU_FAULT=kind:n`` injection points
  (SIGKILL mid-pass, crash mid-publish, transient IO error, reader
  exception, NaN gradient, a serving slot's death);
* ``retry``      — jittered-exponential-backoff for transient IO;
* ``watchdog``   — step-deadline supervision (trips are metrics + trace
  instants, not silent hangs).

``Trainer.train(..., checkpoint_every_n_steps=N, resume=True)`` is the
consumer: kill-and-resume reproduces the uninterrupted loss trajectory
bit-exactly.  ``selftest.py`` is the kill-and-resume gate
(``python -m paddle_tpu_torch --resilience-selftest``): SIGKILL mid-pass,
a bit-exact resume, and a checkpoint torn between its renames.
"""

from . import checkpoint, faults, retry, watchdog
from .checkpoint import (latest_checkpoint, load_train_state,
                         prune_checkpoints, save_train_state, step_dir)
from .retry import Backoff, RetryError, retry_call
from .watchdog import Watchdog

__all__ = [
    "checkpoint", "faults", "retry", "watchdog",
    "latest_checkpoint", "load_train_state", "prune_checkpoints",
    "save_train_state", "step_dir",
    "Backoff", "RetryError", "retry_call", "Watchdog",
]

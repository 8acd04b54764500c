"""MetricsReporter — a Trainer event handler that turns the step stream
into telemetry: registry metrics, periodic one-line summaries, and JSONL
records (`runlog.RunLog`).  The port's counterpart of
``paddle_tpu/observability/reporter.py``.

    reporter = MetricsReporter(log_every_n=10, jsonl_path="run.jsonl")
    trainer.train(reader, event_handler=reporter)
    reporter.close()

Composes with a user handler via ``chain``:

    trainer.train(reader, event_handler=reporter.chain(my_handler))

Events are duck-typed by class name (BeginPass/EndPass/BeginIteration/
EndIteration) so this module never imports the trainer.

The JSONL ``step`` record has the reference's keys, so one reader parses
rows of either package.  The collective accounting comes from a mesh
step's collective log (``Executor.last_step_cost``; null off a mesh);
the lint counts, the per-op attribution summary (``attr_*``, with
``attr_model_err_pct`` from ``attribution.reconcile`` against the step's
measured wall), the cost model's status and what the kernel ops ran come
from the Executor's fold-in (``core/executor.py: _fold_in``; null under
its kill switches).  The compiled executable's memory analysis
(``compiled_hbm_high_water_bytes``, ``compiled_temp_bytes``) has no
counterpart in an eager step and is written as null.  The ``run_meta``
record carries the bench stamp (``bench_history.run_stamp``:
``schema_version``, ``run_id``, ``git_sha``) the corpus joins on.
"""

import collections
import math
import sys
import time

from . import hardware as _hardware
from . import metrics as _metrics
from .runlog import RunLog

__all__ = ["MetricsReporter"]

# the collective accounting a mesh step's cost carries (null off a mesh)
_COMM_KEYS = ("collective_count", "collective_bytes", "reduce_ops_in_loop",
              "comm_plan")
# the fold-in's keys, as the step cost carries them
_FOLD_KEYS = ("lint_findings", "lint_errors", "lint_checks", "costmodel",
              "kernel_backends", "kernel_families")
# step-record keys of the reference that an eager step has no figure for
_NOT_MEASURED = ("compiled_hbm_high_water_bytes", "compiled_temp_bytes")


class MetricsReporter:
    """Event handler emitting per-step telemetry.

    * registry: ``trainer.steps`` counter, ``trainer.step_seconds`` /
      ``trainer.throughput`` histograms, ``trainer.mfu`` gauge, plus the
      device-memory gauges from ``hardware.sample_memory``;
    * a one-line summary every ``log_every_n`` steps (0 disables);
    * one JSONL ``step`` record per iteration and a ``pass`` record per
      pass when ``jsonl_path`` is given — step records carry wall_time,
      throughput, compile_count, flops and MFU.
    """

    def __init__(self, log_every_n=10, jsonl_path=None, registry=None,
                 sample_memory_every_n=10, print_fn=None, run_meta=None):
        self.log_every_n = int(log_every_n)
        self.sample_memory_every_n = max(1, int(sample_memory_every_n))
        self.registry = registry or _metrics.get_registry()
        self.runlog = RunLog(jsonl_path) if jsonl_path else None
        self._print = print_fn or (lambda s: print(s, file=sys.stderr))
        self._steps_total = 0
        self._pass_t0 = None
        self._pass_samples = 0
        self._last_mem = {}
        # training-dynamics window: recent losses for the spike z-score
        self._loss_window = collections.deque(maxlen=64)
        if self.runlog is not None:
            # the run identity stamp rides the run_meta record so the
            # measurement corpus (observability/corpus.py) can dedup and
            # attribute this file's step rows; caller meta wins on clash
            from .bench_history import run_stamp

            self.runlog.log("run_meta", **{**run_stamp(),
                                           **(run_meta or {})})

    # -- composition -------------------------------------------------------
    def chain(self, handler):
        """Wrap a user event handler: telemetry first, then the user's."""

        def both(event):
            self(event)
            handler(event)

        return both

    # -- event dispatch ----------------------------------------------------
    def __call__(self, event):
        name = type(event).__name__
        if name == "EndIteration":
            self._end_iteration(event)
        elif name == "BeginPass":
            self._pass_t0 = time.perf_counter()
            self._pass_samples = 0
        elif name == "EndPass":
            self._end_pass(event)

    def _end_iteration(self, ev):
        reg = self.registry
        reg.counter("trainer.steps").inc()
        self._steps_total += 1
        wall = getattr(ev, "wall_time", None)
        throughput = getattr(ev, "throughput", None)
        mfu_v = getattr(ev, "mfu", None)
        samples = getattr(ev, "samples", None)
        if wall:
            reg.histogram("trainer.step_seconds").observe(wall)
        if throughput:
            reg.histogram("trainer.throughput").observe(throughput)
        if mfu_v is not None:
            reg.gauge("trainer.mfu").set(mfu_v)
        if samples:
            self._pass_samples += samples
        if self._steps_total % self.sample_memory_every_n == 0 or \
                self._steps_total == 1:
            self._last_mem = _hardware.sample_memory(reg)

        # training dynamics: loss-spike z-score over the recent-loss
        # window (mean/std of the PREVIOUS window, so a spike judges
        # against history, not against itself) + the step's grad norm
        loss_z = self._loss_zscore(ev.cost)
        grad_norm = getattr(ev, "grad_norm", None)
        if loss_z is not None:
            reg.gauge("trainer.loss_zscore",
                      help="z-score of this step's loss vs the recent "
                           "window (spike detector)").set(loss_z)

        # the Executor reports its compile/cache counters to the GLOBAL
        # registry regardless of which registry this reporter writes to
        compile_count = int(
            _metrics.get_registry().value("executor.compile_count"))
        if self.runlog is not None:
            sc = getattr(ev, "step_cost", None) or {}
            att = sc.get("attribution") or {}
            # the roofline estimate's error against this step's measured
            # wall: one formula (attribution.reconcile) for the JSONL and
            # the corpus
            from . import attribution as _attr

            rec = _attr.reconcile(att, wall) if att else None
            self.runlog.log(
                "step",
                pass_id=ev.pass_id, batch_id=ev.batch_id,
                step=self._steps_total, cost=ev.cost,
                wall_time=wall, throughput=throughput, samples=samples,
                mfu=mfu_v,
                reader_wait=getattr(ev, "reader_wait", None),
                compile_count=compile_count,
                cache_hit=sc.get("cache_hit"),
                compile_seconds=sc.get("compile_seconds"),
                flops=sc.get("flops"),
                bytes_accessed=sc.get("bytes_accessed"),
                hbm_high_water_bytes=self._last_mem.get("high_water"),
                # resilience spine: checkpoint overhead + resume lineage,
                # None until the first save/resume of the process
                checkpoint_save_ms=self._resil_value(
                    "checkpoint.last_save_ms"),
                checkpoint_bytes=self._resil_value(
                    "checkpoint.last_bytes"),
                checkpoint_saves=self._resil_value("checkpoint.saves"),
                resume_count=self._resil_value("executor.resume_count"),
                # training dynamics: global grad norm + loss-spike
                # z-score — the flight recorder's NaN window reads the
                # same stream
                grad_norm=grad_norm,
                loss_zscore=loss_z,
                **{k: sc.get(k) for k in _COMM_KEYS + _FOLD_KEYS},
                # the per-op attribution summary of the step: top classes
                # by estimated time, the estimate, coverage against
                # step_flops, the workload key, the estimate's error, and
                # the compact per-class [flops, bytes, ops, est_ms] table
                # a corpus row fits on
                attr_top=att.get("top"),
                attr_est_ms=att.get("est_ms_total"),
                attr_coverage=att.get("coverage"),
                attr_workload=att.get("workload"),
                attr_model_err_pct=rec["err_pct"] if rec else None,
                attr_classes=att.get("classes"),
                **dict.fromkeys(_NOT_MEASURED),
            )
        if self.log_every_n and ev.batch_id % self.log_every_n == 0:
            self._print(self._summary_line(ev, wall, throughput, mfu_v,
                                           compile_count))

    def _loss_zscore(self, cost):
        """z-score of this step's loss against the PREVIOUS window's
        mean/std (so a spike is judged against history); None until the
        window holds 8 samples or while the std is ~0.  NaN losses skip
        the window (they would poison the statistics the next real
        steps are judged by)."""
        try:
            c = float(cost)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(c):
            return None
        z = None
        n = len(self._loss_window)
        if n >= 8:
            mean = sum(self._loss_window) / n
            var = sum((x - mean) ** 2 for x in self._loss_window) / n
            std = math.sqrt(var)
            if std > 1e-12:
                z = round((c - mean) / std, 4)
        self._loss_window.append(c)
        return z

    @staticmethod
    def _resil_value(name):
        """A checkpoint/resume metric from the GLOBAL registry (io and
        the trainer report there), or None before its first update."""
        m = _metrics.get_registry().get(name)
        return None if m is None else getattr(m, "value", None)

    def _summary_line(self, ev, wall, throughput, mfu_v, compile_count):
        parts = [f"[pass {ev.pass_id} batch {ev.batch_id}]",
                 f"cost={float(ev.cost):.6f}"]
        if wall:
            parts.append(f"{wall * 1e3:.1f} ms/step")
        if throughput:
            parts.append(f"{throughput:.1f} samples/s")
        if mfu_v is not None:
            parts.append(f"mfu={mfu_v * 100:.1f}%")
        parts.append(f"compiles={compile_count}")
        hw = self._last_mem.get("high_water")
        if hw:
            parts.append(f"hbm_hw={hw / (1 << 30):.2f}GiB")
        return " ".join(parts)

    def _end_pass(self, ev):
        dt = (time.perf_counter() - self._pass_t0
              if self._pass_t0 is not None else None)
        if self.runlog is not None:
            self.runlog.log(
                "pass", pass_id=ev.pass_id, wall_time=dt,
                samples=self._pass_samples,
                throughput=(self._pass_samples / dt
                            if dt and self._pass_samples else None),
                compile_count=int(
                    self.registry.value("executor.compile_count")),
            )
            self.runlog.flush()
        if self.log_every_n:
            line = f"[pass {ev.pass_id}] done"
            if dt:
                line += f" in {dt:.2f}s"
                if self._pass_samples:
                    line += f" ({self._pass_samples / dt:.1f} samples/s)"
            self._print(line)

    def close(self):
        if self.runlog is not None:
            self.runlog.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

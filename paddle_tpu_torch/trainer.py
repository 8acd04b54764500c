"""v2-style training driver with events — the port's counterpart of
``paddle_tpu/trainer.py``.

Reference: python/paddle/v2/trainer.py:37 SGD (train:137 — pass loop,
batch loop, event_handler callbacks) + python/paddle/v2/event.py and the
C++ pass driver paddle/trainer/Trainer.cpp:265/496.  The event-handler
pattern is preserved exactly; the body of a step is one ``Executor.run``
(``run_steps`` for a fused group).

On the card, ``Trainer(place=None)`` runs there and raises where there
is none; the CPU is ``CPUPlace()``.  ``mesh=`` (``parallel.make_mesh``)
trains this process as one rank of the mesh (``Executor(place,
mesh=...)``, ``parallel/spmd.py``): each rank reads the same batches and
steps on its rows of them (``prefetch`` lands only those rows), events
carry the global batch's loss, and checkpoints are sharded (``io``;
synchronous: ``async_checkpoint`` raises on a mesh).

Bit-exact resume needs bit-exact steps.  Two sums on the GPT path are
atomics in a run-dependent order on the card: the fused flash
backward's ``dq`` and the embedding tables' gradients (PyTorch's
accumulating ``index_put_``, the backward of ``lookup_table``'s
gather).  Under ``torch.use_deterministic_algorithms(True)`` the flash
op takes the split backward route instead (``kernels/flash_attention.
py``) and PyTorch sorts the embedding gradient's indices, and a resumed
run then repeats the uninterrupted one bit for bit on the card as on
the CPU.  ``train`` warns when it checkpoints steps or resumes on the
card with those algorithms off.
"""

import math
import time
import warnings

import numpy as np
import torch

from . import io as _io
from . import profiler as _profiler
from .core.executor import Executor, draws_random
from .core.program import default_main_program, default_startup_program
from .core.scope import GRAD_NORM_VAR, RNG_VAR, global_scope, tensor_to_numpy
from .data_feeder import DataFeeder
from .observability import flight as _flight
from .observability import hardware as _hardware
from .observability import metrics as _obs
from .observability import trace as _trace
from .resilience import checkpoint as _resil_ckpt
from .resilience import faults as _faults

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "Trainer", "SGD"]


def _warn_if_not_bitwise(device):
    """Warn (once per call site, Python's default filter) that a resume
    on the card is not bit-exact while torch's deterministic algorithms
    are off: the fused flash backward's dq and the embedding gradients
    are sums of atomics in an order that changes from run to run."""
    if device.type == "cuda" and \
            not torch.are_deterministic_algorithms_enabled():
        warnings.warn(
            "step checkpoints or resume on the card without "
            "torch.use_deterministic_algorithms(True): the atomic sums "
            "of the fused flash backward's dq and of the embedding "
            "gradients make a resumed run differ from the uninterrupted "
            "one in a few bits; turn them on for a bit-exact resume",
            RuntimeWarning, stacklevel=3)


# -- events (reference: python/paddle/v2/event.py) --------------------------
class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass:
    def __init__(self, pass_id, evaluator_results=None):
        self.pass_id = pass_id
        self.evaluator_results = evaluator_results


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration:
    """End-of-batch event.  Beyond the v2 fields (cost, metrics) it
    carries the step telemetry the observability layer reports:

    * ``wall_time``   — host-observed seconds for this batch (feed
      conversion + device step + fetch materialization);
    * ``samples``     — batch size (leading dim of the first feed);
    * ``throughput``  — samples / wall_time;
    * ``mfu``         — achieved model-FLOPs utilization: the Executor's
      FLOP count of the step (``core.executor.step_flops``) over the
      card's peak (None for a card ``observability.hardware`` does not
      name);
    * ``reader_wait`` — seconds this step stalled waiting on the input
      pipeline (prefetch queue empty);
    * ``step_cost``   — the Executor's ``last_step_cost`` dict
      (compile_seconds, flops, bytes_accessed, cache_hit);
    * ``grad_norm``   — the step's global gradient norm (the Executor's
      ``@GRAD_NORM@`` scope entry; None for programs without a
      backward).
    """

    def __init__(self, pass_id, batch_id, cost, metrics, wall_time=None,
                 samples=None, throughput=None, mfu=None, reader_wait=None,
                 step_cost=None, grad_norm=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics
        self.wall_time = wall_time
        self.samples = samples
        self.throughput = throughput
        self.mfu = mfu
        self.reader_wait = reader_wait
        self.step_cost = step_cost
        self.grad_norm = grad_norm


class Trainer:
    """Drive a built program: pass/batch loops, events, checkpointing.

    cost: the loss Variable (the program must already contain optimize ops —
    build with optimizer.minimize(cost) before constructing the Trainer).
    """

    def __init__(self, cost, feed_list, place=None, extra_fetch=None,
                 main_program=None, startup_program=None, mesh=None):
        self.mesh = mesh
        self.cost = cost
        self.feed_list = feed_list
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.exe = Executor(place, mesh=mesh)
        self.feeder = DataFeeder(feed_list, place)
        self.extra_fetch = extra_fetch or []
        self._initialized = False
        self._peak_flops_cache = None
        self._global_step = 0  # record_function step number across passes
        self._last_ckpt_step = 0  # last global step a step-checkpoint saved
        self.last_resume = None   # train-state dict of the last resume
        self._nan_dumped = False  # one nan-trip flight bundle per trainer

    def init_params(self):
        self.exe.run(self.startup_program)
        self._initialized = True

    def train(self, reader, num_passes=1, event_handler=None,
              checkpoint_dir=None, checkpoint_every_n_passes=1,
              async_checkpoint=False, prefetch=0, steps_per_call=1,
              fused_group=8, probe_samples=6, trace_dir=None,
              trace_start=1, trace_steps=2,
              checkpoint_every_n_steps=None, resume=False,
              keep_checkpoints=3, watchdog_deadline=None):
        """``async_checkpoint=True`` writes per-pass checkpoints from a
        background thread (io.AsyncCheckpointer): training pays the
        device->host copy, not serialization + disk IO.  Pending writes
        are drained before train() returns.

        ``prefetch=N`` converts and copies up to N batches to the card
        ahead on a producer thread (reader.prefetch_to_device, a side
        CUDA stream), so steps do not stall on the input pipe.

        ``steps_per_call=N`` runs N consecutive same-shape batches in ONE
        ``Executor.run_steps`` call — the same math as N separate steps
        (state threads through); events still fire once per batch with
        that batch's cost — BeginIteration before the group executes,
        EndIteration after, so a fused group interleaves as
        Begin..Begin End..End.  ``"auto"`` times ``probe_samples``
        single steps and ``probe_samples - 1`` fused groups of
        ``fused_group`` (the first of each is a lowering; compared by
        median) and keeps whichever is faster per batch.  Batches whose
        shapes differ run unfused; incompatible with ``prefetch``.

        Every step is traced: a ``torch.profiler.record_function``
        range (``train#<step>``) plus host spans (``trainer.step``
        containing feed_h2d / dispatch / device_sync / opt_boundary,
        with reader_wait just before it) into the global span tracer
        (``observability.trace``; ``PADDLE_TPU_TRACE=0`` disables).
        ``trace_dir=`` additionally captures a ``torch.profiler`` Chrome
        trace of the host and the card for THIS call's step window
        ``[trace_start, trace_start + trace_steps)``; it requires the
        unfused path (``steps_per_call != 1`` raises: a group is one
        call, with no per-step boundary to window on).

        Resilience: ``checkpoint_every_n_steps=N`` saves a FULL-state
        checkpoint (persistables + RNG state + reader cursor + pass/step
        counters, ``resilience.checkpoint`` schema) to
        ``checkpoint_dir/step_<global_step>`` every N completed steps,
        keeping the ``keep_checkpoints`` newest.  ``resume=True``
        discovers the latest loadable step checkpoint (skipping torn
        ones, honoring the crash-publish ``.old`` fallback), restores
        params + optimizer state + RNG + reader position, and continues
        such that the loss trajectory is BIT-EXACT against the
        uninterrupted run (on the card, under
        ``torch.use_deterministic_algorithms(True)``; see the module
        docstring).  ``watchdog_deadline=S`` supervises the step loop: a
        step that makes no progress for S seconds trips the
        ``resilience.watchdog_trips`` counter and a timeline instant."""
        if not self._initialized:
            self.init_params()
        event_handler = event_handler or (lambda e: None)
        fetch = [self.cost] + list(self.extra_fetch)
        if self.mesh is not None and async_checkpoint:
            raise NotImplementedError(
                "async_checkpoint on a mesh: sharded checkpoints are "
                "written synchronously (io.save_vars)")
        if steps_per_call != 1 and prefetch:
            raise ValueError("steps_per_call and prefetch are mutually "
                             "exclusive (prefetch already hides host time)")
        if steps_per_call != 1 and trace_dir:
            raise ValueError(
                "trace_dir requires steps_per_call=1: the fused path "
                "runs whole step groups as one call, so there is no "
                "per-step boundary to window the capture on (an empty "
                "trace directory would be the only symptom)")
        if resume and not checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        if checkpoint_every_n_steps and keep_checkpoints < 2:
            # fail HERE, not 100 steps in when the first prune runs
            raise ValueError(
                f"keep_checkpoints must be >= 2 (the async write queue "
                f"can hold the two newest saves in flight): "
                f"{keep_checkpoints}")
        if resume or checkpoint_every_n_steps:
            _warn_if_not_bitwise(self.exe.device)
        if steps_per_call != 1:
            return self._train_fused(reader, num_passes, event_handler,
                                     checkpoint_dir,
                                     checkpoint_every_n_passes,
                                     async_checkpoint, steps_per_call,
                                     fused_group, probe_samples,
                                     checkpoint_every_n_steps, resume,
                                     keep_checkpoints, watchdog_deadline)
        if prefetch:
            from .reader import prefetch_to_device

            def batches():
                return iter(prefetch_to_device(
                    reader, prefetch, self.feeder.feed,
                    device=self.exe.device,
                    sharding=(self.exe.feed_slicer(self.main_program)
                              if self.mesh is not None else None))())
        else:
            # keep feeder.feed inside the per-batch timer: raw batches
            # here, converted in the loop below
            def batches():
                return (b for b in reader())
        ckpt = _io.AsyncCheckpointer() if (
            checkpoint_dir and async_checkpoint) else None
        reg = _obs.get_registry()
        tracer = _trace.get_tracer()
        start_pass, resume_skip, reader_skips = self._maybe_resume(
            resume, checkpoint_dir, reader, num_passes)
        wd = self._make_watchdog(watchdog_deadline)
        capture = None
        capture_done = False
        call_step = 0  # THIS call's step count: the trace_dir window is
        #                per-call (self._global_step keeps counting across
        #                train() calls)
        try:
            for pass_id in range(start_pass, num_passes):
                event_handler(BeginPass(pass_id))
                it = iter(batches())
                batch_id = 0
                if pass_id == start_pass and resume_skip:
                    # fast-forward the resumed pass to the checkpoint's
                    # reader cursor: a resumable reader already skips
                    # inside its own iteration; anything else is drained
                    # here (drawn and discarded — no training compute)
                    if not reader_skips:
                        for _ in range(resume_skip):
                            try:
                                next(it)
                            except StopIteration:
                                break
                    batch_id = resume_skip
                while True:
                    # reader/feed stall: time spent waiting for the input
                    # pipeline to produce the next batch — ~0 with
                    # prefetch unless the producer cannot keep up
                    t_wait = time.perf_counter()
                    _faults.maybe_fault("reader.next")
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    t_have = time.perf_counter()
                    reader_wait = t_have - t_wait
                    tracer.add_span("trainer.reader_wait", t_wait, t_have,
                                    cat="trainer", pass_id=pass_id,
                                    batch=batch_id)
                    reg.gauge("trainer.reader_wait_seconds").set(reader_wait)
                    reg.counter("trainer.reader_wait_seconds_total").inc(
                        reader_wait)
                    event_handler(BeginIteration(pass_id, batch_id))
                    fault_action = _faults.maybe_fault("trainer.step")
                    step_num = self._global_step
                    self._global_step += 1
                    if trace_dir and capture is None and not capture_done \
                            and call_step >= trace_start:
                        capture = _profiler.start_trace(trace_dir)
                    t0 = time.perf_counter()
                    with torch.profiler.record_function(
                            f"train#{step_num}"), \
                            tracer.span("trainer.step", cat="trainer",
                                        timer=False, pass_id=pass_id,
                                        batch=batch_id, step=step_num):
                        # the step span is timeline-only (timer=False):
                        # its window is exactly the sum of the phase
                        # spans below, which carry the host_timer.*
                        # aggregation.  The sync stays a phase of its
                        # own — dispatch alone returns before the card
                        # finishes.
                        with tracer.span("trainer.feed_h2d",
                                         cat="trainer",
                                         prefetched=bool(prefetch)):
                            feed = (item if prefetch
                                    else self.feeder.feed(item))
                        t_feed = time.perf_counter()
                        # dispatch: lowering-or-cache-hit + the eager
                        # step's launches (asynchronous on the card)
                        with tracer.span("trainer.dispatch",
                                         cat="trainer"):
                            vals = self.exe.run(
                                self.main_program,
                                feed=feed,
                                fetch_list=fetch,
                                return_numpy=False,
                            )
                        t_disp = time.perf_counter()
                        # device_sync: the host materializing the
                        # fetches — on the card, the sync
                        with tracer.span("trainer.device_sync",
                                         cat="trainer"):
                            vals = [tensor_to_numpy(v) for v in vals]
                        t_sync = time.perf_counter()
                        cost = float(vals[0].reshape(-1)[0])
                        if fault_action == "nan":
                            cost = float("nan")  # injected bad gradient
                        wall = time.perf_counter() - t0
                        # opt_boundary: host-side step-boundary work —
                        # telemetry + event fan-out
                        with tracer.span("trainer.opt_boundary",
                                         cat="trainer"):
                            metrics = vals[1:]
                            tele = self._step_telemetry(wall, feed)
                            event_handler(EndIteration(
                                pass_id, batch_id, cost, metrics,
                                reader_wait=reader_wait, **tele))
                    self._flight_step(
                        pass_id, batch_id, cost, reader_wait, tele,
                        phase_feed_h2d=t_feed - t0,
                        phase_dispatch=t_disp - t_feed,
                        phase_device_sync=t_sync - t_disp)
                    if wd is not None:
                        wd.beat()
                    self._step_checkpoint(
                        ckpt, checkpoint_dir, checkpoint_every_n_steps,
                        keep_checkpoints, pass_id, batch_id + 1,
                        num_passes,
                        reader_state_src=(
                            reader if not prefetch
                            and hasattr(reader, "state") else None))
                    call_step += 1
                    if capture is not None and \
                            call_step >= trace_start + trace_steps:
                        _profiler.stop_trace(capture)
                        capture = None
                        capture_done = True
                    batch_id += 1
                self._pass_checkpoint(pass_id, ckpt, checkpoint_dir,
                                      checkpoint_every_n_passes)
                event_handler(EndPass(pass_id))
        except Exception as e:
            # post-mortem: an exception escaping the train loop dumps
            # the flight bundle (classified oom / nan_trip /
            # trainer_exception) before propagating
            self._flight_crash(e)
            raise
        finally:
            if wd is not None:
                wd.stop()
            if capture is not None:
                _profiler.stop_trace(capture)
            elif trace_dir and not capture_done:
                # the capture window never opened — an empty trace
                # directory must not be the only symptom
                warnings.warn(
                    f"trace_dir={trace_dir!r}: no capture — this train() "
                    f"call ran {call_step} step(s), the window starts at "
                    f"step {trace_start}; lower trace_start or feed more "
                    f"batches", RuntimeWarning, stacklevel=2)
            if ckpt is not None:
                ckpt.close()

    def _peak_flops(self):
        """Peak FLOP/s of the device a step runs on (cached; None for a
        card the hardware table does not name)."""
        if self._peak_flops_cache is None:
            self._peak_flops_cache = (
                _hardware.device_peak_flops(self.exe.device) or 0.0)
        return self._peak_flops_cache

    def _step_telemetry(self, wall, feed, n_batches=1):
        """EndIteration telemetry kwargs for one batch: wall time,
        samples (leading feed dim), throughput, and the MFU of the
        Executor's FLOP count.  ``n_batches`` divides a fused run_steps
        group's wall/flops back to per-batch."""
        samples = None
        for v in feed.values():
            shape = getattr(v, "shape", None)
            if shape:
                samples = int(shape[0])
                break
        wall = wall / max(1, n_batches)
        out = {"wall_time": wall, "samples": samples,
               "throughput": (samples / wall if samples and wall > 0
                              else None),
               "step_cost": self.exe.last_step_cost, "mfu": None,
               "grad_norm": self._read_grad_norm()}
        sc = self.exe.last_step_cost or {}
        flops = sc.get("flops")
        if flops and sc.get("steps"):
            flops = flops / sc["steps"]  # a run_steps group's whole count
        out["mfu"] = _hardware.mfu(flops, wall, self._peak_flops())
        return out

    def _read_grad_norm(self):
        """The step's global grad norm from the scope's ``@GRAD_NORM@``
        entry (already materialized by the fetch sync).  Also sets the
        ``trainer.grad_norm`` gauge — the training-dynamics signal the
        flight recorder's NaN window is built from."""
        var = global_scope().find_var(GRAD_NORM_VAR)
        if var is None:
            return None
        gn = float(var)
        _obs.get_registry().gauge(
            "trainer.grad_norm",
            help="global gradient norm of the last step").set(gn)
        return gn

    # -- flight recorder ---------------------------------------------------
    def _flight_step(self, pass_id, batch_id, cost, reader_wait, tele,
                     **phases):
        """One step record into the bounded flight ring: loss, grad
        norm, phase durations and the memory high-water — the
        post-mortem context a crash bundle ships.  A NaN step cost
        (incl. the ``nan_grad`` injected fault) additionally dumps the
        bundle, once per trainer."""
        _flight.record_step(
            pass_id=pass_id, batch=batch_id, step=self._global_step,
            loss=cost, wall_time=tele.get("wall_time"),
            reader_wait=reader_wait, grad_norm=tele.get("grad_norm"),
            mfu=tele.get("mfu"),
            hbm_high_water_bytes=(
                _obs.get_registry().value("device.hbm_high_water_bytes")
                or None),
            **phases)
        if isinstance(cost, float) and math.isnan(cost) \
                and not self._nan_dumped:
            self._nan_dumped = True
            _obs.get_registry().counter(
                "trainer.nan_costs",
                help="steps whose fetched loss was NaN").inc()
            _flight.dump("nan_trip", loss=cost, pass_id=pass_id,
                         batch=batch_id, step=self._global_step)

    def _flight_crash(self, e):
        """Dump the flight bundle for an exception escaping the train
        loop — unless the nan guard already dumped for this abort (the
        executor marks its FloatingPointError)."""
        if getattr(e, "_pt_nan_counted", False):
            return
        _flight.dump(_flight.classify_exception(e),
                     error=f"{type(e).__name__}: {e}"[:300],
                     step=self._global_step)

    def _train_fused(self, reader, num_passes, event_handler, checkpoint_dir,
                     checkpoint_every_n_passes, async_checkpoint,
                     steps_per_call, fused_group=8, probe_samples=6,
                     checkpoint_every_n_steps=None, resume=False,
                     keep_checkpoints=3, watchdog_deadline=None):
        """The steps_per_call train loop: group same-shape converted
        batches, stack them [steps, ...], one run_steps per group, unpack
        stacked fetches back to per-batch events.  Step checkpoints fire
        at group boundaries (a crossed ``checkpoint_every_n_steps``
        multiple saves once the group lands); resume fast-forwards the
        resumed pass's batches before grouping restarts."""
        fetch = [self.cost] + list(self.extra_fetch)
        auto = steps_per_call == "auto"
        group_n = 1 if auto else int(steps_per_call)
        if not auto and group_n < 1:
            raise ValueError(f"steps_per_call must be >= 1: {group_n}")
        fused_group = int(fused_group)
        if auto and fused_group < 2:
            raise ValueError(
                f"fused_group must be >= 2 (a group of 1 is the unfused "
                f"schedule): {fused_group}")
        probe_samples = max(3, int(probe_samples))
        ckpt = _io.AsyncCheckpointer() if (
            checkpoint_dir and async_checkpoint) else None
        start_pass, resume_skip, reader_skips = self._maybe_resume(
            resume, checkpoint_dir, reader, num_passes)
        wd = self._make_watchdog(watchdog_deadline)
        # auto-probe state, shared across passes: single-step timings,
        # fused-group per-batch timings (first of each is a lowering)
        single_t, fused_t = [], []
        try:
            for pass_id in range(start_pass, num_passes):
                event_handler(BeginPass(pass_id))
                batch_id = resume_skip if pass_id == start_pass else 0
                skip = (resume_skip
                        if pass_id == start_pass and not reader_skips
                        else 0)
                pending = []  # [(feed_dict, signature)]

                def emit_end(batch_id, row, telemetry=None, poison=False):
                    cost = float(np.asarray(row[0]).reshape(-1)[0])
                    if poison:  # injected nan_grad fault for this batch
                        cost = float("nan")
                    metrics = [np.asarray(v) for v in row[1:]]
                    event_handler(EndIteration(pass_id, batch_id, cost,
                                               metrics, **(telemetry or {})))
                    self._flight_step(pass_id, batch_id, cost, None,
                                      telemetry or {})

                def flush(pending, batch_id):
                    nonlocal group_n, auto
                    while pending:
                        sig = pending[0][1]
                        run = []
                        for f, s in pending:
                            if s != sig:
                                break
                            run.append(f)
                        # Begin fires BEFORE execution for every batch of
                        # the group (a fused group interleaves as
                        # Begin..Begin End..End — execution is one call)
                        fault_actions = []
                        for k in range(len(run)):
                            fault_actions.append(
                                _faults.maybe_fault("trainer.step"))
                            event_handler(BeginIteration(pass_id,
                                                         batch_id + k))
                        t0 = time.perf_counter()
                        # fused groups trace as ONE step span (the group
                        # is one call; per-phase spans live on the
                        # unfused path).  timeline-only: the train_batch
                        # timer below covers the same window
                        group_span = _trace.get_tracer().span(
                            "trainer.step", cat="trainer", timer=False,
                            pass_id=pass_id, batch=batch_id,
                            fused=len(run))
                        if len(run) == 1:  # odd-shaped straggler: plain step
                            with group_span, _profiler.timer("train_batch"):
                                vals = self.exe.run(
                                    self.main_program, feed=run[0],
                                    fetch_list=fetch)
                            rows = [vals]
                        else:
                            stacked = {
                                k: np.stack([f[k] for f in run])
                                for k in run[0]
                            }
                            with group_span, _profiler.timer("train_batch"):
                                vals = self.exe.run_steps(
                                    self.main_program, feed=stacked,
                                    fetch_list=fetch, steps=len(run))
                            rows = [[np.asarray(v)[i] for v in vals]
                                    for i in range(len(run))]
                            if auto:
                                fused_t.append(
                                    (time.perf_counter() - t0) / len(run))
                                if len(fused_t) >= probe_samples - 1:
                                    # compare post-lowering MEDIANS (a
                                    # single sample decides nothing):
                                    # keep the faster schedule
                                    if float(np.median(fused_t[1:])) < \
                                            float(np.median(single_t[1:])):
                                        group_n = fused_group
                                    else:
                                        group_n = 1
                                    auto = False
                        del pending[: len(run)]
                        telemetry = self._step_telemetry(
                            time.perf_counter() - t0, run[0],
                            n_batches=len(run))
                        for k, row in enumerate(rows):
                            emit_end(batch_id, row, telemetry,
                                     poison=fault_actions[k] == "nan")
                            batch_id += 1
                        self._global_step += len(run)
                        if wd is not None:
                            wd.beat()
                        self._step_checkpoint(ckpt, checkpoint_dir,
                                              checkpoint_every_n_steps,
                                              keep_checkpoints, pass_id,
                                              batch_id, num_passes)
                    return batch_id

                for item in reader():
                    _faults.maybe_fault("reader.next")
                    if skip:
                        skip -= 1  # resumed pass: already-trained batch
                        continue
                    feed = self.feeder.feed(item)
                    if auto and len(single_t) < probe_samples:
                        # probe phase 1: single steps (first is a lowering)
                        fault_action = _faults.maybe_fault("trainer.step")
                        event_handler(BeginIteration(pass_id, batch_id))
                        t0 = time.perf_counter()
                        vals = self.exe.run(self.main_program, feed=feed,
                                            fetch_list=fetch)
                        single_t.append(time.perf_counter() - t0)
                        emit_end(batch_id, vals,
                                 self._step_telemetry(single_t[-1], feed),
                                 poison=fault_action == "nan")
                        batch_id += 1
                        self._global_step += 1
                        if wd is not None:
                            wd.beat()
                        self._step_checkpoint(ckpt, checkpoint_dir,
                                              checkpoint_every_n_steps,
                                              keep_checkpoints, pass_id,
                                              batch_id, num_passes)
                        if len(single_t) >= probe_samples:
                            # probe phase 2: fused groups
                            group_n = fused_group
                        continue
                    sig = tuple(sorted(
                        (k, v.shape, str(getattr(v, "dtype", "")))
                        for k, v in feed.items()))
                    pending.append((feed, sig))
                    if len(pending) >= group_n:
                        batch_id = flush(pending, batch_id)
                batch_id = flush(pending, batch_id)
                self._pass_checkpoint(pass_id, ckpt, checkpoint_dir,
                                      checkpoint_every_n_passes)
                event_handler(EndPass(pass_id))
        except Exception as e:
            self._flight_crash(e)  # same post-mortem as the unfused loop
            raise
        finally:
            if wd is not None:
                wd.stop()
            if ckpt is not None:
                ckpt.close()

    def _pass_checkpoint(self, pass_id, ckpt, checkpoint_dir, every):
        if checkpoint_dir and (pass_id + 1) % every == 0:
            path = f"{checkpoint_dir}/pass_{pass_id}"
            if ckpt is not None:
                ckpt.save(path, self.main_program)
            else:
                _io.save_persistables(self.exe, path, self.main_program)

    # -- resilience ----------------------------------------------------------
    def _make_watchdog(self, deadline):
        if not deadline:
            return None
        from .resilience.watchdog import Watchdog

        return Watchdog(deadline, label="trainer.step")

    def _maybe_resume(self, resume, checkpoint_dir, reader, num_passes):
        """Restore the latest full-state checkpoint.  Returns
        ``(start_pass, resume_skip, reader_skips)``: the pass to resume
        in, how many of its batches are already done, and whether the
        reader fast-forwards itself (``ResumableReader.set_state``) or
        the caller must drain them from the iterator."""
        if not resume:
            return 0, 0, False
        path = _resil_ckpt.latest_checkpoint(checkpoint_dir)
        if path is None:
            return 0, 0, False  # cold start: nothing to resume from
        _io.load_persistables(self.exe, path, self.main_program)
        st = _resil_ckpt.load_train_state(path)
        rng = _resil_ckpt.rng_state_for(st, draws_random(self.main_program))
        if rng is not None:
            # the @RNG@ state AFTER the checkpointed step: restoring it
            # replays the exact per-step dropout draws
            global_scope().set(RNG_VAR, torch.from_numpy(rng.copy()))
        self._global_step = int(st.get("global_step", 0))
        self._last_ckpt_step = self._global_step
        start_pass = int(st.get("pass_id", 0))
        resume_skip = int(st.get("step_in_pass", 0))
        saved_passes = st.get("num_passes")
        if saved_passes is not None and int(saved_passes) != num_passes:
            warnings.warn(
                f"resuming a num_passes={saved_passes} run with "
                f"num_passes={num_passes}: pass accounting continues "
                f"from pass {start_pass}", RuntimeWarning, stacklevel=3)
        reader_skips = hasattr(reader, "set_state")
        if reader_skips:
            reader.set_state(st.get("reader_state")
                             or {"items": resume_skip})
        self.last_resume = dict(st, path=path)
        _obs.get_registry().counter(
            "executor.resume_count",
            help="trainer resumes from a full-state checkpoint").inc()
        _trace.get_tracer().instant(
            "resume", cat="resilience", path=path,
            step=self._global_step, pass_id=start_pass)
        return start_pass, resume_skip, reader_skips

    def _step_checkpoint(self, ckpt, checkpoint_dir, every_n, keep,
                         pass_id, batches_done, num_passes,
                         reader_state_src=None):
        """Full-state checkpoint at step granularity: fires when
        ``global_step`` crossed a multiple of ``every_n`` since the last
        save (a fused group can cross mid-group; the save lands at the
        group boundary).  ``reader_state_src``: a position-tracking
        reader (``reader.resumable``) whose ``state()`` snapshot replaces
        the plain item count; only passed where handed-out == trained
        (the unfused, non-prefetch loop: prefetch producers and fused
        pending queues run AHEAD of training)."""
        if not (checkpoint_dir and every_n):
            return
        if (self._global_step // every_n
                <= self._last_ckpt_step // every_n):
            return
        if reader_state_src is not None:
            reader_state = reader_state_src.state()
        else:
            reader_state = {"items": batches_done}
        rng = global_scope().find_var(RNG_VAR)
        state = {
            "global_step": self._global_step,
            "pass_id": pass_id,
            "step_in_pass": batches_done,
            "rng_key": None if rng is None else rng.numpy().copy(),
            "rng_kind": _resil_ckpt.RNG_KIND,
            "rng_seed": self.main_program.random_seed,
            "reader_state": reader_state,
            "num_passes": num_passes,
        }
        path = _resil_ckpt.step_dir(checkpoint_dir, self._global_step)
        if ckpt is not None:
            ckpt.save(path, self.main_program, extra_state=state)
        else:
            _io.save_checkpoint(self.exe, path, self.main_program,
                                train_state=state)
        self._last_ckpt_step = self._global_step
        # retention is safe against the async queue: with max_pending=2
        # only the two newest saves can be in flight, and prune keeps >= 2
        _resil_ckpt.prune_checkpoints(checkpoint_dir, keep=keep)

    def test(self, reader, test_program=None, fetch_list=None):
        """Average fetched values over a test reader (reference
        Tester.cpp / v2 SGD.test)."""
        program = test_program or self.main_program.clone(for_test=True)
        fetch = fetch_list or [self.cost]
        totals = None
        n = 0
        for batch in reader():
            vals = self.exe.run(
                program, feed=self.feeder.feed(batch), fetch_list=fetch
            )
            vals = [np.asarray(v, dtype=np.float64) for v in vals]
            totals = vals if totals is None else [t + v for t, v in zip(totals, vals)]
            n += 1
        if totals is None:
            return []
        return [t / n for t in totals]

    def save_checkpoint(self, dirname):
        _io.save_persistables(self.exe, dirname, self.main_program)

    def load_checkpoint(self, dirname):
        if not self._initialized:
            self.init_params()
        _io.load_persistables(self.exe, dirname, self.main_program)


# v2 API name
SGD = Trainer

"""Continuous-batching serving engine — slot-scheduled multi-request
decode over a PAGED, prefix-shared KV cache with SLO-aware goodput
scheduling.  The port's counterpart of ``paddle_tpu/serving/engine.py``.

* **Paged slot pool** — KV lives in a physical block pool
  (``serving.kvcache``) of fixed-size blocks, indexed per slot by a
  block table the decode step attends through; blocks are
  reference-counted and return to the pool the moment nothing uses
  them.
* **Prefix reuse** — identical prompt prefixes map through a trie to
  SHARED block chains; a divergence inside a cached block forks it
  copy-on-write.
* **Continuous batching** — queued requests are admitted into free slots
  BETWEEN decode chunks.
* **Bucketed prefill** — the non-cached prompt suffix pads to the
  nearest power-of-two multiple of ``min_bucket``.
* **Chunked decode** — ``decode_chunk`` greedy steps per call; EOS is
  detected on the host after the chunk.
* **SLO-aware scheduling** — least predicted-TTFT-slack admission and
  shedding of requests that provably cannot meet their e2e budget
  (``serving.scheduler``).

* **Speculative decoding** — with a draft model
  (``draft_params``), decode runs propose / verify / accept rounds
  (``serving.speculative``): the draft proposes ``spec_k`` tokens per
  slot into scratch block chains, one ``k + 1``-wide target verify
  scores them, greedy acceptance commits the agreeing prefix plus a
  bonus token, and rejected scratch blocks roll back to the pool.

Greedy decode through the engine matches running each request alone
through ``transformer.generate``, prefix reuse on or off, speculative or
not.  Telemetry flows through the port's observability registry under
the JAX engine's ``serving.*`` names; with tracing on (``observability.
trace``, ``PADDLE_TPU_TRACE``) the engine records ``serving.prefill``,
``serving.decode_chunk`` and ``serving.spec_round`` spans, a
``serving.shed`` instant, and one span tree per finished request on its
own timeline lane, exported to Chrome-trace by ``trace.save(path)``.
An abort dumps the flight recorder (``observability.flight``);
``PADDLE_TPU_FAULT=slot_death:n`` kills one request at the n-th decode
round (``resilience.faults``).

Attention runs through the paged-attention kernel, or, for step
callables built under ``PADDLE_TPU_PAGED_ATTN=0``, through the
``decode_gather`` kernel and a dense softmax; ``kernel_backends`` and
``serving.paged_attn_compiles`` record which spelling each callable was
built with.

What differs from the JAX engine: PyTorch runs eagerly, so there is no
ahead-of-time compile — the pools and slot state are updated in place
instead of donated, and the CUDA kernels build when the engine is
constructed (set-up, outside every timed window the TTFT predictor
reads).  Temperature sampling and the tune-cache lookups are not ported:
with no ``decode_chunk`` / ``min_bucket`` / ``spec_k`` given the engine
uses the JAX engine's tune-miss defaults, 4, 8 and
``speculative.DEFAULT_SPEC_K``.
"""

import collections
import threading
import time

import numpy as np
import torch

from ..core.place import resolve_device
from ..kernels import decode_gather as _dg
from ..kernels import paged_attention as _pa
from ..models.transformer import (as_torch_dtype, infer_compute_dtype,
                                  params_from_numpy)
from ..observability import flight as _flight
from ..observability import metrics as _obs
from ..observability import trace as _trace
from ..resilience import faults as _faults
from . import batched_decode as _bd
from . import kvcache as _kv
from . import scheduler as _sched
from . import speculative as _spec

__all__ = ["Request", "ServingEngine"]

DEFAULT_DECODE_CHUNK = 4
DEFAULT_MIN_BUCKET = 8


class Request:
    """One submitted generation request and its (eventual) result.

    ``tokens`` holds only GENERATED tokens (EOS included when hit);
    ``result()`` returns prompt + generated as one int32 array.  Handles
    are thread-safe: ``wait``/``result`` may be called from any thread
    while the engine runs in another.  If the engine aborts (a device
    error mid-serve), the handle completes with ``error`` set and
    ``result()`` re-raises it; a request the SLO scheduler sheds
    completes with ``shed`` True and a ``SheddedRequest`` error.
    """

    __slots__ = ("rid", "prompt", "max_new", "eos_id", "tokens",
                 "submit_t", "first_token_t", "finish_t", "error",
                 "admit_t", "prefill_t0", "prefill_t1", "bucket", "chunks",
                 "slo_ok", "ttft_slo_s", "e2e_slo_s", "shed", "sheddable",
                 "prefix_hit", "spec_proposed", "spec_accepted", "_done")

    def __init__(self, rid, prompt, max_new, eos_id,
                 ttft_slo_s=None, e2e_slo_s=None, sheddable=True):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.tokens = []
        self.submit_t = time.perf_counter()
        self.first_token_t = None
        self.finish_t = None
        self.error = None
        # span-tree timestamps (observability.trace): queue pop, prefill
        # window, prefill bucket, and the decode-chunk windows this
        # request was live for — its timeline lane is emitted at finish
        self.admit_t = None
        self.prefill_t0 = None
        self.prefill_t1 = None
        self.bucket = None
        self.chunks = []
        # SLO verdict at finish: True (met), False (violated/shed), or
        # None (no SLO budgets configured)
        self.slo_ok = None
        self.ttft_slo_s = ttft_slo_s
        self.e2e_slo_s = e2e_slo_s
        self.shed = False
        # False exempts the request from scheduler shedding (it is
        # still judged against its budgets at finish)
        self.sheddable = sheddable
        # prompt tokens whose prefill was skipped via the prefix trie
        self.prefix_hit = 0
        # speculative accounting (0 when the engine has no draft)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not finished")
        if self.error is not None:
            if isinstance(self.error, _sched.SheddedRequest):
                raise self.error
            raise RuntimeError(
                f"request {self.rid} failed: "
                f"{type(self.error).__name__}: {self.error}") \
                from self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def ttft(self):
        """Submit -> first generated token, seconds (None until then)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def e2e(self):
        """Submit -> finished, seconds (None until finished)."""
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t


class ServingEngine:
    """Slot-scheduled continuous-batching front-end over the paged
    batched decode step.

    params   name->array dict with the Program's parameter names (numpy
             arrays, e.g. ``paddle_tpu.models.transformer.
             extract_params()``, or tensors); EVERY entry is cast once to
             ``compute_dtype`` (default: the dtype the block/lm_head
             matmul weights imply), embeddings included.
    max_len  per-slot logical KV capacity; every request needs
             ``len(prompt) + max_new_tokens <= max_len``.
    max_slots     concurrent sequences in the batched step.
    decode_chunk  decode steps per call (default 4).
    min_bucket    smallest prefill bucket (default 8); prompt SUFFIXES
             pad to the nearest power-of-two multiple of it.
    block_tokens  tokens per physical KV block (also the prefix-sharing
             granularity).
    cache_blocks  prefix-cache budget: blocks the trie may keep alive
             beyond live requests.  Default ``2 * ceil(max_len /
             block_tokens)`` with reuse on.
    prefix_reuse  False disables the trie.
    scheduler  "slo" (default) or "fifo".
    eos_id   default EOS token id (per-request override in ``submit``).
    ttft_slo_s / e2e_slo_s   per-request latency budgets (seconds).
    draft_params  parameter dict of a small DRAFT model (identical vocab
             / d_model / head geometry, fewer layers — e.g.
             ``speculative.depth_draft``).  When given (and
             ``PADDLE_TPU_SPEC`` is not off), decode runs speculative
             rounds, token-exact against plain greedy decode.  Geometry
             mismatches raise at construction.
    draft_n_layer / draft_n_head  the draft's depth / head count
             (default: inferred depth / the target's ``n_head``; a
             differing head count is rejected — the draft shares the
             target's pool tensors).
    spec_k   draft tokens proposed per round (default
             ``speculative.DEFAULT_SPEC_K``).
    device   default the card (``cuda``); ``"cpu"`` must be asked for,
             and with no card and no request construction raises.

    Drive it synchronously (``generate_many`` / ``step`` + ``results``)
    or from a background thread (``start``/``stop``) with producers
    calling ``submit`` concurrently.
    """

    def __init__(self, params, n_layer, n_head, d_model, max_len=128,
                 max_slots=8, decode_chunk=None, min_bucket=None,
                 eos_id=None, compute_dtype=None, eps=1e-5,
                 ttft_slo_s=None, e2e_slo_s=None,
                 block_tokens=16, cache_blocks=None, prefix_reuse=True,
                 scheduler="slo", draft_params=None, draft_n_layer=None,
                 draft_n_head=None, spec_k=None, device=None):
        self.device = resolve_device(device)
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} % n_head {n_head} != 0")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1: {max_slots}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1: {block_tokens}")
        self.n_layer, self.n_head, self.d_model = n_layer, n_head, d_model
        self.max_len, self.max_slots = int(max_len), int(max_slots)
        self.eos_id = eos_id
        self._eps = eps
        if ttft_slo_s is not None and ttft_slo_s <= 0:
            raise ValueError(f"ttft_slo_s must be > 0: {ttft_slo_s}")
        if e2e_slo_s is not None and e2e_slo_s <= 0:
            raise ValueError(f"e2e_slo_s must be > 0: {e2e_slo_s}")
        self.ttft_slo_s = ttft_slo_s
        self.e2e_slo_s = e2e_slo_s
        self._good_tokens = 0       # tokens of SLO-met completions
        self._first_submit_t = None  # goodput window opens here
        if compute_dtype is None:
            compute_dtype = infer_compute_dtype(params)
        self.compute_dtype = as_torch_dtype(compute_dtype)
        if decode_chunk is None:
            decode_chunk = DEFAULT_DECODE_CHUNK
        if min_bucket is None:
            min_bucket = DEFAULT_MIN_BUCKET
        if decode_chunk < 1 or min_bucket < 1:
            raise ValueError("decode_chunk and min_bucket must be >= 1")
        self.decode_chunk = int(decode_chunk)
        self.min_bucket = int(min_bucket)
        table_len = params["pos_emb.w.w"].shape[0]
        if self.max_len > table_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the trained position-"
                f"embedding table ({table_len} positions)")
        self._p = params_from_numpy(params, self.device, self.compute_dtype)
        if self.device.type == "cuda":
            # the kernels' nvcc build is set-up: it lands here, never in
            # the first (timed) prefill the TTFT predictor reads
            _pa.build()
            _dg.build()

        # -- speculative decoding (serving.speculative): with a draft and
        # PADDLE_TPU_SPEC on, decode runs propose/verify/commit rounds.
        # Off (or no draft): none of this exists — no validation, no
        # extra pool blocks, no draft callables.
        spec_on = draft_params is not None and _spec.spec_enabled()
        if spec_on:
            draft_n_layer = _spec.validate_draft(
                params, draft_params, n_layer, n_head, d_model,
                self.max_len, draft_n_layer=draft_n_layer,
                draft_n_head=draft_n_head)
            if spec_k is None:
                spec_k = _spec.DEFAULT_SPEC_K
        self.spec_k = int(spec_k) if spec_on else None

        # -- paged KV state (kvcache.py): pool tensors + host accounting
        self.block_tokens = int(block_tokens)
        self.blocks_per_slot = -(-self.max_len // self.block_tokens)
        if cache_blocks is None:
            cache_blocks = 2 * self.blocks_per_slot if prefix_reuse else 0
        if cache_blocks < 0:
            raise ValueError(f"cache_blocks must be >= 0: {cache_blocks}")
        self.cache_blocks = int(cache_blocks)
        # trash block + every slot's worst-case chain + the cache budget:
        # admission can ALWAYS allocate a full chain once the trie evicts
        # its unreferenced tail (kvcache.py invariants).  Speculative mode
        # reserves a second worst-case chain per slot for the draft's
        # scratch blocks, so a propose round can never starve admission.
        num_blocks = (1 + self.max_slots * self.blocks_per_slot
                      + self.cache_blocks)
        if spec_on:
            num_blocks += self.max_slots * self.blocks_per_slot
        self.kv_pool = _kv.BlockPool(num_blocks, self.block_tokens)
        self.prefix_trie = (_kv.PrefixTrie(self.kv_pool, self.cache_blocks)
                            if prefix_reuse else None)
        self.prefix_reuse = bool(prefix_reuse)
        dh = d_model // n_head
        shape = (num_blocks, self.block_tokens, n_head, dh)
        self._pk = [torch.zeros(shape, dtype=self.compute_dtype,
                                device=self.device) for _ in range(n_layer)]
        self._pv = [torch.zeros(shape, dtype=self.compute_dtype,
                                device=self.device) for _ in range(n_layer)]
        self._last = torch.zeros(self.max_slots, dtype=torch.int32,
                                 device=self.device)
        self._pos = torch.zeros(self.max_slots, dtype=torch.int32,
                                device=self.device)
        # host-side block table: unused entries -> trash block 0
        self._table = np.zeros((self.max_slots, self.blocks_per_slot),
                               np.int32)
        self._slot_blocks = [None] * self.max_slots  # bids a slot holds

        self._slots = [None] * self.max_slots     # Request or None
        self._free = list(range(self.max_slots))  # LIFO free list
        self._queue = collections.deque()
        self._completed = collections.deque()
        self._qlock = threading.Lock()    # queue/completed/counters
        self._dlock = threading.RLock()   # the device state (one stepper)
        self._next_rid = 0
        self._prefill_fns = {}            # suffix bucket -> prefill step
        self._decode_fn = None
        # step-callable label -> {kernel: backend} of the attention
        # spelling it was built with (paged_attention, or decode_gather
        # under PADDLE_TPU_PAGED_ATTN=0)
        self.kernel_backends = {}
        self._thread = None
        self._stop = threading.Event()
        self._error = None                # fatal error: engine is dead
        self._inflight = 0                # popped, not yet slotted
        self._req_lane_ends = []          # trace lane i -> last finish_t
        # the SLO control loop: measured-latency predictor + scheduler
        self.predictor = _sched.TtftPredictor()
        self._sched = _sched.make_scheduler(scheduler, self.predictor,
                                            budgets=self)
        # prefix-hit accounting window (reset with the goodput window)
        self._hit_tokens = 0
        self._prompt_tokens = 0

        self._reg = _obs.get_registry()
        self._reg.gauge("serving.slots_total").set(self.max_slots)
        self._reg.gauge("serving.slots_active").set(0)
        self._reg.gauge("serving.queue_depth").set(0)
        self._reg.gauge(
            "serving.kv_blocks_total",
            help="physical KV blocks in the paged pool (excl. trash)",
        ).set(num_blocks - 1)
        self._reg.gauge("serving.blocks_in_use").set(0)
        self._spec = (_spec.SpecState(self, draft_params, draft_n_layer,
                                      spec_k) if spec_on else None)

    @property
    def _tracer(self):
        # resolved per call, so a tracer installed with trace.set_tracer()
        # after the engine exists still receives the spans
        return _trace.get_tracer()

    # -- request intake ---------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None,
               ttft_slo_s=None, e2e_slo_s=None, sheddable=True):
        """Queue one request; returns its ``Request`` handle.  Thread-safe.
        Per-request ``ttft_slo_s``/``e2e_slo_s`` budgets override the
        engine defaults; ``sheddable=False`` exempts the request from
        scheduler shedding."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p_len = prompt.shape[0]
        if p_len < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1: {max_new}")
        if p_len + max_new > self.max_len:
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens ({max_new}) exceeds "
                f"the slot KV capacity max_len={self.max_len}")
        t = self._thread
        if t is not None and not t.is_alive() and not self._stop.is_set():
            raise RuntimeError(
                "serving thread is dead") from self._error
        with self._qlock:
            if self._error is not None:
                raise RuntimeError(
                    "serving engine aborted") from self._error
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid, prompt, max_new,
                          self.eos_id if eos_id is None else eos_id,
                          ttft_slo_s=ttft_slo_s, e2e_slo_s=e2e_slo_s,
                          sheddable=sheddable)
            if self._first_submit_t is None:
                self._first_submit_t = req.submit_t
            self._queue.append(req)
            self._reg.gauge("serving.queue_depth").set(len(self._queue))
        return req

    def results(self, block=False, timeout=None):
        """Drain finished requests (FIFO completion order; aborted and
        shed requests surface here too, with ``error`` set)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self._qlock:
                out = list(self._completed)
                self._completed.clear()
            if out or not block:
                return out
            if deadline is not None and time.monotonic() >= deadline:
                return []
            time.sleep(0.001)

    # -- scheduler --------------------------------------------------------
    @property
    def active_slots(self):
        return self.max_slots - len(self._free)

    @property
    def idle(self):
        with self._qlock:
            pending = bool(self._queue) or self._inflight > 0
        return not pending and self.active_slots == 0

    def step(self):
        """One scheduler iteration: admit queued requests into free slots,
        then run one batched decode chunk.  Returns the number of
        requests finished this iteration.  A device error mid-step is
        fatal: every pending request completes with ``error`` set and
        further ``submit``/``step`` calls raise."""
        if self._error is not None:
            raise RuntimeError("serving engine aborted") from self._error
        with self._dlock:
            try:
                finished = self._admit()
                if self.active_slots:
                    finished += self._decode()
            except Exception as e:
                self._abort(e)
                raise
        return finished

    def _abort(self, exc):
        """Fail every pending request and mark the engine dead."""
        with self._qlock:
            self._error = exc
            self._inflight = 0
            pending = list(self._queue)
            self._queue.clear()
            for s, req in enumerate(self._slots):
                if req is not None:
                    pending.append(req)
                    self._slots[s] = None
                for b in self._slot_blocks[s] or ():
                    self.kv_pool.deref(b)
                self._slot_blocks[s] = None
                if self._spec is not None:
                    self._spec.release(self, s)
            self._table[:] = 0
            self._free = list(range(self.max_slots))
            for req in pending:
                req.error = exc
                req.finish_t = time.perf_counter()
                self._completed.append(req)
            self._reg.gauge("serving.queue_depth").set(0)
            self._reg.gauge("serving.slots_active").set(0)
            self._reg.counter("serving.aborted").inc(len(pending))
        for req in pending:
            req._done.set()
        # post-mortem: the bundle's recent spans carry the request and
        # decode timeline that led here
        _flight.dump("serving_abort",
                     error=f"{type(exc).__name__}: {exc}"[:300],
                     failed_requests=len(pending))

    def run_until_idle(self):
        """Drive ``step`` until the queue and every slot are empty."""
        n = 0
        while not self.idle:
            n += self.step()
        return n

    def generate_many(self, prompts, max_new_tokens=16, eos_id=None):
        """Synchronous batch front-end: submit every prompt, run to
        completion, return one prompt+generated int32 array per prompt
        (order preserved).  ``max_new_tokens`` may be a scalar or a
        per-prompt sequence."""
        if np.ndim(max_new_tokens) == 0:
            max_new_tokens = [max_new_tokens] * len(prompts)
        if len(max_new_tokens) != len(prompts):
            raise ValueError(
                f"max_new_tokens has {len(max_new_tokens)} entries for "
                f"{len(prompts)} prompts")
        reqs = [self.submit(p, m, eos_id, sheddable=False)
                for p, m in zip(prompts, max_new_tokens)]
        self.run_until_idle()
        mine = {id(r) for r in reqs}
        with self._qlock:
            kept = [r for r in self._completed if id(r) not in mine]
            self._completed.clear()
            self._completed.extend(kept)
        return [r.result(timeout=0) for r in reqs]

    # -- background thread ------------------------------------------------
    def start(self):
        """Run the scheduler loop on a daemon thread until ``stop()``.
        The thread is supervised: if the thread dies for any reason,
        every queued and in-flight request is failed with the captured
        exception.  Kernels launch on the current CUDA stream of this
        thread (the default stream unless the caller's code sets
        another)."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()

        def loop():
            try:
                while not self._stop.is_set():
                    if self.idle:
                        time.sleep(0.001)
                        continue
                    self.step()
            except BaseException as e:  # noqa: BLE001 — supervision
                if self._error is None:
                    self._abort(e)
                self._reg.counter(
                    "serving.driver_deaths",
                    help="serving threads that died (requests "
                         "failed over, not stranded)").inc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ptt-serving-engine")
        self._thread.start()

    def driver_alive(self):
        """True while the background serving thread is running."""
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self, drain=True):
        """Stop the background loop (``drain=True`` serves out queued and
        active work first)."""
        if self._thread is None:
            return
        if drain:
            while not self.idle:
                if self._error is not None or not self._thread.is_alive():
                    break
                time.sleep(0.001)
        self._stop.set()
        self._thread.join()
        self._thread = None

    # -- internals --------------------------------------------------------
    def bucket_for(self, p_len):
        """Prefill bucket for a (suffix) length: the smallest
        power-of-two multiple of ``min_bucket`` that covers it, capped
        at ``max_len``."""
        b = self.min_bucket
        while b < p_len:
            b *= 2
        return min(b, self.max_len)

    def _record_spelling(self, fn, label):
        """Record which attention spelling step callable ``fn`` was built
        with (``kernel_backends[label]``; ``serving.paged_attn_compiles``
        counts the paged ones) — the JAX engine records the same per
        compiled executable."""
        kern = "paged_attention" if fn.paged else "decode_gather"
        self.kernel_backends[label] = {
            kern: "cuda" if self.device.type == "cuda" else "torch_ref"}
        if fn.paged:
            self._reg.counter(
                "serving.paged_attn_compiles",
                help="serving step callables built through the "
                     "paged_attention kernel (vs the "
                     "PADDLE_TPU_PAGED_ATTN=0 gather spelling)").inc()

    def _prefill_fn(self, bucket):
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = _bd.make_prefill(self.n_layer, self.n_head, self.d_model,
                                  bucket, eps=self._eps)
            self._record_spelling(fn, f"prefill_{bucket}")
            self._prefill_fns[bucket] = fn
        return fn

    def _release_slot(self, slot):
        """Return a slot and every KV block it references to the pool
        (shared blocks just drop one ref; private ones free)."""
        for b in self._slot_blocks[slot] or ():
            self.kv_pool.deref(b)
        self._slot_blocks[slot] = None
        self._table[slot] = 0
        if self._spec is not None:
            # the slot's draft scratch chain obeys the same discipline
            self._spec.release(self, slot)
        self._slots[slot] = None
        self._free.append(slot)
        if self.prefix_trie is not None:
            self.prefix_trie.enforce_budget()
        self._reg.gauge("serving.blocks_in_use").set(
            self.kv_pool.blocks_in_use)

    def _decode(self):
        if self._spec is not None:
            return self._spec_decode()
        if self._decode_fn is None:
            self._decode_fn = _bd.make_decode_chunk(
                self.n_layer, self.n_head, self.d_model, self.decode_chunk,
                eps=self._eps)
            self._record_spelling(self._decode_fn, "decode")
        # fault injection point (PADDLE_TPU_FAULT=slot_death:n): the n-th
        # decode chunk kills one active request mid-decode — its slot and
        # KV blocks must be reclaimed and the engine keep serving
        if _faults.maybe_fault("serving.decode") == "slot_death":
            self._kill_one_slot()
            if not self.active_slots:
                return 0
        t0 = time.perf_counter()
        tbl = torch.from_numpy(self._table).to(self.device)
        toks = self._decode_fn(self._p, self._pk, self._pv, self._last,
                               self._pos, tbl)
        toks = toks.cpu().numpy()  # host sync: [chunk, S]
        t1 = time.perf_counter()
        wall = t1 - t0
        self._reg.histogram("serving.step_seconds").observe(
            wall / self.decode_chunk)
        self._reg.histogram("serving.decode_chunk").observe(wall)
        self.predictor.observe_chunk(wall, self.decode_chunk)
        tracer = self._tracer
        tracer.add_span("serving.decode_chunk", t0, t1, cat="serving",
                        steps=self.decode_chunk, active=self.active_slots)
        if tracer.enabled:
            # per-request windows feed only the finish-time lane emission
            for req in self._slots:
                if req is not None:
                    req.chunks.append((t0, t1))
        emitted = 0
        finished = 0
        now = time.perf_counter()
        for j in range(self.decode_chunk):
            for s, req in enumerate(self._slots):
                if req is None:
                    continue
                tok = int(toks[j, s])
                req.tokens.append(tok)
                emitted += 1
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.tokens) >= req.max_new):
                    self._release_slot(s)
                    self._finish(req, now)
                    finished += 1
        self._reg.counter("serving.tokens").inc(emitted)
        if wall > 0:
            self._reg.gauge("serving.tok_s").set(emitted / wall)
        self._reg.gauge("serving.slots_active").set(self.active_slots)
        return finished

    def _spec_decode(self):
        """One speculative round (serving.speculative): the draft proposes
        ``spec_k`` tokens per slot into scratch chains, ONE target verify
        scores every slot's ``k + 1``-token window, greedy acceptance
        commits the agreeing prefix plus the bonus token, and scratch
        blocks past the committed frontier roll back to the pool.  At
        least one token commits per live slot per round."""
        sp = self._spec
        k = sp.k
        B = self.block_tokens
        S = self.max_slots
        # per-slot committed frontier, rebuilt from host truth each
        # round: last committed token, its position, and the last
        # position the slot may ever write (the verify write limit)
        last_h = np.zeros(S, np.int32)
        pos_h = np.zeros(S, np.int32)
        limit_h = np.full(S, -1, np.int32)
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            p_len = req.prompt.shape[0]
            last_h[s] = req.tokens[-1]
            pos_h[s] = p_len + len(req.tokens) - 1
            limit_h[s] = p_len + req.max_new - 1
            hi = min(pos_h[s] + k, limit_h[s])
            sp.ensure_chain(self, s, int(hi) // B + 1)
        verify = sp.verify_fn(self)
        t0 = time.perf_counter()
        drafts = sp.propose(self, last_h, pos_h)       # [k, S] host
        t_d = time.perf_counter()
        self._reg.gauge(
            "serving.spec_draft_ms",
            help="draft propose wall time per speculative round (ms)",
        ).set((t_d - t0) * 1000.0)
        # fault injection point (PADDLE_TPU_FAULT=slot_death:n): in
        # speculative mode the death fires MID-VERIFY, between propose
        # and commit.  The killed slot's real AND draft chains are
        # reclaimed (_release_slot), its table rows zero, and the verify
        # below runs with its write limit at -1: it scatters only into
        # the trash block.
        if _faults.maybe_fault("serving.decode") == "slot_death":
            self._kill_one_slot()
            if not self.active_slots:
                return 0
        for s in range(S):
            if self._slots[s] is None:
                limit_h[s] = -1
        U = np.zeros((S, k + 1), np.int32)
        U[:, 0] = last_h
        U[:, 1:] = drafts.T
        dev = self.device
        greedy = verify(self._p, self._pk, self._pv,
                        torch.from_numpy(U).to(dev),
                        torch.from_numpy(pos_h).to(dev),
                        torch.from_numpy(limit_h).to(dev),
                        torch.from_numpy(self._table).to(dev))
        greedy = greedy.cpu().numpy()                  # host sync [S, k+1]
        t1 = time.perf_counter()
        wall = t1 - t0
        active = self.active_slots
        tracer = self._tracer
        if tracer.enabled:
            for req in self._slots:
                if req is not None:
                    req.chunks.append((t0, t1))
        emitted = 0
        finished = 0
        round_acc = 0
        now = time.perf_counter()
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            remaining = req.max_new - len(req.tokens)
            commit, n_matched = _spec.accept_greedy(
                drafts[:, s], greedy[s], remaining)
            done = False
            appended = 0
            for tok in commit:
                req.tokens.append(tok)
                emitted += 1
                appended += 1
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.tokens) >= req.max_new):
                    done = True
                    break
            acc = min(n_matched, appended)
            # acceptance is judged over the draft tokens that COULD have
            # committed (the request's remaining window), not the full k
            eff = min(k, max(0, remaining - 1))
            sp.proposed += eff
            sp.accepted += acc
            round_acc += acc
            req.spec_proposed += eff
            req.spec_accepted += acc
            if done:
                self._release_slot(s)
                self._finish(req, now)
                finished += 1
            else:
                # the draft KV is valid through the new frontier - 1;
                # scratch blocks past it held rejected-token state
                pos2 = req.prompt.shape[0] + len(req.tokens) - 1
                sp.rollback(self, s, (int(pos2) - 1) // B + 1)
        self._reg.counter("serving.tokens").inc(emitted)
        if wall > 0:
            self._reg.gauge("serving.tok_s").set(emitted / wall)
        if sp.proposed:
            self._reg.gauge(
                "serving.spec_accept_rate",
                help="draft tokens accepted / proposed since the last "
                     "accounting reset",
            ).set(sp.accepted / sp.proposed)
        self._reg.histogram("serving.decode_chunk").observe(wall)
        self._reg.histogram("serving.step_seconds").observe(wall / (k + 1))
        if active:
            # steps per round for the predictor: the steady-state
            # expectation 1 + accept_rate * k, not this round's noisy
            # emitted/active
            if sp.proposed:
                steps = 1 + k * (sp.accepted / sp.proposed)
            else:
                steps = emitted / active
            self.predictor.observe_chunk(wall, max(1, int(round(steps))))
        tracer.add_span("serving.spec_round", t0, t1, cat="serving",
                        k=k, active=active, emitted=emitted,
                        accepted=round_acc)
        self._reg.gauge("serving.blocks_in_use").set(
            self.kv_pool.blocks_in_use)
        self._reg.gauge("serving.slots_active").set(self.active_slots)
        return finished

    def _kill_one_slot(self):
        """Injected mid-decode slot death: fail the first active request,
        reclaim its slot and KV blocks (the no-leak regression), keep the
        engine serving."""
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            req.error = RuntimeError(
                f"injected slot death (PADDLE_TPU_FAULT) — request "
                f"{req.rid} died in slot {s} mid-decode")
            req.finish_t = time.perf_counter()
            self._release_slot(s)
            self._reg.counter(
                "serving.slot_deaths",
                help="requests killed by injected mid-decode slot death "
                     "(blocks + slot reclaimed)").inc()
            self._reg.gauge("serving.slots_active").set(self.active_slots)
            with self._qlock:
                self._completed.append(req)
            req._done.set()
            return True
        return False

    def _sched_bucket(self, req):
        """The scheduler's prefill-bucket estimate for a queued request,
        reuse-aware via a non-mutating trie probe."""
        p_len = req.prompt.shape[0]
        hit = 0
        if self.prefix_trie is not None:
            hit = self.prefix_trie.peek_hit(req.prompt, p_len - 1)
        return self.bucket_for(p_len - hit)

    def _admit(self):
        """Move queued requests into free slots in SCHEDULER order.
        Returns requests finished AT admission (immediate EOS /
        max_new == 1 / shed)."""
        finished = 0
        while self._free:
            now = time.perf_counter()
            with self._qlock:
                if not self._queue:
                    break
                req, shed = self._sched.pick(self._queue, now,
                                             self._sched_bucket)
                if req is not None:
                    self._inflight += 1
                self._reg.gauge("serving.queue_depth").set(
                    len(self._queue))
            for victim in shed:
                self._shed(victim)
                finished += 1
            if req is None:
                if shed:
                    continue
                break
            req.admit_t = time.perf_counter()
            slot = self._free.pop()
            try:
                finished += self._prefill_into(slot, req)
                self._reg.histogram("serving.queue_wait").observe(
                    req.admit_t - req.submit_t)
                with self._qlock:
                    self._inflight -= 1
            except _kv.PoolExhausted:
                # live slots hold the rest of the pool: back off until
                # decode frees blocks (the victim keeps its place)
                self._free.append(slot)
                with self._qlock:
                    self._queue.appendleft(req)
                    self._inflight -= 1
                req.admit_t = None
                if self.active_slots == 0:
                    raise  # nothing will ever free blocks: fatal
                break
            except Exception:
                self._free.append(slot)
                with self._qlock:
                    self._queue.appendleft(req)
                    self._inflight -= 1
                raise
        self._reg.gauge("serving.slots_active").set(self.active_slots)
        return finished

    def _prefill_into(self, slot, req):
        """Admit one request into ``slot``: match the prefix trie,
        reference shared blocks, allocate the private tail (LRU-evicting
        cached chains under pressure), run the bucketed SUFFIX prefill
        (with the copy-on-write fork folded in), then register the
        prompt's full blocks in the trie.  Returns 1 when the request
        finished at prefill (immediate EOS / max_new == 1), else 0."""
        pool, trie = self.kv_pool, self.prefix_trie
        p_len = req.prompt.shape[0]
        n_total = -(-(p_len + req.max_new) // self.block_tokens)
        shared, cow, hit = [], None, 0
        if trie is not None:
            shared, cow, hit = trie.match(req.prompt, p_len - 1)
        # hold every matched block across the eviction/alloc window so
        # LRU pressure can never free a chain we are about to attend
        hold = list(shared) + ([cow[0]] if cow else [])
        for b in hold:
            pool.ref(b)
        need = n_total - len(shared)
        try:
            if need > pool.free_blocks and trie is not None:
                trie.evict_lru(need - pool.free_blocks)
            priv = pool.alloc(need)
        except _kv.PoolExhausted:
            for b in hold:
                pool.deref(b)
            raise
        row = np.zeros(self.blocks_per_slot, np.int32)
        row[:len(shared)] = shared
        row[len(shared):n_total] = priv
        cow_src = cow_dst = 0
        if cow is not None:
            # fork the partially-matched cached block copy-on-write into
            # the first private block (logical block len(shared))
            cow_src, cow_dst = cow[0], priv[0]
            self._reg.counter(
                "serving.cow_copies",
                help="prefix-cache blocks forked copy-on-write").inc()
        start = int(hit)
        suffix = p_len - start
        bucket = self.bucket_for(suffix)
        req.bucket = bucket
        req.prefix_hit = start
        fn = self._prefill_fn(bucket)
        padded = np.zeros(bucket, np.int32)
        padded[:suffix] = req.prompt[start:]
        t_p0 = time.perf_counter()
        first = fn(self._p, self._pk, self._pv, self._last, self._pos,
                   slot, torch.from_numpy(row).to(self.device),
                   torch.from_numpy(padded).to(self.device), start, suffix,
                   int(cow_src), int(cow_dst))
        first = int(first)  # host sync
        now = time.perf_counter()
        # the CoW source was held only for the copy window
        if cow is not None:
            pool.deref(cow[0])
        self._table[slot] = row
        self._slot_blocks[slot] = list(shared) + list(priv)
        if self._spec is not None:
            # draft prefill: the FULL prompt through the draft into the
            # slot's scratch chain, so the first propose round has a
            # complete draft KV.  Before any request-state mutation below,
            # so a PoolExhausted (the pool reserves a draft chain per
            # slot, so unlikely) re-queues cleanly.
            try:
                self._spec.prefill(self, slot, req)
            except _kv.PoolExhausted:
                for b in self._slot_blocks[slot] or ():
                    pool.deref(b)
                self._slot_blocks[slot] = None
                self._table[slot] = 0
                self._spec.release(self, slot)
                if trie is not None:
                    trie.enforce_budget()
                self._reg.gauge("serving.blocks_in_use").set(
                    pool.blocks_in_use)
                raise
        if trie is not None:
            # register the prompt's FULL blocks (shared ones are already
            # cached and skipped; our private full blocks become reusable)
            trie.insert(req.prompt,
                        [int(b) for b in row[:p_len // self.block_tokens]])
        req.prefill_t0, req.prefill_t1 = t_p0, now
        self._reg.histogram("serving.prefill_seconds").observe(now - t_p0)
        self.predictor.observe_prefill(bucket, now - t_p0)
        self._tracer.add_span("serving.prefill", t_p0, now, cat="serving",
                              rid=req.rid, bucket=bucket, slot=slot,
                              prefix_hit=start)
        req.first_token_t = now
        req.tokens.append(first)
        self._reg.counter("serving.admitted").inc()
        self._reg.counter("serving.tokens").inc()
        self._reg.counter(
            "serving.prefill_tokens",
            help="prompt-suffix tokens actually scanned by prefill "
                 "(bucket-padded; prefix hits subtract from this)",
        ).inc(bucket)
        self._reg.histogram("serving.ttft_seconds").observe(
            now - req.submit_t)
        with self._qlock:
            self._hit_tokens += start
            self._prompt_tokens += p_len
            hit_rate = (self._hit_tokens / self._prompt_tokens
                        if self._prompt_tokens else 0.0)
        self._reg.counter(
            "serving.prefix_hit_tokens",
            help="prompt tokens served from the prefix cache "
                 "(prefill skipped)").inc(start)
        self._reg.gauge(
            "serving.prefix_hit_rate",
            help="cumulative prefix-cache hit rate over prompt tokens "
                 "(since the last accounting reset)").set(hit_rate)
        self._reg.gauge("serving.blocks_in_use").set(pool.blocks_in_use)
        if ((req.eos_id is not None and first == req.eos_id)
                or req.max_new == 1):
            self._release_slot(slot)
            self._finish(req, now)
            return 1
        self._slots[slot] = req
        return 0

    def _shed(self, req):
        """Fail a request the scheduler refused (cannot meet its e2e
        budget): it completes immediately with ``shed`` True."""
        now = time.perf_counter()
        req.shed = True
        req.slo_ok = False
        req.error = _sched.SheddedRequest(
            f"request {req.rid} shed after {now - req.submit_t:.3f}s in "
            f"queue: predicted completion exceeds its e2e budget")
        req.finish_t = now
        self._reg.counter(
            "serving.shed_total",
            help="requests shed by the SLO scheduler (could no longer "
                 "meet their e2e budget)").inc()
        self._tracer.instant("serving.shed", cat="serving", rid=req.rid)
        with self._qlock:
            self._completed.append(req)
        req._done.set()

    def _finish(self, req, now):
        req.finish_t = now
        self._reg.counter("serving.completed").inc()
        self._reg.histogram("serving.e2e_seconds").observe(req.e2e)
        self._judge_slo(req, now)
        self._emit_request_trace(req)
        with self._qlock:
            self._completed.append(req)
        req._done.set()

    def reset_slo_accounting(self):
        """Re-open the goodput window and zero the violation/shed
        counters and the prefix-hit window — call after a warm pass so
        its TTFT breaches and trie traffic don't charge the timed run."""
        with self._qlock:
            self._good_tokens = 0
            self._first_submit_t = None
            self._hit_tokens = 0
            self._prompt_tokens = 0
            if self._spec is not None:
                self._spec.proposed = 0
                self._spec.accepted = 0
        for nm in ("serving.slo_violations", "serving.goodput_tok_s",
                   "serving.shed_total", "serving.prefix_hit_rate",
                   "serving.prefix_hit_tokens", "serving.prefill_tokens",
                   "serving.cow_copies", "serving.spec_accept_rate",
                   "serving.spec_draft_ms",
                   "serving.spec_rollback_blocks"):
            m = self._reg.get(nm)
            if m is not None:
                m.reset()

    def _judge_slo(self, req, now):
        """SLO verdict at completion: a TTFT or e2e budget breach counts
        ``serving.slo_violations``; tokens of SLO-met requests feed the
        ``serving.goodput_tok_s`` gauge."""
        ttft_b = (req.ttft_slo_s if req.ttft_slo_s is not None
                  else self.ttft_slo_s)
        e2e_b = (req.e2e_slo_s if req.e2e_slo_s is not None
                 else self.e2e_slo_s)
        if ttft_b is None and e2e_b is None:
            return
        ok = True
        if ttft_b is not None and (req.ttft is None or req.ttft > ttft_b):
            ok = False
        if e2e_b is not None and (req.e2e is None or req.e2e > e2e_b):
            ok = False
        req.slo_ok = ok
        if not ok:
            self._reg.counter(
                "serving.slo_violations",
                help="completed requests that breached their TTFT/e2e "
                     "SLO budget").inc()
        with self._qlock:
            if ok:
                self._good_tokens += len(req.tokens)
            good, t0 = self._good_tokens, self._first_submit_t
        window = now - t0 if t0 is not None else 0.0
        if window > 0:
            self._reg.gauge(
                "serving.goodput_tok_s",
                help="tokens/sec from SLO-met requests since the first "
                     "submit").set(good / window)

    def _emit_request_trace(self, req):
        """Lay the finished request's span tree on its own timeline lane:
        ``serving.request`` (submit -> finish) containing
        ``serving.req.queue`` / ``serving.req.prefill`` / one
        ``serving.req.decode_chunk`` per round the request was live for,
        closed by a zero-length ``serving.req.evict`` marker.  These
        re-present intervals the histograms and the engine-thread spans
        already observed, so they are timeline-only (``timer=False``)."""
        tr = self._tracer
        if not tr.enabled or req.error is not None or req.admit_t is None:
            return
        lane = f"serving req {self._req_lane(req)}"
        spec_attrs = ({"spec_proposed": req.spec_proposed,
                       "spec_accepted": req.spec_accepted}
                      if req.spec_proposed else {})
        tr.add_span("serving.request", req.submit_t, req.finish_t,
                    cat="serving", lane=lane, timer=False, rid=req.rid,
                    prompt_len=int(req.prompt.shape[0]),
                    tokens=len(req.tokens), prefix_hit=req.prefix_hit,
                    **spec_attrs)
        tr.add_span("serving.req.queue", req.submit_t, req.admit_t,
                    cat="serving", lane=lane, timer=False, rid=req.rid)
        if req.prefill_t0 is not None:
            tr.add_span("serving.req.prefill", req.prefill_t0,
                        req.prefill_t1, cat="serving", lane=lane,
                        timer=False, rid=req.rid, bucket=req.bucket,
                        prefix_hit=req.prefix_hit)
        for c0, c1 in req.chunks:
            tr.add_span("serving.req.decode_chunk", c0, c1, cat="serving",
                        lane=lane, timer=False, rid=req.rid)
        tr.add_span("serving.req.evict", req.finish_t, req.finish_t,
                    cat="serving", lane=lane, timer=False, rid=req.rid)

    def _req_lane(self, req):
        """A timeline lane whose previous occupant finished before this
        request was submitted, so overlapping requests never share a lane
        (Chrome/Perfetto nest by ts/dur containment within a tid).  Lanes
        are reused once free; past 64 live requests the least-recently
        freed lane is reused.  Engine thread only, so no lock."""
        ends = self._req_lane_ends
        for i, end in enumerate(ends):
            if end <= req.submit_t:
                ends[i] = req.finish_t
                return i
        if len(ends) < 64:
            ends.append(req.finish_t)
            return len(ends) - 1
        i = min(range(len(ends)), key=ends.__getitem__)
        ends[i] = req.finish_t
        return i

    def stats(self):
        """Snapshot of the engine's ``serving.*`` metrics."""
        return self._reg.snapshot(prefix="serving.")

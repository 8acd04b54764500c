"""SLO-aware goodput scheduling — the CONTROL half of the serving SLO
loop (the measurement half is the ``serving.*`` latency telemetry).

The port's own copy of ``paddle_tpu/serving/scheduler.py`` (standard
library only; the port imports nothing of the JAX package).

The original admission policy was FIFO: maximize raw tok/s, serve every
request in arrival order no matter how late.  Under bursty load that is
exactly wrong for goodput — tokens delivered WITHIN each request's
TTFT/e2e budget: FIFO burns whole decode chunks finishing requests that
blew their deadline minutes ago while requests that could still make
theirs age out in the queue behind them.  This module closes the loop
with three decisions per free slot, fed by the engine's own measured
latency telemetry:

* **predict** — :class:`TtftPredictor` keeps EMAs of per-bucket prefill
  wall time and per-chunk decode wall time (the histograms
  ``serving.queue_wait`` / ``serving.prefill_seconds`` /
  ``serving.decode_chunk`` already observe; the predictor is the same
  stream folded to a point estimate).  Predicted TTFT of a queued
  request = time already queued + its bucket's prefill estimate;
  minimum service time adds the decode chunks its token budget needs.
* **shed** — a request whose age plus OPTIMISTIC minimum service time
  already exceeds its e2e budget cannot meet it under any schedule;
  serving it would burn capacity that on-time requests need.  It is
  failed immediately (``SheddedRequest``, ``serving.shed_total``).
  Optimism is deliberate: the bound only sheds provably-doomed work,
  never a request a lucky schedule could still save.
* **reorder** — among admissible requests, pop the one with the least
  TTFT slack (budget minus predicted TTFT): earliest-deadline-first
  over the deadline actually contracted.  Requests with no TTFT budget
  sort FIFO behind budgeted ones.

``FifoScheduler`` keeps that FIFO behavior verbatim — it is the
benchmark baseline (``benchmarks/serving.py`` runs both policies under
the same shared-prefix Poisson load and gates SLO goodput > FIFO
goodput) and the compatibility spelling (``ServingEngine`` with no
budgets behaves identically under either).
"""

import math

__all__ = ["SheddedRequest", "TtftPredictor", "FifoScheduler",
           "SloScheduler", "make_scheduler"]


class SheddedRequest(RuntimeError):
    """The scheduler refused a request that could no longer meet its
    end-to-end budget (``Request.shed`` is True; ``result()`` raises
    this)."""


class TtftPredictor:
    """Point estimates of the engine's service-time components, fed by
    the engine's serving loop after every measured prefill / decode chunk.

    EMA with a fast alpha: serving latencies are regime-y (compile
    storms, co-tenant noise) and an old regime's tail should wash out
    within a few observations.  ``ready`` stays False until at least
    one decode chunk AND one prefill have been observed — a cold
    predictor must never shed (the optimistic-bound contract degrades
    to "never doomed", not to garbage estimates)."""

    def __init__(self, alpha=0.3):
        self.alpha = float(alpha)
        self._prefill = {}      # suffix bucket -> EMA seconds
        self._chunk = None      # EMA seconds per decode-chunk call
        self._chunk_steps = 1

    def _fold(self, old, v):
        return v if old is None else old + self.alpha * (v - old)

    def observe_prefill(self, bucket, seconds):
        self._prefill[bucket] = self._fold(
            self._prefill.get(bucket), float(seconds))

    def observe_chunk(self, seconds, steps):
        self._chunk = self._fold(self._chunk, float(seconds))
        self._chunk_steps = max(1, int(steps))

    @property
    def ready(self):
        return self._chunk is not None and bool(self._prefill)

    def prefill_s(self, bucket):
        """Prefill estimate for a bucket; an unseen bucket scales the
        nearest observed one by the bucket ratio (prefill wall is
        linear in scanned tokens)."""
        if bucket in self._prefill:
            return self._prefill[bucket]
        if not self._prefill:
            return 0.0
        ref = min(self._prefill, key=lambda b: abs(b - bucket))
        return self._prefill[ref] * (bucket / ref)

    def decode_s(self, new_tokens):
        """OPTIMISTIC decode time for ``new_tokens`` greedy tokens: the
        chunk calls needed at the measured per-chunk wall, assuming the
        request rides every chunk from admission (no queueing ahead of
        it).  One token rode the prefill already."""
        if self._chunk is None:
            return 0.0
        calls = math.ceil(max(0, new_tokens - 1) / self._chunk_steps)
        return calls * self._chunk

    def predicted_ttft(self, req, bucket, now):
        """Queue age so far + the bucket's prefill estimate — the TTFT
        this request lands at if admitted right now."""
        return (now - req.submit_t) + self.prefill_s(bucket)

    def min_service_s(self, bucket, new_tokens):
        return self.prefill_s(bucket) + self.decode_s(new_tokens)


class FifoScheduler:
    """The baseline policy: strict arrival order, never sheds."""

    name = "fifo"

    def pick(self, queue, now, bucket_of):
        """Pop the next request to admit.  Returns ``(req_or_None,
        shed_list)``; FIFO never sheds."""
        return (queue.popleft() if queue else None), []


class SloScheduler:
    """Admit by least TTFT slack, shed what cannot meet its e2e budget.

    ``queue`` is the engine's deque, mutated under the engine's queue
    lock; ``bucket_of(req)`` maps a request to its (conservative,
    reuse-blind) prefill bucket.  ``budgets`` is any object with
    ``ttft_slo_s``/``e2e_slo_s`` attributes (the engine passes itself,
    so budgets mutated after construction — the bench/test pattern —
    are honored live); per-request budgets win over those defaults."""

    name = "slo"

    def __init__(self, predictor, budgets):
        self.predictor = predictor
        self.budgets = budgets

    def _budgets(self, req):
        ttft = getattr(req, "ttft_slo_s", None)
        e2e = getattr(req, "e2e_slo_s", None)
        return (ttft if ttft is not None else self.budgets.ttft_slo_s,
                e2e if e2e is not None else self.budgets.e2e_slo_s)

    def pick(self, queue, now, bucket_of):
        """One admission decision: remove and return the least-slack
        admissible request, plus the list of requests shed as provably
        unable to meet their e2e budget (removed from the queue; the
        engine fails them).  A cold predictor sheds nothing and
        degrades to FIFO order."""
        if not queue:
            return None, []
        pred = self.predictor
        shed, keep = [], []
        for req in queue:
            # one budget resolution + one trie-probing bucket estimate
            # per request — pick() runs under the engine's queue lock,
            # so the per-request work here gates concurrent submits
            ttft_b, e2e_b = self._budgets(req)
            bucket = bucket_of(req)
            if (e2e_b is not None and pred.ready
                    and getattr(req, "sheddable", True)
                    and (now - req.submit_t) + pred.min_service_s(
                        bucket, req.max_new) > e2e_b):
                shed.append(req)
            else:
                keep.append((req, ttft_b, bucket))
        choice = None
        if keep:
            def slack(item):
                i, (req, ttft_b, bucket) = item
                if ttft_b is None or not pred.ready:
                    # unbudgeted requests keep FIFO order BEHIND every
                    # budgeted one (inf slack, arrival index tiebreak)
                    return (math.inf, i)
                return (ttft_b - pred.predicted_ttft(req, bucket, now), i)

            _, (choice, _, _) = min(enumerate(keep), key=slack)
        queue.clear()
        queue.extend(r for (r, _, _) in keep if r is not choice)
        return choice, shed


def make_scheduler(kind, predictor, budgets):
    """Factory for ``ServingEngine(scheduler=...)``: "slo" (default) or
    "fifo" (the baseline policy).  ``budgets`` supplies the
    engine-level ``ttft_slo_s``/``e2e_slo_s`` defaults (read live)."""
    kind = (kind or "slo").lower()
    if kind == "fifo":
        return FifoScheduler()
    if kind == "slo":
        return SloScheduler(predictor, budgets)
    raise ValueError(f"unknown scheduler {kind!r} (use 'slo' or 'fifo')")

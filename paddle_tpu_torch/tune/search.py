"""The measured-feedback search loop — the counterpart of
``paddle_tpu/tune/search.py``.

``tune_gpt_step`` is the searchable training workload: it generates the
schedule candidates (``space.schedule_candidates``), prunes them
statically (``space.prune_static``), then for each survivor:

1. **preflight** — rejects it when ``estimate_gpt_step_hbm`` (scaled by
   the cost model's ``hbm_scale_for``) exceeds the budget (the caller's,
   else the card's memory).  The JAX package compiles each candidate and
   reads the compiled figure; PyTorch runs eagerly, so the estimate is
   the pre-run check, and a candidate whose start-up or warm-up step
   raises ``torch.cuda.OutOfMemoryError`` on the card is recorded as
   ``preflight_rejected`` with reason ``"oom"``, its memory freed, and
   the search goes on;
2. builds the Program, runs the warm-up, and times ``repeats`` windows
   of ``steps`` steps, each ending in ``torch.cuda.synchronize()`` and a
   host read of the loss; the median wins.  Each measured record carries
   ``torch.cuda.max_memory_allocated()`` as ``hbm_high_water_bytes`` on
   the card (the estimate on the CPU) beside ``hbm_est_bytes``, and the
   backward route its ``block_k`` gives.  A candidate carrying a kernel
   ``backend`` runs under ``kernels.forced_backend`` (not strict: an op
   the backend cannot serve takes auto), and its record carries the
   backend that ran (``backend_requested`` where that differs) and its
   workload key with that backend's ``|kb=`` token.

The winner persists in the cache (``tune.cache``) under its workload key
plus a companion ``op=flash`` entry that ``layers.multi_head_attention``
reads.  ``tune_serving_decode`` / ``tune_spec_decode`` time real engines
on a synthetic load; ``tune_paged_attention`` times the split kernel at
each candidate split count with CUDA events (the device time of queued
calls), after holding its output against ``paged_attention_split_ref``
at the same count.

Every measured candidate emits a ``tune.search`` span (category
``tune``); ``tune.searches`` / ``tune.cache_hits`` /
``tune.cache_misses`` / ``tune.candidates_measured`` /
``tune.pruned_static`` / ``tune.pruned_preflight`` count in the metrics
registry under the JAX package's names.
"""

import contextlib
import gc
import os
import time

import numpy as np
import torch

from ..observability import metrics as _obs
from ..observability import trace as _trace
from .cache import device_platform, get_cache
from .space import (
    POLICY_ORDER, WorkloadKey, device_budget, estimate_gpt_step_hbm,
    paged_attention_candidates, prune_static, schedule_candidates,
    serving_candidates, spec_candidates)

__all__ = ["tune_gpt_step", "tune_serving_decode", "tune_spec_decode",
           "tune_paged_attention", "flagship_static_demo",
           "flagship_dims", "PreflightRejected"]


class PreflightRejected(Exception):
    """A candidate rejected before it was timed: its memory estimate is
    over the budget, or its warm-up ran out of device memory."""


def flagship_dims():
    """The GPT flagship model dims (bench.py's ``BENCH_GPT_*`` envs
    win)."""
    return {
        "n_layer": int(os.environ.get("BENCH_GPT_LAYERS", "12")),
        "d_model": int(os.environ.get("BENCH_GPT_DMODEL", "768")),
        "n_head": int(os.environ.get("BENCH_GPT_HEADS", "6")),
        "vocab": int(os.environ.get("BENCH_GPT_VOCAB", "32768")),
        "batch": int(os.environ.get("BENCH_GPT_BATCH", "8")),
    }


def _counter(name, help):
    return _obs.get_registry().counter(name, help=help)


def _lookup(key, mode, force):
    """The shared head of every ``tune_*``: ``(report, cache)``, with
    ``report["source"]`` "off", "cache" (a hit), "miss" (cached mode: the
    caller keeps its defaults), or None when the search must run."""
    report = {"key": key.s, "mode": mode, "entry": None, "source": "miss",
              "candidates": 0, "measured": []}
    if mode == "off":
        report["source"] = "off"
        return report, None
    cache = get_cache()
    hit = cache.get(key.s)
    if hit is not None and not force:
        _counter("tune.cache_hits", "tuned-config cache lookups served").inc()
        report.update(entry=hit, source="cache")
        return report, cache
    _counter("tune.cache_misses", "tuned-config cache lookups missed").inc()
    if mode != "search":
        return report, cache
    _counter("tune.searches", "measured schedule searches executed").inc()
    report["source"] = None
    return report, cache


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _measure_candidate(cand, *, seq_len, n_layer, d_model, n_head, vocab,
                       batch, dtype, fused_head, steps, warmup, repeats,
                       learning_rate, device, hbm_est):
    """Build, warm up and time ONE candidate.  Returns
    ``(median_seconds, cost)``; raises :class:`PreflightRejected` when
    its start-up or warm-up runs out of device memory."""
    import paddle_tpu_torch as pt
    from ..kernels import forced_backend
    from ..kernels.flash_attention import bwd_route
    from ..models import transformer

    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = 11
    with pt.program_guard(main_prog, startup):
        outs = transformer.build(
            vocab_size=vocab, n_layer=n_layer, n_head=n_head,
            d_model=d_model, max_len=seq_len, dropout_rate=0.0,
            dtype=dtype, fused_head=fused_head,
            learning_rate=learning_rate,
            attn_block_q=cand["block_q"], attn_block_k=cand["block_k"],
            attn_packed=cand.get("packed"))
        accum = int(cand.get("accum", 1) or 1)
        if accum > 1:
            pt.gradient_accumulation(main_prog, accum)
        policy = cand.get("policy")
        if policy and policy != "none":
            pt.memory_optimize(main_prog, policy=policy)
    if "fsdp" in cand:
        main_prog._fsdp = bool(cand["fsdp"])
    rng = np.random.default_rng(17)
    toks = rng.integers(0, vocab, (batch, seq_len)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    itemsize = 2 if dtype == "bfloat16" else 4
    route = bwd_route((batch // accum, seq_len, n_head, d_model // n_head),
                      seq_len, itemsize, cand["block_k"])
    on_card = device.type == "cuda"
    if on_card:
        _free(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    exe, scope = pt.Executor(device), pt.Scope()

    def run():
        return exe.run(main_prog, feed=feed, fetch_list=[outs["avg_cost"]],
                       scope=scope, return_numpy=False)

    # the candidate's kernel backend, forced over its whole run: every op
    # of the step (flash and the CE head) resolves it at each call
    backend_ctx = (forced_backend(cand["backend"]) if cand.get("backend")
                   else contextlib.nullcontext())
    try:
        oom = None
        with backend_ctx:
            try:
                exe.run(startup, scope=scope)
                for _ in range(max(0, warmup)):
                    run()
                _sync(device)
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e).splitlines()[0][:160]
            if oom is not None:
                # raised outside the handler, so no traceback keeps the
                # candidate's tensors alive while the search goes on
                raise PreflightRejected(f"oom: {oom}")
            times = []
            for _ in range(max(1, repeats)):
                t0 = time.perf_counter()
                out = None
                for _ in range(max(1, steps)):
                    out = run()
                _sync(device)
                float(out[0].float().cpu().reshape(-1)[0])  # the host read
                times.append(time.perf_counter() - t0)
        last = exe.last_step_cost or {}
        cost = {"flops": last.get("flops"), "route": route,
                "hbm_est_bytes": int(hbm_est),
                "kernel_backends": dict(last.get("kernel_backends") or {})}
        if on_card:
            cost["hbm_high_water_bytes"] = int(
                torch.cuda.max_memory_allocated(device))
            cost["hbm_baseline_bytes"] = int(base)
        else:
            cost["hbm_high_water_bytes"] = int(hbm_est)
    finally:
        del exe, scope
        _free(device)
    return float(np.median(times)), cost


def _truncate_survivors(survivors, max_measure, report):
    """Cap the measured list at ``max_measure`` (the statically best
    schedules first) without dropping a whole kernel backend: one
    best-ranked candidate of each backend the head left out rides along
    (the budget stretches by at most the number of backends)."""
    if not max_measure or len(survivors) <= max_measure:
        return survivors
    keep = survivors[:max_measure]
    kept = {c.get("backend") for c in keep}
    for c in survivors[max_measure:]:
        b = c.get("backend")
        if b is not None and b not in kept:
            keep.append(c)
            kept.add(b)
    report["truncated_to"] = len(keep)
    return keep


def tune_gpt_step(seq_len, n_layer, d_model, n_head, vocab, batch,
                  dtype="bfloat16", fused_head=True, steps=2, warmup=1,
                  repeats=3, budget_bytes=None, block_caps=None,
                  policies=POLICY_ORDER, accums=(1,), fsdp_opts=(None,),
                  backends=None, max_measure=8, learning_rate=1e-3,
                  force=False, mode=None, block_q_caps=None, device=None):
    """Search (or serve from cache) the step schedule for one GPT shape.

    Returns a report dict: ``entry`` (the winning cache entry or None),
    ``source`` ("cache" | "search" | "miss" | "off" | "exhausted"),
    candidate / prune counters and the per-candidate ``measured`` list.
    In mode "cached" (the default) a miss builds nothing and returns
    ``entry=None``; mode "search" measures on a miss (or always, with
    ``force=True``) and persists the winner.  ``device`` is where the
    candidates run (default the card; ``"cpu"`` must be asked for)."""
    from ..core.place import resolve_device
    from . import tune_mode

    device = resolve_device(device)
    key = WorkloadKey("gpt_step", seq_len, d_model // n_head, n_head,
                      dtype, device_platform(device), remat="auto")
    report, cache = _lookup(key, mode or tune_mode(), force)
    report.update(pruned_static=0, pruned_preflight=0)
    if report["source"] is not None:
        return report
    accums = tuple(a for a in accums if batch % a == 0)
    cands = schedule_candidates(seq_len, d_model // n_head, n_head,
                                block_caps=block_caps, policies=policies,
                                accums=accums or (1,), fsdp_opts=fsdp_opts,
                                backends=backends, block_q_caps=block_q_caps)
    report["candidates"] = len(cands)
    survivors, pruned = prune_static(seq_len, d_model // n_head, n_head,
                                     cands)
    report["pruned_static"] = len(pruned)
    if pruned:
        _counter("tune.pruned_static",
                 "candidates rejected by static pruning (geometry/"
                 "roofline/analytic hbm) before any step").inc(len(pruned))
        report["pruned_static_reasons"] = [
            (dict(c), r) for c, r in pruned[:8]]
    survivors.sort(key=lambda c: (
        POLICY_ORDER.index(c.get("policy") or "none"),
        c.get("accum", 1), c.get("roofline", 9.9), -c["block_q"],
        -c["block_k"]))
    survivors = _truncate_survivors(survivors, max_measure, report)
    budget = budget_bytes or device_budget(device)
    report["budget_bytes"] = budget

    tracer = _trace.get_tracer()
    measured = []
    for i, cand in enumerate(survivors):
        est = estimate_gpt_step_hbm(
            n_layer, d_model, n_head, vocab, seq_len, batch,
            policy=cand.get("policy"), accum=cand.get("accum", 1),
            dtype_size=2 if dtype == "bfloat16" else 4)
        cand = dict(cand, hbm_est_bytes=int(est))
        with tracer.span("tune.search", cat="tune", key=key.s,
                         candidate=i, **{k: v for k, v in cand.items()
                                         if k != "hbm_est_bytes"}) as sp:
            try:
                if budget and est > budget:
                    raise PreflightRejected(
                        f"hbm estimate {est / (1 << 30):.2f} GiB > budget "
                        f"{budget / (1 << 30):.2f} GiB")
                median_s, cost = _measure_candidate(
                    cand, seq_len=seq_len, n_layer=n_layer,
                    d_model=d_model, n_head=n_head, vocab=vocab,
                    batch=batch, dtype=dtype, fused_head=fused_head,
                    steps=steps, warmup=warmup, repeats=repeats,
                    learning_rate=learning_rate, device=device,
                    hbm_est=est)
            except PreflightRejected as e:
                _counter("tune.pruned_preflight",
                         "candidates rejected by the memory preflight "
                         "before they were timed").inc()
                report["pruned_preflight"] += 1
                measured.append(dict(cand, verdict="preflight_rejected",
                                     reason=str(e)[:200]))
                sp.set(verdict="preflight_rejected")
                continue
            _counter("tune.candidates_measured",
                     "schedule candidates built and timed").inc()
            tok_s = batch * seq_len * max(1, steps) / median_s
            ran = cost.pop("kernel_backends").get("flash_attention")
            rec = dict(cand, verdict="measured",
                       median_s=round(median_s, 6), tok_s=round(tok_s, 1),
                       **cost)
            # the backend that ran, not the request: forced_backend is not
            # strict, so an unavailable request measured auto's choice
            if cand.get("backend") and ran and ran != cand["backend"]:
                rec["backend"] = ran
                rec["backend_requested"] = cand["backend"]
            rec["workload"] = WorkloadKey(
                "gpt_step", seq_len, d_model // n_head, n_head, dtype,
                key.platform, remat=cand.get("policy") or "-",
                backend=ran).s
            measured.append(rec)
            sp.set(verdict="measured", median_s=rec["median_s"])
    report["measured"] = measured
    timed = [m for m in measured if m["verdict"] == "measured"]
    if not timed:
        report["source"] = "exhausted"
        return report
    win = min(timed, key=lambda m: m["median_s"])
    config = {k: win[k] for k in ("block_q", "block_k", "packed", "policy",
                                  "accum", "fsdp", "backend")
              if k in win and win[k] is not None}
    meas = {k: win[k] for k in ("median_s", "tok_s", "flops",
                                "hbm_high_water_bytes", "hbm_est_bytes",
                                "route") if win.get(k) is not None}
    meas["worst_median_s"] = max(m["median_s"] for m in timed)
    meas["measured_candidates"] = len(timed)
    entry = cache.put(key.s, config, measured=meas)
    flash_key = WorkloadKey("flash", seq_len, d_model // n_head, n_head,
                            dtype, key.platform, remat="-")
    cache.put(flash_key.s,
              {k: config[k] for k in ("block_q", "block_k", "packed",
                                      "backend")
               if k in config},
              measured={"from": key.s})
    cache.save()
    tracer.instant("tune.winner", cat="tune", key=key.s, **config)
    report.update(entry=entry, source="search")
    return report


def _engine_search(key, report, cache, cands, build, params, requests,
                   prompt_len, max_new, seed, extra=None):
    """Time one engine a candidate on a fixed synthetic load (one warm-up
    request first) and persist the fastest; the shared body of
    ``tune_serving_decode`` and ``tune_spec_decode``."""
    rng = np.random.default_rng(seed)
    vocab = int(np.asarray(params["tok_emb.w"]).shape[0])
    prompts = [rng.integers(1, vocab, (prompt_len,)).astype(np.int32)
               for _ in range(requests)]
    tracer = _trace.get_tracer()
    measured = []
    for i, cand in enumerate(cands):
        with tracer.span("tune.search", cat="tune", key=key.s,
                         candidate=i, **cand) as sp:
            eng = build(cand)
            eng.generate_many(prompts[:1], max_new_tokens=2)  # warm-up
            t0 = time.perf_counter()
            eng.generate_many(prompts, max_new_tokens=max_new)
            wall = time.perf_counter() - t0
            _counter("tune.candidates_measured",
                     "schedule candidates built and timed").inc()
            rec = dict(cand, verdict="measured", median_s=round(wall, 6),
                       tok_s=round(requests * max_new / wall, 1))
            if extra is not None:
                rec.update(extra(eng))
            measured.append(rec)
            sp.set(verdict="measured", median_s=rec["median_s"])
    report["measured"] = measured
    if not measured:
        report["source"] = "exhausted"
        return report
    win = min(measured, key=lambda m: m["median_s"])
    config = {k: win[k] for k in cands[0]}
    meas = {k: win[k] for k in ("median_s", "tok_s", "accept_rate")
            if k in win}
    meas["worst_median_s"] = max(m["median_s"] for m in measured)
    meas["measured_candidates"] = len(measured)
    entry = cache.put(key.s, config, measured=meas)
    cache.save()
    tracer.instant("tune.winner", cat="tune", key=key.s, **config)
    report.update(entry=entry, source="search")
    return report


def _serving_dtype(params, dtype):
    """Key on the dtype the engine will SERVE in, or the persisted winner
    lands under a key the engine's lookup never hits."""
    if dtype is not None:
        return dtype
    from ..models.transformer import as_torch_dtype, infer_compute_dtype

    return as_torch_dtype(infer_compute_dtype(params))


def tune_serving_decode(params, n_layer, n_head, d_model, max_len,
                        dtype=None, max_slots=4, requests=6, prompt_len=5,
                        max_new=8, chunks=(2, 4, 8), min_buckets=(4, 8),
                        max_measure=6, force=False, mode=None, seed=0,
                        device=None):
    """Search (or serve from cache) the serving engine's decode chunk and
    smallest prefill bucket for one model shape (``op=serving_decode``,
    keyed on ``max_len``).  Each candidate builds a real engine, serves a
    fixed synthetic load synchronously and is timed wall to wall; the
    winner's ``{"chunk", "min_bucket"}`` persists and ``ServingEngine``
    reads it when given no geometry.  In mode "cached" a miss builds
    nothing."""
    from ..core.place import resolve_device
    from . import tune_mode

    device = resolve_device(device)
    key = WorkloadKey("serving_decode", max_len, d_model // n_head, n_head,
                      _serving_dtype(params, dtype),
                      device_platform(device), remat="-")
    report, cache = _lookup(key, mode or tune_mode(), force)
    if report["source"] is not None:
        return report
    from ..serving import ServingEngine

    cands = serving_candidates(max_len, chunks=chunks,
                               min_buckets=min_buckets)
    report["candidates"] = len(cands)
    if max_measure and len(cands) > max_measure:
        report["truncated_to"] = max_measure
        cands = cands[:max_measure]

    def build(cand):
        return ServingEngine(
            params, n_layer, n_head, d_model, max_len=max_len,
            max_slots=max_slots, decode_chunk=cand["chunk"],
            min_bucket=cand["min_bucket"], prefix_reuse=False,
            device=device)

    return _engine_search(key, report, cache, cands, build, params,
                          requests, prompt_len, max_new, seed)


def tune_spec_decode(params, draft_params, n_layer, n_head, d_model,
                     max_len, dtype=None, draft_n_layer=None,
                     max_slots=4, requests=6, prompt_len=5, max_new=8,
                     ks=(1, 2, 3, 4, 6, 8), max_measure=5, force=False,
                     mode=None, seed=0, device=None):
    """Search (or serve from cache) the speculative draft window ``k`` for
    one serving shape (``op=spec_decode``, keyed on ``max_len``): each
    candidate builds a real speculative engine, serves a fixed synthetic
    load and is timed wall to wall; the winner's ``{"k"}`` persists and
    ``ServingEngine`` reads it when given a draft but no ``spec_k``."""
    from ..core.place import resolve_device
    from . import tune_mode

    device = resolve_device(device)
    key = WorkloadKey("spec_decode", max_len, d_model // n_head, n_head,
                      _serving_dtype(params, dtype),
                      device_platform(device), remat="-")
    report, cache = _lookup(key, mode or tune_mode(), force)
    if report["source"] is not None:
        return report
    from ..serving import ServingEngine

    cands = spec_candidates(max_len, ks=ks)
    report["candidates"] = len(cands)
    if max_measure and len(cands) > max_measure:
        report["truncated_to"] = max_measure
        cands = cands[:max_measure]

    def build(cand):
        return ServingEngine(
            params, n_layer, n_head, d_model, max_len=max_len,
            max_slots=max_slots, prefix_reuse=False,
            draft_params=draft_params, draft_n_layer=draft_n_layer,
            spec_k=cand["k"], device=device)

    def accept(eng):
        sp = eng._spec
        return {"accept_rate": round(
            sp.accepted / sp.proposed if sp.proposed else 0.0, 4)}

    return _engine_search(key, report, cache, cands, build, params,
                          requests, prompt_len, max_new, seed, extra=accept)


def _paged_inputs(n_head, d_head, slots, NB, B, dtype, device, seed):
    """The synthetic decode-step inputs of ``tune_paged_attention``: a
    pool of ``1 + S * NB`` blocks, slot ``s`` owning blocks ``1 + s * NB
    ...``, per-slot positions spread over the capacity (W=1)."""
    g = torch.Generator().manual_seed(int(seed))
    S = int(slots)
    nblk = 1 + S * NB

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    q = rand(S, 1, n_head, d_head)
    pool_k = rand(nblk, B, n_head, d_head)
    pool_v = rand(nblk, B, n_head, d_head)
    table = (1 + torch.arange(S * NB, dtype=torch.int32)).reshape(
        S, NB).to(device)
    pos = torch.randint(0, NB * B, (S, 1), generator=g,
                        dtype=torch.int32).to(device)
    return q, pool_k, pool_v, table, pos


def _time_call(fn, device, repeats, calls=50):
    """Seconds a call of ``fn``, median of ``repeats``.  On the card, the
    device time of ``calls`` queued calls over CUDA events, with a sleep
    kernel holding the stream while the host enqueues them, so the events
    bracket the kernels and not the Python between launches; on the CPU,
    the host clock of one call."""
    walls = []
    for _ in range(max(1, int(repeats))):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            e0.record()
            for _ in range(calls):
                fn()
            e1.record()
            e1.synchronize()
            walls.append(e0.elapsed_time(e1) / 1e3 / calls)
        else:
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def tune_paged_attention(n_head, d_head, max_len, block_tokens,
                         dtype="float32", slots=8, max_measure=8,
                         repeats=3, force=False, mode=None, seed=0,
                         device=None, inputs=None, backends=None):
    """Search (or serve from cache) the split kernel's split count for one
    kernel call (``op=paged_attention``, keyed on the slot capacity ``T =
    NB * block_tokens`` and the call's ``(slots, window, block_tokens)``:
    ``slots`` rows of a one-token query, the decode chunk's call).  Each
    candidate (``space.paged_attention_candidates``) runs
    ``paged_attention(..., splits=n)`` on a synthetic ragged pool
    (``inputs=(q, pool_k, pool_v, table, pos)`` overrides it, and its
    shapes then key the entry), is held against
    ``paged_attention_split_ref`` at the same count within
    ``oracle_tol`` — a candidate outside it raises, since it is a kernel
    fault — and timed median-of-``repeats``; the winner's ``{"splits"}``
    persists and ``ServingEngine`` reads it once per engine for the call
    it was measured at.  ``backends`` adds the kernel registry's
    dimension (``space.paged_attention_candidates``): a backend candidate
    runs that backend's call (held against the plain block scan when it
    carries no split count), one unavailable here is recorded with the
    registry's reason and skipped, and the winner's ``backend`` persists
    beside its count."""
    from ..core.place import resolve_device
    from ..kernels import registry
    from ..kernels.paged_attention import (
        oracle_tol, paged_attention, paged_attention_ref,
        paged_attention_split_ref)
    from ..models.transformer import as_torch_dtype
    from . import tune_mode

    device = resolve_device(device)
    tdt = as_torch_dtype(dtype)
    B = int(block_tokens)
    NB = max(1, int(max_len) // B)
    S, W = (int(slots), 1) if inputs is None else inputs[0].shape[:2]
    key = WorkloadKey("paged_attention", NB * B, d_head, n_head, tdt,
                      device_platform(device), remat="-", call=(S, W, B))
    report, cache = _lookup(key, mode or tune_mode(), force)
    if report["source"] is not None:
        return report
    if inputs is None:
        inputs = _paged_inputs(n_head, d_head, S, NB, B, tdt, device, seed)
    cands = paged_attention_candidates(NB, S, n_head, backends=backends)
    report["candidates"] = len(cands)
    if max_measure and len(cands) > max_measure:
        report["truncated_to"] = max_measure
        cands = cands[:max_measure]
    tol = oracle_tol(tdt)
    tracer = _trace.get_tracer()
    measured = []
    for i, cand in enumerate(cands):
        n = cand["splits"]
        call = paged_attention
        if cand.get("backend"):
            try:
                call = registry.resolve("paged_attention", cand["backend"],
                                        device.type).impl.call
            except registry.KernelUnavailable as e:
                measured.append(dict(cand, verdict="unavailable",
                                     reason=e.reason))
                continue
        with tracer.span("tune.search", cat="tune", key=key.s,
                         candidate=i, **cand) as sp:
            got = call(*inputs, splits=n)
            want = (paged_attention_ref(*inputs) if n is None
                    else paged_attention_split_ref(*inputs, n))
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max().clamp_min(1e-30))
            if not err <= tol:
                raise RuntimeError(
                    f"paged_attention at splits={n} ({cand.get('backend')}"
                    f"): relative error {err:.3e} against its plain "
                    f"version exceeds oracle_tol {tol}")
            median_s = _time_call(lambda: call(*inputs, splits=n), device,
                                  repeats)
            _counter("tune.candidates_measured",
                     "schedule candidates built and timed").inc()
            rec = dict(cand, verdict="measured", median_s=median_s,
                       rel_err=err)
            measured.append(rec)
            sp.set(verdict="measured", median_s=median_s)
    report["measured"] = measured
    timed = [m for m in measured if m["verdict"] == "measured"]
    if not timed:
        report["source"] = "exhausted"
        return report
    win = min(timed, key=lambda m: m["median_s"])
    meas = {"median_s": win["median_s"],
            "worst_median_s": max(m["median_s"] for m in timed),
            "measured_candidates": len(timed)}
    config = {k: win[k] for k in ("splits", "backend")
              if win.get(k) is not None}
    entry = cache.put(key.s, config, measured=meas)
    cache.save()
    tracer.instant("tune.winner", cat="tune", key=key.s, **config)
    report.update(entry=entry, source="search")
    return report


def flagship_static_demo(seq_len=16384, budget_bytes=None, batch=None,
                         device=None):
    """Statically prune the flagship schedule space against a memory
    budget (the caller's, else ``BENCH_HBM_BUDGET_GIB``, else the card's
    memory) and report which configs die and which survives —
    ``gpt_t16k_*`` keys, every figure the analytic estimate.  No step
    runs.  As in the JAX package, the t=16k rounds run global batch 6."""
    dims = flagship_dims()
    if batch is not None:
        dims["batch"] = int(batch)
    elif seq_len >= 16384:
        dims["batch"] = 6
    if budget_bytes is None and os.environ.get("BENCH_HBM_BUDGET_GIB"):
        budget_bytes = int(float(os.environ["BENCH_HBM_BUDGET_GIB"])
                           * (1 << 30))
    if budget_bytes is None:
        from ..core.place import resolve_device

        budget_bytes = device_budget(resolve_device(device))
    if not budget_bytes:
        raise ValueError("flagship_static_demo needs a budget on the CPU: "
                         "pass budget_bytes or set BENCH_HBM_BUDGET_GIB")
    d_head = dims["d_model"] // dims["n_head"]
    cands = schedule_candidates(
        seq_len, d_head, dims["n_head"], block_caps=(256, 512, 1024),
        policies=POLICY_ORDER, accums=(1, 2))
    hbm_model = lambda c: estimate_gpt_step_hbm(  # noqa: E731
        dims["n_layer"], dims["d_model"], dims["n_head"], dims["vocab"],
        seq_len, dims["batch"], policy=c.get("policy"),
        accum=c.get("accum", 1))
    survivors, pruned = prune_static(
        seq_len, d_head, dims["n_head"], cands,
        hbm_budget=budget_bytes, hbm_model=hbm_model)
    out = {
        "gpt_t16k_candidates": len(cands),
        "gpt_t16k_pruned_static": len(pruned),
        "gpt_t16k_survivors": len(survivors),
        "gpt_t16k_static_only": True,
        "gpt_t16k_budget_gib": round(budget_bytes / (1 << 30), 2),
    }
    r05 = [(c, r) for c, r in pruned
           if c.get("policy") == "offload" and c.get("accum", 1) == 1
           and c["block_q"] == 1024]
    if r05:
        out["gpt_t16k_rejected_r05_config"] = (
            f"offload accum=1 blocks=1024: {r05[0][1]}")
    if survivors:
        survivors.sort(key=lambda c: (
            POLICY_ORDER.index(c.get("policy") or "none"),
            c.get("accum", 1), c.get("roofline", 9.9), -c["block_q"]))
        room = [c for c in survivors
                if c.get("hbm_est_bytes", 0) <= 0.85 * budget_bytes]
        sel = (room or survivors)[0]
        out.update({
            "gpt_t16k_selected_policy": sel.get("policy"),
            "gpt_t16k_selected_accum": sel.get("accum", 1),
            "gpt_t16k_selected_block_q": sel["block_q"],
            "gpt_t16k_selected_block_k": sel["block_k"],
            "gpt_t16k_selected_est_hbm_gib": round(
                sel.get("hbm_est_bytes", 0) / (1 << 30), 2),
        })
    return out

"""paddle_tpu_torch.tune — the autotuning engine, the port's counterpart of
``paddle_tpu.tune``.

The performance knobs that decide how a configuration runs on the card
are MEASURED per workload key ``(op, seq_len, d_head, n_heads, dtype,
platform, remat)``:

- ``tune_gpt_step`` sweeps the schedule space (attention ``block_k`` —
  the fused or split backward route —, packed routing, the remat policy,
  gradient accumulation), prunes statically, rejects candidates over the
  memory budget (the estimate before a run, an out-of-memory warm-up on
  the card), times the rest median-of-k and persists the winner in the
  on-disk cache (``PADDLE_TPU_TUNE_CACHE`` or
  ``~/.cache/paddle_tpu_torch/tuned.json``, never the JAX package's);
- ``tune_serving_decode`` / ``tune_spec_decode`` / ``tune_paged_attention``
  measure the serving engine's decode chunk and prefill bucket, the
  speculative window, and the paged-attention split count;
- the hot path consults the cache: ``layers.multi_head_attention`` takes
  the tuned geometry when the caller passes none,
  ``memory_optimize(policy="auto")`` the tuned policy, ``ServingEngine``
  its chunk, bucket and window when given none, and the split count of
  the one kernel call it was measured at (the decode chunk's).  Explicit
  arguments and environment knobs always win.

Modes (``PADDLE_TPU_TUNE``): ``off``/``0`` — kill switch, the port runs
bit for bit as with no tuner; ``cached`` (default) — lookups only, a miss
keeps the JAX package's defaults and never searches; ``search`` — a miss
runs the measured search.  Lookups count ``tune.cache_hits`` /
``tune.cache_misses`` / ``tune.searches`` in the metrics registry, and
``Executor.last_step_cost["tune"]`` carries them.

The JAX package's TPU-only knobs (``DIAG_W``, the VMEM budget, Mosaic
compile checks) are left out (``tune.space``); the kernel-registry
``backend`` is a dimension (``backends=``), a candidate measured under
``kernels.forced_backend``.  CI: ``python -m paddle_tpu_torch --tune-selftest``.
"""

import contextlib
import os

from ..observability import metrics as _obs
from .cache import (
    CACHE_SCHEMA_VERSION, TuneCache, cache_path, device_platform,
    geometry_fingerprint, get_cache, reset_cache)
from .costmodel import (
    COSTMODEL_SCHEMA_VERSION, CostModel, costmodel_enabled,
    costmodel_path, fit_and_save, fit_cost_model, get_model,
    model_status, reset_model)
from .space import (
    POLICY_ORDER, WorkloadKey, attention_candidates,
    estimate_gpt_step_hbm, paged_attention_candidates, prune_static,
    schedule_candidates, serving_candidates, spec_candidates)
from .search import (
    PreflightRejected, flagship_dims, flagship_static_demo,
    tune_gpt_step, tune_paged_attention, tune_serving_decode,
    tune_spec_decode)

__all__ = [
    "CACHE_SCHEMA_VERSION", "TuneCache", "cache_path", "device_platform",
    "geometry_fingerprint", "get_cache", "reset_cache",
    "POLICY_ORDER", "WorkloadKey", "attention_candidates",
    "estimate_gpt_step_hbm", "paged_attention_candidates",
    "prune_static", "schedule_candidates",
    "serving_candidates", "spec_candidates", "PreflightRejected",
    "flagship_dims", "flagship_static_demo", "tune_gpt_step",
    "tune_paged_attention", "tune_serving_decode", "tune_spec_decode",
    "tune_mode", "attention_config", "schedule_config_for",
    "serving_decode_config", "spec_decode_config",
    "paged_attention_config", "program_schedule_config",
    "forced_attention_config", "tune_stats",
    "COSTMODEL_SCHEMA_VERSION", "CostModel", "costmodel_enabled",
    "costmodel_path", "fit_and_save", "fit_cost_model", "get_model",
    "model_status", "reset_model",
]


def tune_mode():
    """The ``PADDLE_TPU_TUNE`` mode: "off" | "cached" | "search" (default
    "cached").  "0" / "off" / "false" is the kill switch: no lookup
    happens and every knob keeps its default."""
    v = os.environ.get("PADDLE_TPU_TUNE", "cached").strip().lower()
    if v in ("0", "off", "false", "no", ""):
        return "off"
    if v == "search":
        return "search"
    return "cached"


# a forced config consulted before the cache (the search and the tests)
_FORCED = []


@contextlib.contextmanager
def forced_attention_config(cfg):
    """Force :func:`attention_config` to return ``cfg`` inside the
    context — how tests pin the hot path without a cache file."""
    _FORCED.append(dict(cfg) if cfg else None)
    try:
        yield
    finally:
        _FORCED.pop()


def _cache_lookup(op, seq_len, d_head, n_head, dtype, remat, device=None,
                  call=None):
    """Counted cache lookup shared by every hot-path entry point: the
    tuned config dict or None.  With the kill switch set or an empty
    cache it does nothing (no key, no count); otherwise a hit or a miss
    counts ``tune.cache_hits`` / ``tune.cache_misses``.  ``device`` is the
    device the workload runs on (default: the card when one is usable);
    ``call`` the key's ``(slots, window, block_tokens)`` field."""
    if tune_mode() == "off":
        return None
    cache = get_cache()
    if not cache.entries:
        return None
    reg = _obs.get_registry()
    key = WorkloadKey(op, seq_len, d_head, n_head, dtype,
                      device_platform(device), remat=remat, call=call)
    entry = cache.get(key.s)
    if entry is None:
        reg.counter("tune.cache_misses",
                    help="tuned-config cache lookups missed").inc()
        return None
    reg.counter("tune.cache_hits",
                help="tuned-config cache lookups served").inc()
    return dict(entry.get("config") or {}) or None


def attention_config(seq_len, d_head, n_head, dtype, causal=True):
    """Hot-path lookup for ``layers.multi_head_attention``: the tuned
    geometry ``{"block_q", "block_k", "packed"}`` for one causal
    self-attention shape, or None (the caller keeps its defaults)."""
    if _FORCED:
        return _FORCED[-1]
    if not causal or seq_len is None or int(seq_len) <= 0:
        return None
    return _cache_lookup("flash", seq_len, d_head, n_head, dtype,
                         remat="-")


def schedule_config_for(seq_len, d_head, n_head, dtype):
    """The tuned step schedule ``{"policy", "accum", "block_q", ...}``
    for one GPT shape, or None — read by ``memory_optimize(policy=
    "auto")``."""
    return _cache_lookup("gpt_step", seq_len, d_head, n_head, dtype,
                         remat="auto")


def serving_decode_config(max_len, d_head, n_head, dtype, device=None):
    """Hot-path lookup for ``ServingEngine``: the tuned ``{"chunk",
    "min_bucket"}`` for one serving shape (keyed on ``max_len``), or
    None.  The engine asks only when given no geometry."""
    if max_len is None or int(max_len) <= 0:
        return None
    return _cache_lookup("serving_decode", max_len, d_head, n_head,
                         dtype, remat="-", device=device)


def paged_attention_config(seq_len, d_head, n_head, dtype, slots,
                           block_tokens, window=1, device=None):
    """Lookup for the paged-attention split count: the tuned ``{"splits"}``
    for one kernel call — slot capacity ``T = NB * block_tokens``,
    ``slots`` rows of a ``window``-token query — or None
    (``paged_splits``' rule applies).  ``ServingEngine`` asks once, at
    construction, for its decode chunk's call, never per decode step."""
    if seq_len is None or int(seq_len) <= 0:
        return None
    return _cache_lookup("paged_attention", seq_len, d_head, n_head,
                         dtype, remat="-", device=device,
                         call=(slots, window, block_tokens))


def spec_decode_config(max_len, d_head, n_head, dtype, device=None):
    """Hot-path lookup for ``ServingEngine``'s speculative window: the
    tuned ``{"k"}``, or None.  The engine asks only when given a draft
    but no ``spec_k``."""
    if max_len is None or int(max_len) <= 0:
        return None
    return _cache_lookup("spec_decode", max_len, d_head, n_head,
                         dtype, remat="-", device=device)


def program_schedule_config(program):
    """The tuned schedule for a built Program, located by its flash
    attention op (shape and dtype read off the op's Q var) — the
    ``memory_optimize(policy="auto")`` entry point.  None when the
    program has no flash op, the switch is off, or the cache misses."""
    if tune_mode() == "off":
        return None
    block = program.global_block()
    for op in block.ops:
        if op.type not in ("flash_attention_packed", "flash_attention"):
            continue
        q_names = op.inputs.get("Q") or []
        var = block._find_var(q_names[0]) if q_names else None
        if var is None or len(var.shape) < 3:
            continue
        t = int(var.shape[1])
        if t <= 0:
            continue
        if op.type == "flash_attention_packed":
            n_head = int(op.attrs.get("n_head") or 0)
            if not n_head:
                continue
            d_head = int(var.shape[2]) // n_head
        else:
            n_head, d_head = int(var.shape[2]), int(var.shape[3])
        return schedule_config_for(t, d_head, n_head, var.dtype)
    return None


def tune_stats():
    """Registry snapshot for ``Executor.last_step_cost["tune"]``: None
    when no tune traffic happened in this process."""
    reg = _obs.get_registry()
    hits = int(reg.value("tune.cache_hits"))
    misses = int(reg.value("tune.cache_misses"))
    searches = int(reg.value("tune.searches"))
    if not (hits or misses or searches):
        return None
    return {"mode": tune_mode(), "cache_hits": hits,
            "cache_misses": misses, "searches": searches}

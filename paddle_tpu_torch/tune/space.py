"""Candidate space and STATIC pruning for the port's autotune engine —
the counterpart of ``paddle_tpu/tune/space.py``.

Tunable workload kinds (``op=`` of the workload key):

- ``flash`` — attention geometry for one shape: ``block_k``, which picks
  the backward route (fused or split, ``kernels.flash_attention.
  bwd_route``), the packed-vs-4-D head routing (``packed_sub_heads``),
  and ``block_q``, which the op records for its signature;
- ``gpt_step`` — the whole training-step schedule: that geometry plus the
  remat policy and the gradient-accumulation factor;
- ``serving_decode`` (decode chunk, smallest prefill bucket),
  ``spec_decode`` (the draft window ``k``) and ``paged_attention`` (the
  split kernel's split count).

Knobs the JAX package tunes that exist only for its TPU kernels are left
out: the ``DIAG_W`` causal sub-tile width and the scoped-VMEM fit of a
block pair.  The kernel-registry ``backend`` is a dimension as in the
JAX package (``backends=``: ``cuda``, ``triton``, ``torch_ref``); a
candidate carrying one is measured under ``kernels.forced_backend``.
The sm90 kernels' tiles are compile-time constants, so the roofline
counts the same schedule for every block size.

Pruning order (cheapest test first):

1. geometry validity — the blocks tile ``t``;
2. roofline sanity via ``causal_flash_flops`` (the port's count of the
   sm90 tiles the causal kernels compute), or the fitted cost model's
   milliseconds when one is loaded (``tune.costmodel``);
3. HBM — ``estimate_gpt_step_hbm`` against a budget: the caller's, else
   the card's ``total_memory``.  The search applies the same estimate
   again before each measurement, and a candidate whose warm-up step
   runs out of memory on the card is rejected there.
"""

from ..kernels.flash_attention import (_pick_block, causal_flash_flops,
                                       packed_sub_heads)
from ..kernels.paged_attention import paged_splits, split_entries

__all__ = [
    "WorkloadKey", "attention_candidates", "schedule_candidates",
    "serving_candidates", "spec_candidates", "paged_attention_candidates",
    "prune_static", "estimate_gpt_step_hbm", "POLICY_ORDER",
    "device_budget",
]

# remat policies from cheapest recompute to most; "none" = no
# memory_optimize marking at all (autograd keeps every activation)
POLICY_ORDER = ("none", "selective", "offload", "compact", "full")

# per-token-per-layer SAVED activation floats, in units of d_model, and
# one layer's live working set — the JAX package's coefficients, copied
# unchanged.  They were calibrated on its TPU readings (t=16k, a 16 GiB
# chip), not on the card; phase 18b of chip_smoke.py prints the card's
# measured peak beside this estimate.
_ACT_FLOATS_PER_TOKEN_LAYER = {
    "none": 13.0, "selective": 10.0, "offload": 8.0,
    "compact": 3.0, "full": 1.5,
}
_LIVE_LAYER_FLOATS_PER_TOKEN = 16.0


def _check_backends(backends):
    """The backend dimension takes the kernel registry's names."""
    from ..kernels.registry import BACKENDS

    bad = [b for b in backends or () if str(b) not in BACKENDS]
    if bad:
        raise ValueError(f"unknown kernel backend(s) {bad} (valid: "
                         f"{', '.join(BACKENDS)})")


def _canon_dtype(dtype):
    """Canonical dtype string for the workload key ('bfloat16',
    'float32', ...) from a string, numpy or torch dtype, or a Program
    var's dtype."""
    s = getattr(dtype, "name", None) or str(dtype)
    return s.split(".")[-1]


class WorkloadKey:
    """The identity a tuned config is valid for:
    ``(op, seq_len, d_head, n_heads, dtype, platform, remat[, backend]
    [, call])``, with the JAX package's canonical string ``.s`` for the
    same fields.  ``platform`` is ``"gpu"`` on the card and ``"cpu"`` on
    the CPU.  ``call`` (the port's own field, ``op=paged_attention``
    only) is the kernel call's ``(slots, window, block_tokens)``: the best
    split count depends on ``slots * n_heads`` and the split family takes
    only some windows and block sizes, so a count holds only for the call
    it was measured at."""

    __slots__ = ("op", "seq_len", "d_head", "n_heads", "dtype",
                 "platform", "remat", "backend", "call")

    def __init__(self, op, seq_len, d_head, n_heads, dtype,
                 platform, remat="auto", backend=None, call=None):
        self.op = str(op)
        self.seq_len = int(seq_len)
        self.d_head = int(d_head)
        self.n_heads = int(n_heads)
        self.dtype = _canon_dtype(dtype)
        self.platform = str(platform)
        self.remat = str(remat)
        self.backend = None if backend is None else str(backend)
        self.call = None if call is None else tuple(int(v) for v in call)

    @property
    def s(self):
        base = (f"op={self.op}|t={self.seq_len}|dh={self.d_head}"
                f"|h={self.n_heads}|dt={self.dtype}|plat={self.platform}"
                f"|remat={self.remat}")
        if self.backend:
            base += f"|kb={self.backend}"
        if self.call:
            base += "|slots={}|w={}|bt={}".format(*self.call)
        return base

    def __repr__(self):
        return f"WorkloadKey({self.s})"

    def __eq__(self, other):
        return isinstance(other, WorkloadKey) and self.s == other.s

    def __hash__(self):
        return hash(self.s)


def _block_choices(seq_len, caps=None):
    """Distinct exact block sizes for a sequence length: each cap maps
    through ``_pick_block`` (largest divisor <= cap)."""
    caps = caps or (256, 512, 1024, 2048)
    return sorted({_pick_block(seq_len, int(c)) for c in caps})


def attention_candidates(seq_len, d_head, n_head, block_caps=None,
                         include_packed=True, backends=None,
                         block_q_caps=None):
    """The attention-geometry candidate list for one shape:
    ``{"block_q", "block_k", "packed"}`` dicts — the JAX package's cross
    product without its ``diag_w``.  ``block_q_caps`` (default
    ``block_caps``) narrows ``block_q``, which changes nothing the card
    runs: a search that passes one value measures the ``block_k`` routes
    alone.

    ``backends`` adds the kernel-registry choice as a dimension, each
    candidate carrying ``"backend"``: ``cuda`` takes the geometry above;
    ``triton`` blocks clamped to its ``MAX_BLOCK`` of 128 (deduplicated)
    and no ``packed`` (a view there, as the reference ignores it); any
    other backend (``torch_ref``) one candidate with the default blocks.
    None keeps the list without the key (resolution left to env and
    auto)."""
    _check_backends(backends)
    packs = [None]
    if include_packed and packed_sub_heads(n_head, d_head) is not None:
        packs = [True, False]
    geo = []
    for bq in _block_choices(seq_len, block_q_caps or block_caps):
        for bk in _block_choices(seq_len, block_caps):
            for p in packs:
                geo.append({"block_q": bq, "block_k": bk, "packed": p})
    if not backends:
        return geo
    out = []
    for b in backends:
        b = str(b)
        if b == "cuda":
            out.extend(dict(g, backend=b) for g in geo)
        elif b == "triton":
            from ..kernels.triton_attention import MAX_BLOCK

            clamp = lambda caps: tuple(  # noqa: E731
                min(int(c), MAX_BLOCK)
                for c in (caps or (256, 512, 1024, 2048)))
            for bq in _block_choices(seq_len,
                                     clamp(block_q_caps or block_caps)):
                for bk in _block_choices(seq_len, clamp(block_caps)):
                    out.append({"block_q": bq, "block_k": bk,
                                "packed": None, "backend": b})
        else:
            out.append({"block_q": _pick_block(seq_len, 1024),
                        "block_k": _pick_block(seq_len, 1024),
                        "packed": None, "backend": b})
    return out


def schedule_candidates(seq_len, d_head, n_head, block_caps=None,
                        policies=POLICY_ORDER, accums=(1, 2),
                        fsdp_opts=(None,), backends=None,
                        block_q_caps=None):
    """The step-schedule candidate list: geometry x remat policy x
    gradient-accumulation factor (x FSDP gather-vs-replicate when
    ``fsdp_opts=(False, True)``; ``None`` leaves the key off)."""
    out = []
    for geo in attention_candidates(seq_len, d_head, n_head,
                                    block_caps=block_caps,
                                    include_packed=False,
                                    backends=backends,
                                    block_q_caps=block_q_caps):
        for pol in policies:
            for acc in accums:
                for fs in fsdp_opts:
                    c = dict(geo)
                    c["policy"] = pol
                    c["accum"] = int(acc)
                    if fs is not None:
                        c["fsdp"] = bool(fs)
                    out.append(c)
    return out


def serving_candidates(max_len, chunks=(2, 4, 8, 16, 32),
                       min_buckets=(4, 8, 16)):
    """The ``op="serving_decode"`` candidate list: decode chunk x smallest
    prefill bucket, ``{"chunk", "min_bucket"}`` dicts; a chunk or bucket
    beyond ``max_len`` is pruned."""
    out = []
    for c in chunks:
        if not 1 <= int(c) <= max_len:
            continue
        for b in min_buckets:
            if 1 <= int(b) <= max_len:
                out.append({"chunk": int(c), "min_bucket": int(b)})
    return out


def paged_attention_candidates(num_table_blocks, slots=None, n_head=None,
                               backends=None):
    """The ``op="paged_attention"`` candidate list: ``{"splits": n}`` for
    1, the powers of two up to ``NB``, and ``paged_splits``' own count
    (given ``slots`` and ``n_head``), each as the count of runs the split
    kernel launches (``split_entries``), deduplicated.  The JAX package's
    ``block_step`` (its XLA scan) has no counterpart here.  ``backends``
    adds the registry's dimension: ``cuda`` takes the split counts, each
    other backend one candidate ``{"splits": None, "backend": b}`` (the
    Triton kernel and the plain scan fix their own iteration)."""
    _check_backends(backends)
    nb = max(1, int(num_table_blocks))
    want = [1]
    p = 2
    while p <= nb:
        want.append(p)
        p *= 2
    if slots is not None and n_head is not None:
        want.append(paged_splits(int(slots), int(n_head), nb)[0])
    counts = [{"splits": n}
              for n in sorted({split_entries(nb, w)[0] for w in want})]
    if not backends:
        return counts
    out = []
    for b in backends:
        if str(b) == "cuda":
            out.extend(dict(c, backend="cuda") for c in counts)
        else:
            out.append({"splits": None, "backend": str(b)})
    return out


def spec_candidates(max_len, ks=(1, 2, 3, 4, 6, 8)):
    """The ``op="spec_decode"`` candidate list: the draft window ``k``
    (``{"k"}`` dicts); a window of ``max_len`` or more is pruned."""
    return [{"k": int(k)} for k in ks if 1 <= int(k) < max_len]


def estimate_gpt_step_hbm(n_layer, d_model, n_head, vocab, seq_len,
                          batch, policy="selective", accum=1,
                          dtype_size=2):
    """Analytic device-memory high-water bound (bytes) for one GPT
    training step — the JAX package's arithmetic exactly: bf16 weights,
    f32 embedding masters, f32 Adam moments, the f32 gradient buffer, the
    policy's saved activations for one microbatch and one layer's live
    working set, scaled by the fitted cost model's ``hbm_scale`` (exactly
    1.0 with no model file or ``PADDLE_TPU_COSTMODEL=0``).  The
    coefficients are TPU calibrations (``_ACT_FLOATS_PER_TOKEN_LAYER``)."""
    policy = policy or "none"
    if policy not in _ACT_FLOATS_PER_TOKEN_LAYER:
        raise ValueError(f"unknown policy {policy!r}")
    p_block = 12 * d_model * d_model * n_layer  # qkv+out + 2x(d<->4d)
    p_head = vocab * d_model
    p_embed = vocab * d_model + seq_len * d_model
    params = (p_block + p_head) * dtype_size + p_embed * 4
    n_elems = p_block + p_head + p_embed
    opt_state = n_elems * 8          # two f32 Adam moments
    grads = n_elems * 4              # f32 accumulated gradient
    mb = max(1, batch // max(1, int(accum)))
    saved = (_ACT_FLOATS_PER_TOKEN_LAYER[policy]
             * d_model * n_layer * mb * seq_len * dtype_size)
    live_layer = (_LIVE_LAYER_FLOATS_PER_TOKEN
                  * d_model * mb * seq_len * dtype_size)
    est = int(params + opt_state + grads + saved + live_layer)
    from .costmodel import hbm_scale_for

    scale = hbm_scale_for()
    if scale != 1.0:
        est = int(est * scale)
    return est


def device_budget(device=None):
    """The HBM budget a prune checks when the caller gives none: the
    card's ``total_memory``, or None on the CPU (no bound)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def prune_static(seq_len, d_head, n_head, candidates, roofline_slack=1.20,
                 hbm_budget=None, hbm_model=None, device=None):
    """Static pruning pass: returns ``(survivors, pruned)``; each survivor
    gains ``roofline`` (scheduled / useful flops) and, under an HBM
    check, ``hbm_est_bytes``; each pruned entry is ``(candidate,
    reason)``.  The HBM check runs when ``hbm_model(cand)`` is given,
    against ``hbm_budget`` or else :func:`device_budget`."""
    from . import costmodel as _cm

    if hbm_model is not None and not hbm_budget:
        hbm_budget = device_budget(device)
    # the sm90 tiles are fixed, so every geometry schedules the same
    # flops: the roofline orders nothing until the tiles are a dimension
    sched, useful = causal_flash_flops(seq_len, seq_len, d_head)
    scored, pruned = [], []
    for c in candidates:
        if seq_len % c["block_q"] or seq_len % c["block_k"]:
            pruned.append((c, "blocks do not tile t"))
            continue
        c = dict(c, roofline=round(sched / max(useful, 1), 4))
        scored.append((sched, c))
    if not scored:
        return [], pruned
    best = min(s for s, _ in scored)
    cm_entry = _cm.active_entry()
    if cm_entry is not None:
        cost_of = lambda s: _cm.predict_sched_ms(cm_entry, s)  # noqa: E731
    else:
        cost_of = float
    best_cost = cost_of(best)
    survivors = []
    for sched, c in scored:
        if cost_of(sched) > best_cost * roofline_slack:
            what = ("calibrated roofline" if cm_entry is not None
                    else "roofline")
            pruned.append(
                (c, f"{what}: schedules {sched / best:.2f}x the best "
                    f"candidate's flops"))
            continue
        if hbm_budget and hbm_model is not None:
            est = hbm_model(c)
            if est > hbm_budget:
                pruned.append(
                    (c, f"hbm estimate {est / (1 << 30):.1f} GiB > "
                        f"budget {hbm_budget / (1 << 30):.1f} GiB"))
                continue
            c = dict(c, hbm_est_bytes=int(est))
        survivors.append(c)
    return survivors, pruned

"""Per-op performance attribution — which op classes own the
milliseconds of a step.  The port's counterpart of
``paddle_tpu/observability/attribution.py``, with its public contract:
``SCHEMA_VERSION``, the class names, the table's keys, the workload-key
format and the pure functions (``program_workload_key``,
``normalize_workload_key``, ``summarize``, ``share_table``,
``reconcile``, the fitted-cost-model path).

The reference walks the compiled executable's optimized HLO.  An eager
step has none, so the port walks the lowered step's **op records**
(``analysis.jaxpr_tools.step_records``: every op of the differentiated
forward and the optimizer, a control-flow op's sub-block for its trips,
with the shapes and dtypes of the run's batch — the records
``core.executor.step_flops`` counts) into the same per-op-CLASS table:

* ``pallas``            — the port's hand-written kernels: the flash
  attention ops, the fused CE head (and, on a profile, the paged
  attention, decode gather and bottleneck kernels);
* ``matmul``            — ``mul`` / ``matmul`` / ``conv2d`` and the
  recurrent ops' and ``sequence_conv``'s products;
* ``collective.<kind>`` — a mesh step's collectives, one class per kind,
  from its collective log;
* ``elementwise``       — pointwise ops, activations, optimizer updates;
* ``reduce``            — reductions, softmax, the norms, pooling, losses;
* ``other``             — data movement and everything unclassified.

Each class row carries ``flops`` (products exact from the recorded
shapes, with the backward's products where an operand takes a gradient —
the formulas of the ops' ``flops`` hooks, written out again here so the
two counts check each other; one flop per output element for pointwise
work, one per input element for a reduction), ``transcendentals`` in
their own column, ``bytes`` at op boundaries (each op's inputs read and
outputs written; the backward of a differentiated op reads its output's
gradient and its inputs and writes its inputs' gradients; a view moves
nothing), the recompute a checkpointed region adds (``recompute_flops``),
a roofline ``est_ms = max(flops / peak, bytes / HBM_BW)`` (or the fitted
cost model's estimate) and the ``share`` of the estimated step.
``coverage`` is the table's product flops (``pallas`` + ``matmul``, the
recompute left out) over ``step_flops``, the Executor's ``flops``: 1.0
where every product has a hook (``step_flops`` counts no convolution, so
a conv net reads above 1).

The Executor computes this table at the first run of every lowered step
at each batch (``exe.last_attribution``, kill switch ``PADDLE_TPU_ATTR=0``)
and folds :func:`summarize` into ``last_step_cost["attribution"]``.  On
the card, :func:`attribute_profile` puts a profiled step's CUDA kernel
time into the same classes, so the estimated and the measured shares
stand side by side; :func:`kernel_family` is the one kernel-name
classifier the package and ``chip_smoke.py`` share.
"""

import math
import os

from . import metrics as _obs

__all__ = [
    "SCHEMA_VERSION", "attribution_enabled", "attribute_step",
    "attribute_records", "summarize", "reconcile", "share_table",
    "program_workload_key", "normalize_workload_key", "KERNEL_FAMILIES",
    "kernel_family", "kernel_class", "kernel_table", "attribute_profile",
    "launched_families",
]

SCHEMA_VERSION = 1

# -- op classes -------------------------------------------------------------

_PALLAS_OPS = frozenset(("flash_attention", "flash_attention_packed",
                         "fused_softmax_ce_head"))
_PRODUCT_OPS = frozenset(("mul", "matmul", "conv2d", "lstm", "lstmp", "gru",
                          "gru_unit", "sequence_conv"))
_REDUCE_OPS = frozenset((
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "mean", "softmax", "log_softmax", "sequence_softmax", "layer_norm",
    "batch_norm", "lrn", "cross_entropy", "softmax_with_cross_entropy",
    "squared_l2_norm", "clip_by_norm", "pool2d", "sequence_pool",
    "accuracy", "top_k", "arg_max", "arg_min", "cos_sim", "auc",
    "linear_chain_crf", "crf_decoding", "warpctc", "multibox_loss",
    "edit_distance"))
_ELEMENTWISE_OPS = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "sum", "scale", "dropout", "cast", "clip", "abs",
    "ceil", "floor", "round", "sign", "square", "relu", "relu6", "brelu",
    "leaky_relu", "prelu", "elu", "hard_shrink", "softshrink",
    "thresholded_relu", "hard_sigmoid", "soft_relu", "softsign",
    "reciprocal", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "logical_and", "logical_or",
    "logical_not", "logical_xor", "isfinite", "error_clip", "increment",
    "scale_sub_region", "sequence_scale", "row_conv", "lstm_unit",
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
    "decayed_adagrad", "rmsprop", "ftrl", "proximal_gd",
    "proximal_adagrad"))
# pointwise ops whose output elements cost a transcendental each (the
# reference's cost analysis counts these apart from flops)
_TRANSCENDENTAL_OPS = frozenset((
    "exp", "log", "tanh", "sigmoid", "gelu", "sqrt", "pow", "softplus",
    "swish", "logsigmoid", "stanh", "tanh_shrink"))
# reductions with a transcendental per input element (the exp of a
# softmax, the log of a cross entropy)
_REDUCE_TRANSCENDENTAL = frozenset((
    "softmax", "log_softmax", "sequence_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "warpctc", "linear_chain_crf"))
# ops that move no data on the card (views and aliases)
_VIEW_OPS = frozenset(("reshape", "assign", "shape", "sequence_reshape",
                       "is_empty", "array_length"))


_CLASS_OF = {**dict.fromkeys(_ELEMENTWISE_OPS | _TRANSCENDENTAL_OPS,
                             "elementwise"),
             **dict.fromkeys(_REDUCE_OPS, "reduce"),
             **dict.fromkeys(_PRODUCT_OPS, "matmul"),
             **dict.fromkeys(_PALLAS_OPS, "pallas")}


def op_class(op_type):
    """The class a Program op's work attributes to."""
    return _CLASS_OF.get(op_type, "other")


def attribution_enabled():
    """``PADDLE_TPU_ATTR=0`` turns the table off entirely (the Executor
    then never touches ``last_attribution``)."""
    return os.environ.get("PADDLE_TPU_ATTR", "1").lower() not in (
        "0", "", "false", "off", "no")


# -- the product formulas ----------------------------------------------------

def _shape_of(rec, slot, i=0):
    names = rec.op.inputs.get(slot) or []
    if len(names) <= i:
        return None
    for n, s, _d in rec.ins:
        if n == names[i]:
            return s
    return None


def _takes(rec, slot):
    names = rec.op.inputs.get(slot) or []
    return int(bool(names) and names[0] in rec.grads)


def _product_flops(rec, train):
    """``(all, forward)``: the products of one record, forward and the
    backward's for each operand that takes a gradient (the flash ops: the
    model's products, ``2 + 4`` passes of ``2·b·h·pairs·d`` in training,
    not the backward's recompute of the scores), and the forward's
    alone."""
    t = rec.type
    if t == "mul":
        xs, ys = _shape_of(rec, "X"), _shape_of(rec, "Y")
        xc = int(rec.op.attrs.get("x_num_col_dims", 1))
        yc = int(rec.op.attrs.get("y_num_col_dims", 1))
        one = 2 * math.prod(xs[:xc]) * math.prod(xs[xc:]) * math.prod(
            ys[yc:])
        return one * (1 + _takes(rec, "Y") + _takes(rec, "X")), one
    if t == "matmul":
        xs, ys = list(_shape_of(rec, "X")), list(_shape_of(rec, "Y"))
        if rec.op.attrs.get("transpose_X"):
            xs = xs[:-2] + xs[-2:][::-1]
        if rec.op.attrs.get("transpose_Y") and len(ys) >= 2:
            ys = ys[:-2] + ys[-2:][::-1]
        lead = (math.prod(xs[:-2]) if len(xs) > len(ys)
                else math.prod(ys[:-2]))
        m = xs[-2] if len(xs) >= 2 else 1
        n = ys[-1] if len(ys) >= 2 else 1
        one = 2 * lead * m * n * xs[-1]
        return one * (1 + _takes(rec, "Y") + _takes(rec, "X")), one
    if t in ("flash_attention", "flash_attention_packed"):
        qs, ks = _shape_of(rec, "Q"), _shape_of(rec, "K")
        if t == "flash_attention":
            b, tq, h, d = qs
        else:
            h = int(rec.op.attrs["n_head"])
            b, tq, d = qs[0], qs[1], qs[2] // h
        tk = ks[1]
        pairs = tq * tk
        if rec.op.attrs.get("causal", False):
            pairs = tq * (tq + 1) // 2 if tq == tk else pairs // 2
        one = 2 * b * h * pairs * d
        return one * (2 + (4 if train else 0)), 2 * one
    if t == "fused_softmax_ce_head":
        xs, ws = _shape_of(rec, "X"), _shape_of(rec, "W")
        one = 2 * math.prod(xs[:-1]) * xs[-1] * ws[-1]
        return one * (1 + _takes(rec, "W") + _takes(rec, "X")), one
    if t in ("lstm", "lstmp", "gru"):
        b, tt = _shape_of(rec, "Input")[:2]
        total = fwd = 0
        for slot in ("Weight", "ProjWeight") if t == "lstmp" else (
                "Weight",):
            w = _shape_of(rec, slot)
            one = 2 * b * tt * w[0] * w[1]
            total += one * (1 + _takes(rec, slot) + _takes(rec, "Input"))
            fwd += one
        return total, fwd
    if t == "gru_unit":
        w = _shape_of(rec, "Weight")
        one = 2 * _shape_of(rec, "Input")[0] * w[0] * w[1]
        return (one * (1 + _takes(rec, "Weight")
                       + _takes(rec, "HiddenPrev")), one)
    if t == "sequence_conv":
        xs, fs = _shape_of(rec, "X"), _shape_of(rec, "Filter")
        one = 2 * xs[0] * xs[1] * fs[0] * fs[1]
        return one * (1 + _takes(rec, "Filter") + _takes(rec, "X")), one
    if t == "conv2d":
        fs = _shape_of(rec, "Filter")
        out = next((s for _n, s, _d in rec.outs if s), None)
        if not fs or not out:
            return 0, 0
        one = 2 * math.prod(out) * math.prod(fs[1:])
        return one * (1 + _takes(rec, "Filter") + _takes(rec, "Input")), one
    return 0, 0


def _sizes(values, known):
    """``(elements, bytes)`` of distinct ``(name, shape, dtype)`` values;
    ``known`` caches each value's pair."""
    n = b = 0
    names = set()
    for v in values:
        if v[1] is None or v[0] in names:
            continue
        names.add(v[0])
        kb = known.get(v)
        if kb is None:
            k = math.prod(v[1])
            kb = known[v] = (k, k * v[2].itemsize if v[2] is not None else 0)
        n += kb[0]
        b += kb[1]
    return n, b


def _record_costs(rec, train, known):
    """``(flops, transcendentals, bytes, ops, product_flops,
    recompute_flops)`` of one op record, all of its trips."""
    if rec.type in _VIEW_OPS:
        return 0, 0, 0, rec.times, 0, 0
    cls = op_class(rec.type)
    in_n, in_b = _sizes(rec.ins, known)
    out_n, out_b = _sizes(rec.outs, known)
    bwd = bool(rec.grads)
    grad_b = _sizes([v for v in rec.ins if v[0] in rec.grads],
                    known)[1] if bwd else 0
    trans = 0
    product = 0
    if cls in ("pallas", "matmul"):
        product, fwd_flops = _product_flops(rec, train)
        flops = product
    elif cls == "reduce":
        flops = in_n * (2 if bwd else 1)
        fwd_flops = in_n
        if rec.type in _REDUCE_TRANSCENDENTAL:
            trans = in_n
    elif rec.type in _TRANSCENDENTAL_OPS:
        flops = out_n if bwd else 0
        fwd_flops = 0
        trans = out_n
    elif cls == "elementwise":
        flops = out_n * (1 + len(rec.grads))
        fwd_flops = out_n
    else:
        flops = fwd_flops = 0
    nbytes = in_b + out_b + ((out_b + in_b + grad_b) if bwd else 0)
    ops = 1 + int(bwd)
    recompute = 0
    if rec.recompute:
        recompute = fwd_flops
        flops += fwd_flops
        nbytes += in_b + out_b
        ops += 1
    n = rec.times
    return (flops * n, trans * n, nbytes * n, ops * n, product * n,
            recompute * n)


# -- the table ----------------------------------------------------------------

def _row(classes, cls):
    return classes.setdefault(cls, {"ops": 0, "flops": 0,
                                    "transcendentals": 0, "bytes": 0,
                                    "recompute_flops": 0})


def attribute_records(records, comm_plan=None, peak_flops=None,
                      hbm_bw=None, platform=None):
    """Walk op records (and a mesh step's ``CommPlan``) into the per-class
    table: ``{"schema_version", "classes": {name: row}, "ops_total",
    "transcendentals_total", "bytes_total", "product_flops",
    "peak_flops", "hbm_bw", "hlo_flops_total", "est_ms_total",
    "costmodel"}``; each row ``{"ops", "flops", "transcendentals",
    "bytes", "recompute_flops", "est_ms", "bound", "share"}``."""
    train = any(r.phase == "forward" for r in records)
    classes = {}
    product_total = 0
    known = {}
    for rec in records:
        flops, trans, nbytes, ops, product, recompute = _record_costs(
            rec, train, known)
        row = _row(classes, op_class(rec.type))
        row["ops"] += ops
        row["flops"] += flops
        row["transcendentals"] += trans
        row["bytes"] += nbytes
        row["recompute_flops"] += recompute
        product_total += product
    for op in (comm_plan or ()):
        row = _row(classes, f"collective.{op.kind}")
        row["ops"] += 1
        row["bytes"] += op.bytes
    att = {
        "schema_version": SCHEMA_VERSION,
        "classes": classes,
        "ops_total": sum(r["ops"] for r in classes.values()),
        "transcendentals_total": sum(
            r["transcendentals"] for r in classes.values()),
        "bytes_total": sum(r["bytes"] for r in classes.values()),
        "product_flops": product_total,
        "peak_flops": peak_flops,
        "hbm_bw": hbm_bw,
        "platform": platform,
    }
    _finalize_roofline(att)
    return att


def _fitted_costmodel(platform=None):
    """``(entry, status)`` of the fitted cost model for ``platform``
    (``tune/costmodel.py``), or ``(None, {"mode": "analytic"})`` — None
    when the ``PADDLE_TPU_COSTMODEL=0`` kill switch is set, no fit covers
    this platform, or the model cannot be read.  A None entry means the
    analytic roofline in :func:`_finalize_roofline` runs exactly as
    before the learned model existed, bit-exact."""
    try:
        from ..tune import costmodel as _cm

        entry = _cm.active_entry(platform)
        if entry is None:
            return None, {"mode": "analytic"}
        return entry, _cm.model_status(platform)
    except Exception:  # noqa: BLE001 — the consult must never break a walk
        return None, {"mode": "analytic"}


def _finalize_roofline(att):
    """(Re)compute the per-class estimates, bound verdicts and shares plus
    the flop/est totals from the classes' flops/bytes.  With a FITTED
    cost model loadable (``tune/costmodel.py``) each class's estimate
    comes from the calibrated per-class coefficients instead of the
    analytic ``max(flops/peak, bytes/bw)``; the model status rides on
    ``att["costmodel"]`` either way."""
    classes = att["classes"]
    peak_flops, hbm_bw = att["peak_flops"], att["hbm_bw"]
    entry, status = _fitted_costmodel(att.get("platform"))
    att["costmodel"] = status
    if entry is not None:
        from ..tune import costmodel as _cm
    total_est = 0.0
    for cls, row in classes.items():
        if entry is not None:
            est_ms, compute_ms, mem_ms = _cm.predict_class_ms(
                entry, cls, row["flops"], row["bytes"], row["ops"])
            row["est_ms"] = est_ms
            row["bound"] = ("compute" if compute_ms >= mem_ms
                            else "memory")
            total_est += row["est_ms"]
            continue
        compute_s = row["flops"] / peak_flops if peak_flops else 0.0
        mem_s = row["bytes"] / hbm_bw if hbm_bw else 0.0
        row["est_ms"] = max(compute_s, mem_s) * 1e3
        row["bound"] = "compute" if compute_s >= mem_s else "memory"
        total_est += row["est_ms"]
    for row in classes.values():
        row["share"] = (round(row["est_ms"] / total_est, 4)
                        if total_est else 0.0)
        row["est_ms"] = round(row["est_ms"], 6)
    att["hlo_flops_total"] = sum(r["flops"] for r in classes.values())
    att["est_ms_total"] = round(total_est, 6)
    return att


def _machine_roofline(device):
    """(peak FLOP/s, memory bytes/s) of ``device`` — the roofline the
    per-class estimates are computed against (None for a card the
    hardware table does not name)."""
    from . import hardware as _hardware

    return (_hardware.device_peak_flops(device),
            _hardware.device_hbm_bandwidth(device))


def attribute_step(program, batch=1, flops=None, comm_plan=None,
                   device=None, records=None):
    """The full attribution record of one step of ``program``:
    :func:`attribute_records` over its op records at ``batch``
    (``step_records``, unless ``records`` already walked them), the
    ``coverage`` of its product flops against ``flops`` (the Executor's
    ``step_flops``) and the workload key.  ``device``: whose roofline
    (None: the card)."""
    import torch

    from ..analysis.jaxpr_tools import step_records
    from ..core.place import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if records is None:
        records = step_records(program, batch)
    peak, bw = _machine_roofline(dev)
    att = attribute_records(records, comm_plan, peak, bw,
                            platform="gpu" if dev.type == "cuda" else "cpu")
    att["cost_flops"] = flops
    att["coverage"] = (round(att["product_flops"] / flops, 4)
                       if flops else None)
    att["workload"] = program_workload_key(program, device=dev)
    reg = _obs.get_registry()
    reg.counter("attribution.tables",
                help="lowered steps walked into attribution tables").inc()
    if att["coverage"] is not None:
        reg.gauge(
            "attribution.coverage",
            help="attributed product flops / step_flops of the last "
                 "table").set(att["coverage"])
    return att


# -- the pure contract functions (the reference's, as they are) -------------

def program_workload_key(program, remat=None, device=None):
    """The tune-cache-style workload key string for a Program's step —
    located by its flash attention op exactly the way
    ``tune.program_schedule_config`` locates the schedule key, so an
    attribution corpus row and a tuner measurement of the same workload
    share one join key.  The platform is the device's (``gpu`` / ``cpu``,
    ``tune.cache.device_platform``); the key carries no ``|kb=`` kernel
    backend token until the port has a kernel registry (ROADMAP.md A6),
    so ``normalize_workload_key`` reads it as ``kb=unknown``.  None when
    the program has no flash op."""
    if program is None:
        return None
    try:
        from ..tune.cache import device_platform
        from ..tune.space import WorkloadKey
    except Exception:  # noqa: BLE001 — tune package unavailable
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
        pol = remat if remat is not None else (
            getattr(program, "_remat_policy", None) or "-")
        return WorkloadKey("step", t, d_head, n_head, var.dtype,
                           device_platform(device), remat=pol).s
    return None


def normalize_workload_key(key):
    """Canonicalize a workload-key string for corpus joins: keys that
    carry no ``|kb=`` backend token get ``|kb=unknown``, so mixed-vintage
    corpora join on one key shape.  Non-key strings and None pass through
    unchanged (None stays None)."""
    if not isinstance(key, str) or not key.startswith("op="):
        return key if key else None
    if "|kb=" in key:
        return key
    return key + "|kb=unknown"


def share_table(att):
    """``{class: share}`` of an attribution record (the compact form
    bench artifacts carry and ``bench_history`` diffs)."""
    if not isinstance(att, dict):
        return {}
    return {c: r.get("share") for c, r in (att.get("classes") or {}).items()
            if isinstance(r, dict) and isinstance(
                r.get("share"), (int, float))}


def summarize(att, top_n=3):
    """The compact summary folded into ``last_step_cost["attribution"]``
    (and thence trainer JSONL): the top-``top_n`` classes by estimated
    time plus the totals the reconciliation needs, the compact per-class
    ``[flops, bytes, ops, est_ms]`` table a corpus row fits on
    (``observability/corpus.py``), and the cost-model status (fitted vs
    analytic) the estimates were computed under."""
    if not att:
        return None
    rows = sorted(att.get("classes", {}).items(),
                  key=lambda kv: -(kv[1].get("est_ms") or 0))
    return {
        "top": [[c, r.get("share"), r.get("bound")]
                for c, r in rows[:top_n]],
        "est_ms_total": att.get("est_ms_total"),
        "coverage": att.get("coverage"),
        "workload": att.get("workload"),
        "classes": {c: [r.get("flops"), r.get("bytes"), r.get("ops"),
                        r.get("est_ms")]
                    for c, r in att.get("classes", {}).items()},
        "costmodel": att.get("costmodel"),
    }


def reconcile(att, measured_step_s):
    """Roofline-estimate vs measured step time: ``{"est_ms",
    "measured_ms", "err_pct"}`` — the model-quality figure every
    attribution corpus row ships with.  ``err_pct`` is signed: negative =
    the roofline under-estimates (host overhead, serialization),
    positive = over-estimates."""
    if not att or not measured_step_s or measured_step_s <= 0:
        return None
    est_ms = att.get("est_ms_total")
    if est_ms is None:
        return None
    measured_ms = measured_step_s * 1e3
    out = {
        "est_ms": round(est_ms, 6),
        "measured_ms": round(measured_ms, 6),
        "err_pct": round((est_ms - measured_ms) / measured_ms * 100.0, 2),
    }
    wk = normalize_workload_key(att.get("workload"))
    if wk:
        out["workload"] = wk
    return out


# -- the measured side: a profiled step's kernels by class -------------------

# (family, name patterns, class): the kernel families ``chip_smoke.py``
# reports a profile in, first match wins; the hand-written kernels by
# their ``csrc/`` function names
KERNEL_FAMILIES = (
    ("flash forward (sm90)", ("flash_fwd_sm90_kernel",), "pallas"),
    ("flash forward (simple)", ("flash_fwd_kernel",), "pallas"),
    ("flash backward (fused, sm90)", ("flash_bwd_sm90_fused_kernel",),
     "pallas"),
    ("flash backward (fused, simple)", ("flash_bwd_kernel",), "pallas"),
    ("flash backward dq (split, simple)", ("flash_bwd_dq_kernel",),
     "pallas"),
    ("flash backward dk/dv (split, simple)", ("flash_bwd_dkv_kernel",),
     "pallas"),
    ("flash backward dq (split, sm90)", ("flash_bwd_sm90_dq_kernel",),
     "pallas"),
    ("flash backward dk/dv (split, sm90)", ("flash_bwd_sm90_dkv_kernel",),
     "pallas"),
    ("flash backward delta pre-pass", ("flash_bwd_delta_kernel",),
     "pallas"),
    ("CE forward (sm90)", ("ce_fwd_sm90_kernel",), "pallas"),
    ("CE forward (simple)", ("ce_fwd_kernel",), "pallas"),
    ("CE dx (sm90)", ("ce_dx_sm90_kernel",), "pallas"),
    ("CE dx (simple)", ("ce_dx_kernel",), "pallas"),
    ("CE dW (sm90)", ("ce_dw_sm90_kernel",), "pallas"),
    ("CE dW (simple)", ("ce_dw_kernel",), "pallas"),
    ("paged attention (split)", ("paged_split_kernel",), "pallas"),
    ("paged attention merge", ("paged_merge_kernel",), "pallas"),
    ("paged attention (simple)", ("paged_attention_kernel",), "pallas"),
    ("decode gather", ("decode_gather_kernel",), "pallas"),
    ("bottleneck", ("bottleneck_kernel", "bottleneck_sm90_kernel"),
     "pallas"),
    ("collectives (NCCL)", ("nccl",), "collective"),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad",
                             "implicit"), "matmul"),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "gemv",
              "splitKreduce"), "matmul"),
    ("batch norm / reductions", ("reduce", "batch_norm"), "reduce"),
    ("pooling", ("pool",), "reduce"),
    ("softmax / log-softmax", ("softmax",), "reduce"),
    ("LayerNorm", ("layer_norm", "LayerNorm", "GammaBeta"), "reduce"),
    ("memcpy / memset", ("Memcpy", "Memset"), "other"),
)

# names outside every family, by what the kernel does (ATen's kernels)
_CLASS_PATTERNS = (
    ("reduce", ("norm_kernel", "cross_entropy", "nll_loss", "welford",
                "Reduce", "topk", "sort", "cumsum", "scan_")),
    ("other", ("index", "gather", "scatter", "embedding", "CatArray",
               "cat_", "transpose", "permute", "arange", "tril", "triu",
               "roll", "copy", "take")),
    ("elementwise", ("elementwise", "multi_tensor_apply", "dropout",
                     "distribution_", "foreach", "pointwise", "Functor",
                     "fill", "where", "clamp")),
)

_NCCL_KINDS = (("AllReduce", "all-reduce"), ("AllGather", "all-gather"),
               ("ReduceScatter", "reduce-scatter"),
               ("Broadcast", "collective-broadcast"),
               ("AllToAll", "all-to-all"), ("SendRecv", "collective-permute"),
               ("Send", "collective-permute"), ("Recv", "collective-permute"))


# wrapper (``kernels.WRAPPERS``) -> (its family counter in
# ``kernels.FAMILIES``, or None, and {family: the ``KERNEL_FAMILIES`` its
# launches show in a profile}); a wrapper without families uses the key None
_WRAPPER_FAMILIES = {
    "flash_attention_fwd": ("flash_attention_fwd", {
        "sm90": ("flash forward (sm90)",),
        "simple": ("flash forward (simple)",)}),
    "flash_attention_bwd": ("flash_attention_bwd", {
        "sm90": ("flash backward (fused, sm90)",),
        "simple": ("flash backward (fused, simple)",)}),
    "flash_attention_bwd_dq": ("flash_attention_split", {
        "sm90": ("flash backward dq (split, sm90)",),
        "simple": ("flash backward dq (split, simple)",)}),
    "flash_attention_bwd_dkv": ("flash_attention_split", {
        "sm90": ("flash backward dk/dv (split, sm90)",),
        "simple": ("flash backward dk/dv (split, simple)",)}),
    "flash_attention_bwd_delta": (None, {
        None: ("flash backward delta pre-pass",)}),
    "fused_ce_fwd": ("fused_ce_fwd", {"sm90": ("CE forward (sm90)",),
                                      "simple": ("CE forward (simple)",)}),
    "fused_ce_dx": ("fused_ce_dx", {"sm90": ("CE dx (sm90)",),
                                    "simple": ("CE dx (simple)",)}),
    "fused_ce_dw": ("fused_ce_dw", {"sm90": ("CE dW (sm90)",),
                                    "simple": ("CE dW (simple)",)}),
    "paged_attention": ("paged_attention", {
        "split": ("paged attention (split)", "paged attention merge"),
        "simple": ("paged attention (simple)",)}),
    "decode_gather": (None, {None: ("decode gather",)}),
    "bottleneck": ("bottleneck", {"sm90": ("bottleneck",),
                                  "simple": ("bottleneck",)}),
}


def launched_families(launches, families):
    """The ``KERNEL_FAMILIES`` (all of class ``pallas``) that a profile of
    some work must show, from the launches each wrapper made in it
    (``{wrapper: n}``, a difference of ``kernels.launch_counts``) and the
    calls of each kernel family (``{counter: {family: n}}``, a difference
    of ``kernels.family_counts``): each hand-written kernel the work
    launched, under its own family."""
    out = set()
    for wrapper, n in launches.items():
        if n <= 0:
            continue
        counter, names = _WRAPPER_FAMILIES[wrapper]
        if counter is None:
            out.update(names[None])
            continue
        for fam, calls in families.get(counter, {}).items():
            if calls > 0:
                out.update(names[fam])
    return sorted(out)


def kernel_family(name):
    """The family of a CUDA kernel's name (``KERNEL_FAMILIES``), or None
    (ATen's elementwise, reduction and data-movement kernels)."""
    for fam, pats, _cls in KERNEL_FAMILIES:
        if any(p in name for p in pats):
            return fam
    return None


def kernel_class(name):
    """The attribution class of a CUDA kernel's name, or None for a name
    no pattern knows (unaccounted time)."""
    for _fam, pats, cls in KERNEL_FAMILIES:
        if any(p in name for p in pats):
            if cls == "collective":
                kind = next((k for p, k in _NCCL_KINDS if p in name),
                            "other")
                return f"collective.{kind}"
            return cls
    for cls, pats in _CLASS_PATTERNS:
        if any(p in name for p in pats):
            return cls
    return None


def kernel_table(events, step_s=None):
    """One step's device kernels ``[(start_ns, duration_ns, name)]`` by
    class: ``{"classes": {cls: {"ms", "calls", "share"}}, "families":
    {family: ms}`` (``KERNEL_FAMILIES``), ``"total_ms", "accounted_ms",
    "accounted_share"`` (the time of kernels a pattern knows),
    ``"unmatched"`` (the largest unknown names with their ms),
    ``"step_ms"``, ``"busy_share"``}.  Unknown kernels count under
    ``other`` and stay out of ``accounted_ms``."""
    classes, unmatched, families = {}, {}, {}
    total = accounted = 0.0
    for _start, ns, name in events:
        ms = ns / 1e6
        total += ms
        fam = kernel_family(name)
        if fam is not None:
            families[fam] = families.get(fam, 0.0) + ms
        cls = kernel_class(name)
        if cls is None:
            unmatched[name] = unmatched.get(name, 0.0) + ms
            cls = "other"
        else:
            accounted += ms
        row = classes.setdefault(cls, {"ms": 0.0, "calls": 0})
        row["ms"] += ms
        row["calls"] += 1
    for row in classes.values():
        row["share"] = round(row["ms"] / total, 4) if total else 0.0
        row["ms"] = round(row["ms"], 6)
    step_ms = step_s * 1e3 if step_s else None
    return {"schema_version": SCHEMA_VERSION, "classes": classes,
            "families": {f: round(ms, 6) for f, ms in families.items()},
            "total_ms": round(total, 6), "accounted_ms": round(accounted, 6),
            "accounted_share": round(accounted / total, 4) if total else 0.0,
            "unmatched": sorted(unmatched.items(), key=lambda kv: -kv[1])[:8],
            "step_ms": step_ms,
            "busy_share": round(total / step_ms, 4) if step_ms else None}


def attribute_profile(run, step_s=None, device=None):
    """The measured counterpart of :func:`attribute_step` on the card:
    one call of ``run`` (``run(i)`` for ``i`` in 0, 1, 2; the middle call
    is the one counted, ``profiler.middle_call_kernels``) recorded by
    ``torch.profiler``'s CUDA activity, its kernel time put into the
    attribution classes (:func:`kernel_table`).  ``step_s``: the step's
    unprofiled wall, for the busy share.  The CPU has no CUDA activity:
    a CPU ``device`` raises, as does a recording with no device events."""
    from ..core.place import resolve_device
    from ..profiler import middle_call_kernels

    if resolve_device(device).type != "cuda":
        raise ValueError("attribute_profile reads the card's CUDA activity; "
                         "the CPU has none to read")
    return kernel_table(middle_call_kernels(run), step_s)

"""Step-level checks (the reference's ``jaxpr`` level) — the port's
counterpart of ``paddle_tpu/analysis/jaxpr_checks.py``, with its check
ids.  They read the lowered step: its op records and its remat plan
(``jaxpr_tools``), one shared walk (``ctx.walk``); none runs a step.

Where the reference reads a traced jaxpr, these read:

* ``jaxpr.scan-locality`` — every flash op of the forward sits inside a
  uniform layer group of the remat plan (the reference's layer
  ``lax.scan``), none of them left out of it;
* ``jaxpr.kernel-residual`` — under ``offload``, the plan sends the block
  inputs to the host (else the policy silently degraded to
  ``selective``), and the kernels keep their residuals;
* ``jaxpr.kernel-backend`` — inside a timed-run region no kernel op runs
  its plain PyTorch version (a CPU step) or the simple family where its
  rule takes sm90;
* ``jaxpr.constraint-placement`` — ``shard_activation``'s specs; silent,
  see its docstring;
* ``jaxpr.bf16-accum`` — a carried accumulator or a long reduction kept
  in bf16, from the records' dtypes;
* ``jaxpr.tanh-gelu`` — tanh activations inside a checkpointed region.
"""

import contextlib

from .framework import register_check
from .jaxpr_tools import BLOCK_INPUT_TAG, KERNEL_RESIDUAL_TAG

__all__ = ["timed_run", "timed_run_active"]

# up to one layer's worth of flash ops (one a layer in the port's
# Program) may sit outside the layer groups when a policy's segmentation
# leaves the first layer out of the uniform group; the failure mode is
# O(L) ungrouped layers, not O(1)
PALLAS_OUTSIDE_SCAN_TOLERANCE = 1

_TIMED_DEPTH = [0]


@contextlib.contextmanager
def timed_run():
    """Declare a timed-run region: inside it the ``jaxpr.kernel-backend``
    check holds every kernel op to its hand-written kernel (the
    reference's ``kernels.timed_run``)."""
    _TIMED_DEPTH[0] += 1
    try:
        yield
    finally:
        _TIMED_DEPTH[0] -= 1


def timed_run_active():
    """Inside :func:`timed_run`."""
    return _TIMED_DEPTH[0] > 0


def _has_remat(program):
    return bool(getattr(program, "_remat_segments", None))


@register_check("jaxpr.scan-locality", level="jaxpr")
def scan_locality(ctx):
    """Under a ``memory_optimize`` policy every flash op of the forward
    must sit inside a uniform layer group of the remat plan — the layers
    the step runs as one repeated region (the reference's ``lax.scan``
    body).  A flash op outside every group means its layer fell out of
    the grouping (its structure or widths differ from its neighbours'):
    the layer's segments then run unrolled, each its own region.  (The
    reference also reports its scan kill switch here; the port's
    ``PADDLE_TPU_SCAN_REMAT=0`` touches only FSDP's grouping, so a
    non-uniform layer stack is the one way in.)  Also
    errors on a kernel operand carrying a leading layer-count axis (the
    reference's stacked form)."""
    if not _has_remat(ctx.program):
        return []  # no remat policy marked: ungrouped layers are the
        # program's declared shape, not a defect
    rep = ctx.walk
    findings = []
    if rep["layer_stacked_pallas"]:
        findings.append(ctx.finding(
            "jaxpr.scan-locality", "error", "jaxpr", "kernel call",
            f"kernel operand/result carries a leading layer-count axis "
            f"{rep['layer_stacked_pallas'][:2]} — per-layer kernel calls "
            f"were stacked out of the layer loop",
            hint="check exe.last_remat_plan's groups",
            data={"layer_stacked": rep["layer_stacked_pallas"][:8]}))
    if (rep["pallas_total"] > 0
            and rep["pallas_outside_scan"]
            > PALLAS_OUTSIDE_SCAN_TOLERANCE):
        findings.append(ctx.finding(
            "jaxpr.scan-locality", "error", "jaxpr", "flash op",
            f"{rep['pallas_outside_scan']} of {rep['pallas_total']} "
            f"flash calls sit outside every layer group — the layers run "
            f"unrolled, each segment its own region",
            hint="the uniform layer group fell out of the plan (the "
                 "layers are not structurally uniform — see "
                 "exe.last_remat_plan)",
            data={"outside": rep["pallas_outside_scan"],
                  "total": rep["pallas_total"]}))
    return findings


@register_check("jaxpr.kernel-residual", level="jaxpr")
def kernel_residual(ctx):
    """The offload contract: under ``memory_optimize(policy='offload')``
    the plan must send the per-layer block inputs to pinned host memory
    (``pt_blk_in``: the layer groups' carries) — none means the policy
    silently degraded to plain ``selective`` and the memory saving never
    happens — and the kernels must keep their residuals for their own
    backward (``pt_kernel_res``: a kernel op outside any recomputed
    region), or the backward re-runs them.  (The reference also reports
    scan groups that fell back to its barrier spelling; the port's layer
    groups have no fallback: a layer is grouped or runs unrolled, which
    ``jaxpr.scan-locality`` reports.)"""
    findings = []
    program = ctx.program
    if not getattr(program, "_offload", False):
        return findings
    plan = ctx.remat_plan or {}
    mode = plan.get("offload", "off")
    if mode == "off":
        return findings
    rep = ctx.walk
    tags = rep["name_tags"]
    if BLOCK_INPUT_TAG not in tags:
        findings.append(ctx.finding(
            "jaxpr.kernel-residual", "warning", "jaxpr",
            "checkpoint names",
            f"offload policy requested (mode {mode!r}) but the plan sends "
            f"no block input ({BLOCK_INPUT_TAG!r}) to the host — no "
            f"block-input residual will leave device memory (policy "
            f"degraded to selective)",
            hint="offload only engages inside uniform layer groups; "
                 "check exe.last_remat_plan — a non-uniform program "
                 "cannot offload",
            data={"offload_mode": mode, "tags": sorted(tags)}))
    if rep["kernel_calls"] and KERNEL_RESIDUAL_TAG not in tags:
        findings.append(ctx.finding(
            "jaxpr.kernel-residual", "warning", "jaxpr",
            "checkpoint names",
            f"kernel calls present but none keeps its residuals "
            f"({KERNEL_RESIDUAL_TAG!r}) — the backward re-runs the "
            f"kernels instead",
            hint="keep the kernel ops out of the checkpointed regions "
                 "(memory_optimize's EXPENSIVE_OPS)",
            data={"tags": sorted(tags)}))
    return findings


@register_check("jaxpr.kernel-backend", level="jaxpr")
def kernel_backend(ctx):
    """Stand-in kernels in a TIMED run: inside a declared timed-run
    region (:func:`timed_run`) a kernel op
    lowered for the CPU runs its plain PyTorch version, and a bf16 op
    whose widths the sm90 rule takes must not be forced onto the simple
    family — either way the "measurement" times a stand-in.  Outside
    timed regions the plain versions are the desired CPU test path and
    this check stays silent."""
    if not timed_run_active():
        return []
    calls = ctx.walk["kernel_calls"]
    if not calls:
        return []
    if ctx.torch_device.type == "cpu":
        return [ctx.finding(
            "jaxpr.kernel-backend", "error", "jaxpr", "kernel call",
            f"{len(calls)} kernel call(s) lowered for the CPU run their "
            f"plain PyTorch versions inside a timed-run region — not a "
            f"measurement of the kernels",
            hint="time on the card",
            data={"kernel_calls": len(calls), "device": "cpu"})]
    return []


@register_check("jaxpr.constraint-placement", level="jaxpr")
def constraint_placement(ctx):
    """The reference errors on a ``with_sharding_constraint`` inside a
    scan body that is not one of its blessed pin sites: a symmetric
    constraint transposes into the backward scan and turns per-layer
    gradients into in-loop collectives.  That hazard cannot arise in the
    port: an eager step has no constraint to transpose, and the mesh path
    places every activation by its tp rules, issuing each collective
    itself (``parallel/spmd.py``).  The only constraints a Program holds
    are ``shard_activation``'s recorded specs, the reference's declared
    ``pt_shard[var]`` annotations, which it skips too (their traffic is
    ``hlo.accidental-reshard``'s business).  So this stays registered
    and silent on every record."""
    findings = []
    for sc in ctx.walk.get("sharding_constraints", ()):
        if sc["scan_depth"] <= 0 or sc["scope"].startswith("pt_shard["):
            continue
        findings.append(ctx.finding(
            "jaxpr.constraint-placement", "error", "jaxpr",
            f"scan depth {sc['scan_depth']}",
            f"sharding constraint over {sc['axes']} inside a layer group "
            f"is not a declared annotation ({sc['scope']})",
            data=sc))
    return findings


@register_check("jaxpr.bf16-accum", level="jaxpr")
def bf16_accum(ctx):
    """Reduced-precision accumulation lint: an ``acc = acc + delta``
    carried state held in bf16/f16 (a ``scan_block`` memory), or a sum
    reduction folding thousands of bf16 terms into a bf16 result, drops
    low bits as the running sum outgrows the terms.  The framework's own
    accumulators (gradient accumulation, Adam moments) carry f32 and
    never fire this."""
    rep = ctx.walk
    findings = []
    for c in rep["low_precision_carries"]:
        findings.append(ctx.finding(
            "jaxpr.bf16-accum", "warning", "jaxpr",
            f"scan carry {c['carry_index']}",
            f"scan (length {c['scan_length']}) accumulates into a "
            f"{c['dtype']} carry of shape {list(c['shape'])} — "
            f"precision loss grows with the scan length",
            hint="carry the accumulator in float32 and cast once at the "
                 "boundary (the gradient-accumulation engine's own "
                 "spelling)",
            data=c))
    for r in rep["low_precision_reduces"]:
        findings.append(ctx.finding(
            "jaxpr.bf16-accum", "warning", "jaxpr", r["op"],
            f"{r['op']} folds {r['folded_elems']} {r['dtype']} "
            f"elements per output element in {r['dtype']} (operand "
            f"shape {list(r['shape'])})",
            hint="cast to float32 before the reduction",
            data=r))
    return findings


@register_check("jaxpr.tanh-gelu", level="jaxpr")
def tanh_gelu(ctx):
    """tanh-based activations inside a checkpointed region of a
    remat-marked program.  On the reference's XLA, a tanh recompute
    drifts from the saved forward (not reassociation-stable under scan),
    which breaks the remat engine's bit-exactness; the port's
    ``torch.utils.checkpoint`` recompute runs the same kernel on the same
    inputs and keeps the bits, but the same Program runs in both
    packages, so the hazard is reported on the Program as the reference
    reports it."""
    if not _has_remat(ctx.program):
        return []
    rep = ctx.walk
    if not rep["tanh_in_scan"]:
        return []
    return [ctx.finding(
        "jaxpr.tanh-gelu", "warning", "jaxpr", "scan body",
        f"{rep['tanh_in_scan']} tanh op(s) inside checkpointed regions of "
        f"a remat-marked program — tanh's backward is not "
        f"reassociation-stable under the reference's scan, so its "
        f"recompute can drift from the saved forward",
        hint="use the exact erf gelu (this framework's 'gelu' op) or "
             "keep tanh segments unwrapped (saved, not rematerialized)",
        data={"tanh_in_scan": rep["tanh_in_scan"]})]

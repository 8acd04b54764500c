"""paddle_tpu_torch.analysis — the static-analysis engine, the port's
counterpart of ``paddle_tpu.analysis``: a lint pass framework over the
three artifact levels a training step passes through, with structured
findings and a strict mode that raises.  The level names are the
reference's (``program`` / ``jaxpr`` / ``hlo``); what the port reads at
each is its own artifact: the Program, the lowered step (op records and
remat plan), and the run (memory figure, in-place record, collective
log) — ``framework.py`` says which stands for which.

    import paddle_tpu_torch as pt

    report = pt.analysis.lint(main_prog, feed, [loss], device="cpu")
    for f in report:
        print(f)                  # [error] hlo.hbm-preflight @ ...
    report.raise_for_errors()     # or lint(..., strict=True)

CLI: ``python -m paddle_tpu_torch --lint <config.py>`` and
``python -m paddle_tpu_torch --lint-selftest``.  The Executor folds the
program- and hlo-level findings of every lowered step's first run into
``exe.last_step_cost`` (``lint_findings`` / ``lint_errors`` /
``lint_checks``; kill switch ``PADDLE_TPU_LINT=0``) and the trainer
JSONL.  ``comm`` holds the communication plan of a mesh step and the
contracts it is held to.
"""

from .framework import (
    SEVERITIES,
    LEVELS,
    Finding,
    AnalysisError,
    AnalysisReport,
    ArtifactError,
    CheckContext,
    register_check,
    registered_checks,
    lint,
    compile_findings,
    preflight_hbm,
    lint_enabled,
    report_json,
    report_from_json,
    LINT_JSON_SCHEMA_VERSION,
)

# importing the check modules registers the seeded checks
from . import program_checks  # noqa: F401
from . import jaxpr_checks  # noqa: F401
from . import hlo_checks  # noqa: F401
from . import comm  # noqa: F401 — registers the comm-plan checks
from .hlo_checks import donation_findings

__all__ = [
    "SEVERITIES", "LEVELS", "Finding", "AnalysisError", "AnalysisReport",
    "ArtifactError", "CheckContext", "register_check", "registered_checks",
    "lint", "compile_findings", "preflight_hbm", "lint_enabled",
    "report_json", "report_from_json", "LINT_JSON_SCHEMA_VERSION",
    "donation_findings",
    "audit_program",
    "comm",
]


def audit_program(program, feed, fetch_list, scope=None, layer_count=None,
                  compile_stats=True, absent_shapes=(), device=None):
    """Lower ``program``'s step and return its kernel-call locality
    report (``jaxpr_tools.jaxpr_report``) with the remat plan's groups
    (``scan_remat_plan``) and, with ``compile_stats``, the step's memory
    figure (``hbm_high_water_bytes`` and its ``memory_source``: one
    step's ``max_memory_allocated`` on the card, the analytic estimate on
    the CPU) — the reference's audit entry point, on the port's
    artifacts.  ``absent_shapes``: shapes that must NOT appear among the
    op records' values (e.g. ``(num_layers, t, d_model)``, a stacked
    layer axis); hit counts land in ``report["absent_shape_hits"]``.

    The scope must hold the program's parameters on ``device`` (run the
    startup program into it first) when the memory figure is measured;
    ``device=None`` is the card."""
    from .hlo_tools import shape_hits
    from .jaxpr_tools import jaxpr_report

    ctx = CheckContext(program, feed=feed, fetch_list=fetch_list,
                       scope=scope, layer_count=layer_count, donate=False,
                       device=device)
    report = jaxpr_report(program, ctx.records, ctx.remat_plan,
                          layer_count=layer_count, batch=ctx.batch)
    report["scan_remat_plan"] = list((ctx.remat_plan or {}).get(
        "groups", ()))
    if compile_stats:
        mem = ctx.memstats
        report["hbm_high_water_bytes"] = mem.get("hbm_high_water_bytes")
        report["memory_source"] = mem.get("source")
    if absent_shapes:
        report["absent_shape_hits"] = {
            tuple(s): shape_hits(ctx.records, s) for s in absent_shapes}
    return report

"""Comm-plan checks: the contract gate, accidental activation
reshards, and axis attribution — the port's counterpart of
``paddle_tpu/analysis/comm/checks.py``, with its check ids.

All three run at the ``hlo`` level over ``ctx.comm_plan``: the CommPlan
the Executor builds from a mesh step's collective log
(``core/executor.py: _log_comm``), which its fold-in seeds, where the
reference extracts one from the partitioned HLO.  Every collective of
the port is issued by name over named mesh axes, so a plan op's axes are
known by construction; ``hlo.axis-attribution`` fires only for a logged
collective whose axes match no axis of the mesh."""

from ..framework import register_check
from .contract import comm_contracts


@register_check("hlo.comm-contract", level="hlo")
def comm_contract(ctx):
    """Evaluate every CommContract attached to the program
    (``attach_comm_contract``) against the compiled step's CommPlan.
    Each violation is an error finding carrying the rule and the
    offending/matched collectives with their kind/axes/phase/loop
    attribution."""
    contracts = comm_contracts(ctx.program)
    if not contracts or ctx.mesh is None:
        return []
    if ctx.in_loop_expected:
        # a caller that declares in-loop reductions expected: the
        # in_loop/phase selectors would false-fire — the same exemption
        # hlo.inloop-collective applies.  forbid_reshard is
        # provenance-based and loop-insensitive, so those rules still
        # evaluate.
        contracts = [c.loop_insensitive() for c in contracts]
        contracts = [c for c in contracts if c.rules]
        if not contracts:
            return []
    plan = ctx.comm_plan
    findings = []
    for contract in contracts:
        for v in contract.check(plan):
            findings.append(ctx.finding(
                "hlo.comm-contract", "error", "hlo",
                f"contract {contract.name!r}",
                f"{v['message']} — e.g. {v['ops'][:3]}"
                if v.get("ops") else v["message"],
                hint="the comm plan diverged from the declared "
                     "contract; compare exe.last_comm_plan against the "
                     "contract rules (analysis.comm.comm_diff explains "
                     "which op moved vs a good config)",
                data=v))
    return findings


@register_check("hlo.accidental-reshard", level="hlo")
def accidental_reshard(ctx):
    """Collectives attributed (the log's ``var`` provenance) to an
    activation sharding annotation that no attached contract expects: the annotation is costing gather/reduce traffic
    nobody declared.  Warning-severity — a ``forbid_reshard`` rule in a
    contract upgrades the same traffic to a contract error."""
    if ctx.mesh is None:
        return []  # no mesh, no collectives
    plan = ctx.comm_plan
    attributed = [op for op in plan
                  if op.provenance and "var" in op.provenance]
    if not attributed:
        return []
    covered = set()
    for contract in comm_contracts(ctx.program):
        covered.update(id(op) for op in contract.covered(plan))
    by_var = {}
    for op in attributed:
        if id(op) in covered:
            continue
        # a multi-output producer's scope names every annotated output
        # (comma-joined): attribute the op to each var individually
        for name in op.provenance_names():
            by_var.setdefault(name, []).append(op)
    findings = []
    for var, ops in sorted(by_var.items()):
        kinds = sorted({op.kind for op in ops})
        in_loop = sum(1 for op in ops if op.in_loop)
        findings.append(ctx.finding(
            "hlo.accidental-reshard", "warning", "hlo", f"var {var}",
            f"{len(ops)} collective(s) ({', '.join(kinds)}; "
            f"{in_loop} in-loop, "
            f"{sum(op.bytes for op in ops)} bytes) attributed to the "
            f"sharding annotation on {var!r} — an activation reshard "
            f"no contract expects",
            hint="drop the annotation, or declare the movement with "
                 "CommContract.expect(...) if it is intentional "
                 "(forbid_reshard(var_pattern) makes it a hard error)",
            data={"var": var,
                  "ops": [op.describe() for op in ops[:8]],
                  "op_count": len(ops),
                  "bytes": sum(op.bytes for op in ops)}))
    return findings


@register_check("hlo.axis-attribution", level="hlo")
def axis_attribution(ctx):
    """Collectives whose axes match NO subset of the mesh's axes (the
    reference: replica groups GSPMD invented).  Needs a mesh to judge —
    silent otherwise."""
    if ctx.mesh is None:
        return []  # no mesh, nothing to attribute
    plan = ctx.comm_plan
    if not plan.mesh_axes:
        return []
    bad = plan.unattributed()
    if not bad:
        return []
    return [ctx.finding(
        "hlo.axis-attribution", "warning", "hlo",
        f"{len(bad)} collective(s)",
        f"{len(bad)} collective(s) run over axes matching no "
        f"mesh-axis subset of {sorted(plan.mesh_axes)} (e.g. "
        f"{[op.describe() for op in bad[:3]]})",
        hint="inspect exe.last_comm_plan ops with axes=None and the "
             "op that issued them",
        data={"ops": [op.to_dict() for op in bad[:8]],
              "op_count": len(bad)})]

"""Run-level checks (the reference's ``hlo`` level) — the port's
counterpart of ``paddle_tpu/analysis/hlo_checks.py``, with its check
ids.  They read what one step did (``hlo_tools``): the collectives a
mesh step issued and their loop membership, whether the optimizer wrote
the state in place, and the step's memory figure.  The Executor folds
them into its first run of every lowered step, over the run it just
made."""

from .framework import preflight_hbm, register_check

# state smaller than this is noise (tiny test programs, scalar state);
# the audit targets parameter-scale buffers
DONATION_MIN_BYTES = 1 << 20


@register_check("hlo.inloop-collective", level="hlo")
def inloop_collective(ctx):
    """A REDUCE collective (all-reduce / reduce-scatter) issued inside a
    loop of the step — a microbatch of gradient accumulation, or a layer
    of a uniform layer group — runs once per iteration: the
    per-microbatch gradient reduction of a naive accumulation loop,
    instead of once per optimizer step at the boundary.  Read from the
    collective log's loop flags (``CommPlan.comm_report``).  Gather-class
    collectives in a loop are expected structure (FSDP gathers each
    layer's weight where the layer reads it), reported as info only."""
    comm = ctx.comm
    if not comm or not comm.get("collective_count"):
        return []
    findings = []
    rin = comm.get("reduce_ops_in_loop", 0)
    if rin and not ctx.in_loop_expected:
        findings.append(ctx.finding(
            "hlo.inloop-collective", "error", "hlo", "loop body",
            f"{rin} reduce collective(s) "
            f"({comm.get('reduce_bytes_in_loop', 0)} bytes) run INSIDE a "
            f"loop of the step — gradients are reduced across ranks once "
            f"per iteration instead of once per optimizer step",
            hint="reduce gradients at the optimizer boundary "
                 "(Spmd.boundary_grads); check the collective log's "
                 "phases in exe.last_comm_plan",
            data={"reduce_ops_in_loop": rin,
                  "reduce_bytes_in_loop":
                      comm.get("reduce_bytes_in_loop", 0)}))
    gathers_in = comm.get("collectives_in_loop", 0) - rin
    if gathers_in > 0:
        findings.append(ctx.finding(
            "hlo.inloop-collective", "info", "hlo", "loop body",
            f"{gathers_in} gather-class collective(s) inside loops "
            f"({comm.get('collective_bytes_in_loop', 0)} total in-loop "
            f"bytes) — expected structure (FSDP per-layer weight "
            f"gathers), not gated",
            data=dict(
                {k: comm.get(k) for k in (
                    "collectives_in_loop", "collective_bytes_in_loop",
                    "collective_ops")},
                gather_ops_in_loop=gathers_in)))
    return findings


def donation_findings(memstats, donate, min_bytes=DONATION_MIN_BYTES):
    """Pure in-place audit over a step's memory record: the optimizer
    updated parameter-scale state but wrote NONE of it in place — every
    updated tensor was replaced by a new one, so the old and the new
    state are both alive at the update (the reference's "donation
    aliased nothing").  Returns a list of Findings."""
    from .framework import Finding

    if not donate or not memstats:
        return []
    arg = memstats.get("argument_bytes") or 0
    alias = memstats.get("alias_bytes")
    if alias is None or arg < min_bytes:
        return []
    if alias > 0:
        return []
    return [Finding(
        "hlo.donation-alias", "warning", "hlo", "input_output_alias",
        f"the optimizer updated {arg} bytes of state but wrote none of "
        f"it in place — every updated tensor was replaced, so two copies "
        f"of the state are alive at the update",
        hint="update ops write ParamOut / the moments into their input "
             "tensors (ops/optimizer_ops.py); check for an op returning "
             "a new tensor",
        data={"argument_bytes": int(arg), "alias_bytes": 0})]


@register_check("hlo.donation-alias", level="hlo")
def donation_alias(ctx):
    """The in-place audit of the step's state (``donation_findings``):
    eager PyTorch has no buffers to donate; the optimizer ops update the
    scope's tensors in place, and a step that replaces them instead
    holds the state twice."""
    return donation_findings(ctx.memstats, ctx.donate)


@register_check("hlo.hbm-preflight", level="hlo")
def hbm_preflight(ctx):
    """The memory preflight: the step's memory figure (one step's
    ``max_memory_allocated`` on the card, the analytic estimate as a
    preflight) against the card's ``total_memory`` or an explicit
    ``hbm_budget``.  Skipped when neither figure is known (the CPU
    reports no capacity)."""
    budget = ctx.hbm_budget
    if budget is None:
        from ..observability.hardware import device_hbm_bytes

        try:
            budget = device_hbm_bytes(ctx.torch_device)
        except Exception:  # noqa: BLE001 — no device: no budget
            budget = None
    if not budget:
        return []
    high = (ctx.memstats or {}).get("hbm_high_water_bytes")
    return preflight_hbm(high, budget, context="step")

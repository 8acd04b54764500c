"""CommPlan: one step's collectives as a structured, mesh-aware plan
(``paddle_tpu/analysis/comm/plan.py``).

The reference recovers its plan from the partitioned HLO text of a
compiled step: the collectives GSPMD inserted, their mesh axes from
replica groups, loop membership and phase from the computation they sit
in.  The port runs eagerly and issues every collective itself
(``parallel/collectives.py``), so its plan is built from the step's
**recorded collective log**: each entry is one collective the rank ran —
kind, bytes, mesh axes, whether it ran inside a loop of the step (a
microbatch of gradient accumulation, or a layer of a uniform layer group:
the loops the reference compiles as ``lax.scan``), phase, and the
variable it moved.  :class:`CommOp`, :class:`CommPlan` (``select``,
``buckets``, ``summary``, ``comm_report``, ``unattributed``) and
:func:`comm_diff` keep the reference's semantics, so the contracts of
``contract.py`` and ``parallel/contracts.py`` read a port plan as they
read a compiled one.

Phases: ``forward`` and ``backward`` (a collective of the differentiated
forward or of autograd's backward outside any loop), ``fwd-scan`` and
``bwd-scan`` (the same inside a loop), ``boundary`` (the optimizer
boundary: the gradient reduction, ZeRO's parameter gathers, the fetches),
and the reference's serving phases ``prefill`` / ``decode``.
"""

import re

__all__ = ["CommOp", "CommPlan", "plan_from_log", "comm_diff",
           "REDUCE_COLLECTIVES", "GATHER_COLLECTIVES", "ALL_COLLECTIVES",
           "KIND_CLASSES", "PHASES"]

# collectives that REDUCE across ranks (gradient aggregation); gathers /
# permutes move activations and are reported separately
REDUCE_COLLECTIVES = ("all-reduce", "reduce-scatter")
GATHER_COLLECTIVES = ("all-gather", "collective-permute", "all-to-all",
                      "collective-broadcast")
ALL_COLLECTIVES = REDUCE_COLLECTIVES + GATHER_COLLECTIVES

# kind aliases a contract may use instead of one concrete kind
KIND_CLASSES = {
    "reduce": REDUCE_COLLECTIVES,
    "gather": GATHER_COLLECTIVES,
    "any": ALL_COLLECTIVES,
}

PHASES = ("forward", "backward", "fwd-scan", "bwd-scan", "boundary",
          "prefill", "decode")


class CommOp:
    """One collective of the plan: kind, bytes, mesh axes, loop
    membership, phase, and provenance."""

    __slots__ = ("kind", "bytes", "axes", "in_loop", "phase",
                 "computation", "op_name", "provenance", "channel")

    def __init__(self, kind, nbytes, axes, in_loop, phase,
                 computation="", op_name="", provenance=None,
                 channel=None):
        self.kind = kind
        self.bytes = int(nbytes)
        self.axes = axes  # tuple of axis names, () for degenerate,
        #                   None = matched no mesh-axis subset
        self.in_loop = bool(in_loop)
        self.phase = phase
        self.computation = computation
        self.op_name = op_name
        self.provenance = provenance  # {"site"|"var": name} or None
        self.channel = channel

    def matches_kind(self, kind):
        if kind is None:
            return True
        return self.kind == kind or self.kind in KIND_CLASSES.get(
            kind, ())

    def matches_axis(self, axis):
        if axis is None:
            return True
        return self.axes is not None and axis in self.axes

    def provenance_names(self):
        """The individual annotation names of this op's provenance (a
        multi-output producer's ``pt_shard`` scope joins its annotated
        outputs with commas)."""
        if not self.provenance:
            return ()
        value = next(iter(self.provenance.values()))
        return tuple(n for n in value.split(",") if n)

    def to_dict(self):
        return {
            "kind": self.kind, "bytes": self.bytes,
            "axes": list(self.axes) if self.axes is not None else None,
            "in_loop": self.in_loop, "phase": self.phase,
            "computation": self.computation, "op_name": self.op_name,
            "provenance": dict(self.provenance)
            if self.provenance else None,
        }

    def describe(self):
        ax = ("?" if self.axes is None
              else "x".join(self.axes) if self.axes else "-")
        prov = ""
        if self.provenance:
            k, v = next(iter(self.provenance.items()))
            prov = f" [{k}={v}]"
        return (f"{self.kind}@{ax} {self.phase}"
                f"{' in-loop' if self.in_loop else ''}"
                f" {self.bytes}B{prov}")

    def __repr__(self):
        return f"CommOp({self.describe()})"


class CommPlan:
    """The structured communication plan of one compiled executable."""

    def __init__(self, ops=(), mesh_axes=None, label=None):
        self.ops = list(ops)
        self.mesh_axes = dict(mesh_axes or {})  # axis name -> size
        self.label = label

    def __iter__(self):
        return iter(self.ops)

    def __len__(self):
        return len(self.ops)

    def select(self, kind=None, axis=None, in_loop=None, phase=None,
               provenance=None):
        """Ops matching every given criterion.  ``kind`` may be a
        concrete HLO kind or a class alias ('reduce' / 'gather' /
        'any'); ``provenance`` is a regex matched against EACH name of
        the op's ``pt_pin``/``pt_shard`` annotation (a multi-output
        producer's scope joins its annotated outputs with commas, and
        anchored patterns must still hit every one)."""
        out = []
        pat = re.compile(provenance) if provenance else None
        for op in self.ops:
            if not op.matches_kind(kind):
                continue
            if not op.matches_axis(axis):
                continue
            if in_loop is not None and op.in_loop != in_loop:
                continue
            if phase is not None and op.phase != phase:
                continue
            if pat is not None:
                if not any(pat.search(n)
                           for n in op.provenance_names()):
                    continue
            out.append(op)
        return out

    def unattributed(self):
        """Ops whose replica groups matched no mesh-axis subset — the
        ``hlo.axis-attribution`` input."""
        return [op for op in self.ops if op.axes is None]

    def buckets(self):
        """``{(kind, axes, phase, in_loop): {"count", "bytes"}}`` — the
        aggregation ``comm_diff`` and the compact summary share."""
        out = {}
        for op in self.ops:
            axes = (tuple(op.axes) if op.axes is not None else ("?",))
            key = (op.kind, axes, op.phase, op.in_loop)
            b = out.setdefault(key, {"count": 0, "bytes": 0})
            b["count"] += 1
            b["bytes"] += op.bytes
        return out

    def summary(self):
        """JSON-able compact form for ``last_step_cost["comm_plan"]`` /
        trainer JSONL: one sorted row per (kind, axes, phase, in_loop)
        bucket."""
        rows = []
        for (kind, axes, phase, in_loop), b in sorted(
                self.buckets().items(),
                key=lambda kv: (kv[0][2], kv[0][0], kv[0][1])):
            rows.append({
                "kind": kind, "axes": "x".join(axes) if axes else "-",
                "phase": phase, "in_loop": in_loop,
                "count": b["count"], "bytes": b["bytes"],
            })
        return rows

    def comm_report(self):
        """The legacy scalar comm report (``hlo_tools.hlo_comm_report``
        key-compatible: per-kind counts, totals, the reduce class and
        every loop split) derived from this plan — one HLO parse serves
        both shapes (the Executor's fold-in uses this instead of
        re-parsing the text)."""
        report = {
            "collective_ops": {},
            "collective_count": 0, "collective_bytes": 0,
            "reduce_ops": 0, "reduce_bytes": 0,
            "reduce_ops_in_loop": 0, "reduce_bytes_in_loop": 0,
            "collectives_in_loop": 0, "collective_bytes_in_loop": 0,
        }
        for op in self.ops:
            report["collective_ops"][op.kind] = (
                report["collective_ops"].get(op.kind, 0) + 1)
            report["collective_count"] += 1
            report["collective_bytes"] += op.bytes
            if op.in_loop:
                report["collectives_in_loop"] += 1
                report["collective_bytes_in_loop"] += op.bytes
            if op.kind in REDUCE_COLLECTIVES:
                report["reduce_ops"] += 1
                report["reduce_bytes"] += op.bytes
                if op.in_loop:
                    report["reduce_ops_in_loop"] += 1
                    report["reduce_bytes_in_loop"] += op.bytes
        return report

    def to_dict(self):
        return {"label": self.label, "mesh_axes": dict(self.mesh_axes),
                "ops": [op.to_dict() for op in self.ops],
                "summary": self.summary()}


def plan_from_log(entries, mesh_axes=None, label=None, reference=False):
    """A :class:`CommPlan` from a collective log: ``entries`` are dicts of
    the ops' fields (``kind``, ``bytes``, ``axes``, ``in_loop``, ``phase``
    and optionally ``var``, ``site``, ``op_name``, ``block``); a ``var``
    or ``site`` becomes the op's provenance.

    The plan holds what ran.  ``reference=True`` names it as the
    reference's compiled step would: a boundary all-reduce of one block
    of a gradient (``block``: the axes the gradient is cut over, FSDP's)
    is the reference's reduce-scatter of the whole gradient over the
    reduced axes and the block's — each rank ends with its block reduced,
    at the block's volume, which is what the reference's ZeRO-3 contract
    reads."""
    ops = []
    for e in entries:
        prov = None
        if e.get("var"):
            prov = {"var": e["var"]}
        elif e.get("site"):
            prov = {"site": e["site"]}
        kind, axes = e["kind"], e.get("axes")
        if (reference and e.get("block") and kind == "all-reduce"
                and e.get("phase") == "boundary"):
            kind = "reduce-scatter"
            axes = tuple(axes or ()) + tuple(e["block"])
        ops.append(CommOp(
            kind, e["bytes"],
            tuple(axes) if axes is not None else None,
            e.get("in_loop", False), e.get("phase", "boundary"),
            op_name=e.get("op_name", ""), provenance=prov))
    return CommPlan(ops, mesh_axes, label)


def comm_diff(plan_a, plan_b, name_a="A", name_b="B"):
    """Explain which collective moved between two plans.

    Buckets both plans by (kind, axes, phase, in_loop) and reports every
    bucket whose count or bytes changed, plus a human-readable ``text``
    list — the tool for "FSDP=1 added 19 in-loop all-reduces: they are
    all-reduce@fsdp bwd-scan, i.e. the dW replication the asymmetric
    pin exists to prevent" (docs/parallel.md)."""
    ba, bb = plan_a.buckets(), plan_b.buckets()
    changed = []
    for key in sorted(set(ba) | set(bb),
                      key=lambda k: (k[2], k[0], k[1])):
        a = ba.get(key, {"count": 0, "bytes": 0})
        b = bb.get(key, {"count": 0, "bytes": 0})
        if a == b:
            continue
        kind, axes, phase, in_loop = key
        changed.append({
            "kind": kind, "axes": "x".join(axes) if axes else "-",
            "phase": phase, "in_loop": in_loop,
            "count_a": a["count"], "count_b": b["count"],
            "bytes_a": a["bytes"], "bytes_b": b["bytes"],
        })
    text = []
    for c in changed:
        where = f"{c['phase']}{' in-loop' if c['in_loop'] else ''}"
        text.append(
            f"{c['kind']}@{c['axes']} {where}: "
            f"{c['count_a']} -> {c['count_b']} ops "
            f"({c['bytes_a']} -> {c['bytes_b']} bytes) "
            f"[{name_a} -> {name_b}]")
    return {"changed": changed, "text": text,
            "same": not changed}

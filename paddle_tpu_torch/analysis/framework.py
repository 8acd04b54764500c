"""Static-analysis pass framework: check registry, artifact context,
structured findings — the port's counterpart of
``paddle_tpu/analysis/framework.py``, with the reference's public
contract kept letter for letter: check ids, the level names
(``program`` / ``jaxpr`` / ``hlo``), the severities, the
``--lint --json`` schema (``LINT_JSON_SCHEMA_VERSION`` 1).

Every invariant is a registered *check* over one of three artifact
levels.  The level names are the reference's; what stands behind them
is the port's own artifact, since an eager step has no jaxpr and no
compiled HLO:

* ``program`` — the Program IR itself (``core/program.py``), the same
  ops and vars as the reference's: pure Python, runs in microseconds;
* ``jaxpr``   — the **lowered step** (``Executor.lower``): its op records
  (every op the step runs, with the shapes and dtypes of the run's batch,
  ``analysis.jaxpr_tools.step_records``) and its remat plan
  (``core.executor.remat_plan``: the policy, the offload mode, the layer
  groups and which ops run inside a checkpointed region).  Nothing runs;
* ``hlo``     — the **run**: the step's memory figure
  (``max_memory_allocated`` of one step on the card; the analytic
  ``tune.space.estimate_gpt_step_hbm`` on the CPU and as a preflight),
  whether the optimizer wrote the state in place (the reference's
  donation aliasing), and on a mesh the step's collective log as a
  ``CommPlan`` (``analysis.comm``).

A check is a function ``check(ctx) -> iterable[Finding]`` registered
with ``@register_check(id, level)``.  ``lint(program, feed, fetch_list)``
builds the artifacts lazily (a program-level-only lint needs no device),
runs every enabled check, and returns an ``AnalysisReport``;
``strict=True`` raises ``AnalysisError`` when any error-severity finding
survives.  A ``jaxpr``-level lint lowers the step and runs nothing; an
``hlo``-level lint on the card runs one step from zero state to read its
memory.  Entry points take ``device=None``, meaning the card
(``core/place.py: resolve_device``).

Registering a new check::

    from paddle_tpu_torch.analysis import register_check, Finding

    @register_check("program.my-invariant", level="program")
    def my_invariant(ctx):
        for op in ctx.program.global_block().ops:
            if bad(op):
                yield ctx.finding(
                    "program.my-invariant", "error", "program",
                    location=f"op {op.type}", message="...",
                    hint="how to fix it")
"""

import os

__all__ = [
    "SEVERITIES", "LEVELS", "Finding", "AnalysisError", "AnalysisReport",
    "CheckContext", "ArtifactError", "register_check", "registered_checks",
    "lint", "compile_findings", "preflight_hbm", "report_json",
    "report_from_json", "LINT_JSON_SCHEMA_VERSION", "lint_enabled",
]

SEVERITIES = ("info", "warning", "error")
LEVELS = ("program", "jaxpr", "hlo")


class Finding:
    """One structured lint finding: check id, severity, artifact level,
    location, human message, and a remediation hint."""

    __slots__ = ("check", "severity", "level", "location", "message",
                 "hint", "data")

    def __init__(self, check, severity, level, location, message,
                 hint="", data=None):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        if level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, "
                             f"got {level!r}")
        self.check = check
        self.severity = severity
        self.level = level
        self.location = location
        self.message = message
        self.hint = hint
        self.data = dict(data or {})

    def to_dict(self):
        d = {"check": self.check, "severity": self.severity,
             "level": self.level, "location": self.location,
             "message": self.message, "hint": self.hint}
        if self.data:
            d["data"] = self.data
        return d

    def __repr__(self):
        return (f"[{self.severity}] {self.check} @ {self.location}: "
                f"{self.message}")


class AnalysisError(RuntimeError):
    """Raised by strict-mode lint when error-severity findings survive."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = [f"lint found {len(self.findings)} error(s):"]
        lines += [f"  {f!r}" for f in self.findings[:10]]
        if len(self.findings) > 10:
            lines.append(f"  ... and {len(self.findings) - 10} more")
        super().__init__("\n".join(lines))


class ArtifactError(RuntimeError):
    """An artifact level could not be built (no device, lowering failed,
    feed missing...).  Checks raising this are reported once per level as
    an ``analysis.artifact`` info finding, not as a crash."""


class AnalysisReport:
    """Ordered findings of one lint run."""

    def __init__(self, findings=()):
        self.findings = list(findings)

    def add(self, finding):
        self.findings.append(finding)

    def extend(self, findings):
        self.findings.extend(findings)

    def __iter__(self):
        return iter(self.findings)

    def __len__(self):
        return len(self.findings)

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self):
        return not self.errors

    def ids(self):
        return sorted({f.check for f in self.findings})

    def by_check(self, check_id):
        return [f for f in self.findings if f.check == check_id]

    def counts(self):
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def to_dict(self):
        return {"findings": [f.to_dict() for f in self.findings],
                "counts": self.counts(), "ok": self.ok}

    def summary(self):
        c = self.counts()
        return (f"{len(self.findings)} finding(s): {c['error']} error, "
                f"{c['warning']} warning, {c['info']} info")

    def raise_for_errors(self):
        if self.errors:
            raise AnalysisError(self.errors)
        return self


class CheckSpec:
    __slots__ = ("id", "level", "fn")

    def __init__(self, check_id, level, fn):
        self.id = check_id
        self.level = level
        self.fn = fn


_CHECKS = {}


def register_check(check_id, level):
    """Register a check function ``fn(ctx) -> iterable[Finding]`` under
    ``check_id`` at artifact ``level`` ('program' | 'jaxpr' | 'hlo')."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")

    def deco(fn):
        if check_id in _CHECKS:
            raise ValueError(f"check {check_id!r} registered twice")
        _CHECKS[check_id] = CheckSpec(check_id, level, fn)
        return fn

    return deco


def registered_checks(level=None):
    """Registered CheckSpecs, optionally filtered by level."""
    return [s for s in _CHECKS.values()
            if level is None or s.level == level]


class CheckContext:
    """Lazy artifact store one lint run's checks share.

    Artifacts build on first access and cache: ``prepared`` (an Executor,
    the feeds and the state, zeros of the declared shapes where the
    caller gave none), ``records`` / ``remat_plan`` / ``walk`` (the
    lowered step), ``memstats`` (the memory figure and the in-place
    record), ``comm`` / ``comm_plan`` (a mesh step's collectives).
    ``seed(name, value)`` pre-loads an artifact the caller already has
    (the Executor's fold-in seeds ``memstats`` / ``comm`` /
    ``comm_plan`` from the run it just made, so linting costs no extra
    step)."""

    def __init__(self, program, feed=None, fetch_list=None, scope=None,
                 mesh=None, layer_count=None, hbm_budget=None, donate=True,
                 in_loop_expected=False, label=None, device=None):
        self.program = program
        self.feed = feed
        self.fetch_list = list(fetch_list or [])
        self.scope = scope
        self.mesh = mesh
        self.layer_count = layer_count
        self.hbm_budget = hbm_budget
        self.donate = donate
        self.in_loop_expected = in_loop_expected
        self.label = label
        self.device = device
        self._cache = {}

    def seed(self, name, value):
        self._cache[name] = value
        return self

    def finding(self, check, severity, level, location, message, hint="",
                data=None):
        return Finding(check, severity, level, location, message,
                       hint=hint, data=data)

    @property
    def fetch_names(self):
        return [v.name if hasattr(v, "name") else str(v)
                for v in self.fetch_list]

    # -- artifact builders -------------------------------------------------
    def _get(self, name, builder):
        if name not in self._cache:
            try:
                self._cache[name] = builder()
            except ArtifactError:
                raise
            except Exception as e:
                raise ArtifactError(
                    f"{name} unavailable: {type(e).__name__}: {e}") from e
        return self._cache[name]

    @property
    def torch_device(self):
        from ..core.place import resolve_device

        return self._get("device", lambda: resolve_device(self.device))

    @property
    def batch(self):
        """The batch the -1 dims stand for: the leading dim of a
        batch-leading feed, else 2 (the synthesized feeds' batch)."""
        def build():
            block = self.program.global_block()
            for n, val in (self.feed or {}).items():
                var = block._find_var(n)
                shape = getattr(val, "shape", None)
                if var is not None and var.shape and var.shape[0] == -1 \
                        and shape:
                    return int(shape[0])
            return 2
        return self._get("batch", build)

    @property
    def prepared(self):
        """(exe, scope, feeds, fetch_names, state_names, state): the
        Executor's run prologue over zero feeds and state of the declared
        shapes where the caller supplied none (no initializer op runs)."""
        return self._get("prepared", self._build_prepared)

    def _build_prepared(self):
        import numpy as np
        import torch

        from ..core.dtypes import torch_dtype
        from ..core.executor import Executor
        from ..core.scope import Scope

        if self.program is None:
            raise ArtifactError("no program")
        dev = self.torch_device
        block = self.program.global_block()
        feed = dict(self.feed or {})
        for v in block.vars.values():
            if getattr(v, "is_data", False) and v.name not in feed:
                shape = tuple(self.batch if s is None or int(s) < 0
                              else int(s) for s in (v.shape or (1,)))
                # numpy has no bfloat16: such feeds go as f32 and the
                # Executor casts them to the declared dtype
                feed[v.name] = np.zeros(shape, np.float32 if v.dtype.name
                                        == "bfloat16" else v.dtype.name)
        scope = self.scope
        if scope is None:
            scope = Scope()
            for v in self.program.persistable_vars():
                shape = tuple(int(s) if s and int(s) > 0 else 1
                              for s in v.shape)
                scope.set(v.name, torch.zeros(
                    shape, dtype=torch_dtype(v.dtype), device=dev))
        exe = Executor(dev, mesh=self.mesh, donate_state=self.donate)
        (program, scope, feeds, fetch_names, state_names,
         state) = exe._prepare(self.program, feed, self.fetch_list, scope)
        return exe, scope, feeds, fetch_names, state_names, state

    @property
    def records(self):
        """The lowered step's op records at the run's batch
        (``jaxpr_tools.step_records``)."""
        from .jaxpr_tools import step_records

        return self._get("records",
                         lambda: step_records(self.program, self.batch))

    @property
    def remat_plan(self):
        """The lowered step's remat plan (``core.executor.remat_plan``):
        None without a ``memory_optimize`` policy."""
        from ..core.executor import remat_plan

        return self._get("remat_plan", lambda: remat_plan(
            self.program, self.torch_device))

    @property
    def walk(self):
        """The shared one-pass walk of the lowered step
        (``jaxpr_tools.walk_report``), with layer-count hypotheses from
        the caller plus every layer group's repeat count."""
        def build():
            from .jaxpr_tools import walk_report

            counts = {self.layer_count} if self.layer_count else set()
            for g in (self.remat_plan or {}).get("groups", ()):
                counts.add(g.get("count"))
            return walk_report(self.program, self.records, self.remat_plan,
                               layer_counts=counts, batch=self.batch)
        return self._get("walk", build)

    @property
    def memstats(self):
        """``{"hbm_high_water_bytes", "source", "argument_bytes",
        "alias_bytes"}``: on the card one step from the prepared state,
        its ``max_memory_allocated`` and how many bytes of the state the
        optimizer wrote in place; on the CPU the analytic estimate of a
        GPT program (else None) and no in-place record."""
        from .hlo_tools import measured_memstats, static_memstats

        def build():
            if self.torch_device.type == "cuda":
                exe, scope, feeds, fetch_names, _sn, state = self.prepared
                return measured_memstats(exe, self.program, scope, feeds,
                                         fetch_names, state)
            return static_memstats(self.program, self.batch)
        return self._get("memstats", build)

    @property
    def comm_plan(self):
        """The step's ``CommPlan`` (``analysis.comm``): on a mesh, the
        collective log of one step from the prepared state (the
        Executor's fold-in seeds it from the step it ran)."""
        def build():
            if self.mesh is None:
                from .comm.plan import CommPlan

                return CommPlan([], {}, self.label)
            exe, scope, feeds, fetch_names, _sn, _st = self.prepared
            exe.run(self.program, feed=feeds, fetch_list=fetch_names,
                    scope=scope, return_numpy=False)
            return exe.last_comm_plan
        return self._get("comm_plan", build)

    @property
    def comm(self):
        """The scalar comm report of ``comm_plan`` ({} off a mesh)."""
        def build():
            plan = self.comm_plan
            return plan.comm_report() if len(plan) else {}
        return self._get("comm", build)


def _run_checks(ctx, specs, report):
    """Run checks against a context, containing failures: an artifact
    failure is reported once per (level, reason); a check crash becomes
    a warning finding instead of killing the run."""
    artifact_failures = set()
    for spec in specs:
        try:
            report.extend(spec.fn(ctx) or ())
        except ArtifactError as e:
            key = (spec.level, str(e))
            if key not in artifact_failures:
                artifact_failures.add(key)
                report.add(Finding(
                    "analysis.artifact", "info", spec.level, spec.id,
                    f"{spec.level}-level checks skipped: {e}",
                    hint="pass feed/fetch_list (and a scope holding "
                         "initialized parameters) so the step can be "
                         "lowered and run, and a device that exists"))
        except Exception as e:  # noqa: BLE001 — checks must not kill lint
            report.add(Finding(
                "analysis.check-crash", "warning", spec.level, spec.id,
                f"check crashed: {type(e).__name__}: {e}",
                hint="report/fix the check; its invariant was NOT "
                     "verified"))
    return report


def lint(program=None, feed=None, fetch_list=None, scope=None,
         levels=LEVELS, checks=None, strict=False, mesh=None,
         layer_count=None, hbm_budget=None, donate=True,
         in_loop_expected=False, device=None):
    """Run the registered static checks over ``program`` and return an
    ``AnalysisReport``.

    ``feed``/``fetch_list``/``scope`` feed the jaxpr/hlo artifact levels
    (missing feeds and parameters are synthesized as zeros from the
    declared shapes — nothing random runs).  ``levels``/``checks``
    restrict what runs; ``layer_count`` sharpens the layer-stacked
    probes; ``hbm_budget`` (bytes) overrides the card's ``total_memory``
    for the memory preflight; ``strict=True`` raises ``AnalysisError``
    when error-severity findings survive.  ``device``: where the step
    lowers (and, at the hlo level on the card, runs once); None is the
    card."""
    from ..core.program import default_main_program

    unknown = [lvl for lvl in levels if lvl not in LEVELS]
    if unknown:
        raise ValueError(
            f"unknown artifact level(s) {unknown}; valid: {list(LEVELS)}")
    program = program or default_main_program()
    ctx = CheckContext(
        program, feed=feed, fetch_list=fetch_list, scope=scope, mesh=mesh,
        layer_count=layer_count, hbm_budget=hbm_budget, donate=donate,
        in_loop_expected=in_loop_expected, device=device)
    specs = [s for s in _CHECKS.values() if s.level in levels
             and (checks is None or s.id in checks)]
    report = _run_checks(ctx, specs, AnalysisReport())
    if strict:
        report.raise_for_errors()
    return report


def compile_findings(program=None, fetch_names=(), memstats=None,
                     comm=None, in_loop_expected=False, donate=True,
                     hbm_budget=None, kernel_backends=None, mesh=None,
                     comm_plan=None, label=None, device=None,
                     kernel_families=None):
    """The Executor's fold-in at a cache miss: run the program-level
    checks plus the hlo-level checks over what the run already produced
    (no extra step).  Returns a list of Findings — the Executor
    summarizes them into ``last_step_cost``.

    ``kernel_backends`` is the kernel registry's record of the step
    (``{op class: "cuda" | "triton" | "torch_ref"}``) and
    ``kernel_families`` the families its kernel calls took
    (``hlo_tools.kernel_families``: ``"plain"`` on the CPU, else
    ``"sm90"``, ``"simple"`` or ``"simple-forced"``): the snapshots the
    timed-run form of ``jaxpr.kernel-backend`` reads."""
    ctx = CheckContext(
        program, fetch_list=list(fetch_names), donate=donate,
        hbm_budget=hbm_budget, in_loop_expected=in_loop_expected,
        mesh=mesh, label=label, device=device)
    if memstats is not None:
        ctx.seed("memstats", memstats)
    ctx.seed("comm", comm or {})
    if comm_plan is None:
        from .comm.plan import CommPlan

        comm_plan = CommPlan([], {}, label)
    ctx.seed("comm_plan", comm_plan)
    specs = []
    if program is not None:
        specs += [s for s in _CHECKS.values() if s.level == "program"]
    if memstats is not None:
        specs += [s for s in _CHECKS.values() if s.level == "hlo"]
    report = _run_checks(ctx, specs, AnalysisReport())
    # artifact-skip notes are lint() UX; the fold-in only wants real
    # findings
    findings = [f for f in report if f.check != "analysis.artifact"]
    findings += _timed_run_backend_findings(kernel_backends,
                                            kernel_families)
    return findings


def _timed_run_backend_findings(kernel_backends, kernel_families=None):
    """The snapshot form of ``jaxpr.kernel-backend``: inside a timed-run
    region, a kernel op class that the registry resolved to its plain
    PyTorch version (``torch_ref``: asked for by name on a card, or any
    CPU run) or that ran the simple family where its rule picks sm90
    (``simple-forced`` in the family record) is an error — the timed row
    would ship a stand-in, not the kernel's measurement."""
    from .jaxpr_checks import timed_run_active

    if not timed_run_active():
        return []
    kernel_backends = kernel_backends or {}
    kernel_families = kernel_families or {}
    bad = {op: b for op, b in kernel_backends.items() if b == "torch_ref"}
    bad.update({op: f for op, f in kernel_families.items()
                if f == "simple-forced"})
    if not bad:
        return []
    ops = sorted(bad)
    return [Finding(
        "jaxpr.kernel-backend", "error", "jaxpr", "kernel launches",
        f"kernel op class(es) {', '.join(ops)} ran "
        f"{'/'.join(sorted(set(bad.values())))} versions inside a "
        f"timed-run region — the timing measures a stand-in, not the "
        f"hand-written kernels",
        hint="time on the card with the registry's auto choice (no "
             "torch_ref request) and inputs the sm90 family takes (bf16, "
             "the widths its rule admits)",
        data={"kernel_backends": dict(kernel_backends),
              "kernel_families": dict(kernel_families)})]


def preflight_hbm(high_water_bytes, budget_bytes, context=""):
    """The HBM preflight as a pure helper: compare a step's memory figure
    (``hbm_high_water_bytes``) against a device budget and return the
    error Finding list ([] when it fits or either figure is unknown)."""
    if not high_water_bytes or not budget_bytes:
        return []
    if high_water_bytes <= budget_bytes:
        return []
    where = f" at {context}" if context else ""
    return [Finding(
        "hlo.hbm-preflight", "error", "hlo", context or "step",
        f"RESOURCE_EXHAUSTED (preflight): step hbm high-water "
        f"{high_water_bytes / (1 << 30):.2f} GiB > device limit "
        f"{budget_bytes / (1 << 30):.2f} GiB{where}",
        hint="reduce the sequence length / batch, enable "
             "memory_optimize(policy='offload'|'full') or "
             "gradient_accumulation, or shard over more cards",
        data={"hbm_high_water_bytes": int(high_water_bytes),
              "budget_bytes": int(budget_bytes)})]


# the versioned ``--lint --json`` output contract.  Bump ONLY when a
# key is renamed/removed or a meaning changes; adding keys is
# backward-compatible and needs no bump.
LINT_JSON_SCHEMA_VERSION = 1

_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def report_json(report, levels=None):
    """The schema-versioned JSON form of an ``AnalysisReport`` — the
    ``python -m paddle_tpu_torch --lint --json`` output contract, the
    reference's.

    Stable keys: ``schema_version``, ``levels`` (the artifact levels
    that ran), ``findings`` (each with ALL of check / severity / level /
    location / message / hint / data — ``data`` is ``{}`` when a check
    attached none), ``counts`` and ``ok``.  Findings sort by severity
    (errors first), then check id, location and message.
    ``report_from_json`` round-trips."""
    findings = sorted(
        report.findings,
        key=lambda f: (-_SEV_RANK[f.severity], f.check, f.location,
                       f.message))
    return {
        "schema_version": LINT_JSON_SCHEMA_VERSION,
        "levels": list(levels if levels is not None else LEVELS),
        "findings": [
            {"check": f.check, "severity": f.severity, "level": f.level,
             "location": f.location, "message": f.message,
             "hint": f.hint, "data": dict(f.data)}
            for f in findings
        ],
        "counts": report.counts(),
        "ok": report.ok,
    }


def report_from_json(obj):
    """Rebuild an ``AnalysisReport`` from ``report_json`` output (the
    round-trip half of the contract).  Refuses newer schema versions."""
    version = obj.get("schema_version")
    if version is None or int(version) > LINT_JSON_SCHEMA_VERSION:
        raise ValueError(
            f"unsupported lint JSON schema_version {version!r} "
            f"(this build reads <= {LINT_JSON_SCHEMA_VERSION})")
    return AnalysisReport([
        Finding(f["check"], f["severity"], f["level"], f["location"],
                f["message"], hint=f.get("hint", ""),
                data=f.get("data") or None)
        for f in obj.get("findings", ())
    ])


def lint_enabled():
    """The PADDLE_TPU_LINT kill switch (default on) — gates the
    Executor's fold-in at a cache miss."""
    return os.environ.get("PADDLE_TPU_LINT", "1").lower() not in (
        "0", "", "false")

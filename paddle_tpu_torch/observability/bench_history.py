"""Bench-history engine: read every ``BENCH_*.json`` / ``MULTICHIP_*.json``
artifact under a directory, classify the broken ones, and flag metric
regressions against best-so-far — the port's copy of
``paddle_tpu/observability/bench_history.py``, ported whole (standard
library only), with the same row stamp, classification, regression and
acknowledgement contracts.  It reads artifact files, whichever package
wrote them: a figure in them is that run's, on that run's hardware.

An artifact is the bench harness's wrapper around one benchmark
invocation::

    {"n": 4, "cmd": "...", "rc": 0, "tail": "...", "parsed": {
        "metric": "resnet50_train_images_per_sec_per_chip",
        "value": 2326.18, "unit": "img/s/chip", "vs_baseline": 12.4,
        "extra": {"gpt_tokens_per_sec_per_chip": 115689.9, ...}}}

Classification (``classify_artifact``) marks an artifact FAILED when its
``rc`` is nonzero, its row is missing/unparseable, or the row lacks the
required keys (``metric``/``value``) — each with a reason string.

Regression detection (``history``) builds one trajectory per tracked
metric (higher-is-better: img/s, tok/s, MFU, serving tok/s and speedup;
the ``_LOWER_IS_BETTER`` family — cost-model error
``gpt_attr_model_err_pct`` — inverts the direction) ordered by round and
flags any value more than ``threshold`` (default 10%) below the best
seen so far (above, for the lower-is-better family); multichip
``scaling_efficiency`` shows in the trajectory but is exempt from
flagging.  Known, root-caused failures are acknowledged via a JSON file
(``tools/bench_known_failures.json``).  Acks are scoped to the rot
class: ``{"BENCH_r05.json": reason}`` covers that artifact's
classification *failure*; a flagged *regression* needs its own
``{"BENCH_r05.json:gpt_mfu": reason}`` key.

Un-ack by evidence: a failed BENCH artifact whose tail carries the t=16k
OOM signature is auto-RESOLVED once a later-round BENCH artifact ships
``gpt_t16k_*`` keys.  An ack that outlives its defect reports under
``stale_acks`` as a WARNING.

Rows are stamped with ``run_stamp()`` (``schema_version`` / ``run_id`` /
``git_sha``) so trajectories can be keyed and joined; the tune cache
(``tune/cache.py``) and the reporter's ``run_meta`` record read the same
stamp, so a tune-cache entry and a corpus row of one checkout carry one
``git_sha``.
"""

import glob
import json
import os
import re
import uuid

__all__ = [
    "SCHEMA_VERSION", "run_stamp", "stamp_row", "scan_artifacts",
    "classify_artifact", "history", "format_table",
]

SCHEMA_VERSION = 1

# metric fields tracked across rounds — every one is higher-is-better.
# gate_flagship_gpt_seq is the RUNG the flagship row shipped at: a t/2
# fallback row halves it, which the >10% regression flagging catches —
# a fallback can never silently impersonate a true t=16k row.
_EXTRA_METRICS = (
    "gpt_tokens_per_sec_per_chip", "gpt_mfu", "gate_flagship_gpt_seq",
    "gpt_t16k_tune_tok_s",
)
# first-class LOWER-is-better trajectory metrics, each with the reason
# it tracks in this direction (the _REGRESSION_EXEMPT discipline:
# documented, not hardcoded).  Flagging inverts: a value more than
# ``threshold`` ABOVE the best (lowest) seen so far is a regression.
_LOWER_IS_BETTER = {
    # |roofline est - measured| / measured of the GPT step: the learned
    # cost model (tune/costmodel.py) exists to drive this DOWN, so the
    # trajectory must flag when model error WORSENS >10% vs best-so-far
    # — a silently decaying cost model mis-prunes every later search
    "gpt_attr_model_err_pct":
        "cost-model error: lower is better; tracked as |err| so the "
        "fitted model's drift vs best-so-far gates",
}
_MULTICHIP_METRICS = ("scaling_efficiency", "param_bytes_per_device",
                      "grad_bytes_per_device", "boundary_comm_bytes")
_SERVING_METRICS = ("tok_s", "speedup", "goodput_under_slo",
                    "prefix_hit_rate", "spec_goodput_under_slo",
                    "spec_accept_rate", "spec_speedup")

# a per-class share has to move at least this much (absolute) before
# the regression attribution names it — sub-2% wiggle is measurement
# noise, not an explanation
_ATTR_SHARE_EPS = 0.02
# surfaced in the trajectory table but EXEMPT from regression flagging,
# each with its root-caused reason (ROADMAP known-regression triage):
_REGRESSION_EXEMPT = {
    # virtual-CPU-mesh step times share host cores and are indicative
    # only (benchmarks/multichip.py) — the multichip gates are the
    # contract there
    "scaling_efficiency": "virtual-CPU-mesh step times are indicative "
                          "only; the multichip gates are the contract",
    # the r04 2403->2326 img/s/chip dip (-3.2%) reproduced as
    # shared-runner measurement noise: single-region timings on the
    # shared chip vary more than that, which is why timed_steps now
    # medians BENCH_REPEATS=5 independent regions and ships the
    # min/max spread in extra (resnet_img_s_min/max).  The tuned
    # workload sweep covers the GPT flagship (the config that actually
    # broke); a real ResNet regression would exceed the 10% threshold
    # of the median-of-regions value and still flag.
    "resnet50_train_images_per_sec_per_chip":
        "r04 dip root-caused as shared-runner noise; bench medians "
        "BENCH_REPEATS regions since (bench.py timed_steps)",
    # FSDP capacity figure from the tiny virtual-CPU-mesh smoke model:
    # LOWER is better (the flagger assumes higher-is-better) and the
    # absolute value tracks the toy model's size, not the engine —
    # gate_fsdp_param_sharding's <= replicated/(fsdp_degree/2) bound is
    # the contract (benchmarks/multichip.py)
    "param_bytes_per_device":
        "lower-is-better bytes figure on the virtual CPU mesh; the "
        "multichip gate_fsdp_param_sharding bound is the contract",
    # ZeRO-3 reduce-scatter comm figures, same discipline: both track
    # the toy smoke model's size on the virtual CPU mesh and LOWER is
    # better — gate_zero3_grad_rs's strict per < replicated bound and
    # zero3_grad_contract are the contracts (benchmarks/multichip.py)
    "grad_bytes_per_device":
        "lower-is-better bytes figure on the virtual CPU mesh; the "
        "multichip gate_zero3_grad_rs bound is the contract",
    "boundary_comm_bytes":
        "lower-is-better bytes figure on the virtual CPU mesh; "
        "zero3_grad_contract + gate_zero3_grad_rs are the contract",
}

# the t=16k rot class and its resolution evidence: a FAILED artifact
# whose tail shows the t=16k OOM signature is auto-resolved (no ack
# needed) once a LATER BENCH artifact ships gpt_t16k_* keys — the tuned
# flagship row (on TPU) or the static prune demonstration (off-TPU,
# bench.py BENCH_GPT_TUNE=1).  An ack left in place for a resolved or
# now-passing artifact is STALE and flags as a warning.
_T16K_EVIDENCE_PREFIX = "gpt_t16k"


def run_stamp(cwd=None):
    """The row identity stamp every bench row carries: schema version,
    a fresh run id, and the repo git sha (None outside a checkout)."""
    sha = None
    try:
        import subprocess

        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:  # noqa: BLE001 — the stamp must never kill a bench
        sha = None
    return {"schema_version": SCHEMA_VERSION,
            "run_id": uuid.uuid4().hex[:12],
            "git_sha": sha}


def stamp_row(row):
    """Apply :func:`run_stamp` to a bench row in place and return it —
    exception-safe, because the stamp must never kill the row (the
    one-parseable-JSON-line contract outranks row identity).  This is
    the ONE place the stamp contract lives; bench.py and the
    benchmarks/ scripts all route through it."""
    try:
        row.update(run_stamp())
    except Exception:  # noqa: BLE001
        pass
    return row


def scan_artifacts(root):
    """Sorted artifact paths under ``root`` (BENCH then MULTICHIP,
    round order within each)."""

    def key(p):
        name = os.path.basename(p)
        m = re.search(r"_r(\d+)", name)
        return (name.split("_")[0], int(m.group(1)) if m else 0, name)

    paths = (glob.glob(os.path.join(root, "BENCH_*.json"))
             + glob.glob(os.path.join(root, "MULTICHIP_*.json")))
    return sorted(paths, key=key)


def _round_of(name, data):
    n = data.get("n")
    if isinstance(n, int):
        return n
    m = re.search(r"_r(\d+)", name)
    return int(m.group(1)) if m else 0


def _row_from_tail(data):
    """The LAST parseable one-line JSON row with a ``metric`` key found
    in the wrapper's captured ``tail`` — the multichip artifacts carry
    their scaling row only there (the wrapper has no ``parsed`` field
    for them), and a bench row that printed but failed wrapper-side
    parsing is still recoverable this way."""
    tail = data.get("tail")
    if not isinstance(tail, str):
        return None
    row = None
    for line in tail.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue  # truncated / non-row line
        if isinstance(obj, dict) and "metric" in obj:
            row = obj
    return row


def classify_artifact(path):
    """One artifact -> classification row: ``{artifact, kind, round, rc,
    ok, reasons, metrics, run_id, git_sha}``."""
    name = os.path.basename(path)
    kind = "multichip" if name.startswith("MULTICHIP") else "bench"
    row = {"artifact": name, "kind": kind, "round": 0, "rc": None,
           "ok": True, "reasons": [], "metrics": {},
           "run_id": None, "git_sha": None,
           "t16k_class": False, "t16k_evidence": False,
           "attribution": {}}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        row["ok"] = False
        row["reasons"].append(f"unreadable artifact: {e}")
        return row
    if not isinstance(data, dict):
        # valid JSON but not an object (truncated/corrupt write that
        # still parses) — classify the rot, don't crash the gate on it
        row["ok"] = False
        row["reasons"].append(
            f"artifact is not a JSON object ({type(data).__name__})")
        m = re.search(r"_r(\d+)", name)
        row["round"] = int(m.group(1)) if m else 0
        return row
    row["round"] = _round_of(name, data)
    rc = data.get("rc")
    row["rc"] = rc
    if rc not in (0, None):
        row["reasons"].append(f"rc={rc}")
    if kind == "bench":
        parsed = data.get("parsed")
        if not isinstance(parsed, dict):
            # the wrapper failed to parse stdout — the row may still be
            # recoverable from the captured tail (wrapper rot, not
            # bench rot)
            parsed = _row_from_tail(data)
        if not isinstance(parsed, dict):
            row["reasons"].append("no parseable row (parsed is null)")
        else:
            for k in ("metric", "value"):
                if parsed.get(k) is None:
                    row["reasons"].append(f"row missing key {k!r}")
            row["run_id"] = parsed.get("run_id")
            row["git_sha"] = parsed.get("git_sha")
            metric, value = parsed.get("metric"), parsed.get("value")
            if isinstance(metric, str) and isinstance(value, (int, float)):
                row["metrics"][metric] = float(value)
            extra = parsed.get("extra") or {}
            for k in _EXTRA_METRICS:
                v = extra.get(k)
                if isinstance(v, (int, float)) and not isinstance(
                        v, bool):
                    row["metrics"][k] = float(v)
            for k in _LOWER_IS_BETTER:
                v = extra.get(k)
                if isinstance(v, (int, float)) and not isinstance(
                        v, bool):
                    # err_pct is SIGNED (negative = underestimate);
                    # model quality is its magnitude
                    row["metrics"][k] = abs(float(v))
            for k in _SERVING_METRICS:
                v = extra.get(f"serving_{k}")
                if isinstance(v, (int, float)):
                    row["metrics"][f"serving_{k}"] = float(v)
            row["t16k_evidence"] = any(
                k.startswith(_T16K_EVIDENCE_PREFIX) for k in extra)
            # per-op attribution tables riding the row (bench.py
            # _fold_attribution): keep each model's {class: share} map
            # so a flagged regression can be ATTRIBUTED by diffing the
            # two rounds' tables instead of just named
            from .attribution import share_table

            for akey in ("gpt_attribution", "resnet_attribution",
                         "attribution"):
                shares = share_table(extra.get(akey))
                if shares:
                    row["attribution"][
                        akey.replace("_attribution", "")
                        or "attribution"] = shares
        if row["reasons"]:
            # rot-class the failure: the t=16k OOM signature — the
            # 16384 sequence length TOGETHER with an allocator-dump
            # marker (the BENCH_r05 tail is the truncated XLA buffer
            # table: "Allocation type: HLO temp" around the
            # bf16[6,16384,768] temps).  A future t=16384 failure with
            # a DIFFERENT cause (harness crash, new bug) must NOT
            # auto-resolve — it stays an unacknowledged failure.
            tail = data.get("tail")
            alloc_marks = ("RESOURCE_EXHAUSTED", "Out of memory",
                           "out of memory", "Failed to allocate",
                           "Allocation of ", "Allocation type: HLO temp")
            if isinstance(tail, str) and "16384" in tail and any(
                    m in tail for m in alloc_marks):
                row["t16k_class"] = True
    else:  # multichip
        if data.get("ok") is False:
            row["reasons"].append("ok=false")
        # the scaling row lives in the wrapper's tail (dryrun_multichip
        # prints it to stdout; the wrapper has no parsed field here)
        src = _row_from_tail(data) or data
        row["run_id"] = src.get("run_id")
        row["git_sha"] = src.get("git_sha")
        if src is not data and "error" in src:
            row["reasons"].append(
                f"row error: {str(src['error'])[:120]}")
        for k in _MULTICHIP_METRICS:
            v = src.get(k)
            if isinstance(v, (int, float)):
                row["metrics"][k] = float(v)
    row["ok"] = not row["reasons"]
    return row


def history(root, threshold=0.1, known_failures=None):
    """Classify every artifact under ``root`` and detect regressions.

    Returns ``(summary, rows)``: ``rows`` is the per-artifact
    classification; ``summary`` is ONE json-able row with ``failed`` /
    ``acknowledged`` / ``regressions`` and ``ok`` — the CI gate is
    ``summary["ok"]`` (True iff every failure is acknowledged under its
    artifact name and every regression under ``artifact:metric`` in the
    ``known_failures`` dict)."""
    known = dict(known_failures or {})
    rows = [classify_artifact(p) for p in scan_artifacts(root)]
    series = {}  # metric -> [(round, artifact, value)] in round order
    for row in sorted(rows, key=lambda r: (r["round"], r["artifact"])):
        for metric, value in row["metrics"].items():
            series.setdefault(metric, []).append(
                (row["round"], row["artifact"], value))
    regressions = []
    for metric, points in sorted(series.items()):
        if metric in _REGRESSION_EXEMPT:
            continue
        lower = metric in _LOWER_IS_BETTER
        best, best_at, best_artifact = None, None, None
        for rnd, artifact, value in points:
            if lower:
                # lower-is-better (cost-model error): flag a value more
                # than threshold ABOVE the best (lowest) seen so far
                worse = (best is not None and best > 0
                         and value > best * (1.0 + threshold))
            else:
                worse = (best is not None
                         and value < best * (1.0 - threshold))
            if worse:
                entry = {
                    "metric": metric, "round": rnd, "artifact": artifact,
                    "value": value, "best": best, "best_round": best_at,
                    "best_artifact": best_artifact,
                    "drop": round(abs(1.0 - value / best), 4),
                }
                if lower:
                    entry["direction"] = "lower_is_better"
                regressions.append(entry)
            if best is None or (value < best if lower else value > best):
                best, best_at, best_artifact = value, rnd, artifact
    # ATTRIBUTE each flagged regression: diff the regressed artifact's
    # per-op-class share table against the best round's and name the
    # classes whose share moved — "tok/s dropped 14% and the collective
    # share doubled" is actionable; a bare percentage is not.  Keyed
    # "artifact:metric" like the regression acks.
    att_of = {r["artifact"]: r.get("attribution") or {} for r in rows}
    regression_attribution = {}
    for r in regressions:
        if r["metric"].startswith("serving"):
            # no attribution table exists for the serving engine's
            # compiled programs — diffing the TRAINING step's shares
            # would confidently misdirect triage, so emit nothing
            continue
        model = "resnet" if "resnet" in r["metric"] else "gpt"
        now_sh = (att_of.get(r["artifact"], {}).get(model)
                  or att_of.get(r["artifact"], {}).get("attribution"))
        ref_sh = (att_of.get(r.get("best_artifact"), {}).get(model)
                  or att_of.get(r.get("best_artifact"), {}).get(
                      "attribution"))
        if not (isinstance(now_sh, dict) and isinstance(ref_sh, dict)):
            continue
        moved = []
        for cls in sorted(set(now_sh) | set(ref_sh)):
            delta = (now_sh.get(cls) or 0.0) - (ref_sh.get(cls) or 0.0)
            if abs(delta) >= _ATTR_SHARE_EPS:
                moved.append({
                    "op_class": cls,
                    "share_best": ref_sh.get(cls),
                    "share": now_sh.get(cls),
                    "delta": round(delta, 4),
                })
        if moved:
            moved.sort(key=lambda m: -abs(m["delta"]))
            regression_attribution[
                f"{r['artifact']}:{r['metric']}"] = moved
    failed = [r["artifact"] for r in rows if not r["ok"]]
    # un-ack by evidence: a FAILED artifact of the t=16k rot class is
    # RESOLVED — no ack needed — once a later-round BENCH artifact ships
    # gpt_t16k_* keys (the tuned flagship row, or the off-TPU static
    # prune demonstration).  This is what lets the BENCH_r05 entry leave
    # tools/bench_known_failures.json the moment the autotuned t=16k
    # evidence lands, instead of the ack rotting in place forever.
    evidence_rounds = [r["round"] for r in rows
                       if r["kind"] == "bench" and r["ok"]
                       and r.get("t16k_evidence")]
    resolved = {}
    for r in rows:
        if (not r["ok"] and r.get("t16k_class")
                and any(er > r["round"] for er in evidence_rounds)):
            er = min(e for e in evidence_rounds if e > r["round"])
            resolved[r["artifact"]] = (
                f"t=16k failure superseded by gpt_t16k_* evidence in "
                f"round {er}")
    # acks are scoped to the rot class they root-caused: a plain
    # artifact key covers that artifact's classification FAILURE; a
    # regression needs its own "artifact:metric" key — otherwise the
    # BENCH_r05 failure ack would silently green-light a future metric
    # regression in the regenerated artifact (new rot must fail CI)
    reg_keys = {f"{r['artifact']}:{r['metric']}" for r in regressions}
    acknowledged = sorted(
        set(a for a in failed if a in known)
        | set(k for k in reg_keys if k in known))
    unacknowledged = (
        [a for a in failed if a not in known and a not in resolved]
        + sorted(k for k in reg_keys if k not in known))
    # a stale ack is a WARNING, not a failure: the acknowledged defect
    # no longer exists — the ack entry should be deleted from the
    # known-failures file.  A plain (failure) ack is stale when its
    # artifact classifies ok or was resolved by evidence; an
    # "artifact:metric" (regression) ack is stale only when that
    # regression no longer flags — the artifact classifying ok is the
    # NORMAL state for a still-acked regression, not staleness.
    ok_names = {r["artifact"] for r in rows if r["ok"]}
    stale_acks = sorted(
        k for k in known
        if ((":" in k and k not in reg_keys
             and k.split(":")[0] in ok_names)
            or (":" not in k and (k in ok_names or k in resolved))))
    summary = {
        "metric": "bench_history",
        "schema_version": SCHEMA_VERSION,
        "root": os.path.abspath(root),
        "threshold": threshold,
        "artifacts": len(rows),
        "rounds": sorted({r["round"] for r in rows}),
        "metrics_tracked": sorted(series),
        "failed": failed,
        "failed_reasons": {r["artifact"]: r["reasons"]
                           for r in rows if not r["ok"]},
        "acknowledged": acknowledged,
        "resolved": resolved,
        "stale_acks": stale_acks,
        "regressions": regressions,
        "regression_attribution": regression_attribution,
        "ok": not unacknowledged,
    }
    return summary, rows


def format_table(rows):
    """Human-readable trajectory table (stderr companion of the JSON
    summary row)."""
    out = [f"{'artifact':<22}{'round':>6}{'rc':>4}{'ok':>4}  metrics"]
    for r in rows:
        mets = " ".join(
            f"{k}={v:g}" for k, v in sorted(r["metrics"].items()))
        if not r["ok"]:
            mets = (mets + " " if mets else "") + \
                "FAILED: " + "; ".join(r["reasons"])
        out.append(f"{r['artifact']:<22}{r['round']:>6}"
                   f"{str(r['rc']):>4}{('y' if r['ok'] else 'N'):>4}"
                   f"  {mets}")
    return "\n".join(out)

"""Cross-run measurement corpus — the dataset the learned cost model
fits on (``tune/costmodel.py``).  The port's copy of
``paddle_tpu/observability/corpus.py``, with its row shape, ingests and
classify-not-crash contract.

Every subsystem already EMITS the measurements: trainer JSONL step
records carry the attribution summary and the measured wall time
(``observability/reporter.py``), bench artifacts carry per-op-class
tables, and the tune cache stores every measured candidate's median step
time with its flops and memory figures.  This module reads them all back
into ONE append-only row shape::

    {"schema_version": 1, "source": "trainer_jsonl", "workload":
     "op=step|t=128|...|plat=gpu|remat=-|kb=unknown", "platform": "gpu",
     "backend": "unknown", "measured_ms": 412.7, "est_ms": 3.1,
     "err_pct": -99.2, "flops": ..., "bytes": ..., "ops": ...,
     "classes": {cls: {"flops", "bytes", "ops", "est_ms"}},
     "git_sha": ..., "run_id": ..., "step": ...}

A truncated JSONL line, a step record missing its attribution fields, a
non-object artifact JSON — each is CLASSIFIED into ``corpus.skipped``
(source, reason) and never crashes the ingest.  Duplicate ``(run_id,
step, workload)`` rows dedup (re-ingesting a file is idempotent).
Workload keys are normalized via ``attribution.normalize_workload_key``
(the port's keys carry no ``|kb=`` token yet, so they join as
``kb=unknown``).  The rows feed ``tune.fit_and_save``.
"""

import json
import os

from . import attribution as _attr

__all__ = ["SCHEMA_VERSION", "Corpus", "workload_field"]

SCHEMA_VERSION = 1

# the attribution prefixes bench.py folds per-model tables under
_ARTIFACT_PREFIXES = ("gpt_", "resnet_", "")


def workload_field(key, name):
    """One ``name=value`` token of a canonical workload-key string, or
    None (``workload_field("op=step|...|plat=cpu", "plat") == "cpu"``)."""
    if not isinstance(key, str):
        return None
    for tok in key.split("|"):
        if tok.startswith(name + "="):
            return tok[len(name) + 1:] or None
    return None


class Corpus:
    """In-memory corpus with classify-not-crash ingestion.

    ``rows``    the accepted measurement rows (append-only);
    ``skipped`` ``(source, reason)`` pairs for everything classified
                away — the ingest analog of bench-history's failed-
                artifact reasons.
    """

    def __init__(self):
        self.rows = []
        self.skipped = []
        self._seen = set()

    def __len__(self):
        return len(self.rows)

    def _skip(self, source, reason):
        self.skipped.append((str(source), str(reason)))

    # -- the one row gate --------------------------------------------------
    def add_row(self, source, workload=None, measured_ms=None,
                est_ms=None, err_pct=None, flops=None, nbytes=None,
                ops=None, classes=None, platform=None, backend=None,
                git_sha=None, run_id=None, step=None,
                hbm_high_water_bytes=None, hbm_est_bytes=None):
        """Validate, normalize and append one measurement row; returns
        True when accepted, False when classified into ``skipped``."""
        if not isinstance(measured_ms, (int, float)) or measured_ms <= 0:
            self._skip(source, "no positive measured_ms")
            return False
        if est_ms is None and flops is None and not classes:
            self._skip(source, "no attribution fields "
                               "(est_ms/flops/classes all missing)")
            return False
        workload = _attr.normalize_workload_key(workload)
        row = {
            "schema_version": SCHEMA_VERSION,
            "source": str(source),
            "workload": workload,
            "platform": (platform or workload_field(workload, "plat")
                         or "unknown"),
            "backend": (backend or workload_field(workload, "kb")),
            "measured_ms": float(measured_ms),
            "est_ms": float(est_ms) if isinstance(
                est_ms, (int, float)) else None,
            "err_pct": float(err_pct) if isinstance(
                err_pct, (int, float)) else None,
            "flops": flops, "bytes": nbytes, "ops": ops,
            "classes": classes if isinstance(classes, dict) else None,
            "git_sha": git_sha, "run_id": run_id, "step": step,
        }
        if isinstance(hbm_high_water_bytes, (int, float)):
            row["hbm_high_water_bytes"] = hbm_high_water_bytes
        if isinstance(hbm_est_bytes, (int, float)):
            row["hbm_est_bytes"] = hbm_est_bytes
        dk = (row["run_id"] or row["source"], row["step"],
              row["workload"])
        if dk in self._seen:
            self._skip(source, f"duplicate (run_id, step) row {dk}")
            return False
        self._seen.add(dk)
        self.rows.append(row)
        return True

    # -- trainer JSONL -----------------------------------------------------
    def ingest_trainer_jsonl(self, path):
        """Ingest a ``MetricsReporter`` JSONL file: one corpus row per
        ``step`` record that measured a wall time and carried
        attribution fields.  The file's ``run_meta`` record supplies
        ``run_id``/``git_sha`` (reporters stamp it via ``run_stamp``;
        older files without one fall back to per-file identity).
        Returns the number of rows accepted."""
        src = os.path.basename(str(path))
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError as e:
            self._skip(src, f"unreadable JSONL: {e}")
            return 0
        accepted = 0
        run_id = git_sha = None
        with fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    self._skip(src, f"line {lineno}: truncated or "
                                    f"non-JSON line")
                    continue
                if not isinstance(rec, dict):
                    self._skip(src, f"line {lineno}: not a JSON object")
                    continue
                ev = rec.get("event")
                if ev == "run_meta":
                    run_id = rec.get("run_id") or run_id
                    git_sha = rec.get("git_sha") or git_sha
                    continue
                if ev != "step":
                    continue  # pass records etc. are expected, not rot
                wall = rec.get("wall_time")
                if not isinstance(wall, (int, float)) or wall <= 0:
                    self._skip(src, f"line {lineno}: step record has "
                                    f"no measured wall_time")
                    continue
                classes = self._compact_classes(rec.get("attr_classes"))
                if self.add_row(
                        f"trainer_jsonl:{src}",
                        workload=rec.get("attr_workload"),
                        measured_ms=wall * 1e3,
                        est_ms=rec.get("attr_est_ms"),
                        err_pct=rec.get("attr_model_err_pct"),
                        flops=rec.get("flops"),
                        nbytes=rec.get("bytes_accessed"),
                        ops=self._ops_total(classes),
                        classes=classes,
                        git_sha=git_sha,
                        run_id=run_id or f"file:{src}",
                        step=rec.get("step"),
                        hbm_high_water_bytes=rec.get(
                            "compiled_hbm_high_water_bytes")):
                    accepted += 1
        return accepted

    @staticmethod
    def _compact_classes(raw):
        """The reporter's compact per-class form ``{cls: [flops, bytes,
        ops, est_ms]}`` (or a full dict-of-dicts table) -> the corpus
        class shape; None when absent/malformed."""
        if not isinstance(raw, dict) or not raw:
            return None
        out = {}
        for cls, v in raw.items():
            if isinstance(v, (list, tuple)) and len(v) >= 4:
                out[cls] = {"flops": v[0], "bytes": v[1], "ops": v[2],
                            "est_ms": v[3]}
            elif isinstance(v, dict):
                out[cls] = {k: v.get(k) for k in
                            ("flops", "bytes", "ops", "est_ms")}
        return out or None

    @staticmethod
    def _ops_total(classes):
        if not classes:
            return None
        t = sum((c.get("ops") or 0) for c in classes.values())
        return t or None

    # -- bench / multichip / serving artifacts -----------------------------
    def ingest_artifact(self, path):
        """Ingest one bench artifact (``BENCH_*.json`` /
        ``MULTICHIP_*.json`` wrapper): every ``<prefix>attribution``
        table in the row's extras becomes one corpus row, with the
        measured step time reconstructed from the shipped
        ``est_ms``/``err_pct`` pair.  Malformed artifacts classify into
        ``skipped`` exactly like ``bench_history.classify_artifact``
        does.  Returns the number of rows accepted."""
        name = os.path.basename(str(path))
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError) as e:
            self._skip(name, f"unreadable artifact: {e}")
            return 0
        if not isinstance(data, dict):
            self._skip(name, f"artifact is not a JSON object "
                             f"({type(data).__name__})")
            return 0
        from .bench_history import _row_from_tail

        parsed = data.get("parsed")
        if not isinstance(parsed, dict):
            parsed = _row_from_tail(data) or (
                data if "metric" in data else None)
        if not isinstance(parsed, dict):
            self._skip(name, "no parseable row (parsed is null)")
            return 0
        extra = parsed.get("extra") or {}
        if not isinstance(extra, dict):
            extra = {}
        accepted = 0
        found_any = False
        for prefix in _ARTIFACT_PREFIXES:
            att = extra.get(prefix + "attribution")
            if not isinstance(att, dict):
                continue
            found_any = True
            classes = self._compact_classes(att.get("classes"))
            est = extra.get(prefix + "attr_est_ms")
            if not isinstance(est, (int, float)):
                est = att.get("est_ms_total")
            err = extra.get(prefix + "attr_model_err_pct")
            measured = None
            if isinstance(est, (int, float)) and isinstance(
                    err, (int, float)) and err > -100.0:
                measured = est / (1.0 + err / 100.0)
            if measured is None:
                self._skip(f"{name}:{prefix or 'row'}",
                           "attribution table has no reconstructable "
                           "measured time (est_ms/err_pct missing)")
                continue
            flops = nbytes = None
            if classes:
                flops = sum((c.get("flops") or 0)
                            for c in classes.values()) or None
                nbytes = sum((c.get("bytes") or 0)
                             for c in classes.values()) or None
            if self.add_row(
                    f"bench_artifact:{name}:{prefix or 'row'}",
                    workload=att.get("workload"),
                    measured_ms=measured, est_ms=est, err_pct=err,
                    flops=flops, nbytes=nbytes,
                    ops=self._ops_total(classes), classes=classes,
                    git_sha=parsed.get("git_sha"),
                    run_id=parsed.get("run_id") or f"artifact:{name}",
                    step=None):
                accepted += 1
        if not found_any:
            self._skip(name, "no attribution tables in row extras")
        return accepted

    # -- tune cache --------------------------------------------------------
    def ingest_tune_cache(self, cache=None):
        """Ingest the tune cache's measured winners: every entry whose
        ``measured`` dict carries a ``median_s`` becomes one corpus row
        (companion geometry entries and config-only entries classify
        into ``skipped``).  Returns the number of rows accepted."""
        if cache is None:
            from ..tune.cache import get_cache

            cache = get_cache()
        accepted = 0
        for key_s, entry in sorted((cache.entries or {}).items()):
            meas = entry.get("measured") if isinstance(
                entry, dict) else None
            src = f"tune_cache:{key_s}"
            if not isinstance(meas, dict) or not isinstance(
                    meas.get("median_s"), (int, float)):
                self._skip(src, "entry has no measured median_s "
                                "(companion/config-only entry)")
                continue
            if self.add_row(
                    src, workload=key_s,
                    measured_ms=meas["median_s"] * 1e3,
                    flops=meas.get("flops"),
                    nbytes=meas.get("bytes_accessed"),
                    run_id=f"tunecache:{key_s}", step=None,
                    hbm_high_water_bytes=meas.get(
                        "hbm_high_water_bytes"),
                    hbm_est_bytes=meas.get("hbm_est_bytes")):
                accepted += 1
        return accepted

    # -- direct attribution tables -----------------------------------------
    def ingest_attribution(self, att, measured_step_s, run_id=None,
                           step=None, source="attribution"):
        """One (attribution table, measured step seconds) pair — the
        in-process path (``exe.last_attribution`` + a timed loop).
        Returns True when accepted."""
        rec = _attr.reconcile(att, measured_step_s)
        if rec is None:
            self._skip(source, "no attribution/measured pair to "
                               "reconcile")
            return False
        classes = {
            cls: {"flops": r.get("flops"), "bytes": r.get("bytes"),
                  "ops": r.get("ops"), "est_ms": r.get("est_ms")}
            for cls, r in (att.get("classes") or {}).items()
            if isinstance(r, dict)}
        return self.add_row(
            source, workload=att.get("workload"),
            measured_ms=rec["measured_ms"], est_ms=rec["est_ms"],
            err_pct=rec["err_pct"],
            flops=att.get("hlo_flops_total"),
            nbytes=att.get("bytes_total"),
            ops=att.get("ops_total"), classes=classes or None,
            run_id=run_id, step=step)

    # -- persistence -------------------------------------------------------
    def save_jsonl(self, path):
        """Append the corpus rows to ``path`` (append-only JSONL — the
        cross-run store grows, never rewrites)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            for row in self.rows:
                fh.write(json.dumps(row, sort_keys=True) + "\n")
        return path

    def load_jsonl(self, path):
        """Load a previously saved corpus file back (torn/garbage lines
        classify into ``skipped``, duplicates dedup).  Returns the
        number of rows accepted."""
        src = os.path.basename(str(path))
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError as e:
            self._skip(src, f"unreadable corpus: {e}")
            return 0
        accepted = 0
        with fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    self._skip(src, f"line {lineno}: truncated or "
                                    f"non-JSON line")
                    continue
                if not isinstance(row, dict):
                    self._skip(src, f"line {lineno}: not a JSON object")
                    continue
                if self.add_row(
                        row.get("source") or src,
                        workload=row.get("workload"),
                        measured_ms=row.get("measured_ms"),
                        est_ms=row.get("est_ms"),
                        err_pct=row.get("err_pct"),
                        flops=row.get("flops"), nbytes=row.get("bytes"),
                        ops=row.get("ops"), classes=row.get("classes"),
                        platform=row.get("platform"),
                        backend=row.get("backend"),
                        git_sha=row.get("git_sha"),
                        run_id=row.get("run_id"), step=row.get("step"),
                        hbm_high_water_bytes=row.get(
                            "hbm_high_water_bytes"),
                        hbm_est_bytes=row.get("hbm_est_bytes")):
                    accepted += 1
        return accepted

    def summary(self):
        """One json-able summary row (ingest report): row/skip counts,
        platforms, backends, sources."""
        plats, backs, sources = {}, {}, {}
        for r in self.rows:
            plats[r["platform"]] = plats.get(r["platform"], 0) + 1
            b = r.get("backend") or "unknown"
            backs[b] = backs.get(b, 0) + 1
            s = r["source"].split(":")[0]
            sources[s] = sources.get(s, 0) + 1
        return {
            "schema_version": SCHEMA_VERSION,
            "rows": len(self.rows),
            "skipped": len(self.skipped),
            "skip_reasons": sorted({reason.split(":")[-1].strip()
                                    for _s, reason in self.skipped})[:12],
            "platforms": plats,
            "backends": backs,
            "sources": sources,
        }

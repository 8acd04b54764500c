"""Learned cost model — the counterpart of ``paddle_tpu/tune/costmodel.py``,
ported whole (pure numpy): the same fit, the same file format, the same
consult points.

Model, per ``platform`` x op class::

    est_ms(class) = a * gflops + b * gbytes + c * ops

— ``a`` an effective inverse peak (ms per Gflop), ``b`` an effective
inverse memory bandwidth (ms per GB), ``c`` the per-call overhead.  A
platform-level TOTAL model (``a``/``b`` + one per-step constant) serves
rows with no per-class table, and a per-platform ``hbm_scale`` (clamped
to [1.0, 2.0] — the HBM bound is a prune, so calibration may only make
it more conservative) scales ``tune.space.estimate_gpt_step_hbm``.

Fitting is robust least squares (IRLS with Huber weights, nonnegative
coefficients, a deterministic holdout of every ``holdout_every``-th
row); ``holdout_err_pct`` is stored beside ``analytic_err_pct`` on the
same rows.

Persistence follows the tune cache (``tune/cache.py``): schema-versioned
JSON next to it (``PADDLE_TPU_COSTMODEL_PATH`` overrides), atomic
writes, and a corrupt / truncated / schema-mismatched file degrades to
the analytic defaults, counting ``tune.costmodel_errors``.
``PADDLE_TPU_COSTMODEL=0`` is the kill switch.  With no model file (the
port writes none yet: the corpus that feeds ``fit_and_save`` is ROADMAP.md
A5's next slice) every consult takes the analytic path.  The platform a
consult fits under is the default device's (``tune.cache.
device_platform``: ``"gpu"`` on the card, ``"cpu"`` on the CPU).
"""

import json
import os
import tempfile
import time

from ..observability import metrics as _obs

__all__ = [
    "COSTMODEL_SCHEMA_VERSION", "costmodel_enabled", "costmodel_path",
    "CostModel", "get_model", "reset_model", "fit_cost_model",
    "fit_and_save", "active_entry", "model_status", "current_platform",
    "predict_class_ms", "predict_row_ms", "hbm_scale_for",
    "predict_sched_ms",
]

COSTMODEL_SCHEMA_VERSION = 1
_ENV_KILL = "PADDLE_TPU_COSTMODEL"
_ENV_PATH = "PADDLE_TPU_COSTMODEL_PATH"

# hbm_scale clamp: the analytic HBM bound is a prune — calibration may
# only make it MORE conservative (scale up when measurements show the
# bound underestimates), never relax it below the hand-calibrated
# coefficients (a 0.5x scale would un-reject the BENCH_r05 class from
# toy-run evidence that never saw a capacity shape)
_HBM_SCALE_MIN, _HBM_SCALE_MAX = 1.0, 2.0


def costmodel_enabled():
    """``PADDLE_TPU_COSTMODEL=0`` kills every fitted-model consult: the
    attribution roofline, the static prune and the HBM bound all run on
    the analytic defaults, bit-exact to the pre-costmodel framework."""
    return os.environ.get(_ENV_KILL, "1").lower() not in (
        "0", "", "false", "off", "no")


def costmodel_path():
    """On-disk model location: ``PADDLE_TPU_COSTMODEL_PATH`` wins, else
    ``costmodel.json`` next to the tune cache — so a test that scopes
    ``PADDLE_TPU_TUNE_CACHE`` to a tmp dir scopes the cost model too."""
    p = os.environ.get(_ENV_PATH)
    if p:
        return os.path.expanduser(p)
    from .cache import cache_path

    return os.path.join(os.path.dirname(cache_path()), "costmodel.json")


def current_platform():
    """The platform consults fit under: the default device's
    (``tune.cache.device_platform``)."""
    from .cache import device_platform

    return device_platform()


class CostModel:
    """Load/consult/persist fitted coefficients with the tune cache's
    robustness contract: a file that fails to load degrades to the
    analytic defaults (``platforms == {}``), ``stale_reason`` says why,
    ``tune.costmodel_errors`` counts it, nothing crashes."""

    def __init__(self, path=None):
        self.path = path or costmodel_path()
        self.platforms = {}
        self.version = 0
        self.git_sha = None
        self.stale_reason = None
        self._load()

    def _reject(self, reason):
        self.stale_reason = reason
        self.platforms = {}
        self.version = 0
        _obs.get_registry().counter(
            "tune.costmodel_errors",
            help="cost-model files ignored (corrupt/truncated/schema); "
                 "analytic defaults applied, next fit rewrites").inc()

    def _load(self):
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
        except FileNotFoundError:
            return
        except (OSError, ValueError, UnicodeDecodeError) as e:
            self._reject(f"unreadable cost model: {type(e).__name__}: {e}")
            return
        if not isinstance(raw, dict) or not isinstance(
                raw.get("platforms"), dict):
            self._reject(
                "cost model is not a {schema_version, platforms} object")
            return
        if raw.get("schema_version") != COSTMODEL_SCHEMA_VERSION:
            self._reject(
                f"schema_version {raw.get('schema_version')!r} != "
                f"{COSTMODEL_SCHEMA_VERSION}")
            return
        plats = {}
        for plat, entry in raw["platforms"].items():
            if isinstance(entry, dict) and isinstance(
                    entry.get("total"), list) and len(entry["total"]) == 3:
                plats[plat] = entry
        self.platforms = plats
        self.version = int(raw.get("version") or 0)
        self.git_sha = raw.get("git_sha")

    def entry(self, platform=None):
        """The fitted per-platform entry, or None (analytic)."""
        e = self.platforms.get(platform or current_platform())
        return e if isinstance(e, dict) else None

    def save(self):
        """Atomic persist (tmp + rename), tune-cache style."""
        from .cache import _git_sha

        payload = {
            "schema_version": COSTMODEL_SCHEMA_VERSION,
            "version": self.version,
            "git_sha": _git_sha(),
            "created_at": time.time(),
            "platforms": self.platforms,
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".costmodel.", suffix=".tmp",
                                   dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path


_model_singleton = []  # [(resolved_path, CostModel)]


def get_model():
    """Process-wide model bound to the CURRENT resolved path — changing
    ``PADDLE_TPU_COSTMODEL_PATH``/``PADDLE_TPU_TUNE_CACHE`` re-loads."""
    path = costmodel_path()
    if _model_singleton and _model_singleton[0][0] == path:
        return _model_singleton[0][1]
    m = CostModel(path)
    _model_singleton[:] = [(path, m)]
    return m


def reset_model():
    """Drop the in-process singleton (next get_model() re-reads disk)."""
    _model_singleton[:] = []


def active_entry(platform=None):
    """The fitted entry the consult points use, or None when the kill
    switch is set, no model file fit this platform, or the file was
    rejected — None means "take exactly the analytic code path"."""
    if not costmodel_enabled():
        return None
    return get_model().entry(platform)


def model_status(platform=None):
    """The ``costmodel`` status dict recorded in ``last_step_cost`` and
    trainer JSONL: ``{"mode": "fitted"|"analytic", "version",
    "train_rows", "holdout_err_pct"}`` (analytic mode carries only the
    mode — there is nothing fitted to describe)."""
    e = active_entry(platform)
    if e is None:
        return {"mode": "analytic"}
    return {"mode": "fitted", "version": get_model().version,
            "train_rows": e.get("train_rows"),
            "holdout_err_pct": e.get("holdout_err_pct")}


def hbm_scale_for(platform=None):
    """The calibrated HBM-bound scale (>= 1.0; exactly 1.0 when
    analytic, so ``estimate_gpt_step_hbm`` stays bit-exact)."""
    e = active_entry(platform)
    if e is None:
        return 1.0
    try:
        s = float(e.get("hbm_scale") or 1.0)
    except (TypeError, ValueError):
        return 1.0
    return min(max(s, _HBM_SCALE_MIN), _HBM_SCALE_MAX)


# -- prediction -----------------------------------------------------------
def _coeffs(entry, cls):
    """(a, b, c) for an op class — the class's own fit when present,
    else the platform total's a/b with zero per-call overhead (the
    per-step constant is not a per-class quantity)."""
    cl = entry.get("classes") or {}
    co = cl.get(cls)
    if isinstance(co, list) and len(co) == 3:
        return float(co[0]), float(co[1]), float(co[2])
    a, b, _c = entry["total"]
    return float(a), float(b), 0.0


def predict_class_ms(entry, cls, flops, nbytes, ops):
    """One class's fitted estimate: ``(est_ms, compute_ms, mem_ms)`` —
    the compute/memory split keeps the bound verdict meaningful."""
    a, b, c = _coeffs(entry, cls)
    compute_ms = a * (flops or 0) / 1e9
    mem_ms = b * (nbytes or 0) / 1e9
    return compute_ms + mem_ms + c * (ops or 0), compute_ms, mem_ms


def predict_row_ms(entry, row):
    """A corpus row's fitted total estimate: the per-class sum when the
    row carries a class table, else the platform total model (with its
    per-step constant)."""
    classes = row.get("classes")
    if isinstance(classes, dict) and classes:
        total = 0.0
        for cls, r in classes.items():
            if not isinstance(r, dict):
                continue
            ms, _co, _me = predict_class_ms(
                entry, cls, r.get("flops"), r.get("bytes"), r.get("ops"))
            total += ms
        return total
    a, b, c = entry["total"]
    return (a * (row.get("flops") or 0) / 1e9
            + b * (row.get("bytes") or 0) / 1e9 + c)


def predict_sched_ms(entry, sched_flops):
    """Fitted cost of a flash schedule's MXU work — the figure
    ``prune_static``'s roofline slack compares when a model is loaded.
    Monotonic in ``sched_flops`` (a >= 0), so candidate ORDERING under
    the fitted model matches the analytic flop ordering; only the slack
    RATIO moves (the per-step overhead dilutes small flop deltas)."""
    a_cls, b_cls, _c = _coeffs(entry, "pallas")
    _a, _b, c_step = entry["total"]
    return a_cls * sched_flops / 1e9 + c_step


# -- fitting --------------------------------------------------------------
def _irls_nonneg(X, y, iters=5):
    """Robust nonnegative least squares: IRLS with Huber weights over a
    ridge-stabilized normal solve, coefficients clamped >= 0 each
    round.  Deterministic (numpy only, fixed iteration count)."""
    import numpy as np

    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, k = X.shape
    w = np.ones(n)
    beta = np.zeros(k)
    ridge = 1e-9 * np.eye(k)
    for _ in range(iters):
        Xw = X * w[:, None]
        try:
            beta = np.linalg.solve(Xw.T @ X + ridge, Xw.T @ y)
        except np.linalg.LinAlgError:
            break
        beta = np.maximum(beta, 0.0)
        resid = y - X @ beta
        scale = np.median(np.abs(resid)) * 1.4826 + 1e-12
        r = np.abs(resid) / scale
        w = np.where(r <= 1.345, 1.0, 1.345 / r)
    return [float(b) for b in beta]


def _median_abs_err_pct(pairs):
    """Median |est - measured| / measured * 100 over (est, measured)."""
    errs = sorted(abs(e - m) / m * 100.0 for e, m in pairs if m > 0)
    if not errs:
        return None
    mid = len(errs) // 2
    if len(errs) % 2:
        return round(errs[mid], 2)
    return round((errs[mid - 1] + errs[mid]) / 2.0, 2)


def _row_sort_key(row):
    return (str(row.get("workload") or ""), str(row.get("run_id") or ""),
            row.get("step") or 0, str(row.get("source") or ""))


def fit_cost_model(rows, holdout_every=4):
    """Fit per-platform coefficients on corpus rows (dicts with
    ``platform`` / ``measured_ms`` / ``flops`` / ``bytes`` / optional
    ``ops`` / ``classes`` / ``est_ms``).  Returns the ``platforms``
    payload a :class:`CostModel` persists; platforms with fewer than 3
    usable rows are left unfitted (analytic).

    Split is deterministic: rows sort by (workload, run_id, step,
    source) and every ``holdout_every``-th is held out.  Per-class
    coefficients fit against PROPORTIONALLY ALLOCATED measured time
    (each class's share of the row's analytic estimate — the standard
    trick when only whole-step walls are measured); rows without a
    class table feed the platform total model only."""
    by_plat = {}
    for row in rows or []:
        if not isinstance(row, dict):
            continue
        m = row.get("measured_ms")
        if not isinstance(m, (int, float)) or m <= 0:
            continue
        by_plat.setdefault(row.get("platform") or "unknown",
                           []).append(row)
    platforms = {}
    for plat, prows in sorted(by_plat.items()):
        prows = sorted(prows, key=_row_sort_key)
        if len(prows) < 3:
            continue
        step = max(2, int(holdout_every))
        holdout = [r for i, r in enumerate(prows) if i % step == step - 1]
        train = [r for i, r in enumerate(prows) if i % step != step - 1]
        if not holdout or len(train) < 2:
            continue
        # platform TOTAL model: [gflops, gbytes, 1] -> measured_ms
        X = [[(r.get("flops") or 0) / 1e9, (r.get("bytes") or 0) / 1e9,
              1.0] for r in train]
        y = [float(r["measured_ms"]) for r in train]
        total = _irls_nonneg(X, y)
        # per-class refinement on allocated measured time
        alloc = {}  # cls -> ([features], [allocated_ms])
        for r in train:
            classes = r.get("classes")
            if not isinstance(classes, dict) or not classes:
                continue
            est_total = sum(
                (c.get("est_ms") or 0.0) for c in classes.values()
                if isinstance(c, dict))
            for cls, c in sorted(classes.items()):
                if not isinstance(c, dict):
                    continue
                if est_total > 0:
                    w = (c.get("est_ms") or 0.0) / est_total
                else:
                    nb = sum((x.get("bytes") or 0)
                             for x in classes.values()
                             if isinstance(x, dict))
                    w = ((c.get("bytes") or 0) / nb) if nb else (
                        1.0 / len(classes))
                feats, targs = alloc.setdefault(cls, ([], []))
                feats.append([(c.get("flops") or 0) / 1e9,
                              (c.get("bytes") or 0) / 1e9,
                              float(c.get("ops") or 0)])
                targs.append(float(r["measured_ms"]) * w)
        class_coeffs = {}
        for cls, (feats, targs) in sorted(alloc.items()):
            if len(feats) >= 2 and any(t > 0 for t in targs):
                class_coeffs[cls] = [
                    round(v, 10) for v in _irls_nonneg(feats, targs)]
        entry = {
            "total": [round(v, 10) for v in total],
            "classes": class_coeffs,
            "train_rows": len(train),
            "holdout_rows": len(holdout),
        }
        # post-fit calibration: the per-class fits are INDEPENDENT
        # regressions on allocated time, so their sum can drift
        # systematically from the measured wall — one median
        # measured/predicted ratio over the train rows recenters every
        # coefficient (a single positive scalar, so candidate ordering
        # under predict_sched_ms is untouched)
        cal = sorted(float(r["measured_ms"]) / p for r, p in
                     ((r, predict_row_ms(entry, r)) for r in train)
                     if p > 0)
        if cal:
            s = cal[len(cal) // 2]
            if s > 0:
                entry["total"] = [round(v * s, 10)
                                  for v in entry["total"]]
                entry["classes"] = {
                    cls: [round(v * s, 10) for v in co]
                    for cls, co in entry["classes"].items()}
        # hbm_scale: measured-vs-estimated HBM high water, where rows
        # carry both (tune-cache measured candidates under a budget)
        ratios = sorted(
            r["hbm_high_water_bytes"] / r["hbm_est_bytes"]
            for r in prows
            if isinstance(r.get("hbm_high_water_bytes"), (int, float))
            and isinstance(r.get("hbm_est_bytes"), (int, float))
            and r["hbm_est_bytes"] > 0 and r["hbm_high_water_bytes"] > 0)
        if ratios:
            mid = ratios[len(ratios) // 2]
            entry["hbm_scale"] = round(
                min(max(mid, _HBM_SCALE_MIN), _HBM_SCALE_MAX), 4)
        else:
            entry["hbm_scale"] = 1.0
        # holdout scoring: fitted vs the analytic estimate RECORDED on
        # the same rows (est_ms is what the analytic roofline said at
        # measure time — the selftest seeds the corpus pre-fit, so the
        # comparison is apples-to-apples)
        fitted_pairs, analytic_pairs = [], []
        for r in holdout:
            m = float(r["measured_ms"])
            fitted_pairs.append((predict_row_ms(entry, r), m))
            if isinstance(r.get("est_ms"), (int, float)):
                analytic_pairs.append((float(r["est_ms"]), m))
        entry["holdout_err_pct"] = _median_abs_err_pct(fitted_pairs)
        entry["analytic_err_pct"] = _median_abs_err_pct(analytic_pairs)
        platforms[plat] = entry
    return platforms


def fit_and_save(corpus_or_rows, path=None):
    """Fit on a corpus (or raw row list), persist next to the tune
    cache, and return the saved :class:`CostModel`.  The singleton is
    reset so the next consult sees the new fit."""
    rows = getattr(corpus_or_rows, "rows", corpus_or_rows)
    platforms = fit_cost_model(rows)
    m = CostModel(path)
    m.stale_reason = None
    m.platforms = platforms
    m.version = int(m.version or 0) + 1
    m.save()
    reset_model()
    return m

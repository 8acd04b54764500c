"""Persistent autotune config cache — the counterpart of
``paddle_tpu/tune/cache.py``, with the same file format::

    {"schema_version": 1,
     "fingerprint": "0f3a9c21bd04",
     "git_sha": "269de37a1b2c",
     "entries": {
        "op=gpt_step|t=4096|dh=128|h=6|dt=bfloat16|plat=gpu|remat=auto": {
            "config":   {"policy": "selective", "accum": 1,
                         "block_q": 1024, "block_k": 1024},
            "measured": {"median_s": 0.34, "tok_s": 96000.0, ...},
            "searched_at": 1754200000.0}}}

Location: ``PADDLE_TPU_TUNE_CACHE``, else
``~/.cache/paddle_tpu_torch/tuned.json`` — the port's own file, never the
JAX package's ``~/.cache/paddle_tpu/tuned.json``.

The ``fingerprint`` hashes the port's kernel geometry: the build key of
every ``csrc/`` source (``kernels._build``), ``FUSED_BWD_PARTIAL_BYTES``,
``SM90_MAX_D``, the static family and split rules sampled over
representative shapes, and the device's name.  An entry measured on
another card, under another kernel build, or by the JAX package (whose
fingerprint hashes its TPU geometry) is stale: the file is ignored and
the workload re-tunes.  A corrupt or truncated file, a schema mismatch
and a stale fingerprint each give an EMPTY cache and count
``tune.cache_errors`` — never a crash, never a wrong config served.
"""

import hashlib
import json
import os
import tempfile
import time

from ..observability import metrics as _obs

__all__ = ["CACHE_SCHEMA_VERSION", "cache_path", "geometry_fingerprint",
           "device_platform", "TuneCache", "get_cache", "reset_cache"]

CACHE_SCHEMA_VERSION = 1
_ENV_PATH = "PADDLE_TPU_TUNE_CACHE"


def cache_path():
    """``PADDLE_TPU_TUNE_CACHE`` wins, else
    ``~/.cache/paddle_tpu_torch/tuned.json``."""
    p = os.environ.get(_ENV_PATH)
    if p:
        return os.path.expanduser(p)
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "tuned.json")


def device_platform(device=None):
    """The workload key's ``plat=``: ``"gpu"`` for a CUDA device,
    ``"cpu"`` for the CPU (the JAX package's backend names).  ``None``
    is the default device: the card when one is usable, else the CPU."""
    import torch

    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _device_name():
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(torch.cuda.current_device())


def geometry_fingerprint():
    """Content hash of the port's kernel-geometry decision surface (the
    module docstring's list)."""
    import torch

    from ..kernels import _build
    from ..kernels import flash_attention as fa
    from ..kernels import fused_ce as ce
    from ..kernels import paged_attention as pa

    bf, f32 = torch.bfloat16, torch.float32
    basis = (
        CACHE_SCHEMA_VERSION,
        tuple((n, _build._digest(n)) for n in _build.sources()),
        fa.FUSED_BWD_PARTIAL_BYTES, fa.SM90_MAX_D, ce.SM90_MAX_D,
        tuple(fa.FLASH_BWD_RESIDUALS),
        tuple(fa.bwd_route((8, t, 6, 128), t, 2, bk)
              for t in (1024, 4096, 16384) for bk in (256, 1024)),
        tuple(fa.bwd_family(dt, d, [(128, 128, 128)], [0])
              for dt in (bf, f32) for d in (64, 128, 256)),
        tuple(ce.ce_family(dt, d, 32768, [0])
              for dt in (bf, f32) for d in (512, 768, 1024)),
        tuple(pa.paged_family(dt, 32, w, 6, dh, b, [0])
              for dt in (bf, f32) for w in (1, 4, 9)
              for dh in (64, 128) for b in (16, 32, 128)),
        tuple(pa.paged_splits(s, h, nb)
              for s in (1, 8, 32) for h in (2, 6) for nb in (4, 16, 64)),
        tuple((h, d, fa.packed_sub_heads(h, d))
              for h in (1, 2, 3, 4, 6, 8) for d in (32, 64, 128, 256)),
        tuple(fa._pick_block(t, c)
              for t in (96, 2048, 4096, 16384)
              for c in (128, 256, 512, 1024, 2048)),
        # the schedule dimensions a persisted gpt_step winner carries
        ("policy", "accum", "fsdp", "block_q", "block_k", "packed"),
        _device_name(),
    )
    return hashlib.sha256(repr(basis).encode()).hexdigest()[:12]


def _git_sha():
    """The checkout's git sha as the bench stamp gives it
    (``observability.bench_history.run_stamp``), or None — one stamp for
    the tune cache, the cost model and the corpus rows."""
    try:
        from ..observability.bench_history import run_stamp

        return run_stamp().get("git_sha")
    except Exception:  # noqa: BLE001 — identity must never block caching
        return None


class TuneCache:
    """Load / look up / persist tuned configs with the robustness contract
    above.  ``stale_reason`` says why a file on disk was ignored (None
    when it loaded or did not exist).  The fingerprint is computed when a
    file is read or saved, so an absent cache costs no hashing."""

    def __init__(self, path=None):
        self.path = path or cache_path()
        self._fingerprint = None
        self.entries = {}
        self.stale_reason = None
        self._load()

    @property
    def fingerprint(self):
        if self._fingerprint is None:
            self._fingerprint = geometry_fingerprint()
        return self._fingerprint

    def _reject(self, reason):
        self.stale_reason = reason
        self.entries = {}
        _obs.get_registry().counter(
            "tune.cache_errors",
            help="tune cache files ignored (corrupt/schema/fingerprint); "
                 "defaults applied, next search rewrites").inc()

    def _load(self):
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
        except FileNotFoundError:
            return
        except (OSError, ValueError, UnicodeDecodeError) as e:
            self._reject(f"unreadable cache: {type(e).__name__}: {e}")
            return
        if not isinstance(raw, dict) or not isinstance(
                raw.get("entries"), dict):
            self._reject("cache is not a {schema_version, entries} object")
            return
        if raw.get("schema_version") != CACHE_SCHEMA_VERSION:
            self._reject(
                f"schema_version {raw.get('schema_version')!r} != "
                f"{CACHE_SCHEMA_VERSION}")
            return
        if raw.get("fingerprint") != self.fingerprint:
            self._reject(
                f"kernel-geometry fingerprint {raw.get('fingerprint')!r} "
                f"is stale (current {self.fingerprint}, written at git "
                f"{raw.get('git_sha')!r})")
            return
        self.entries = {k: v for k, v in raw["entries"].items()
                        if isinstance(v, dict) and "config" in v}

    def get(self, key_s):
        """The entry for a canonical key string, or None."""
        e = self.entries.get(key_s)
        return e if isinstance(e, dict) else None

    def put(self, key_s, config, measured=None):
        entry = {"config": dict(config), "searched_at": time.time()}
        if measured:
            entry["measured"] = dict(measured)
        self.entries[key_s] = entry
        return entry

    def save(self):
        """Atomic persist (tmp + rename): a reader never sees a torn
        file, and a crash mid-write leaves the previous cache intact."""
        payload = {
            "schema_version": CACHE_SCHEMA_VERSION,
            "fingerprint": self.fingerprint,
            "git_sha": _git_sha(),
            "entries": self.entries,
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tuned.", suffix=".tmp", dir=d)
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


_cache_singleton = []  # [(resolved_path, TuneCache)]


def get_cache():
    """Process-wide cache bound to the CURRENT resolved path — changing
    ``PADDLE_TPU_TUNE_CACHE`` re-loads."""
    path = cache_path()
    if _cache_singleton and _cache_singleton[0][0] == path:
        return _cache_singleton[0][1]
    c = TuneCache(path)
    _cache_singleton[:] = [(path, c)]
    return c


def reset_cache():
    """Drop the in-process singleton (the next get_cache() re-reads the
    file)."""
    _cache_singleton[:] = []

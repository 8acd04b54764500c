"""DataFeeder — convert Python minibatches to feed dicts.  The port's own
copy of ``paddle_tpu/data_feeder.py`` (numpy only).

Reference: fluid/data_feeder.py (numpy → LoDTensor with LoD set from ragged
lists).  Ragged rows pad to a bucketed max length (rounded up to a
multiple of ``pad_multiple`` so the step sees few distinct shapes) and
fill the shadow ``<name>@LENGTH`` variable — same information as LoD,
static shapes.

The feeder returns host numpy arrays; the Executor, or
``reader.prefetch_to_device``, moves them to the device.  numpy has no
bfloat16, so a bf16 variable's column is built in float32 and the
Executor rounds it to bf16 when it moves it (round to nearest even, as
``ml_dtypes`` rounds the reference's feed).  ``place`` is resolved at
construction: None means the card, and with no card it raises; the CPU
is ``CPUPlace()``.
"""

import numpy as np

from .core.place import resolve_device
from .core.program import (IDS_SUFFIX, LENGTH_SUFFIX, SUBLENGTH_SUFFIX,
                           VALS_SUFFIX)
from .reader.provider import SparseRow


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _np_dtype(dtype):
    """The host dtype of a variable's column (bf16 is built in f32)."""
    name = getattr(dtype, "name", str(dtype))
    return np.dtype("float32" if name == "bfloat16" else name)


class DataFeeder:
    def __init__(self, feed_list, place=None, pad_multiple=8):
        self.feed_vars = feed_list
        self.place = place
        self.device = resolve_device(place)
        self.pad_multiple = pad_multiple

    def feed(self, data):
        """data: iterable of rows, each row a tuple with one entry per feed
        var.  Returns {name: ndarray} including @LENGTH entries for
        lod_level>0 vars."""
        rows = list(data)
        result = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in rows]
            dt = _np_dtype(var.dtype)
            if getattr(var, "sparse_slot", False):
                self._feed_sparse(var, col, result)
                continue
            # sparse provider slot feeding a DENSE var: densify (the
            # small-dim compatibility path; declare the var with
            # layers.sparse_data to stay sparse).  Sequence slots (cells
            # are lists of SparseRow) densify to [t, dim] rows and fall
            # through to the normal lod padding below.  Detection scans
            # for ANY sparse cell — sniffing only col[0] would skip
            # densification whenever the first sample happens to be an
            # empty sequence, crashing later in the lod padding path.
            kind, dim = self._sparse_kind(col)
            if kind == "row":
                col = [c.todense() for c in col]
            elif kind == "seq":
                # empty sequences densify to [0, dim] so the lod padding
                # below sees a consistent feature shape
                col = [np.stack([r.todense() for r in c]) if len(c)
                       else np.zeros((0, dim), np.float32) for c in col]
            if getattr(var, "lod_level", 0) > 1:
                self._feed_nested(var, col, result)
            elif getattr(var, "lod_level", 0) > 0:
                arrs = [np.asarray(c, dtype=dt) for c in col]
                lens = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
                max_len = max(1, _round_up(int(lens.max()), self.pad_multiple))
                feat = arrs[0].shape[1:]
                # honor a declared static time dim — but only when the
                # declared rank actually covers [b, t, *feat]; a
                # feature-only declaration (shape=[d], lod_level=1) must
                # not have its feature dim misread as the time cap (same
                # guard as _feed_nested)
                declared = (var.shape[1]
                            if len(var.shape) == 2 + len(feat) else -1)
                if declared and declared > 0:
                    max_len = declared
                out = np.zeros((len(arrs), max_len) + feat, dtype=dt)
                for j, a in enumerate(arrs):
                    t = min(a.shape[0], max_len)
                    out[j, :t] = a[:t]
                result[var.name] = out
                result[var.name + LENGTH_SUFFIX] = np.minimum(lens, max_len)
            else:
                arr = np.asarray(col, dtype=dt)
                want = [s for s in var.shape]
                if (
                    len(want) >= 2
                    and arr.ndim == len(want) - 1
                    and want[-1] == 1
                ):
                    arr = arr[..., None]  # fluid's trailing [.,1] label shape
                result[var.name] = arr
        return result

    @staticmethod
    def _sparse_kind(col):
        """Classify a column by its first UNAMBIGUOUS cell: ("row", dim)
        — cells are SparseRow samples; ("seq", dim) — cells are sequences
        of SparseRow; (None, None) — not sparse.  Only empty sequences
        are ambiguous (they say nothing about the inner type), so this
        stays O(1) on dense columns while still classifying a batch whose
        first cells are empty sparse sequences."""
        for c in col:
            if isinstance(c, SparseRow):
                return "row", c.dim
            if isinstance(c, (list, tuple)):
                if not c:
                    continue  # empty sequence: keep scanning
                if isinstance(c[0], SparseRow):
                    return "seq", c[0].dim
                return None, None  # ordinary nested list
            else:
                return None, None  # dense cell: not a sparse column
        return None, None

    def _feed_sparse(self, var, col, result):
        """Native sparse slot: pad each sample's (ids, vals) to the batch
        max nnz (bucketed by ``pad_multiple`` so the compile cache sees few
        distinct shapes) and emit ``@IDS``/``@VALS``.  Index 0 with value
        0.0 as padding keeps the sparse_fc weighted sum exact.  Sequence
        slots (lod_level=1: each cell a list of SparseRow) pad to
        [b, t_max, nnz_max] and fill ``@LENGTH``."""
        if getattr(var, "lod_level", 0) > 0:
            lens = np.asarray([len(c) for c in col], np.int32)
            max_t = max(1, _round_up(int(lens.max()), self.pad_multiple))
            nnz = max([1] + [r.nnz for c in col for r in c])
            nnz = _round_up(nnz, self.pad_multiple)
            ids = np.zeros((len(col), max_t, nnz), np.int64)
            vals = np.zeros((len(col), max_t, nnz), np.float32)
            # max_t/nnz are padded batch maxima, so no cell can truncate
            for j, c in enumerate(col):
                for k, r in enumerate(c):
                    ids[j, k, : r.nnz] = r.ids
                    vals[j, k, : r.nnz] = r.vals
            result[var.name + LENGTH_SUFFIX] = lens
        else:
            nnz = max(1, _round_up(max(c.nnz for c in col),
                                   self.pad_multiple))
            ids = np.zeros((len(col), nnz), np.int64)
            vals = np.zeros((len(col), nnz), np.float32)
            for j, c in enumerate(col):
                ids[j, : c.nnz] = c.ids
                vals[j, : c.nnz] = c.vals
        result[var.name + IDS_SUFFIX] = ids
        result[var.name + VALS_SUFFIX] = vals.astype(_np_dtype(var.dtype))

    def _feed_nested(self, var, col, result):
        """2-level (nested) rows: each sample is a list of sub-sequences,
        each sub-sequence a list/array of items — padded to
        [b, max_subseqs, max_items, ...] with ``@LENGTH`` [b] (sub-seqs
        per sample) and ``@SUBLENGTH`` [b, s] (items per sub-seq)."""
        dt = _np_dtype(var.dtype)
        samples = [[np.asarray(sub, dtype=dt) for sub in sample]
                   for sample in col]
        lens = np.asarray([len(s) for s in samples], np.int32)
        max_s = max(1, _round_up(int(lens.max()), self.pad_multiple))
        max_t = max([1] + [sub.shape[0] for s in samples for sub in s])
        max_t = _round_up(max_t, self.pad_multiple)
        feat = next((s[0].shape[1:] for s in samples if s), ())
        # declared static dims override BEFORE any allocation, so data,
        # @LENGTH and @SUBLENGTH always agree on [b, s, t] — but ONLY
        # when the declared rank actually covers [b, s, t, *feat]; a
        # feature-only declaration (shape=[d], lod_level=2) must not
        # have its feature dim misread as the sub-sequence cap
        declared = list(var.shape)
        if len(declared) == 3 + len(feat):
            if declared[1] and declared[1] > 0:
                max_s = declared[1]
            if declared[2] and declared[2] > 0:
                max_t = declared[2]
        sub_lens = np.zeros((len(samples), max_s), np.int32)
        for j, sample in enumerate(samples):
            for k, sub in enumerate(sample[:max_s]):
                sub_lens[j, k] = sub.shape[0]
        out = np.zeros((len(samples), max_s, max_t) + feat, dtype=dt)
        for j, sample in enumerate(samples):
            for k, sub in enumerate(sample[:max_s]):
                t = min(sub.shape[0], max_t)
                out[j, k, :t] = sub[:t]
        result[var.name] = out
        result[var.name + LENGTH_SUFFIX] = np.minimum(lens, max_s)
        result[var.name + SUBLENGTH_SUFFIX] = np.minimum(sub_lens, max_t)

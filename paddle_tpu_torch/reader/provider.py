"""PyDataProvider2 ``@provider`` protocol shim — the port's own copy of
``paddle_tpu/reader/provider.py`` (numpy only) (reference:
python/paddle/trainer/PyDataProvider2.py — the v1 in-process data-feed
decorator: ``@provider(input_types=...)`` over a
``process(settings, filename)`` generator, with init_hook settings,
CACHE_PASS_IN_MEM, and typed slots).

Re-design: the decorated generator becomes an ordinary
composable reader factory (``reader/__init__.py`` protocol) —
``process(file_list)`` returns a no-arg reader yielding converted rows
that ``DataFeeder`` pads/batches.  Sparse slots stay SPARSE end to end
(reference PyDataProvider2.cpp:195 assembles sparse Arguments; here each
slot becomes a :class:`SparseRow` of (ids, vals) that the feeder pads to
``<name>@IDS``/``<name>@VALS`` arrays and ``sparse_fc`` consumes as a
weighted gather-sum) — a 10M-dim CTR slot never materializes a dense
row.  ``SparseRow.todense()`` exists for the dense-var fallback.
"""

import functools

import numpy as np

__all__ = [
    "provider", "CacheType", "SequenceType", "DataType", "InputType",
    "SparseRow",
    "dense_vector", "dense_vector_sequence", "dense_array",
    "sparse_binary_vector", "sparse_binary_vector_sequence",
    "sparse_float_vector", "sparse_float_vector_sequence",
    "integer_value", "integer_value_sequence", "integer_sequence",
]


class SparseRow:
    """One sample of one sparse slot: ``ids`` [nnz] int64, ``vals`` [nnz]
    float32 (all-ones for binary slots), ``dim`` the declared vocabulary.
    The feeder pads batches of these to ``@IDS``/``@VALS`` arrays; nothing
    of size ``dim`` is ever allocated on the host."""

    __slots__ = ["ids", "vals", "dim"]

    def __init__(self, ids, vals, dim):
        self.ids = np.asarray(ids, np.int64).reshape(-1)
        self.vals = (np.ones(self.ids.shape[0], np.float32) if vals is None
                     else np.asarray(vals, np.float32).reshape(-1))
        if self.vals.shape != self.ids.shape:
            raise ValueError(
                f"sparse slot ids/vals length mismatch: {self.ids.shape[0]}"
                f" vs {self.vals.shape[0]}")
        self.dim = int(dim)

    @property
    def nnz(self):
        return self.ids.shape[0]

    def todense(self):
        out = np.zeros(self.dim, np.float32)
        # duplicate ids ACCUMULATE — matching sparse_fc's gather-sum, so
        # the dense and native spellings of the same slot agree exactly
        np.add.at(out, self.ids, self.vals)
        return out

    def __repr__(self):
        return f"SparseRow(nnz={self.nnz}, dim={self.dim})"


class SequenceType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class DataType:
    Dense = 0
    SparseNonValue = 1
    SparseValue = 2
    Index = 3


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class InputType:
    """Typed slot declaration (reference PyDataProvider2.py:63)."""

    __slots__ = ["dim", "seq_type", "type"]

    def __init__(self, dim, seq_type, tp):
        self.dim = dim
        self.seq_type = seq_type
        self.type = tp

    def __repr__(self):
        return (f"InputType(dim={self.dim}, seq_type={self.seq_type}, "
                f"type={self.type})")


def dense_vector(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Dense)


def dense_vector_sequence(dim):
    return dense_vector(dim, SequenceType.SEQUENCE)


dense_array = dense_vector


def sparse_binary_vector(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseNonValue)


def sparse_binary_vector_sequence(dim):
    return sparse_binary_vector(dim, SequenceType.SEQUENCE)


def sparse_float_vector(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseValue)


def sparse_float_vector_sequence(dim):
    return sparse_float_vector(dim, SequenceType.SEQUENCE)


def integer_value(value_range, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(value_range, seq_type, DataType.Index)


def integer_value_sequence(value_range):
    return integer_value(value_range, SequenceType.SEQUENCE)


integer_sequence = integer_value_sequence


class _Settings:
    """Attribute bag passed to init_hook and the process generator."""

    def __init__(self):
        self.input_types = None
        self.logger = None


def _convert_slot(value, itype):
    """One slot of one row -> numpy (sparse slots -> SparseRow)."""
    if itype is None:
        return np.asarray(value)
    if itype.type == DataType.Index:
        if itype.seq_type == SequenceType.NO_SEQUENCE:
            return np.asarray(value, np.int64).reshape(())
        return np.asarray(value, np.int64)
    if itype.type == DataType.Dense:
        return np.asarray(value, np.float32)

    def sparsify(v):
        if itype.type == DataType.SparseNonValue:
            return SparseRow(v, None, itype.dim)
        pairs = list(v)
        return SparseRow([i for i, _ in pairs], [val for _, val in pairs],
                         itype.dim)

    if itype.seq_type == SequenceType.NO_SEQUENCE:
        return sparsify(value)
    return [sparsify(v) for v in value]


def provider(input_types=None, should_shuffle=None, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True, calc_batch_size=None,
             cache=CacheType.NO_CACHE, check=False, check_fail_continue=False,
             init_hook=None, **outter_kwargs):
    """Decorator: ``@provider(input_types=[...])`` over
    ``def process(settings, filename): yield slot0, slot1, ...``.

    The decorated function becomes a reader factory:
    ``process(file_list, **hook_kwargs)`` -> no-arg reader of converted
    rows.  ``settings.input_types`` order defines the slot order; dict
    yields are reordered to it when input_types is a dict.  Unknown
    reference knobs (pool_size etc. — trainer-internal scheduling) are
    accepted and ignored.
    """

    def _wrapper(generator):
        @functools.wraps(generator)
        def create(file_list=None, **kwargs):
            settings = _Settings()
            settings.input_types = input_types
            files = ([file_list] if isinstance(file_list, str)
                     else list(file_list or [None]))
            if init_hook is not None:
                init_hook(settings, file_list=files, **dict(outter_kwargs,
                                                            **kwargs))
            types = settings.input_types
            if isinstance(types, dict):
                names = list(types.keys())
                tlist = [types[n] for n in names]
            else:
                names = None
                tlist = list(types) if types else None

            cache_box = {"rows": None}

            def convert_row(row):
                if isinstance(row, dict):
                    row = tuple(row[n] for n in names)
                if not isinstance(row, (tuple, list)):
                    row = (row,)
                if tlist is None:
                    return tuple(np.asarray(v) for v in row)
                return tuple(
                    _convert_slot(v, t) for v, t in zip(row, tlist)
                )

            def reader():
                if cache_box["rows"] is not None:
                    yield from cache_box["rows"]
                    return
                mem = [] if cache == CacheType.CACHE_PASS_IN_MEM else None
                for fname in files:
                    for row in generator(settings, fname):
                        out = convert_row(row)
                        if mem is not None:
                            mem.append(out)
                        yield out
                if mem is not None:
                    cache_box["rows"] = mem

            return reader

        create.origin = generator
        create.input_types = input_types
        return create

    return _wrapper

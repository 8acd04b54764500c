"""Dtype handling — the port's counterpart of ``paddle_tpu/core/dtypes.py``.

The IR names dtypes; tensors are torch's.  A program variable carries a
:class:`DType` (a name with numpy's ``.name`` / ``.itemsize`` surface,
so program text reads the same in both packages) and the op lowerings
turn it into a ``torch.dtype`` with :func:`torch_dtype`.  bfloat16 is
first-class: numpy has no such type of its own, so the IR does not lean
on numpy dtypes.
"""

import numpy as np
import torch

# "int64" maps to int32, as in the JAX package (ids and labels fit, and
# the two packages then build identical programs); the lowerings widen
# to int64 where torch indexing wants it.
_CANONICAL = {
    "bool": "bool", "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int64": "int32", "float16": "float16",
    "bfloat16": "bfloat16", "float32": "float32", "float64": "float64",
    # reference spelling (VarType enum names)
    "fp16": "float16", "fp32": "float32", "fp64": "float64",
}

_TORCH = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64,
}

_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "int32": 4,
             "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}

_FLOATING = ("float16", "bfloat16", "float32", "float64")


class DType:
    """A canonical dtype name.  Compares equal to the same name given as
    a string, a numpy dtype, a torch dtype or another ``DType``."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    @property
    def itemsize(self):
        return _ITEMSIZE[self.name]

    def __eq__(self, other):
        try:
            return self.name == convert_dtype(other).name
        except (ValueError, TypeError):
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return self.name

    __str__ = __repr__


def convert_dtype(dtype):
    """Accept a name / numpy dtype / torch dtype / ``DType``; return the
    canonical :class:`DType` (``None`` means float32)."""
    if dtype is None:
        return DType("float32")
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _CANONICAL:
        raise ValueError(f"unknown dtype {dtype!r}")
    return DType(_CANONICAL[name])


def torch_dtype(dtype):
    """The ``torch.dtype`` of a dtype given in any accepted spelling."""
    return _TORCH[convert_dtype(dtype).name]


def is_floating(dtype):
    return convert_dtype(dtype).name in _FLOATING

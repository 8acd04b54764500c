"""Paged decode gather through the serving block table — the port's
counterpart of ``paddle_tpu/kernels/pallas_gather.py`` (and of its
oracle, ``kernels/xla_ref.py: decode_gather``).

Calling convention and layout are the JAX package's::

    decode_gather(pool, table) -> view

    pool   [num_blocks, B, h, dh]   one layer's physical K or V pool
    table  [S, NB] int32            per-slot block chain (block 0 = trash)
    view   [S, NB * B, h, dh]       slot ``s``'s logical sequence: the
                                    concatenation of its chain's blocks

The view exists only under ``PADDLE_TPU_PAGED_ATTN=0``, the serving
engine's kill-switch and oracle spelling (``serving/batched_decode.py``);
attention otherwise reads the pool through the table directly.

Two spellings of the one function live here:

* :func:`decode_gather_ref` — the plain PyTorch version, the JAX
  ``xla_ref`` advanced-indexing spelling ``pool[table]``.  The CPU path
  and the reference the kernel is held against.
* the CUDA kernel ``csrc/decode_gather.cu``, hand-written for Hopper
  (``sm_90a``), which replaces the TPU kernel ``decode_gather``.

A gather moves bits and computes nothing, so the kernel is BIT-EXACT
against the plain version in every dtype (``ORACLE_TOL`` 0.0).

:func:`decode_gather` is the wrapper, the ``decode_gather`` op class's
``cuda`` backend in the kernel registry (:func:`decode_gather_ref` is its
``torch_ref``).  CPU tensors take the plain version, CUDA tensors launch
the kernel or raise — there is no fallback.
Every launch adds one to ``decode_gather.launches``.  Table entries are
data: they must name blocks of the pool and are not range-checked (that
would need a device sync).
"""

import ctypes

import torch

from . import _build
from .registry import cuda_availability, register_kernel

__all__ = ["ORACLE_TOL", "decode_gather", "decode_gather_ref", "oracle_tol"]

# max |kernel - ref| / max |ref| (paddle_tpu/kernels/xla_ref.py
# ORACLE_TOL, the decode_gather rows): exact in every dtype
ORACLE_TOL = {
    ("decode_gather", "float32"): {"fwd": 0.0, "grad": 0.0},
    ("decode_gather", "bfloat16"): {"fwd": 0.0, "grad": 0.0},
}

_DTYPES = (torch.float32, torch.bfloat16)


def oracle_tol(dtype, kind="fwd"):
    """The documented tolerance for ``decode_gather`` in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    return ORACLE_TOL[("decode_gather", name)][kind]


def decode_gather_ref(pool, table):
    """The plain PyTorch version: ``pool[table]`` reshaped to each slot's
    logical view ``[S, NB * B, h, dh]``."""
    S, NB = table.shape
    return pool[table.long()].reshape(S, NB * pool.shape[1],
                                      *pool.shape[2:])


def _check(pool, table):
    if pool.dim() != 4:
        raise ValueError(
            f"decode_gather: pool must be [num_blocks, B, h, dh]; got "
            f"{tuple(pool.shape)}")
    if table.dim() != 2:
        raise ValueError(
            f"decode_gather: table must be [S, NB]; got {tuple(table.shape)}")
    if pool.dtype not in _DTYPES:
        raise TypeError(
            f"decode_gather: dtype {pool.dtype} not supported "
            f"(bfloat16 or float32)")
    if table.dtype != torch.int32:
        raise TypeError(f"decode_gather: table must be int32; got "
                        f"{table.dtype}")
    if pool.shape[0] < 1:
        raise ValueError("decode_gather: the pool holds no block (block 0 "
                         "is the trash block every engine keeps)")
    if pool.device != table.device:
        raise ValueError("decode_gather: pool and table must share a device")
    if not (pool.is_contiguous() and table.is_contiguous()):
        raise ValueError("decode_gather: pool and table must be contiguous")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("decode_gather")
        fn = lib.decode_gather_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_gather_error_string.argtypes = [ctypes.c_int]
        lib.decode_gather_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.decode_gather_error_string)
    return _fn


def build():
    """Build (if stale) and load the kernel library — set-up work that
    belongs outside any timed window."""
    _kernel()


def decode_gather(pool, table):
    """Each slot's logical KV view through its block chain (module
    docstring).  CPU tensors take :func:`decode_gather_ref`; CUDA tensors
    launch the hand-written kernel on the current stream of the calling
    thread, or raise."""
    _check(pool, table)
    if pool.device.type == "cpu":
        return decode_gather_ref(pool, table)
    if pool.device.type != "cuda":
        raise ValueError(f"decode_gather: unsupported device {pool.device}")
    S, NB = table.shape
    out = torch.empty((S, NB * pool.shape[1], *pool.shape[2:]),
                      dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    _, B, h, dh = pool.shape
    block_bytes = B * h * dh * pool.element_size()
    fn, errstr = _kernel()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = fn(pool.data_ptr(), table.data_ptr(), out.data_ptr(),
                 S * NB, block_bytes, stream)
    if err:
        raise RuntimeError(
            f"decode_gather kernel launch failed: cudaError {err} "
            f"({errstr(err).decode()})")
    decode_gather.launches += 1
    return out


decode_gather.launches = 0


class _GatherCuda:
    call = staticmethod(decode_gather)


class _GatherTorchRef:
    call = staticmethod(decode_gather_ref)


register_kernel("decode_gather", "cuda", _GatherCuda,
                available=cuda_availability)
register_kernel("decode_gather", "torch_ref", _GatherTorchRef)

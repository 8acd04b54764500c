"""Block-table-aware paged attention — the port's counterpart of
``paddle_tpu/kernels/paged_attention.py``.

Calling convention and layout are the JAX package's::

    paged_attention(q, pool_k, pool_v, table, pos) -> ctx

    q       [S, W, h, dh]            query window (W=1 for plain decode)
    pool_k  [num_blocks, B, h, dh]   one layer's physical K pool
    pool_v  [num_blocks, B, h, dh]   the physical V pool
    table   [S, NB] int32            per-slot block chain (block 0 = trash)
    pos     [S, W]  int32            key token ``j`` counts iff ``j <= pos``
    ctx     [S, W, h, dh]            in ``q.dtype``

Two spellings of the one function live here:

* :func:`paged_attention_ref` — the plain PyTorch version: the block scan
  with online softmax of the JAX ``paged_attention_ref`` (f32 scores and
  ``(m, l, acc)`` state, ``NEG_INF`` masking, one normalisation at the
  end with the ``l == 0 -> 1`` guard, output cast to ``q.dtype``).  The
  CPU path and the numerics reference the kernel is held against.
* the CUDA kernel ``csrc/paged_attention.cu``, hand-written for Hopper
  (``sm_90a``), which replaces the TPU kernel ``paged_attention_pallas``.

:func:`paged_attention` is the wrapper.  It dispatches on the tensors'
device: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise — there is no fallback from one to the other.  Every
successful launch adds one to ``paged_attention.launches``.

Kernel limits (checked here, before the launch): ``q`` and the pools
bf16 or f32 and of one dtype, ``table``/``pos`` int32, every tensor
contiguous and on one device, ``1 <= B <= 1024``, ``1 <= dh <= 1024``,
``pos >= 0`` (a row whose ``pos`` is negative attends nothing and
returns zeros), and table entries that name blocks of the pool (they
are data and are not checked without a device sync).
"""

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "ORACLE_TOL", "paged_attention", "paged_attention_ref",
           "oracle_tol"]

NEG_INF = -1e30

# max |kernel - ref| / max |ref| (paddle_tpu/kernels/xla_ref.py
# ORACLE_TOL, the paged_attention rows): the blocked online-softmax
# reassociation (f32) plus input rounding (bf16); inference only
ORACLE_TOL = {
    ("paged_attention", "float32"): {"fwd": 2e-4, "grad": None},
    ("paged_attention", "bfloat16"): {"fwd": 2e-2, "grad": None},
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 1024


def oracle_tol(dtype, kind="fwd"):
    """The documented tolerance for ``paged_attention`` in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    return ORACLE_TOL[("paged_attention", name)][kind]


def paged_attention_ref(q, pool_k, pool_v, table, pos):
    """The plain PyTorch version: a loop over the block chain with
    online-softmax carry, one physical block gathered per step
    (``[S, B, h, dh]``), never the ``T``-wide view.  Runs on any device;
    the wrapper uses it for CPU tensors."""
    S, W, h, dh = q.shape
    B = pool_k.shape[1]
    scale = 1.0 / float(dh) ** 0.5
    off = torch.arange(B, device=q.device)
    qf = q.float()
    pw = pos.long()[:, :, None, None]                      # [S, W, 1, 1]
    m = q.new_full((S, W, h), NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = q.new_zeros((S, W, h, dh), dtype=torch.float32)
    for nb, blk in enumerate(table.long().unbind(dim=1)):   # blk [S]
        kb = pool_k[blk].float()                           # [S, B, h, dh]
        vb = pool_v[blk].float()
        s = torch.einsum("swhd,sbhd->swhb", qf, kb) * scale
        s = torch.where(nb * B + off <= pw, s, torch.full_like(s, NEG_INF))
        m2 = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m2)
        p = torch.exp(s - m2[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("swhb,sbhd->swhd", p, vb)
        m = m2
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype)


def _check(q, pool_k, pool_v, table, pos):
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(
            f"paged_attention: q must be [S, W, h, dh] and the pools "
            f"[num_blocks, B, h, dh]; got {tuple(q.shape)} and "
            f"{tuple(pool_k.shape)}")
    S, W, h, dh = q.shape
    if pool_v.shape != pool_k.shape or pool_k.shape[2:] != (h, dh):
        raise ValueError(
            f"paged_attention: pools {tuple(pool_k.shape)} / "
            f"{tuple(pool_v.shape)} do not match q heads {(h, dh)}")
    if table.dim() != 2 or table.shape[0] != S:
        raise ValueError(
            f"paged_attention: table must be [S={S}, NB]; got "
            f"{tuple(table.shape)}")
    if tuple(pos.shape) != (S, W):
        raise ValueError(
            f"paged_attention: pos must be [S, W] = {(S, W)}; got "
            f"{tuple(pos.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"paged_attention: dtype {q.dtype} not supported "
            f"(bfloat16 or float32)")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(
            f"paged_attention: pools ({pool_k.dtype}, {pool_v.dtype}) must "
            f"match q ({q.dtype})")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(
            f"paged_attention: table and pos must be int32; got "
            f"{table.dtype}, {pos.dtype}")
    B = pool_k.shape[1]
    if not (1 <= B <= _MAX_DIM and 1 <= dh <= _MAX_DIM):
        raise ValueError(
            f"paged_attention: block_tokens {B} and d_head {dh} must lie "
            f"in [1, {_MAX_DIM}]")
    ts = (q, pool_k, pool_v, table, pos)
    if len({t.device for t in ts}) != 1:
        raise ValueError("paged_attention: all tensors must share a device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention: all tensors must be contiguous")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_attention_error_string)
    return _fn


def build():
    """Build (if stale) and load the kernel library — set-up work that
    belongs outside any timed window."""
    _kernel()


def paged_attention(q, pool_k, pool_v, table, pos):
    """Attention of ``q`` over each slot's block chain (module
    docstring).  CPU tensors take :func:`paged_attention_ref`; CUDA
    tensors launch the hand-written kernel on the current stream of the
    calling thread, or raise."""
    _check(q, pool_k, pool_v, table, pos)
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    fn, errstr = _kernel()
    S, W, h, dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 S, W, h, dh, pool_k.shape[1], table.shape[1],
                 1.0 / float(dh) ** 0.5, _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError {err} "
            f"({errstr(err).decode()})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

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

Spellings of the one function here:

* :func:`paged_attention_ref` — the plain PyTorch version: the block scan
  with online softmax of the JAX ``paged_attention_ref`` (f32 scores and
  ``(m, l, acc)`` state, ``NEG_INF`` masking, one normalisation at the
  end with the ``l == 0 -> 1`` guard, output cast to ``q.dtype``).  The
  CPU path and the numerics reference the kernels are held against.
* :func:`paged_attention_split_ref` — the plain spelling of the split
  family's decomposition (the chain cut into splits, each split's
  ``(m, l, acc)`` merged in split order), for the tests and
  ``chip_smoke.py``.
* the CUDA kernels of ``csrc/paged_attention.cu``, hand-written for
  Hopper (``sm_90a``), which replace the TPU kernel
  ``paged_attention_pallas``, in two families that :func:`paged_family`
  picks by a static rule: ``"split"`` (flash-decoding: a block a (chain
  split, head, slot) owning all W queries, then a merge kernel; every
  call of the serving paths) and ``"simple"`` (a block a query row
  walking the whole chain; what the split family does not take).

:func:`paged_attention` is the wrapper, the ``paged_attention`` op
class's ``cuda`` backend in the kernel registry (``kernels/registry.py``;
:func:`paged_attention_triton` is its ``triton`` backend and
:func:`paged_attention_plain` its ``torch_ref``).  It dispatches on the
tensors' device: CPU tensors take the plain version, CUDA tensors launch
the kernels or raise — there is no fallback from one to the other.  Every
successful call on the card adds one to ``paged_attention.launches``
and to ``PAGED_FAMILY_CALLS[family]``.

Kernel limits (checked here, before the launch): ``q`` and the pools
bf16 or f32 and of one dtype, ``table``/``pos`` int32, every tensor
contiguous and on one device, ``1 <= B <= 1024``, ``1 <= dh <= 1024``,
and table entries that name blocks of the pool (they are data and are
not checked without a device sync).  A row whose ``pos`` is negative
attends nothing: the kernels return zeros there, where the JAX oracle
averages every value of the chain (its finite ``NEG_INF`` weighs all
masked keys alike).
"""

import ctypes

import torch

from . import _build
from .registry import (cuda_availability, register_kernel,
                       triton_availability)

__all__ = ["NEG_INF", "ORACLE_TOL", "PAGED_FAMILY_CALLS", "PAGED_SPLIT_CALLS",
           "paged_attention", "paged_attention_ref",
           "paged_attention_split_ref", "paged_family", "paged_splits",
           "split_entries", "oracle_tol", "paged_attention_triton",
           "paged_attention_plain"]

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
_SMS = 132         # streaming multiprocessors of an H100 SXM

# paged_attention calls on the card, by kernel family
PAGED_FAMILY_CALLS = {"split": 0, "simple": 0}

# split-family launches on the card, by the call's (slots, query window)
# and the split count it ran at: {(S, W, splits): launches}
PAGED_SPLIT_CALLS = {}


def paged_family(dtype, S, W, h, dh, B, ptrs):
    """``"split"`` or ``"simple"``: the kernel family for a call with
    ``q [S, W, h, dh]`` and pools of ``B``-token blocks in ``dtype``, whose
    ``q`` and pools start at the addresses ``ptrs``.  ``"split"`` takes
    ``1 <= W <= 8``, a head row of ``dh * itemsize = 16 << k <= 512``
    bytes (one 16-byte chunk a lane, at most a warp a key), ``B <= 64``,
    ``S, h <= 65535`` and 16-byte aligned pointers; anything else is
    ``"simple"``.  Static: decided before any launch."""
    row = dh * (2 if dtype == torch.bfloat16 else 4)
    if dtype not in _DTYPE_CODE or not 1 <= W <= 8 or not 1 <= B <= 64:
        return "simple"
    if row < 16 or row > 512 or row & (row - 1):
        return "simple"
    if S > 65535 or h > 65535 or any(p % 16 for p in ptrs):
        return "simple"
    return "split"


def paged_splits(S, h, NB):
    """``(splits, entries)``: the split family cuts each slot's chain of
    ``NB`` entries into ``splits`` runs of ``entries`` (the last shorter),
    about 16 blocks an SM of the card over ``S * h`` (slot, head) pairs:
    about half of a serving chain is live, and an SM holds some 8 of these
    blocks, so the live blocks fill the card about once.  A pure function
    of the shapes."""
    return split_entries(NB, min(NB, max(1, -(-16 * _SMS // (S * h)))))


def split_entries(NB, splits):
    """``(splits, entries)`` for a requested count: runs of ``entries =
    ceil(NB / splits)`` chain entries, and the runs that takes, ``ceil(NB /
    entries)`` (at most ``splits``; a count whose last runs would be empty
    launches the runs that hold entries, which computes the same sums)."""
    entries = -(-NB // splits)
    return -(-NB // entries), entries


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


def paged_attention_split_ref(q, pool_k, pool_v, table, pos, splits):
    """The plain spelling of the split family: each slot's chain cut into
    ``splits`` runs of ``ceil(NB / splits)`` entries; in each run the online
    softmax with ``-inf`` masking over the keys the kernel reads (those of
    entries holding a token ``<= max_w pos``, up to that position; the rest
    are never read, so garbage there cannot reach the output), a key past a
    row's own ``pos`` skipped rather than weighted by zero; the runs'
    ``(m, l, acc)`` merged in run order, the ``l == 0 -> 1`` guard, the cast
    to ``q.dtype``.  A row with no live key is zeros.  Runs on any device;
    the tests and ``chip_smoke.py`` hold the kernels and the JAX package to
    it."""
    S, W, h, dh = q.shape
    B = pool_k.shape[1]
    NB = table.shape[1]
    per = -(-NB // splits)
    scale = 1.0 / float(dh) ** 0.5
    dev = q.device
    qf = q.float()
    pw = pos.long()                                          # [S, W]
    pmax = pw.max(dim=1).values                              # [S]
    off = torch.arange(B, device=dev)
    ninf = float("-inf")
    parts = []
    for c in range(splits):
        m = torch.full((S, W, h), ninf, device=dev)
        l = torch.zeros((S, W, h), device=dev)
        acc = torch.zeros((S, W, h, dh), device=dev)
        for nb in range(c * per, min((c + 1) * per, NB)):
            tok = nb * B + off                                # [B]
            read = tok[None, :] <= pmax[:, None]              # [S, B]
            blk = table[:, nb].long()
            kb = torch.where(read[:, :, None, None], pool_k[blk].float(), 0.0)
            vb = torch.where(read[:, :, None, None], pool_v[blk].float(), 0.0)
            keep = tok[None, None, :] <= pw[:, :, None]       # [S, W, B]
            s = torch.einsum("swhd,sbhd->swhb", qf, kb) * scale
            s = torch.where(keep[:, :, None, :], s, ninf)
            m2 = torch.maximum(m, s.amax(dim=-1))
            ms = torch.where(m2 == ninf, 0.0, m2)
            alpha = torch.exp(m - ms)
            p = torch.exp(s - ms[..., None])
            l = l * alpha + p.sum(dim=-1)
            vm = torch.where(keep[:, :, :, None, None], vb[:, None], 0.0)
            acc = (acc * alpha[..., None]
                   + torch.einsum("swhb,swbhd->swhd", p, vm))
            m = m2
        parts.append((m, l, acc))
    big = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
    big = torch.where(big == ninf, 0.0, big)
    l = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        a = torch.exp(pm - big)
        l = l + pl * a
        acc = acc + pa * a[..., None]
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
        split = lib.paged_attention_split
        split.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        split.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, split, lib.paged_attention_error_string)
    return _fn


def build():
    """Build (if stale) and load the kernel library — set-up work that
    belongs outside any timed window."""
    _kernel()


def paged_attention(q, pool_k, pool_v, table, pos, splits=None):
    """Attention of ``q`` over each slot's block chain (module
    docstring).  CPU tensors take :func:`paged_attention_ref`; CUDA
    tensors launch the family :func:`paged_family` picks on the current
    stream of the calling thread, or raise.

    ``splits`` (``1 <= splits <= NB``; the tuner's ``op=paged_attention``
    knob) sets the split family's count in place of :func:`paged_splits`'
    rule: CPU tensors then take :func:`paged_attention_split_ref` at that
    count, CUDA tensors the split kernel at that count, and a call the
    split family does not take raises."""
    _check(q, pool_k, pool_v, table, pos)
    NB = table.shape[1]
    if splits is not None and not 1 <= int(splits) <= NB:
        raise ValueError(
            f"paged_attention: splits {splits} must lie in [1, NB={NB}]")
    if q.device.type == "cpu":
        if splits is not None:
            return paged_attention_split_ref(q, pool_k, pool_v, table, pos,
                                             int(splits))
        return paged_attention_ref(q, pool_k, pool_v, table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    fn, split, errstr = _kernel()
    S, W, h, dh = q.shape
    B = pool_k.shape[1]
    family = paged_family(q.dtype, S, W, h, dh, B,
                          (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()))
    if splits is not None and family != "split":
        raise ValueError(
            f"paged_attention: splits={splits} asks for the split kernel, "
            f"which does not take this call (q {tuple(q.shape)} "
            f"{q.dtype}, block_tokens {B})")
    out = torch.empty_like(q)
    scale = 1.0 / float(dh) ** 0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if family == "split":
            splits, entries = (paged_splits(S, h, NB) if splits is None
                               else split_entries(NB, int(splits)))
            part = torch.empty((S, W, h, splits, dh + 2), dtype=torch.float32,
                               device=q.device)
            err = split(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                        table.data_ptr(), pos.data_ptr(), part.data_ptr(),
                        out.data_ptr(), S, W, h, dh, B, NB, entries, splits,
                        scale, _DTYPE_CODE[q.dtype], stream)
        else:
            err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                     table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                     S, W, h, dh, B, NB, scale, _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(
            f"paged_attention {family} kernel launch failed: cudaError {err} "
            f"({errstr(err).decode()})")
    PAGED_FAMILY_CALLS[family] += 1
    if family == "split":
        at = (S, W, splits)
        PAGED_SPLIT_CALLS[at] = PAGED_SPLIT_CALLS.get(at, 0) + 1
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_plain(q, pool_k, pool_v, table, pos, splits=None):
    """The ``torch_ref`` backend's call, on any device: the plain block
    scan, or at a given split count (the tuner's knob) the plain
    split-and-merge spelling — what :func:`paged_attention` computes for
    CPU tensors."""
    if splits is not None:
        return paged_attention_split_ref(q, pool_k, pool_v, table, pos,
                                         int(splits))
    return paged_attention_ref(q, pool_k, pool_v, table, pos)


def paged_attention_triton(q, pool_k, pool_v, table, pos, block_step=None,
                           splits=None):
    """The ``triton`` backend: the reference's ``paged_attention_triton``
    (``paddle_tpu/kernels/paged_attention.py:261``) as one ``@triton.jit``
    kernel, ``triton_paged_attention_kernel``
    (``kernels/triton_attention.py``).  Its grid is ``(S,)``: a program a
    slot (slots share nothing) loops over the slot's heads and, for each,
    over the table entries that hold a token ``<= max(pos[s])``, loading
    the physical block the entry names; scores are a broadcast product
    summed over ``dh`` (``W`` may be 1: no ``tl.dot`` of width 1), the
    online softmax in f32, a masked key weighted by 0, so a row with no
    live key (``pos < 0``) is zeros, as in the cuda kernels.  Bound:
    the bytes of ``q``, the live blocks and the output over the card's
    3.35 TB/s.  ``block_step`` (the reference's) and ``splits`` (the cuda
    split kernel's) are accepted and ignored: the loop takes one physical
    block an iteration.  CPU tensors take :func:`paged_attention_ref`;
    CUDA tensors launch the kernel, or raise.  Each launch adds one to
    ``paged_attention_triton.launches``."""
    del block_step, splits
    _check(q, pool_k, pool_v, table, pos)
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    from .triton_attention import _jit

    S, W, h, dh = q.shape
    B = pool_k.shape[1]
    NB = table.shape[1]
    out = torch.empty_like(q)
    p2 = lambda n: 1 << (max(2, n) - 1).bit_length()  # noqa: E731
    jit = _jit()
    with torch.cuda.device(q.device):
        jit.paged[(S,)](
            q, pool_k, pool_v, table, pos, out, 1.0 / float(dh) ** 0.5,
            W, h, dh, B, NB, q.stride(0), q.stride(1), q.stride(2),
            pool_k.stride(0), pool_k.stride(1), pool_k.stride(2),
            table.stride(0), pos.stride(0), WP=p2(W), BP=p2(B), DP=p2(dh),
            num_warps=4, num_stages=1)
    paged_attention_triton.launches += 1
    return out


paged_attention_triton.launches = 0


class _PagedCuda:
    call = staticmethod(paged_attention)


class _PagedTriton:
    call = staticmethod(paged_attention_triton)


class _PagedTorchRef:
    call = staticmethod(paged_attention_plain)


register_kernel("paged_attention", "cuda", _PagedCuda,
                available=cuda_availability)
register_kernel("paged_attention", "triton", _PagedTriton,
                available=triton_availability)
register_kernel("paged_attention", "torch_ref", _PagedTorchRef)

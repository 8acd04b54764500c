"""Flash attention with a fused and a split backward — the port's
counterpart of ``paddle_tpu/ops/pallas_attention.py``
(``flash_attention``, ``flash_attention_with_lse``,
``flash_attention_packed``).

Layouts are the JAX package's::

    flash_attention(q, k, v, causal, sm_scale) -> o
        q [b, t_q, h, d], k/v [b, t_k, h, d] -> o [b, t_q, h, d]
    flash_attention_with_lse(...) -> (o, lse [b, h, t_q] f32)
    flash_attention_packed(q, k, v, n_head, causal, sm_scale) -> o
        q/k/v [b, t, h*d], the raw projection output -> o [b, t, h*d]

The packed form is a view of the same memory: the kernels address
``[b, t, h, d]`` through the strides they are given, so no pack/unpack
transpose exists on either path.

Two spellings of each function live here:

* :func:`flash_attention_ref` and :func:`flash_attention_bwd_ref` — the
  plain PyTorch versions, with the TPU kernels' conventions: scores and
  softmax state in f32 (f64 for f64 inputs), masked scores ``NEG_INF``,
  the ``l == 0 -> 1`` guard, ``p`` cast to the input dtype before
  ``p @ v`` and ``p^T @ do``, ``ds = p * (dp - delta) * scale`` cast
  before ``ds^T @ q`` and ``ds @ k``, ``delta = rowsum(do * o) - dlse``.
  They materialise the ``[b, h, t_q, t_k]`` score matrix.  The CPU path
  and the numerics reference the kernels are held against.
* the CUDA kernels, hand-written for Hopper (``sm_90a``), which replace
  the TPU kernels ``_flash_fwd``, ``_flash_bwd_fused`` and
  ``_flash_bwd``'s split dq and dk/dv kernels, in two families:
  ``"sm90"`` — ``csrc/flash_fwd_sm90.cu`` (the forward) and
  ``csrc/flash_bwd_sm90.cu`` (the fused backward and the split pair, one
  k-major body), on ``wgmma`` with register accumulators and a TMA
  operand ring, the backwards behind a once-per-row delta pre-pass
  (:func:`flash_bwd_delta`) — and ``"simple"`` — ``csrc/flash_attention.cu``,
  WMMA tiles staged in shared memory, for everything TMA cannot address.

The backward takes one of two routes, chosen as the reference chooses
(:func:`bwd_route`, ``pallas_attention.py: _flash_bwd``): the fused
kernel while its dq partials ``nk * b * h * t_q * d`` (``nk = t_k //
block_k``) fit in ``FUSED_BWD_PARTIAL_BYTES``, else the split pair — a
q-major dq kernel and a k-major dk/dv kernel.  At the flagship's b=8,
h=6, d=128 in bf16 the split route starts at t=8192.  Under
``torch.use_deterministic_algorithms(True)`` the split route runs
whatever the budget says: the fused kernel adds ``dq`` with atomics, in
an order that changes from run to run (below), and the split pair
computes the same gradients with none.  The route is decided before any
launch; each route launches its kernels or raises.

Every launch takes one of the two families, chosen by :func:`bwd_family`,
a static rule on the dtype, the head dim, the strides and the pointers:
bf16 with ``d <= 128`` and every stride and base pointer 16-byte aligned
(what TMA can address) takes ``"sm90"``; anything else (f32, or a ``d``
or stride TMA cannot address) the ``"simple"`` kernels.  The rule picks
the forward's family, the fused route's and the split pair's alike.
``FWD_FAMILY_CALLS``, ``FUSED_FAMILY_CALLS`` and ``BWD_FAMILY_CALLS``
count the forward, fused-backward and split kernels launched by family.
The sm90 backwards read ``delta [b*h, t_q]`` f32 from the pre-pass,
which :func:`flash_bwd` launches once a call (for the fused kernel, or
for both split kernels); they never read ``o``.

:func:`flash_fwd`, :func:`flash_bwd`, :func:`flash_bwd_dq` and
:func:`flash_bwd_dkv` are the wrappers.  They dispatch on the tensors'
device: CPU tensors take the plain versions, CUDA tensors launch the
kernels or raise — there is no fallback from one to the other.  Every
successful launch adds one to the launching wrapper's ``.launches``
(``flash_bwd.launches`` counts the fused kernel); ``BWD_ROUTE_CALLS``
counts the backward calls by route, on either device.

The fused kernel adds each k-tile's share of ``dq`` with f32 atomics
into a zeroed f32 buffer that the wrapper allocates and casts once at
the end (the TPU kernel writes per-k-block partials and sums them; with
64-key tiles that buffer would be ``t_k / 64`` copies of ``q``): scalar
atomics per (64-key, 64-query) tile pair in the simple family, 16-byte
vector reductions per (128-key, 64-query) pair in the sm90 one.  Atomics
add in an order that changes from run to run, so the fused route's
``dq`` is reproducible only to f32 rounding; its ``dk`` and ``dv``, and
all three gradients of the split route (either family), are bit-exact
run to run.  Within a family the fused and split kernels share one
k-major body, so the split route's ``dk`` and ``dv`` are the fused
route's bits; the two families sum in other orders (within one bf16 ulp
of each other).

Gradients flow through :class:`FlashAttentionFunction`, whose forward
saves exactly ``FLASH_BWD_RESIDUALS = (q, k, v, o, lse)`` and whose
backward is one :func:`flash_bwd` call — the forward is never recomputed.

Kernel registry (``kernels/registry.py``): :func:`flash_attention`,
:func:`flash_attention_with_lse` and :func:`flash_attention_packed` are
the ``flash_attention`` op class's ``cuda`` backend; its ``torch_ref``
backend is the same three entry points (:func:`entry_points`) over the
plain versions (:class:`RefKernels`), and its ``triton`` backend
(``kernels/triton_attention.py``) over the Triton kernels — one autograd
Function, one residual contract, whichever backend resolves.

Kernel limits (checked here, before the launch): bf16 or f32, one dtype
and one device for all tensors, contiguous ``[b, t, h, d]``, ``d <= 256``
(the simple family's limit; the sm90 family takes ``d <= 128``, as its
rule says), ``b * h <= 65535``.
"""

import ctypes

import torch

from . import _build
from .registry import cuda_availability, register_kernel

__all__ = ["NEG_INF", "ORACLE_TOL", "FLASH_BWD_RESIDUALS",
           "FUSED_BWD_PARTIAL_BYTES", "BWD_ROUTE_CALLS", "oracle_tol",
           "FWD_FAMILY_CALLS", "FUSED_FAMILY_CALLS", "BWD_FAMILY_CALLS",
           "SM90_MAX_D", "bwd_route", "bwd_family",
           "flash_attention_ref", "flash_attention_bwd_ref",
           "flash_bwd_delta_ref", "flash_fwd", "flash_bwd",
           "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkv",
           "FlashAttentionFunction", "CudaKernels", "RefKernels",
           "entry_points", "flash_attention",
           "flash_attention_with_lse", "flash_attention_packed",
           "packed_sub_heads", "build"]

NEG_INF = -1e30

# the reference's budget for the fused backward's dq partials
# [nk, b*h, t_q, d] (pallas_attention.py FUSED_BWD_PARTIAL_BYTES): past it
# the split dq and dk/dv kernels take over.  Read at call time, so a test
# may patch it.
FUSED_BWD_PARTIAL_BYTES = 512 << 20

# flash_bwd calls by route, on either device (launches are counted by
# the wrappers that launch)
BWD_ROUTE_CALLS = {"fused": 0, "split": 0}

# kernels launched on the card, by family (bwd_family): the forward, the
# fused backward, and the split route's dq and dk/dv kernels
FWD_FAMILY_CALLS = {"sm90": 0, "simple": 0}
FUSED_FAMILY_CALLS = {"sm90": 0, "simple": 0}
BWD_FAMILY_CALLS = {"sm90": 0, "simple": 0}

# what the backward is computed from, and all the forward saves
FLASH_BWD_RESIDUALS = ("q", "k", "v", "o", "lse")

# max |kernel - ref| / max |ref| (paddle_tpu/kernels/xla_ref.py
# ORACLE_TOL, the flash_attention rows): tiling reassociation of the
# online softmax (f32) plus input rounding (bf16)
ORACLE_TOL = {
    ("flash_attention", "float32"): {"fwd": 2e-4, "grad": 1e-3},
    ("flash_attention", "bfloat16"): {"fwd": 2e-2, "grad": 5e-2},
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256       # the simple family's widest head
SM90_MAX_D = 128   # the sm90 family's
_MAX_BH = 65535


def oracle_tol(dtype, kind="fwd"):
    """The documented tolerance for ``flash_attention`` in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    return ORACLE_TOL[("flash_attention", name)][kind]


def packed_sub_heads(n_head, d_head):
    """The JAX package's packed-layout rule (how many heads one 128-lane
    slice carries): 1, 2, or None when the layer must emit the 4-D
    ``flash_attention`` op.  The port's kernels take any head width in
    either layout; the rule is kept so both packages build the same
    program."""
    if n_head == 1:
        return 1
    if d_head % 128 == 0:
        return 1
    if d_head == 64 and n_head % 2 == 0:
        return 2
    return None


def _pick_block(t, cap):
    """Largest divisor of ``t`` that is ``<= cap`` (the reference's
    ``_pick_block``: its blocks tile ``t`` exactly)."""
    b = min(t, cap)
    while t % b:
        b -= 1
    return b


def bwd_route(q_shape, t_k, itemsize, block_k=1024):
    """``"fused"`` or ``"split"``: the backward family the reference's
    ``_flash_bwd`` takes for q ``[b, t_q, h, d]`` (any layout: ``b*h*d``
    is the same product) with ``t_k`` keys of ``itemsize`` bytes."""
    b, t_q, h, d = q_shape
    nk = t_k // _pick_block(t_k, block_k)
    part_bytes = nk * b * h * t_q * d * itemsize
    return "fused" if part_bytes <= FUSED_BWD_PARTIAL_BYTES else "split"


# the sm90 forward's tiles, compile-time constants of its source
# (csrc/sm90.cuh kRows, csrc/flash_fwd_sm90.cu kFwdKT), which
# tests/test_torch_tune.py reads back from the sources
SM90_Q_ROWS = 64    # query rows of one sm90 warpgroup (two a 128-row block)
SM90_K_TILE = 128   # keys of one streamed sm90 K / V tile


def causal_flash_flops(t_q, t_k, d):
    """``(scheduled, useful)`` flops of the causal forward for one (batch,
    head), in the reference's units (4 * d a score entry, the two
    products).  ``scheduled`` counts what the sm90 kernels compute: each
    64-row warpgroup of a 128-row block runs the 128-key tiles up to its
    last row, so tiles wholly above the diagonal are skipped and the
    diagonal tiles are computed whole.  ``useful`` counts the unmasked
    (q_pos >= k_pos) entries.  The reference's version simulates its own
    block and ``DIAG_W`` sub-tile skips; the port's tiles are compile-time
    constants, so the count does not depend on ``block_q`` / ``block_k``."""
    scheduled = 0
    for r0 in range(0, t_q, SM90_Q_ROWS):
        last = min(r0 + SM90_Q_ROWS, t_q) - 1
        tiles = min(last // SM90_K_TILE + 1, -(-t_k // SM90_K_TILE))
        scheduled += min(SM90_Q_ROWS, t_q - r0) * tiles * SM90_K_TILE
    useful = sum(min(r + 1, t_k) for r in range(t_q))
    return 4 * d * scheduled, 4 * d * useful


def bwd_family(dtype, d, strides, ptrs):
    """``"sm90"`` or ``"simple"``: the kernel family (forward, fused
    backward, split pair) for inputs of ``dtype`` with head dim ``d``,
    element strides ``strides`` (one tuple per tensor) and base addresses
    ``ptrs``.  ``"sm90"`` takes bf16
    with ``d <= 128`` and every stride, the head dim's bytes and every
    pointer a multiple of 16 bytes (what TMA addresses); anything else is
    ``"simple"``.  Static: decided before any launch."""
    if dtype != torch.bfloat16 or not 1 <= d <= SM90_MAX_D:
        return "simple"
    es = 2
    if (d * es) % 16 or any((s * es) % 16 for st in strides for s in st):
        return "simple"
    if any(p % 16 for p in ptrs):
        return "simple"
    return "sm90"


def _family(*ts):
    """:func:`bwd_family` of ``[b, t, h, d]`` tensors (strides of the
    batch, time and head dims)."""
    return bwd_family(ts[0].dtype, ts[0].shape[-1],
                      [t.stride()[:3] for t in ts], [t.data_ptr() for t in ts])


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, causal, sm_scale):
    """Masked scaled scores ``[b, h, t_q, t_k]`` in the accumulation
    dtype; the causal rule is ``q_pos >= k_pos``, positions from 0."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        t_q, t_k = s.shape[-2:]
        keep = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_ref(q, k, v, causal=False, sm_scale=None):
    """The plain PyTorch forward: ``(o [b, t_q, h, d] in q.dtype,
    lse [b*h, t_q])``, ``lse = m + log(l)`` in the accumulation dtype."""
    b, t_q, h, d = q.shape
    sm_scale = d ** -0.5 if sm_scale is None else sm_scale
    acc = _acc_dtype(q.dtype)
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(acc), v.to(acc))
    o = o / l_safe[..., 0].permute(0, 2, 1)[..., None]
    lse = (m + torch.log(l_safe))[..., 0].reshape(b * h, t_q)
    return o.to(q.dtype).contiguous(), lse.contiguous()


def flash_bwd_delta_ref(o, do, dlse=None):
    """The plain pre-pass: ``delta [b*h, t_q] = rowsum(do * o) - dlse`` in
    the accumulation dtype, from ``o``, ``do [b, t_q, h, d]`` and the lse
    cotangent ``dlse [b*h, t_q]`` (or None)."""
    b, t_q, h, _ = o.shape
    acc = _acc_dtype(o.dtype)
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1)             # [b, t_q, h]
    delta = delta.permute(0, 2, 1)                           # [b, h, t_q]
    if dlse is not None:
        delta = delta - dlse.reshape(b, h, t_q).to(acc)
    return delta.reshape(b * h, t_q).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, dlse=None, causal=False,
                            sm_scale=None, delta=None):
    """The plain PyTorch backward from the saved ``(q, k, v, o, lse)``:
    ``(dq, dk, dv)`` in the input dtype.  ``dlse [b*h, t_q]`` is the
    cotangent of the returned ``lse`` (None when nothing consumed it);
    ``delta``, when given, is :func:`flash_bwd_delta_ref`'s value for the
    same ``o``, ``do``, ``dlse`` and is used instead of recomputing it."""
    b, t_q, h, d = q.shape
    sm_scale = d ** -0.5 if sm_scale is None else sm_scale
    acc = _acc_dtype(q.dtype)
    dt = q.dtype
    do_a = do.to(acc)
    if delta is None:
        delta = flash_bwd_delta_ref(o, do, dlse)
    delta = delta.reshape(b, h, t_q).to(acc)
    s = _scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.reshape(b, h, t_q, 1).to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).to(acc), do_a)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_a, v.to(acc))
    ds = (p * (dp - delta[..., None]) * sm_scale).to(dt).to(acc)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    return (dq.to(dt).contiguous(), dk.to(dt).contiguous(),
            dv.to(dt).contiguous())


def _check(q, k, v, extra=()):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention: q, k, v must be [b, t, h, d]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}")
    ts = (q, k, v) + tuple(extra)
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention: all tensors must share a device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention: dtype {q.dtype} not supported on the card "
            f"(bfloat16 or float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: k, v ({k.dtype}, {v.dtype}) must match q "
            f"({q.dtype})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention: all tensors must be contiguous")
    if not (1 <= d <= _MAX_D):
        raise ValueError(
            f"flash_attention: d_head {d} must lie in [1, {_MAX_D}]")
    if b * h > _MAX_BH or b * h < 1 or t_q < 1 or k.shape[1] < 1:
        raise ValueError(
            f"flash_attention: batch*heads {b * h} must lie in "
            f"[1, {_MAX_BH}] and both sequence lengths be >= 1")


_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        geom = [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, i32, ptr]
        fns = {}
        for name, n_ptr in (("fwd", 5), ("bwd", 10), ("bwd_dq", 8),
                            ("bwd_dkv", 9)):
            fn = getattr(lib, f"flash_attention_{name}")
            fn.argtypes = [ptr] * n_ptr + geom
            fn.restype = i32
            fns[name] = fn
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        fns["errstr"] = lib.flash_attention_error_string
        _fns = fns
    return _fns


_sm90_fns = None


def _sm90_kernels():
    global _sm90_fns
    if _sm90_fns is None:
        lib = _build.load("flash_bwd_sm90")
        fwd = _build.load("flash_fwd_sm90")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        geom = [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, i32, ptr]
        fns = {"delta": lib.flash_bwd_sm90_delta,
               "dq": lib.flash_bwd_sm90_dq, "dkv": lib.flash_bwd_sm90_dkv,
               "fused": lib.flash_bwd_sm90_fused, "fwd": fwd.flash_fwd_sm90}
        fns["delta"].argtypes = [ptr] * 4 + [i32] * 4 + [i64] * 3 + [ptr]
        fns["dq"].argtypes = [ptr] * 7 + geom
        fns["dkv"].argtypes = [ptr] * 8 + geom
        fns["fused"].argtypes = [ptr] * 9 + geom
        fns["fwd"].argtypes = [ptr] * 5 + geom
        for fn in fns.values():
            fn.restype = i32
        # both libraries return cudaError_t codes: one table names them
        lib.flash_bwd_sm90_error_string.argtypes = [i32]
        lib.flash_bwd_sm90_error_string.restype = ctypes.c_char_p
        fns["errstr"] = lib.flash_bwd_sm90_error_string
        _sm90_fns = fns
    return _sm90_fns


def build():
    """Build (if stale) and load the kernel libraries of both families —
    set-up work that belongs outside any timed window."""
    _kernels()
    _sm90_kernels()


def _geom(q, k, sm_scale, causal):
    b, t_q, h, d = q.shape
    return (b, h, t_q, k.shape[1], d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            float(sm_scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise(what, err, errstr):
    raise RuntimeError(
        f"flash_attention {what} kernel launch failed: cudaError {err} "
        f"({errstr(err).decode()})")


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """``(o, lse [b*h, t_q] f32)`` of attention on ``[b, t, h, d]``.
    CPU tensors take :func:`flash_attention_ref`; CUDA tensors launch the
    forward kernel of the family :func:`bwd_family` picks on the current
    stream, or raise."""
    _check(q, k, v)
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, sm_scale)
    b, t_q, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    family = _family(q, k, v, o)
    fns = _sm90_kernels() if family == "sm90" else _kernels()
    with torch.cuda.device(q.device):
        err = fns["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(),
                         *_geom(q, k, sm_scale, causal))
    if err:
        _raise(f"forward ({family})", err, fns["errstr"])
    flash_fwd.launches += 1
    FWD_FAMILY_CALLS[family] += 1
    return o, lse


flash_fwd.launches = 0


def _check_bwd(q, k, v, o, lse, do, dlse):
    """Shape, device and (on the card) dtype checks of a backward call."""
    extra = (o, lse, do) + (() if dlse is None else (dlse,))
    _check(q, k, v, extra)
    b, t_q, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"flash_attention: o {tuple(o.shape)} and do {tuple(do.shape)} "
            f"must have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (b * h, t_q) or (
            dlse is not None and tuple(dlse.shape) != (b * h, t_q)):
        raise ValueError(
            f"flash_attention: lse / dlse must be [b*h, t_q] = "
            f"{(b * h, t_q)}")
    if q.device.type == "cpu":
        return
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: o, do ({o.dtype}, {do.dtype}) must match q "
            f"({q.dtype})")
    if lse.dtype != torch.float32 or (
            dlse is not None and dlse.dtype != torch.float32):
        raise TypeError("flash_attention: lse and dlse must be float32")


def flash_bwd_delta(o, do, dlse=None):
    """``delta [b*h, t_q] f32 = rowsum(do * o) - dlse``, once per query
    row — the sm90 split family's pre-pass.  CPU tensors take
    :func:`flash_bwd_delta_ref`; CUDA tensors launch the pre-pass kernel
    when they are what the sm90 family takes (:func:`bwd_family`: bf16,
    16-byte aligned rows, contiguous ``[b, t_q, h, d]``), or raise."""
    if o.dim() != 4 or do.shape != o.shape:
        raise ValueError(
            f"flash_bwd_delta: o {tuple(o.shape)} and do {tuple(do.shape)} "
            f"must be one [b, t, h, d] shape")
    b, t_q, h, d = o.shape
    if dlse is not None and tuple(dlse.shape) != (b * h, t_q):
        raise ValueError(f"flash_bwd_delta: dlse must be [b*h, t_q] = "
                         f"{(b * h, t_q)}")
    ts = (o, do) + (() if dlse is None else (dlse,))
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_bwd_delta: all tensors must share a device")
    if o.device.type == "cpu":
        return flash_bwd_delta_ref(o, do, dlse)
    if o.device.type != "cuda":
        raise ValueError(f"flash_bwd_delta: unsupported device {o.device}")
    if dlse is not None and dlse.dtype != torch.float32:
        raise TypeError("flash_bwd_delta: dlse must be float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_bwd_delta: all tensors must be contiguous")
    if do.dtype != o.dtype or _family(o, do) != "sm90":
        raise ValueError(
            f"flash_bwd_delta: the pre-pass serves the sm90 family only "
            f"(bf16, d <= {SM90_MAX_D}, 16-byte aligned rows); got "
            f"{o.dtype}, {do.dtype}, d={d}")
    fns = _sm90_kernels()
    delta = torch.empty((b * h, t_q), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = fns["delta"](o.data_ptr(), do.data_ptr(),
                           None if dlse is None else dlse.data_ptr(),
                           delta.data_ptr(), b, h, t_q, d, o.stride(0),
                           o.stride(1), o.stride(2),
                           torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        _raise("backward delta", err, fns["errstr"])
    flash_bwd_delta.launches += 1
    return delta


flash_bwd_delta.launches = 0


def _check_delta(q, delta):
    b, t_q, h, _ = q.shape
    if tuple(delta.shape) != (b * h, t_q) or delta.device != q.device:
        raise ValueError(f"flash_attention: delta must be [b*h, t_q] = "
                         f"{(b * h, t_q)} on {q.device}")
    if q.device.type == "cuda" and (delta.dtype != torch.float32
                                    or not delta.is_contiguous()):
        raise TypeError("flash_attention: delta must be contiguous float32")


def _sm90_delta(q, o, do, dlse, delta):
    """The delta an sm90 launch reads: ``delta`` as given (checked), or
    one pre-pass launch."""
    if delta is None:
        return flash_bwd_delta(o, do, dlse)
    _check_delta(q, delta)
    return delta


def _bwd_ptrs(q, k, v, o, do, lse, dlse):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if dlse is None else dlse.data_ptr())


def flash_bwd(q, k, v, o, lse, do, dlse=None, causal=False, sm_scale=None,
              block_q=1024, block_k=1024):
    """``(dq, dk, dv)`` from the saved ``(q, k, v, o, lse)`` and the
    cotangents ``do`` (and ``dlse [b*h, t_q]`` or None).  The route
    (:func:`bwd_route`, from ``block_k`` as the reference reads it;
    ``block_q`` is accepted for the same signature; split whenever torch's
    deterministic algorithms are on) is decided first.
    CPU tensors take :func:`flash_attention_bwd_ref` on either route;
    CUDA tensors launch the pre-pass when the family (:func:`bwd_family`)
    is sm90, then the fused kernel of the family, or (split)
    :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`, or raise."""
    _check_bwd(q, k, v, o, lse, do, dlse)
    route = bwd_route(q.shape, k.shape[1], q.element_size(), block_k)
    if torch.are_deterministic_algorithms_enabled():
        route = "split"       # no dq atomics: the same bits run to run
    BWD_ROUTE_CALLS[route] += 1
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal,
                                       sm_scale)
    if route == "split":
        # the sm90 family reads delta: one pre-pass serves both kernels
        delta = (flash_bwd_delta(o, do, dlse)
                 if _family(q, k, v, o, do) == "sm90" else None)
        dq = flash_bwd_dq(q, k, v, o, lse, do, dlse, causal, sm_scale, delta)
        dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, dlse, causal, sm_scale,
                               delta)
        return dq, dk, dv
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    family = _family(q, k, v, o, do, dk, dv)
    if family == "sm90":
        delta = flash_bwd_delta(o, do, dlse)
        fns = _sm90_kernels()
        with torch.cuda.device(q.device):
            err = fns["fused"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq32.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(),
                               *_geom(q, k, sm_scale, causal))
    else:
        fns = _kernels()
        with torch.cuda.device(q.device):
            err = fns["bwd"](*_bwd_ptrs(q, k, v, o, do, lse, dlse),
                             dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             *_geom(q, k, sm_scale, causal))
    if err:
        _raise(f"backward ({family})", err, fns["errstr"])
    flash_bwd.launches += 1
    FUSED_FAMILY_CALLS[family] += 1
    return dq32.to(q.dtype), dk, dv


flash_bwd.launches = 0


def flash_bwd_dq(q, k, v, o, lse, do, dlse=None, causal=False,
                 sm_scale=None, delta=None):
    """The split route's ``dq`` (input dtype, written once by the q-major
    kernel of the family :func:`bwd_family` picks).  ``delta`` is
    :func:`flash_bwd_delta` of the same ``o, do, dlse``, or None: the sm90
    family then launches the pre-pass itself, the simple kernel computes
    it inside.  CPU tensors take the plain backward's ``dq``."""
    _check_bwd(q, k, v, o, lse, do, dlse)
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        if delta is not None:
            _check_delta(q, delta)
        return flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal,
                                       sm_scale, delta)[0]
    dq = torch.empty_like(q)
    family = _family(q, k, v, o, do, dq)
    if family == "sm90":
        delta = _sm90_delta(q, o, do, dlse, delta)
        fns = _sm90_kernels()
        with torch.cuda.device(q.device):
            err = fns["dq"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(), *_geom(q, k, sm_scale, causal))
    else:
        fns = _kernels()
        with torch.cuda.device(q.device):
            err = fns["bwd_dq"](*_bwd_ptrs(q, k, v, o, do, lse, dlse),
                                dq.data_ptr(), *_geom(q, k, sm_scale, causal))
    if err:
        _raise(f"backward dq ({family})", err, fns["errstr"])
    flash_bwd_dq.launches += 1
    BWD_FAMILY_CALLS[family] += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, o, lse, do, dlse=None, causal=False,
                  sm_scale=None, delta=None):
    """The split route's ``(dk, dv)`` (the k-major kernel of the family
    :func:`bwd_family` picks; the simple one is the fused kernel's
    arithmetic without its dq).  ``delta`` as for :func:`flash_bwd_dq`.
    CPU tensors take the plain backward's ``dk, dv``."""
    _check_bwd(q, k, v, o, lse, do, dlse)
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        if delta is not None:
            _check_delta(q, delta)
        return flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal,
                                       sm_scale, delta)[1:]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    family = _family(q, k, v, o, do, dk, dv)
    if family == "sm90":
        delta = _sm90_delta(q, o, do, dlse, delta)
        fns = _sm90_kernels()
        with torch.cuda.device(q.device):
            err = fns["dkv"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(),
                             *_geom(q, k, sm_scale, causal))
    else:
        fns = _kernels()
        with torch.cuda.device(q.device):
            err = fns["bwd_dkv"](*_bwd_ptrs(q, k, v, o, do, lse, dlse),
                                 dk.data_ptr(), dv.data_ptr(),
                                 *_geom(q, k, sm_scale, causal))
    if err:
        _raise(f"backward dk/dv ({family})", err, fns["errstr"])
    flash_bwd_dkv.launches += 1
    BWD_FAMILY_CALLS[family] += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class CudaKernels:
    """The ``cuda`` backend's kernel pair, as :class:`FlashAttentionFunction`
    calls it: :func:`flash_fwd` and :func:`flash_bwd` (looked up by name at
    each call).  ``block_q`` / ``block_k`` pick the backward route."""

    @staticmethod
    def fwd(q, k, v, causal, sm_scale, block_q, block_k):
        return flash_fwd(q, k, v, causal, sm_scale)

    @staticmethod
    def bwd(q, k, v, o, lse, do, dlse, causal, sm_scale, block_q, block_k):
        return flash_bwd(q, k, v, o, lse, do, dlse, causal, sm_scale,
                         block_q=block_q, block_k=block_k)


class RefKernels:
    """The ``torch_ref`` backend's pair: the plain versions, on any device
    (on a CUDA tensor they run only when the backend is asked for by
    name)."""

    @staticmethod
    def fwd(q, k, v, causal, sm_scale, block_q, block_k):
        return flash_attention_ref(q, k, v, causal, sm_scale)

    @staticmethod
    def bwd(q, k, v, o, lse, do, dlse, causal, sm_scale, block_q, block_k):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal,
                                       sm_scale)


class FlashAttentionFunction(torch.autograd.Function):
    """``(o, lse [b*h, t_q])`` with gradients.  Saves exactly
    ``FLASH_BWD_RESIDUALS``; the backward is one ``kernels.bwd`` call (for
    the cuda backend, :func:`flash_bwd` on the route its block sizes give)
    and never re-runs the forward.  ``kernels`` is a backend's pair
    (:class:`CudaKernels` by default, :class:`RefKernels`, or the Triton
    backend's), so every backend shares one residual contract."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_q=1024, block_k=1024,
                kernels=None):
        kernels = kernels or CudaKernels
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = kernels.fwd(q, k, v, causal, sm_scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.blocks = (block_q, block_k)
        ctx.kernels = kernels
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if dlse is not None:
            dlse = dlse.to(lse.dtype).contiguous()
        block_q, block_k = ctx.blocks
        dq, dk, dv = ctx.kernels.bwd(q, k, v, o, lse, do.contiguous(), dlse,
                                     ctx.causal, ctx.sm_scale, block_q,
                                     block_k)
        return dq, dk, dv, None, None, None, None, None


def entry_points(kernels):
    """``(with_lse, plain, packed)``: the three public attention functions
    of a backend whose kernel pair is ``kernels``, each through
    :class:`FlashAttentionFunction` — the registry's ``call_with_lse``,
    ``call`` and ``call_packed``."""

    def with_lse(q, k, v, causal=False, sm_scale=None, block_q=1024,
                 block_k=1024):
        b, t_q, h, d = q.shape
        sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
        o, lse = FlashAttentionFunction.apply(
            q, k, v, bool(causal), sm_scale, int(block_q), int(block_k),
            kernels)
        return o, lse.reshape(b, h, t_q)

    def plain(q, k, v, causal=False, sm_scale=None, block_q=1024,
              block_k=1024):
        return with_lse(q, k, v, causal, sm_scale, block_q, block_k)[0]

    def packed(q, k, v, n_head, causal=False, sm_scale=None, block_q=1024,
               block_k=1024):
        b, t_q, hd = q.shape
        if hd % n_head:
            raise ValueError(
                f"feature dim {hd} not divisible by n_head {n_head}")
        d = hd // n_head
        t_k = k.shape[1]
        o = plain(q.reshape(b, t_q, n_head, d), k.reshape(b, t_k, n_head, d),
                  v.reshape(b, t_k, n_head, d), causal, sm_scale, block_q,
                  block_k)
        return o.reshape(b, t_q, hd)

    return with_lse, plain, packed


_cuda_with_lse, _cuda_plain, _cuda_packed = entry_points(CudaKernels)


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None,
                             block_q=1024, block_k=1024):
    """``(o [b, t_q, h, d], lse [b, h, t_q])``, differentiable through
    both outputs — the building block for merging partial attentions.
    ``block_q``/``block_k`` are the reference's tile attrs; the backward
    route reads ``block_k`` as the reference does.  The ``cuda`` backend's
    ``call_with_lse``."""
    return _cuda_with_lse(q, k, v, causal, sm_scale, block_q, block_k)


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=1024,
                    block_k=1024):
    """Fused attention: q ``[b, t_q, h, d]``, k/v ``[b, t_k, h, d]`` ->
    ``[b, t_q, h, d]``.  Differentiable.  The ``cuda`` backend's
    ``call``."""
    return _cuda_plain(q, k, v, causal, sm_scale, block_q, block_k)


def flash_attention_packed(q, k, v, n_head, causal=False, sm_scale=None,
                           block_q=1024, block_k=1024):
    """Fused attention on the raw projection layout: q/k/v ``[b, t, h*d]``
    -> ``[b, t, h*d]``.  The 4-D view is free (heads are contiguous
    slices of the feature dim), so this is :func:`flash_attention` on the
    same memory.  The ``cuda`` backend's ``call_packed``."""
    return _cuda_packed(q, k, v, n_head, causal, sm_scale, block_q, block_k)


class _FlashCuda:
    call = staticmethod(flash_attention)
    call_with_lse = staticmethod(flash_attention_with_lse)
    call_packed = staticmethod(flash_attention_packed)


class _FlashTorchRef:
    call_with_lse, call, call_packed = (
        staticmethod(f) for f in entry_points(RefKernels))


register_kernel("flash_attention", "cuda", _FlashCuda,
                available=cuda_availability)
register_kernel("flash_attention", "torch_ref", _FlashTorchRef)

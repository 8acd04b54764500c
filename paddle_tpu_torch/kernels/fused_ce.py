"""Fused softmax-cross-entropy LM head — the port's counterpart of
``paddle_tpu/ops/pallas_ce.py`` (``fused_softmax_ce_head``).

    fused_softmax_ce_head(x, w, labels) -> loss
        x [..., d], w [d, V], labels [...] int -> loss [...] f32

The projection, the log-softmax over the vocabulary and the label's
negative log-likelihood happen in one pass: on the card no ``[..., V]``
logit leaves the chip.  Two spellings of each function live here:

* :func:`fused_ce_ref` and :func:`fused_ce_bwd_ref` (its two halves
  :func:`fused_ce_dx_ref`, :func:`fused_ce_dw_ref`) — the plain PyTorch
  versions, with the TPU kernels' algebra: scores in f32 from input-dtype
  operands (f64 for f64), ``lse = m + log(l)``, the label logit picked
  where ``col == y`` (an out-of-range label, -1 or >= V, picks nothing and
  gives the finite ``loss = lse`` that callers mask), ``p = exp(s - lse)``,
  ``ds = (p - onehot) * g`` cast to the input dtype before ``ds @ w^T``
  and ``x^T @ ds`` (as ``pallas_ce.py`` casts it; the ``xla_ref`` backend
  keeps ``ds`` in f32).  They materialise ``[N, V]``: the CPU path and the
  numerics reference the kernels are held against.
* :func:`fused_ce_fwd_tiled_ref`, :func:`fused_ce_dx_split_ref` and
  :func:`fused_ce_dw_split_ref` — plain spellings of the sm90 kernels'
  decompositions (the forward's online softmax over vocab tiles in the
  exp2 domain; dx's and dW's partial scores over ``d`` slices summed, ``ds``
  cast to the input dtype, each slice's product accumulated), for the
  tests.
* the CUDA kernels, hand-written for Hopper (``sm_90a``), which replace the
  TPU kernels ``_ce_fwd`` and the two calls of ``_ce_bwd`` (dx, dW), in two
  families picked by the static rule :func:`ce_family`: for bf16 inputs
  that TMA can address, ``csrc/fused_ce_fwd_dx_sm90.cu`` (the forward and
  dx: ``wgmma``, a TMA ring, dx's ``d`` split between the block's two
  consumer warpgroups) and ``csrc/fused_ce_sm90.cu`` (dW: ``d`` split
  across a thread-block cluster); for everything else (f32, odd widths,
  misaligned pointers) the WMMA kernels of ``csrc/fused_ce.cu``.

:func:`ce_fwd`, :func:`ce_dx` and :func:`ce_dw` are the wrappers.  They
dispatch on the tensors' device: CPU tensors take the plain versions,
CUDA tensors launch the kernels or raise — there is no fallback from one
to the other, nor from one family to the other.  Every successful launch
adds one to ``<wrapper>.launches`` and to its family's count in
``CE_FWD_FAMILY_CALLS``, ``CE_DX_FAMILY_CALLS`` or ``CE_DW_FAMILY_CALLS``.

Gradients flow through :class:`FusedCEFunction`, whose forward saves
exactly ``FUSED_CE_RESIDUALS = (x, w, y, lse)`` — nothing ``[N, V]`` —
and whose backward launches the dx and dW kernels; the forward is never
re-run.  In the kernel registry (``kernels/registry.py``)
:func:`fused_softmax_ce_head` and :func:`fused_softmax_ce_head_with_lse`
are the ``fused_ce`` op class's ``cuda`` backend, and the same entry
points (:func:`entry_points`) over the plain versions its ``torch_ref``.

Kernel limits (checked here, before the launch): x and w bf16 or f32 in
one dtype, y int32, all contiguous on one card.  Any ``d >= 1``: the
simple family loops over d-chunks of 768 past that width (the reference
shrinks its blocks for ``d_model >= 1024``, ``pallas_ce.py:
_auto_blocks``); the sm90 family takes ``d <= 768`` and refuses more.
"""

import ctypes
import math

import torch

from . import _build
from .registry import cuda_availability, register_kernel

__all__ = ["ORACLE_TOL", "FUSED_CE_RESIDUALS", "CE_FWD_FAMILY_CALLS",
           "CE_DX_FAMILY_CALLS", "CE_DW_FAMILY_CALLS", "oracle_tol",
           "fused_ce_ref", "fused_ce_bwd_ref", "fused_ce_dx_ref",
           "fused_ce_dw_ref", "fused_ce_fwd_tiled_ref",
           "fused_ce_dx_split_ref", "fused_ce_dw_split_ref", "dx_d_half",
           "SM90_MAX_D", "ce_family", "ce_fwd", "ce_dx", "ce_dw",
           "FusedCEFunction", "FusedCELseFunction", "CudaKernels",
           "RefKernels", "entry_points", "fused_softmax_ce_head",
           "fused_softmax_ce_head_with_lse", "build"]

# what the backward is computed from, and all the forward saves
# (pallas_ce.py: _ce_core_fwd)
FUSED_CE_RESIDUALS = ("x", "w", "y", "lse")

# max |kernel - ref| / max |ref| (paddle_tpu/kernels/xla_ref.py
# ORACLE_TOL, the fused_ce rows): tiling reassociation of the online
# softmax (f32) plus input rounding (bf16)
ORACLE_TOL = {
    ("fused_ce", "float32"): {"fwd": 2e-4, "grad": 1e-3},
    ("fused_ce", "bfloat16"): {"fwd": 2e-2, "grad": 5e-2},
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SM90_MAX_D = 768   # the widest d the sm90 family takes
D_SLICE = 256      # d a block of the sm90 dW kernel's cluster owns
FWD_BLOCK_V = 128  # vocab columns of an sm90 forward tile
DX_BLOCK_V = 32    # vocab columns of an sm90 dx tile

# launches on the card, by kernel family
CE_FWD_FAMILY_CALLS = {"sm90": 0, "simple": 0}
CE_DX_FAMILY_CALLS = {"sm90": 0, "simple": 0}
CE_DW_FAMILY_CALLS = {"sm90": 0, "simple": 0}


def dx_d_half(d):
    """Where the sm90 dx kernel splits ``d <= 768`` between its two
    consumer warpgroups: each owns ``64 * c`` columns, ``c`` in (1, 2, 3,
    6) the least that covers ``d`` (384 at d = 768; the second half is
    ragged or empty where ``d`` falls short)."""
    return 64 * next(c for c in (1, 2, 3, 6) if 128 * c >= d)


def ce_family(dtype, d, v, ptrs):
    """``"sm90"`` or ``"simple"``: the kernel family of the forward, dx and
    dW alike for ``x [N, d]``, ``w [d, v]`` of ``dtype`` and the inputs'
    base addresses ``ptrs``.
    ``"sm90"`` takes bf16 with ``d <= 768``, rows of ``x`` and ``w`` (``d``
    and ``v`` elements) a multiple of 16 bytes and every pointer 16-byte
    aligned (what TMA addresses); anything else is ``"simple"``.  Static:
    decided before any launch."""
    if dtype != torch.bfloat16 or not 1 <= d <= SM90_MAX_D:
        return "simple"
    if d % 8 or v % 8 or any(p % 16 for p in ptrs):
        return "simple"
    return "sm90"


def oracle_tol(dtype, kind="fwd"):
    """The documented tolerance for ``fused_ce`` in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    return ORACLE_TOL[("fused_ce", name)][kind]


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(x, w):
    """``x [N, d] @ w [d, V]`` in the accumulation dtype, from operands in
    the input dtype (exact products of bf16 values in f32)."""
    acc = _acc_dtype(x.dtype)
    return x.to(acc) @ w.to(acc)


def _in_range(y, v):
    return (y >= 0) & (y < v)


def fused_ce_ref(x, w, y):
    """The plain forward: ``(loss [N], lse [N])`` in the accumulation
    dtype; ``loss = lse - s[y]``, and ``lse`` for an out-of-range label."""
    s = _scores(x, w)
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=-1))
    y = y.long()
    ok = _in_range(y, s.shape[1])
    picked = s.gather(1, torch.where(ok, y, 0)[:, None])[:, 0]
    picked = torch.where(ok, picked, torch.zeros_like(picked))
    return lse - picked, lse


def _ds_ref(x, w, y, lse, g):
    """``ds = (exp(s - lse) - onehot) * g`` in the accumulation dtype,
    rounded through the input dtype as the TPU kernels round it."""
    acc = _acc_dtype(x.dtype)
    ds = torch.exp(_scores(x, w) - lse.to(acc)[:, None])
    y = y.long()
    rows = torch.nonzero(_in_range(y, ds.shape[1]))[:, 0]
    ds[rows, y[rows]] -= 1.0
    ds *= g.to(acc)[:, None]
    return ds.to(x.dtype).to(acc)


def _dx(x, w, ds):
    return (ds @ w.to(ds.dtype).T).to(x.dtype)


def _dw(x, w, ds):
    return (x.to(ds.dtype).T @ ds).to(w.dtype)


def fused_ce_dx_ref(x, w, y, lse, g):
    """The plain dx: ``ds @ w^T`` in the input dtype."""
    return _dx(x, w, _ds_ref(x, w, y, lse, g))


def fused_ce_dw_ref(x, w, y, lse, g):
    """The plain dW: ``x^T @ ds`` in the input dtype."""
    return _dw(x, w, _ds_ref(x, w, y, lse, g))


def fused_ce_fwd_tiled_ref(x, w, y, block_v=FWD_BLOCK_V):
    """The plain spelling of the sm90 forward's decomposition: an online
    softmax over vocab tiles of ``block_v`` columns in the exp2 domain
    (scores scaled by log2(e), the running max ``m2`` and sum ``l``
    carried from tile to tile), the label's logit picked in the tile that
    holds it (an out-of-range label picks nothing), ``lse = m2 ln 2 +
    log(l)``; ``(loss [N], lse [N])`` in the accumulation dtype."""
    acc = _acc_dtype(x.dtype)
    n = x.shape[0]
    v = w.shape[1]
    xa, wa = x.to(acc), w.to(acc)
    y = y.long()
    log2e = 1.0 / math.log(2.0)
    m = torch.full((n,), -math.inf, dtype=acc, device=x.device)
    l = torch.zeros((n,), dtype=acc, device=x.device)
    pick = torch.zeros((n,), dtype=acc, device=x.device)
    for v0 in range(0, v, block_v):
        s = xa @ wa[:, v0:v0 + block_v]
        cols = torch.arange(v0, v0 + s.shape[1], device=x.device)
        pick += torch.where(cols[None, :] == y[:, None], s, 0).sum(dim=1)
        s2 = s * log2e
        m_new = torch.maximum(m, s2.amax(dim=1))
        l = l * torch.exp2(m - m_new) + torch.exp2(
            s2 - m_new[:, None]).sum(dim=1)
        m = m_new
    lse = m * math.log(2.0) + torch.log(l)
    return lse - pick, lse


def _slices(d, cut):
    return [(a, min(a + cut, d)) for a in range(0, d, cut)]


def fused_ce_dx_split_ref(x, w, y, lse, g, d_half=None, block_v=DX_BLOCK_V):
    """The plain spelling of the sm90 dx kernel's decomposition: over vocab
    tiles of ``block_v``, the scores as partial products over the ``d``
    halves cut at ``d_half`` (default :func:`dx_d_half`) summed, ``ds``
    rounded to the input dtype, then each half's ``ds . w_half^T``
    accumulated in the accumulation dtype; dx in the input dtype."""
    acc = _acc_dtype(x.dtype)
    n, d = x.shape
    v = w.shape[1]
    cuts = _slices(d, dx_d_half(d) if d_half is None else d_half)
    xa, wa = x.to(acc), w.to(acc)
    y = y.long()
    la, ga = lse.to(acc)[:, None], g.to(acc)[:, None]
    dx = torch.zeros((n, d), dtype=acc, device=x.device)
    for v0 in range(0, v, block_v):
        wt = wa[:, v0:v0 + block_v]
        s = None
        for a, b in cuts:
            part = xa[:, a:b] @ wt[a:b]
            s = part if s is None else s + part
        cols = torch.arange(v0, v0 + s.shape[1], device=x.device)
        onehot = (cols[None, :] == y[:, None]).to(acc)
        ds = ((torch.exp(s - la) - onehot) * ga).to(x.dtype).to(acc)
        for a, b in cuts:
            dx[:, a:b] += ds @ wt[a:b].T
    return dx.to(x.dtype)


def fused_ce_dw_split_ref(x, w, y, lse, g, d_slice=D_SLICE, block_n=64):
    """The plain spelling of the sm90 dW kernel's decomposition: over row
    tiles of ``block_n``, the scores as partial products over ``d`` slices
    of ``d_slice`` summed in slice order (the cluster's exchange), ``ds``
    rounded to the input dtype, then each slice's ``x_slice^T . ds``
    accumulated in the accumulation dtype; dW in the input dtype."""
    acc = _acc_dtype(x.dtype)
    n, d = x.shape
    v = w.shape[1]
    cuts = _slices(d, d_slice)
    wa = w.to(acc)
    cols = torch.arange(v, device=x.device)
    dw = torch.zeros((d, v), dtype=acc, device=x.device)
    for r0 in range(0, n, block_n):
        xs = x[r0:r0 + block_n].to(acc)
        s = None
        for a, b in cuts:
            part = xs[:, a:b] @ wa[a:b]
            s = part if s is None else s + part
        onehot = cols[None, :] == y[r0:r0 + block_n].long()[:, None]
        ds = ((torch.exp(s - lse[r0:r0 + block_n].to(acc)[:, None])
               - onehot.to(acc)) * g[r0:r0 + block_n].to(acc)[:, None])
        ds = ds.to(x.dtype).to(acc)
        for a, b in cuts:
            dw[a:b] += xs[:, a:b].T @ ds
    return dw.to(w.dtype)


def fused_ce_bwd_ref(x, w, y, lse, g):
    """The plain backward from the saved ``(x, w, y, lse)`` and the loss
    cotangent ``g [N]``: ``(dx [N, d], dw [d, V])`` in the input dtype,
    from one ``ds``."""
    ds = _ds_ref(x, w, y, lse, g)
    return _dx(x, w, ds), _dw(x, w, ds)


def _check(x, w, y, extra=()):
    if x.dim() != 2 or w.dim() != 2 or y.dim() != 1:
        raise ValueError(
            f"fused_ce: x must be [N, d], w [d, V], y [N]; got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(y.shape)}")
    n, d = x.shape
    if w.shape[0] != d or y.shape[0] != n:
        raise ValueError(
            f"fused_ce: w {tuple(w.shape)} / y {tuple(y.shape)} do not match "
            f"x {tuple(x.shape)}")
    if n < 1 or d < 1 or w.shape[1] < 1:
        raise ValueError("fused_ce: N, d and V must all be >= 1")
    if y.dtype.is_floating_point or y.dtype == torch.bool:
        raise TypeError(f"fused_ce: labels must be integers, not {y.dtype}")
    for t in extra:
        if tuple(t.shape) != (n,):
            raise ValueError(
                f"fused_ce: lse and g must be [N] = [{n}]; got "
                f"{tuple(t.shape)}")
    ts = (x, w, y) + tuple(extra)
    if len({t.device for t in ts}) != 1:
        raise ValueError("fused_ce: all tensors must share a device")
    if w.dtype != x.dtype:
        raise TypeError(
            f"fused_ce: x and w must share a dtype ({x.dtype}, {w.dtype})")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"fused_ce: dtype {x.dtype} not supported on the card "
            f"(bfloat16 or float32)")
    if y.dtype != torch.int32:
        raise TypeError(f"fused_ce: labels must be int32 on the card, not "
                        f"{y.dtype}")
    if any(t.dtype != torch.float32 for t in extra):
        raise TypeError("fused_ce: lse and g must be float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_ce: all tensors must be contiguous")


_fns = None


def _kernels():
    """``{(kind, family): C entry}`` of the six kernels, and the error
    string function; every entry takes its pointers, then N, D, V, the
    dtype code and the stream."""
    global _fns
    if _fns is None:
        libs = {"simple": _build.load("fused_ce"),
                "sm90": _build.load("fused_ce_fwd_dx_sm90"),
                "sm90_dw": _build.load("fused_ce_sm90")}
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        geom = [i32, i32, i32, i32, ptr]             # N, D, V, dtype, stream
        fns = {}
        for (kind, family), (lib, name, n_ptrs) in {
                ("forward", "simple"): ("simple", "fused_ce_fwd", 5),
                ("dx", "simple"): ("simple", "fused_ce_dx", 6),
                ("dW", "simple"): ("simple", "fused_ce_dw", 6),
                ("forward", "sm90"): ("sm90", "fused_ce_fwd_sm90", 5),
                ("dx", "sm90"): ("sm90", "fused_ce_dx_sm90", 6),
                ("dW", "sm90"): ("sm90_dw", "fused_ce_dw_sm90", 6)}.items():
            fn = getattr(libs[lib], name)
            fn.argtypes = [ptr] * n_ptrs + geom
            fn.restype = i32
            fns[kind, family] = fn
        errstr = libs["simple"].fused_ce_error_string
        errstr.argtypes = [i32]
        errstr.restype = ctypes.c_char_p
        _fns = (fns, errstr)
    return _fns


def build():
    """Build (if stale) and load the kernel libraries — set-up work that
    belongs outside any timed window."""
    _kernels()


def _launch(kind, ins, outs, calls):
    """Launch the ``kind`` kernel of the family :func:`ce_family` picks for
    the inputs ``ins`` (``x``, ``w`` first) on the current stream, writing
    ``outs``; count it in ``calls``.  Raises (and counts nothing) when the
    launch fails."""
    x, w = ins[:2]
    n, d = x.shape
    family = ce_family(x.dtype, d, w.shape[1], [t.data_ptr() for t in ins])
    fns, errstr = _kernels()
    with torch.cuda.device(x.device):
        err = fns[kind, family](
            *(t.data_ptr() for t in ins + outs), n, d, w.shape[1],
            _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_ce {kind} {family} kernel launch failed: cudaError {err} "
            f"({errstr(err).decode()})")
    calls[family] += 1


def ce_fwd(x, w, y):
    """``(loss [N], lse [N])`` f32 of the fused head on ``x [N, d]``,
    ``w [d, V]``, ``y [N]``.  CPU tensors take :func:`fused_ce_ref`; CUDA
    tensors launch the forward kernel of the family :func:`ce_family`
    picks on the current stream, or raise."""
    _check(x, w, y)
    if x.device.type == "cpu":
        return fused_ce_ref(x, w, y)
    n = x.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    _launch("forward", (x, w, y), (loss, lse), CE_FWD_FAMILY_CALLS)
    ce_fwd.launches += 1
    return loss, lse


ce_fwd.launches = 0


def ce_dx(x, w, y, lse, g):
    """``dx [N, d]`` from the saved ``(x, w, y, lse)`` and the loss
    cotangent ``g [N]``.  CPU tensors take the plain version; CUDA tensors
    launch the dx kernel of the family :func:`ce_family` picks on the
    current stream, or raise."""
    _check(x, w, y, (lse, g))
    if x.device.type == "cpu":
        return fused_ce_dx_ref(x, w, y, lse, g)
    dx = torch.empty_like(x)
    _launch("dx", (x, w, y, lse, g), (dx,), CE_DX_FAMILY_CALLS)
    ce_dx.launches += 1
    return dx


ce_dx.launches = 0


def ce_dw(x, w, y, lse, g):
    """``dw [d, V]`` from the saved ``(x, w, y, lse)`` and the loss
    cotangent ``g [N]``.  CPU tensors take the plain version; CUDA tensors
    launch the dW kernel of the family :func:`ce_family` picks on the
    current stream, or raise."""
    _check(x, w, y, (lse, g))
    if x.device.type == "cpu":
        return fused_ce_dw_ref(x, w, y, lse, g)
    dw = torch.empty_like(w)
    _launch("dW", (x, w, y, lse, g), (dw,), CE_DW_FAMILY_CALLS)
    ce_dw.launches += 1
    return dw


ce_dw.launches = 0


class CudaKernels:
    """The ``cuda`` backend's three kernels as the autograd functions call
    them: :func:`ce_fwd`, :func:`ce_dx`, :func:`ce_dw` (looked up by name
    at each call)."""

    @staticmethod
    def fwd(x, w, y):
        return ce_fwd(x, w, y)

    @staticmethod
    def dx(x, w, y, lse, g):
        return ce_dx(x, w, y, lse, g)

    @staticmethod
    def dw(x, w, y, lse, g):
        return ce_dw(x, w, y, lse, g)


class RefKernels:
    """The ``torch_ref`` backend's: the plain versions, on any device."""

    @staticmethod
    def fwd(x, w, y):
        return fused_ce_ref(x, w, y)

    @staticmethod
    def dx(x, w, y, lse, g):
        return fused_ce_dx_ref(x, w, y, lse, g)

    @staticmethod
    def dw(x, w, y, lse, g):
        return fused_ce_dw_ref(x, w, y, lse, g)


class FusedCEFunction(torch.autograd.Function):
    """``loss [N]`` with gradients in ``x`` and ``w``.  Saves exactly
    ``FUSED_CE_RESIDUALS``; the backward is one dx and one dW call of the
    backend's ``kernels`` (:class:`CudaKernels` by default) and never
    re-runs the forward."""

    @staticmethod
    def forward(ctx, x, w, y, kernels=None):
        kernels = kernels or CudaKernels
        x, w = x.contiguous(), w.contiguous()
        loss, lse = kernels.fwd(x, w, y)
        ctx.save_for_backward(x, w, y, lse)
        ctx.kernels = kernels
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, y, lse = ctx.saved_tensors
        g = g.to(lse.dtype).contiguous()
        k = ctx.kernels
        dx = k.dx(x, w, y, lse, g) if ctx.needs_input_grad[0] else None
        dw = k.dw(x, w, y, lse, g) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


class FusedCELseFunction(torch.autograd.Function):
    """``(loss [N], lse [N])`` with gradients through both — the
    reference's ``_ce_core_lse``, the building block of the vocab-sharded
    head.  ``loss = lse - s[y]``, so with an lse cotangent ``glse`` the
    logits' cotangent is ``(g + glse)(p - onehot) + glse·onehot``: the
    first term is the dx and dW kernels run with ``g + glse``, the second
    a rank-1 correction per row in plain torch (``dx += glse·W[:, y]``,
    ``dW[:, y] += glse·x``) where the label is in range (out of range the
    kernels pick nothing and nothing is corrected)."""

    @staticmethod
    def forward(ctx, x, w, y, kernels=None):
        kernels = kernels or CudaKernels
        x, w = x.contiguous(), w.contiguous()
        loss, lse = kernels.fwd(x, w, y)
        ctx.save_for_backward(x, w, y, lse)
        ctx.kernels = kernels
        ctx.set_materialize_grads(False)
        return loss, lse

    @staticmethod
    def backward(ctx, g, glse):
        x, w, y, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(lse)
        g = g.to(lse.dtype)
        if glse is None:
            glse = torch.zeros_like(lse)
        glse = glse.to(lse.dtype)
        gt = (g + glse).contiguous()
        k = ctx.kernels
        dx = k.dx(x, w, y, lse, gt) if ctx.needs_input_grad[0] else None
        dw = k.dw(x, w, y, lse, gt) if ctx.needs_input_grad[1] else None
        ok = _in_range(y.long(), w.shape[1])
        yi = torch.where(ok, y.long(), torch.zeros_like(y.long()))
        c = torch.where(ok, glse, torch.zeros_like(glse))
        if dx is not None:
            dx = (dx.to(lse.dtype)
                  + c[:, None] * w.to(lse.dtype).t()[yi]).to(x.dtype)
        if dw is not None:
            corr = torch.zeros(w.shape, dtype=lse.dtype, device=w.device)
            corr.index_add_(1, yi, x.to(lse.dtype).t() * c[None, :])
            dw = (dw.to(lse.dtype) + corr).to(w.dtype)
        return dx, dw, None, None


def _rows(x, labels):
    """``x`` as ``[N, d]`` and the labels as int32 ``[N]``, with the
    leading dims to restore."""
    lead = x.shape[:-1]
    n = 1
    for s in lead:
        n *= int(s)
    return lead, x.reshape(n, x.shape[-1]), labels.reshape(n).to(torch.int32)


def entry_points(kernels):
    """``(call, call_with_lse)``: the two public head functions of a
    backend whose kernels are ``kernels`` — the registry's ``call`` and
    ``call_with_lse``.  ``block_n``, ``block_v`` and ``block_v_fwd`` are
    accepted for the reference's signature and not used: the kernels tile
    by their own sizes (the reference's VMEM block chooser has no
    counterpart)."""

    def call(x, w, labels, block_n=512, block_v=1024, block_v_fwd=2048):
        lead, x2, y = _rows(x, labels)
        return FusedCEFunction.apply(x2, w, y, kernels).reshape(lead)

    def call_with_lse(x, w, labels, block_n=512, block_v=1024,
                      block_v_fwd=2048):
        lead, x2, y = _rows(x, labels)
        loss, lse = FusedCELseFunction.apply(x2, w, y, kernels)
        return loss.reshape(lead), lse.reshape(lead)

    return call, call_with_lse


_cuda_call, _cuda_with_lse = entry_points(CudaKernels)


def fused_softmax_ce_head_with_lse(x, w, labels):
    """:func:`fused_softmax_ce_head` that also returns the per-position
    ``lse`` (both ``[...]``, f32), differentiable through both — what the
    vocab-sharded head merges across shards by a logsumexp.  The ``cuda``
    backend's ``call_with_lse``."""
    return _cuda_with_lse(x, w, labels)


def fused_softmax_ce_head(x, w, labels, block_n=512, block_v=1024,
                          block_v_fwd=2048):
    """Fused projection + softmax cross-entropy: ``x [..., d]``,
    ``w [d, V]``, ``labels [...]`` int -> per-position NLL ``[...]`` in f32
    (f64 for f64 inputs), differentiable in ``x`` and ``w``.  The leading
    dimensions are flattened to ``N`` rows and the labels cast to int32
    once.  The ``cuda`` backend's ``call`` (:func:`entry_points` on the
    block arguments)."""
    return _cuda_call(x, w, labels, block_n, block_v, block_v_fwd)


class _CECuda:
    call = staticmethod(fused_softmax_ce_head)
    call_with_lse = staticmethod(fused_softmax_ce_head_with_lse)


class _CETorchRef:
    call, call_with_lse = (staticmethod(f) for f in entry_points(RefKernels))


register_kernel("fused_ce", "cuda", _CECuda, available=cuda_availability)
register_kernel("fused_ce", "torch_ref", _CETorchRef)

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
* :func:`fused_ce_dw_split_ref` — the plain spelling of the sm90 dW
  kernel's decomposition (partial scores over ``d`` slices summed in slice
  order, ``ds`` cast to the input dtype, each slice's update), for the
  tests.
* the CUDA kernels ``csrc/fused_ce.cu``, hand-written for Hopper
  (``sm_90a``), which replace the TPU kernels ``_ce_fwd`` and the two
  calls of ``_ce_bwd`` (dx, dW); the dW of bf16 inputs that TMA can
  address runs on ``csrc/fused_ce_sm90.cu`` (``wgmma``, a TMA ring, the
  ``d`` accumulator split across a thread-block cluster), picked by the
  static rule :func:`ce_family`.

:func:`ce_fwd`, :func:`ce_dx` and :func:`ce_dw` are the wrappers.  They
dispatch on the tensors' device: CPU tensors take the plain versions,
CUDA tensors launch the kernels or raise — there is no fallback from one
to the other.  Every successful launch adds one to ``<wrapper>.launches``;
:func:`ce_dw` adds one to ``CE_DW_FAMILY_CALLS[family]`` too.

Gradients flow through :class:`FusedCEFunction`, whose forward saves
exactly ``FUSED_CE_RESIDUALS = (x, w, y, lse)`` — nothing ``[N, V]`` —
and whose backward launches the dx and dW kernels; the forward is never
re-run.

Kernel limits (checked here, before the launch): x and w bf16 or f32 in
one dtype, y int32, all contiguous on one card, ``1 <= d <= 768``.
"""

import ctypes

import torch

from . import _build

__all__ = ["ORACLE_TOL", "FUSED_CE_RESIDUALS", "CE_DW_FAMILY_CALLS",
           "oracle_tol", "fused_ce_ref", "fused_ce_bwd_ref",
           "fused_ce_dx_ref", "fused_ce_dw_ref", "fused_ce_dw_split_ref",
           "ce_family", "ce_fwd", "ce_dx", "ce_dw", "FusedCEFunction",
           "fused_softmax_ce_head", "build"]

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
_MAX_D = 768
D_SLICE = 256      # d a block of the sm90 dW kernel's cluster owns

# ce_dw launches on the card, by kernel family
CE_DW_FAMILY_CALLS = {"sm90": 0, "simple": 0}


def ce_family(dtype, d, v, ptrs):
    """``"sm90"`` or ``"simple"``: the dW kernel family for ``x [N, d]``,
    ``w [d, v]`` of ``dtype`` and the inputs' base addresses ``ptrs``.
    ``"sm90"`` takes bf16 with ``d <= 768``, rows of ``x`` and ``w`` (``d``
    and ``v`` elements) a multiple of 16 bytes and every pointer 16-byte
    aligned (what TMA addresses); anything else is ``"simple"``.  Static:
    decided before any launch."""
    if dtype != torch.bfloat16 or not 1 <= d <= _MAX_D:
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


def fused_ce_dw_split_ref(x, w, y, lse, g, d_slice=D_SLICE, block_n=64):
    """The plain spelling of the sm90 dW kernel's decomposition: over row
    tiles of ``block_n``, the scores as partial products over ``d`` slices
    of ``d_slice`` summed in slice order (the cluster's exchange), ``ds``
    rounded to the input dtype, then each slice's ``x_slice^T . ds``
    accumulated in the accumulation dtype; dW in the input dtype."""
    acc = _acc_dtype(x.dtype)
    n, d = x.shape
    v = w.shape[1]
    cuts = [(a, min(a + d_slice, d)) for a in range(0, d, d_slice)]
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
    if d > _MAX_D:
        raise ValueError(f"fused_ce: d {d} must be <= {_MAX_D} on the card")


_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("fused_ce")
        sm90 = _build.load("fused_ce_sm90")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        geom = [i32, i32, i32, i32, ptr]                 # N, D, V, dtype, stream
        fwd = lib.fused_ce_fwd
        fwd.argtypes = [ptr] * 5 + geom
        fwd.restype = i32
        dx = lib.fused_ce_dx
        dx.argtypes = [ptr] * 6 + geom
        dx.restype = i32
        dw = lib.fused_ce_dw
        dw.argtypes = [ptr] * 6 + geom
        dw.restype = i32
        dw90 = sm90.fused_ce_dw_sm90
        dw90.argtypes = [ptr] * 6 + [i32, i32, i32, ptr]  # N, D, V, stream
        dw90.restype = i32
        lib.fused_ce_error_string.argtypes = [i32]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
        _fns = (fwd, dx, dw, dw90, lib.fused_ce_error_string)
    return _fns


def build():
    """Build (if stale) and load the kernel libraries — set-up work that
    belongs outside any timed window."""
    _kernels()


def _geom(x, w):
    n, d = x.shape
    return (n, d, w.shape[1], _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)


def _launch(what, fn, ptrs, x, w, errstr):
    with torch.cuda.device(x.device):
        err = fn(*ptrs, *_geom(x, w))
    if err:
        raise RuntimeError(
            f"fused_ce {what} kernel launch failed: cudaError {err} "
            f"({errstr(err).decode()})")


def ce_fwd(x, w, y):
    """``(loss [N], lse [N])`` f32 of the fused head on ``x [N, d]``,
    ``w [d, V]``, ``y [N]``.  CPU tensors take :func:`fused_ce_ref`; CUDA
    tensors launch the forward kernel on the current stream, or raise."""
    _check(x, w, y)
    if x.device.type == "cpu":
        return fused_ce_ref(x, w, y)
    fwd, _, _, _, errstr = _kernels()
    n = x.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    _launch("forward", fwd, (x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             loss.data_ptr(), lse.data_ptr()), x, w, errstr)
    ce_fwd.launches += 1
    return loss, lse


ce_fwd.launches = 0


def ce_dx(x, w, y, lse, g):
    """``dx [N, d]`` from the saved ``(x, w, y, lse)`` and the loss
    cotangent ``g [N]``.  CPU tensors take the plain version; CUDA tensors
    launch the dx kernel on the current stream, or raise."""
    _check(x, w, y, (lse, g))
    if x.device.type == "cpu":
        return fused_ce_dx_ref(x, w, y, lse, g)
    _, dxk, _, _, errstr = _kernels()
    dx = torch.empty_like(x)
    _launch("dx", dxk, (x.data_ptr(), w.data_ptr(), y.data_ptr(),
                        lse.data_ptr(), g.data_ptr(), dx.data_ptr()),
            x, w, errstr)
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
    _, _, dwk, dw90, errstr = _kernels()
    ins = (x.data_ptr(), w.data_ptr(), y.data_ptr(), lse.data_ptr(),
           g.data_ptr())
    family = ce_family(x.dtype, x.shape[1], w.shape[1], ins)
    dw = torch.empty_like(w)
    if family == "sm90":
        n, d = x.shape
        with torch.cuda.device(x.device):
            err = dw90(*ins, dw.data_ptr(), n, d, w.shape[1],
                       torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(
                f"fused_ce dW sm90 kernel launch failed: cudaError {err} "
                f"({errstr(err).decode()})")
    else:
        _launch("dW", dwk, ins + (dw.data_ptr(),), x, w, errstr)
    CE_DW_FAMILY_CALLS[family] += 1
    ce_dw.launches += 1
    return dw


ce_dw.launches = 0


class FusedCEFunction(torch.autograd.Function):
    """``loss [N]`` with gradients in ``x`` and ``w``.  Saves exactly
    ``FUSED_CE_RESIDUALS``; the backward is one :func:`ce_dx` and one
    :func:`ce_dw` call and never re-runs the forward."""

    @staticmethod
    def forward(ctx, x, w, y):
        x, w = x.contiguous(), w.contiguous()
        loss, lse = ce_fwd(x, w, y)
        ctx.save_for_backward(x, w, y, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, y, lse = ctx.saved_tensors
        g = g.to(lse.dtype).contiguous()
        dx = ce_dx(x, w, y, lse, g) if ctx.needs_input_grad[0] else None
        dw = ce_dw(x, w, y, lse, g) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def fused_softmax_ce_head(x, w, labels, block_n=512, block_v=1024,
                          block_v_fwd=2048):
    """Fused projection + softmax cross-entropy: ``x [..., d]``,
    ``w [d, V]``, ``labels [...]`` int -> per-position NLL ``[...]`` in f32
    (f64 for f64 inputs), differentiable in ``x`` and ``w``.  The leading
    dimensions are flattened to ``N`` rows and the labels cast to int32
    once.  ``block_n``, ``block_v`` and ``block_v_fwd`` are accepted for the
    reference's signature and not used: the CUDA kernels tile by their own
    sizes (the reference's VMEM block chooser has no counterpart)."""
    del block_n, block_v, block_v_fwd
    lead = x.shape[:-1]
    d = x.shape[-1]
    n = 1
    for s in lead:
        n *= int(s)
    y = labels.reshape(n).to(torch.int32)
    loss = FusedCEFunction.apply(x.reshape(n, d), w, y)
    return loss.reshape(lead)
